"""The port's command line (``python -m pqp_for_mpc_tpu_torch``) against the
JAX package's (``python -m pqp_for_mpc_tpu``), both in process on the CPU
(the port with ``--device cpu``).

Bars: ``generate`` writes byte-identical files.  A solve's printed verdict
is equal, its iterations within the oracle bar max(5, iters/5) rounded up
to whole checks, Jp and Jd within 1e-3 * max(1, |J|) (the bar of
``tests/test_cli.py`` between two engines), U and u0 within
5e-3 * max(1, |U|max).  The example-format directory is written by
``write_example_dir`` from the thermal RC plant condensed at horizon 1 —
the reference example's dimensions (29 states, 7 inputs, 7 outputs, one
disturbance), which ``solve DIR`` assumes.
"""

import io
import json
import sys

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.cli import main as jmain
from pqp_for_mpc_tpu_torch.cli import main as tmain

#: the solve flags of tests/test_cli.py with the feasibility slack at
#: erc = eac = 1e-4: at its 1e-6 none of the 12 x 30 instances of seeds
#: 0-11 certifies in either package (their Gp U sits within the float32
#: floor of Kp ~ 50 from the bounds)
FLAGS = ["--y0", "0.01", "--accel-every", "4", "--check-every", "8",
         "--no-strict", "--max-iters", "50000", "--eaj", "1e-3",
         "--erj", "1e-4", "--erc", "1e-4", "--eac", "1e-4"]
#: a generator seed whose 12 x 30 instance certifies in both packages
SEED = "3"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bar(iters, check_every):
    bar = max(5, iters // 5)
    return -(-bar // check_every) * check_every


def _fields(line):
    return dict(kv.split("=", 1) for kv in line.split() if "=" in kv)


@pytest.fixture(scope="module")
def instance(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gen") / "inst.txt")
    assert tmain(["generate", "12", "30", "--seed", SEED, "-o", path]) == 0
    return path


@pytest.fixture(scope="module")
def example_dir(tmp_path_factory):
    from pqp_for_mpc_tpu.io import write_example_dir
    from pqp_for_mpc_tpu.models import MPCSpec, condense, thermal_rc
    plant = thermal_rc()
    spec = MPCSpec(plant, horizon=1, Qy=np.eye(plant.n_output),
                   R=0.05 * np.eye(plant.n_input),
                   r=np.full(plant.n_output, 0.5),
                   u_min=-np.ones(plant.n_input),
                   u_max=np.ones(plant.n_input),
                   du_max=0.5 * np.ones(plant.n_input))
    path = str(tmp_path_factory.mktemp("example"))
    write_example_dir(path, condense(spec))
    return path


def test_example_dir_round_trip_matches_jax(tmp_path, example_dir):
    """The port writes the same example-format files as the JAX package
    from the same condensed problem, and reads them back to its arrays."""
    import os
    from pqp_for_mpc_tpu.io import load_example_dir as jload
    from pqp_for_mpc_tpu_torch import convert
    from pqp_for_mpc_tpu_torch.io import load_example_dir, write_example_dir
    from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, thermal_rc
    plant = thermal_rc()
    spec = MPCSpec(plant, horizon=1, Qy=np.eye(plant.n_output),
                   R=0.05 * np.eye(plant.n_input),
                   r=np.full(plant.n_output, 0.5),
                   u_min=-np.ones(plant.n_input),
                   u_max=np.ones(plant.n_input),
                   du_max=0.5 * np.ones(plant.n_input))
    out = str(tmp_path / "port")
    write_example_dir(out, condense(spec, device="cpu"))
    names = sorted(os.listdir(example_dir))
    assert sorted(os.listdir(out)) == names
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(example_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    got = convert.to_numpy(load_example_dir(out, device="cpu"))
    want = convert.to_numpy(jload(example_dir))
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("seed", ["0", "5", "123"])
def test_generate_is_byte_identical(tmp_path, capsys, seed):
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    assert jmain(["generate", "25", "60", "--seed", seed, "-o", a]) == 0
    assert tmain(["generate", "25", "60", "--seed", seed, "-o", b]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax.txt", "") == out[1].replace("torch.txt", "")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("engine", ["auto", "xla", "mixed"])
def test_solve_file_matches_jax(instance, capsys, engine):
    rc_j = jmain(["solve-file", instance, "--engine", engine] + FLAGS)
    want = _fields(capsys.readouterr().out.strip())
    rc_t = tmain(["solve-file", instance, "--engine", engine] + FLAGS + CPU)
    got = _fields(capsys.readouterr().out.strip())
    assert rc_j == rc_t == 0
    for k in ("M", "N", "converged", "feasible", "engine"):
        assert got[k] == want[k], k
    assert got["engine"] == ("mixed" if engine == "mixed" else "xla")
    it_w, it_t = int(want["iters"]), int(got["iters"])
    assert abs(it_t - it_w) <= _bar(it_w, 8)
    for k in ("Jp", "Jd"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-3 * max(1.0, abs(w)), k


def test_solve_file_mixed_flag_is_the_mixed_engine(instance, capsys):
    assert tmain(["solve-file", instance, "--mixed"] + FLAGS + CPU) == 0
    assert _fields(capsys.readouterr().out.strip())["engine"] == "mixed"


def test_solve_example_dir_matches_jax(example_dir, capsys):
    flags = ["--accel-every", "4", "--check-every", "4", "--max-iters",
             "5000"]
    rc_j = jmain(["solve", example_dir] + flags)
    want = capsys.readouterr().out.splitlines()
    rc_t = tmain(["solve", example_dir] + flags + CPU)
    got = capsys.readouterr().out.splitlines()
    assert rc_j == rc_t == 0
    assert len(got) == len(want) == 12
    assert got[0].startswith("Printing number of iterations = ")
    it_w, it_t = int(want[0].split("=")[1]), int(got[0].split("=")[1])
    assert abs(it_t - it_w) <= _bar(it_w, 4)
    for line_w, line_t in zip(want[1:3], got[1:3]):
        w, t = float(line_w.split("=")[1]), float(line_t.split("=")[1])
        assert abs(t - w) <= 1e-3 * max(1.0, abs(w)), line_w
    U_w = np.array([float(v) for v in want[4:11]])
    U_t = np.array([float(v) for v in got[4:11]])
    np.testing.assert_allclose(U_t, U_w,
                               atol=5e-3 * max(1.0, np.abs(U_w).max()))
    assert got[11].split("wall")[0] == want[11].split("wall")[0]


def _serve(main, argv, requests, monkeypatch, capsys):
    lines = "\n".join(json.dumps(r) for r in requests) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert main(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_serve_matches_jax(example_dir, instance, monkeypatch, capsys):
    requests = [
        {"example_dir": example_dir},
        {"example_dir": example_dir,
         "batch_x": np.random.default_rng(3).uniform(
             -0.5, 0.5, (3, 29)).round(4).tolist()},
        {"generator_file": instance},
        {"spec": {"plant": "double_integrator", "horizon": 8},
         "x": [1.5, -0.2], "u_prev": [0.1]},
        {"bogus": 1},
        {"cmd": "quit"},
        {"generator_file": instance},          # after quit: never answered
    ]
    argv = ["serve", "--accel-every", "4", "--check-every", "4",
            "--max-iters", "50000", "--y0", "0.01", "--no-strict",
            "--eaj", "1e-3", "--erj", "1e-4", "--erc", "1e-4", "--eac", "1e-4"]
    want = _serve(jmain, argv, requests, monkeypatch, capsys)
    got = _serve(tmain, argv + CPU, requests, monkeypatch, capsys)
    assert len(got) == len(want) == 5
    assert "error" in got[4] and "error" in want[4]
    for g, w in zip(got[:4], want[:4]):
        assert set(g) == set(w)
        for k in ("batch", "converged", "feasible", "diverged"):
            assert g[k] == w[k], k
        assert w["converged"] == w["batch"]
        assert abs(g["iters_max"] - w["iters_max"]) <= _bar(w["iters_max"], 4)
        U_w, U_t = np.asarray(w["U"]), np.asarray(g["U"])
        np.testing.assert_allclose(U_t, U_w,
                                   atol=5e-3 * max(1.0, np.abs(U_w).max()))
    np.testing.assert_allclose(got[3]["u0"], want[3]["u0"], atol=5e-3)


def test_rollout_jit_matches_jax(capsys):
    argv = ["rollout", "--jit", "--steps", "30", "--horizon", "16"]
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tmain(argv + CPU) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("plant", "horizon", "steps", "backend", "moves", "robust_w"):
        assert got[k] == want[k], k
    assert abs(got["final_state_norm"] - want["final_state_norm"]) <= 1e-3
    assert abs(got["iters_mean"] - want["iters_mean"]) \
        <= 0.1 * want["iters_mean"]
    assert got["steps_per_s"] > 0


def test_rollout_moves_and_y_max(capsys):
    assert tmain(["rollout", "--steps", "5", "--horizon", "12", "--moves",
                  "4", "--y-max", "1.5", "--retry-cold"] + CPU) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["moves"] == 4 and out["backend"] == "condensed"


@pytest.mark.parametrize("argv", [
    ["rollout", "--backend", "stagewise", "--horizon", "32", "--steps", "5"],
    ["rollout", "--robust-w", "0.002,0.005", "--steps", "5"],
    ["rollout", "--robust-w", "0.002,0.005", "--backend", "stagewise",
     "--horizon", "64", "--steps", "5", "--jit"],
], ids=["stagewise", "robust_w", "robust_w_stagewise_jit"])
def test_rollout_stagewise_and_robust_match_jax(capsys, argv):
    """The stage-wise backend (warm_start="shift", as the JAX CLI) and the
    robust tube print the JAX CLI's line: its keys, the same backend and
    flags, the final state within 1e-3 and mean iterations within 10%."""
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tmain(argv + CPU) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("plant", "horizon", "steps", "backend", "moves", "robust_w"):
        assert got[k] == want[k], k
    assert abs(got["final_state_norm"] - want["final_state_norm"]) <= 1e-3
    assert abs(got["iters_mean"] - want["iters_mean"]) \
        <= 0.1 * want["iters_mean"]


def test_rollout_auto_past_the_line_and_bad_robust_w(capsys):
    """backend auto picks the stage-wise backend at H=384 (n_con = 1536);
    a --robust-w of the wrong length exits 1 naming the state count."""
    assert tmain(["rollout", "--horizon", "384", "--steps", "2"] + CPU) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["backend"] == "stagewise" and out["steps"] == 2
    assert tmain(["rollout", "--robust-w", "0.1"] + CPU) == 1
    assert "2 comma-separated" in capsys.readouterr().err


def test_serve_long_horizon_spec_request(monkeypatch, capsys):
    """A spec request past the n_con line reaches the stage-wise backend
    through backend="auto" and answers like the JAX daemon."""
    requests = [{"spec": {"plant": "double_integrator", "horizon": 400},
                 "x": [2.0, 0.0]}, {"cmd": "quit"}]
    argv = ["serve", "--y0", "0.01", "--no-strict", "--accel-every", "8",
            "--check-every", "16", "--erc", "1e-3", "--eac", "1e-3",
            "--eaj", "1e-2", "--erj", "1e-3", "--max-iters", "5000"]
    want = _serve(jmain, argv, requests, monkeypatch, capsys)
    got = _serve(tmain, argv + CPU, requests, monkeypatch, capsys)
    assert len(got) == len(want) == 1 and "error" not in got[0]
    assert set(got[0]) == set(want[0])
    assert got[0]["converged"] == want[0]["converged"] == 1
    assert len(got[0]["U"][0]) == 400
    np.testing.assert_allclose(got[0]["u0"], want[0]["u0"], atol=5e-3)


def test_bench_tiny(capsys):
    argv = ["bench", "--M", "6", "--N", "20", "--iters", "5", "--batch", "8",
            "--repeats", "1"]
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tmain(argv + CPU) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dropped = {"reference_gpu_tiled_seconds", "speedup_vs_reference_gpu",
               "throughput_speedup_vs_reference_gpu"}
    assert set(got) == set(want) - dropped
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["kernel"] == "torch" and got["platform"] == "cpu"
    assert got["value"] > 0


def test_bench_example_prints_the_metric_line(capsys):
    # the twin of bench.py (pqp_for_mpc_tpu_torch.bench): one JSON line
    # with bench.py's keys; on the CPU the router picks the plain solve
    argv = ["bench-example", "--batch", "256", "--repeats", "1"]
    assert tmain(argv + CPU) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "batch", "mean_iters",
            "converged_frac", "seconds_per_batch", "platform"} <= set(got)
    assert got["metric"] == "example_qp_solves_per_s"
    assert got["batch"] == 256 and got["converged_frac"] == 1.0
    assert got["platform"] == "cpu" and got["engine"] == "xla"
    assert got["value"] > 0


def test_bench_example_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["bench-example", "--batch", "8", "--repeats", "1"])


@pytest.mark.parametrize("argv", [
    ["estimate", "--kind", "kf"],
    ["estimate", "--kind", "mhe", "--one-sided"],
    ["estimate", "--kind", "mhe", "--plant", "quadruple_tank", "--simulate",
     "60", "--window", "6"],
    ["rollout", "--offset-free", "input", "--steps", "30"],
    ["rollout", "--offset-free", "output", "--plant", "quadruple_tank",
     "--steps", "30"],
    ["rollout", "--offset-free", "input", "--backend", "stagewise",
     "--horizon", "32", "--steps", "10", "--d-true", "0.25"],
], ids=["estimate_kf", "estimate_mhe_one_sided", "estimate_mhe_mimo",
        "offset_free_input", "offset_free_output",
        "offset_free_stagewise"])
def test_estimation_commands_match_jax(capsys, argv):
    """estimate and rollout --offset-free print the JAX CLI's line: its
    keys, the same exit code, the same plant, kind and counts; RMSE and
    the final estimates within 5e-3 * max(1, |want|) (the oracle bar),
    the final state within 1e-3 and mean iterations within 10% (the
    rollout bar above; 1 iteration where the mean is the floor of one
    check)."""
    rc_j = jmain(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc_t = tmain(argv + CPU)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_t == rc_j == 0
    assert set(got) == set(want)
    exact = ("plant", "kind", "T", "estimates", "converged_frac", "horizon",
             "steps", "backend", "moves", "robust_w", "offset_free",
             "d_true")
    for k in set(exact) & set(want):
        assert got[k] == want[k], k
    for k in ("rmse", "d_hat_final", "y_final"):
        if k in want:
            w = np.asarray(want[k])
            np.testing.assert_allclose(
                got[k], w, rtol=0, atol=5e-3 * max(1.0, np.abs(w).max()),
                err_msg=k)
    if "final_state_norm" in want:
        assert abs(got["final_state_norm"] - want["final_state_norm"]) \
            <= 1e-3
    assert abs(got["iters_mean"] - want["iters_mean"]) \
        <= max(1.0, 0.1 * want["iters_mean"])


def test_estimate_writes_its_estimates(tmp_path, capsys):
    """-o writes x_hat; a record read back with --data gives the same
    estimates as the simulated one (the truth rides along as X)."""
    from pqp_for_mpc_tpu_torch.cli import simulated_record
    from pqp_for_mpc_tpu_torch.models import double_integrator
    out = str(tmp_path / "est.npz")
    assert tmain(["estimate", "--kind", "kf", "-o", out] + CPU) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["out"] == out
    x0, U, Y, X = simulated_record(double_integrator(), 120, 1e-4, 1e-4,
                                   False, 0)
    rec = str(tmp_path / "rec.npz")
    np.savez(rec, U=U, Y=Y, X=X, x0=x0)
    assert tmain(["estimate", "--kind", "kf", "--data", rec] + CPU) == 0
    again = json.loads(capsys.readouterr().out.strip())
    assert again["rmse"] == line["rmse"]
    np.testing.assert_array_equal(np.load(out)["x_hat"].shape, (120, 2))


@pytest.mark.parametrize("argv", [
    ["estimate", "--kind", "kf"],
    ["rollout", "--offset-free", "input", "--steps", "2"],
], ids=["estimate", "rollout_offset_free"])
def test_estimation_commands_need_a_card_by_default(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(argv)


def test_device_defaults_to_the_card(instance):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["solve-file", instance] + FLAGS)
