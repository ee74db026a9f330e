"""The port's example benchmark (``pqp_for_mpc_tpu_torch.bench``) against
the JAX package, on the CPU.

Its workload is the JAX package's ``condense`` of the same ``MPCSpec`` on
the same NumPy x0 (both packages build the condensed matrices in float64
on the host, then store float32), so the assembled problem agrees to
float32 rounding: Qp, Gp, Kp and Fp within 1e-5 * max(1, |want|max).  Its
solve under ``EXAMPLE_CFG`` is held to the JAX ``solve_batched`` under
the same configuration with ROADMAP's parity bar: converged verdicts
equal, iterations within max(5, iters/5) rounded up to whole checks, U
within 5e-3 * max(1, |U|max).  Under ``bench.py``'s own configuration,
where no lane certifies, both packages are held to the port's float64 run
of the same iteration: Y within 1e-3 relative (a drift under 2e-7, about
two float32 ulps, per update over 5,000 updates) and U within 1e-6 of the
terms its recovery cancels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.config import MPC_CONFIG as JMPC
from pqp_for_mpc_tpu.config import SolverConfig as JSolverConfig
from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu.solver import solve_batched as j_solve_batched
from pqp_for_mpc_tpu_torch import bench, solve_batched
from pqp_for_mpc_tpu_torch.config import SolverConfig

#: bench.py's keys (its printed line)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch",
              "mean_iters", "converged_frac", "seconds_per_batch",
              "platform"}
B = 256


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_workload(batch):
    """The JAX package's build of the benchmark's workload at ``batch``
    lanes, from the same NumPy draw as ``bench.example_workload``."""
    spec = MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec)
    x = np.random.default_rng(0).normal(0.0, 0.5,
                                        (2, batch)).astype(np.float32)
    primal = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    return primal, jdualize(primal)


@pytest.fixture(scope="module")
def jax_workload():
    return _jax_workload(B)


def _bar(iters, check_every):
    bar = np.maximum(5, iters // 5)
    return -(-bar // check_every) * check_every


def test_example_workload_matches_jax_condense(jax_workload):
    jp, _ = jax_workload
    primal, dual = bench.example_workload(B, "cpu")
    assert (primal.n_var, dual.n_con) == (7, 28)
    for name in ("Qp", "Gp", "Kp", "Fp"):
        want = np.asarray(getattr(jp, name))
        got = getattr(primal, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()),
            err_msg=name)


def test_example_solve_matches_jax(jax_workload):
    jp, jd = jax_workload
    cfg = bench.EXAMPLE_CFG
    jcfg = dataclasses.replace(JMPC, feas_from_dual_gradient=False,
                               accel_every=0, max_iters=5000)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    want = j_solve_batched(jp, jd, cfg=jcfg)
    got = solve_batched(*bench.example_workload(B, "cpu"), cfg=cfg)
    w_conv = np.asarray(want.converged)
    assert w_conv.all()
    np.testing.assert_array_equal(got.converged.numpy(), w_conv)
    w_it = np.asarray(want.iters).astype(np.int64)
    assert (np.abs(got.iters.numpy() - w_it)
            <= _bar(w_it, cfg.check_every)).all()
    w_u = np.asarray(want.U)
    assert np.abs(got.U.numpy() - w_u).max() <= 5e-3 * max(
        1.0, np.abs(w_u).max())


def test_example_bench_returns_bench_py_keys():
    out = bench.example_bench(512, "cpu", repeats=1)
    assert BENCH_KEYS <= set(out)
    assert out["metric"] == "example_qp_solves_per_s"
    assert out["unit"] == "solves/s" and out["batch"] == 512
    assert out["converged_frac"] == 1.0
    assert out["platform"] == "cpu" and out["engine"] == "xla"
    assert out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 1000.0)
    assert out["value"] == pytest.approx(512 / out["seconds_per_batch"])
    # SMOKE_CFG's work per solve on this workload: ~265 iterations
    assert 200 <= out["mean_iters"] <= 350


def _in_float64(obj):
    """A copy of a port dataclass with its float tensors in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})


def test_bench_py_config_certifies_nothing_on_this_workload():
    # bench.py's own configuration (at its CPU precision) certifies no lane
    # of this workload, in either package and in float64 too: y0 = 1000
    # starts the dual iterate some 1e3 times above this workload's
    # multipliers, and 5,000 iterations leave it near 900 (U near 0, about
    # 1 from the optimum), so every lane runs to max_iters.  This is why
    # the port's benchmark runs EXAMPLE_CFG.
    kw = dict(max_iters=5000, check_every=8, y0=1000.0, precision="highest")
    cfg, jcfg = SolverConfig(**kw), JSolverConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    primal, dual = bench.example_workload(64, "cpu")
    want = j_solve_batched(*_jax_workload(64), cfg=jcfg)
    got = solve_batched(primal, dual, cfg=cfg)
    # ROADMAP's parity bar on the verdicts and iterations
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    # the same iteration in float64: the float32 drift's yardstick
    exact = solve_batched(
        _in_float64(primal), _in_float64(dual),
        Y0=torch.full((dual.n_con, 64), cfg.y0, dtype=torch.float64),
        cfg=cfg)
    y64, u64 = exact.Y.numpy(), exact.U.numpy()
    # U = -Qp^-1 (Gp' Y + Fp) cancels terms of ~7e4 down to ~1e-2 at
    # Y ~ 900, so U's bar is float32's reach on those terms, 1e-6 of
    # their size (ROADMAP's 5e-3 * max(1, |U|) is for a solved lane).
    # JAX's Y against the port's float64 run fails its bar when the port's
    # update is off by 1e-6 relative
    terms = np.abs(primal.Qp_inv.numpy().astype(np.float64)) @ (
        np.abs(primal.Gp.numpy().astype(np.float64)).T @ y64
        + np.abs(primal.Fp.numpy()))
    for res in (got, want):
        y, u = np.asarray(res.Y), np.asarray(res.U)
        assert (np.abs(y - y64) <= 1e-3 * y64).all()
        assert (np.abs(u - u64) <= 1e-6 * terms).all()
    for res in (got, want, exact):
        assert not np.asarray(res.converged).any()
        assert (np.asarray(res.iters) == cfg.max_iters + 1).all()
        assert np.asarray(res.Y).min() > 500.0
