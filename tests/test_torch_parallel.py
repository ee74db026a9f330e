"""The port's ``parallel/`` on an 8-rank gloo ring of CPU processes,
against the JAX package's ``parallel/`` on the 8-device virtual CPU mesh
(``tests/test_sharding.py``'s cases, one test each).

One ring serves the whole file: a module fixture writes every input (NumPy,
from seeds) to a directory, starts eight worker processes that import
``torch`` only, and each rank runs every case on its blocks and saves them.
The tests assemble the blocks by the ranks' mesh coordinates and hold:

* the mesh: ``make_mesh(model=2)`` is 4 x 2 as in JAX, JAX's two errors
  with its words, and the port's own: a mesh that leaves ranks out;
* data parallel (``shard_batch`` + ``solve_batched``, 8 x 1) against the
  JAX single-device solve: U within 1e-5, iterations equal;
* row-sharded at 2 x 4 (N=32) and 1 x 8 (N=128), and ``mixed=True`` at
  2 x 4 against float32 sharded (2e-3, JAX's bar), each against JAX's
  ``solve_row_sharded`` at ROADMAP's parity bar (verdicts equal,
  iterations within max(5, iters/5) rounded up to whole checks, U within
  5e-3 * max(1, |U|max)) and against the port's own ``solve_batched`` at
  JAX's bars (2e-4 and 64 iterations; 5e-4 at N=128);
* the stage-wise solve data-parallel (x0 over 8 ranks) against JAX's
  single device: rtol 1e-4, atol 2e-4, iterations within 4 checks;
* ``process_local_batch_slice`` and its error;
* the row-sharded stamp of a lane frozen non-finite: 0 iterations, as in
  JAX's sharded solve (``solve_batched`` stamps the freeze), from a warm
  start at the solution with that lane NaN.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import SolverConfig as JConfig
from pqp_for_mpc_tpu import dualize as jdualize
from pqp_for_mpc_tpu import solve_batched as jsolve_batched
from pqp_for_mpc_tpu.parallel import make_mesh as jmake_mesh
from pqp_for_mpc_tpu.parallel import solve_row_sharded as jsolve_row_sharded
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu_torch import (PrimalQP, SolverConfig, dualize,
                                   solve_batched)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

#: the cases' configurations (tests/test_sharding.py's)
CFG_DP = dict(max_iters=20_000, check_every=4)
CFG_ROW = dict(max_iters=20_000, check_every=4, eaj=1e-3, erj=1e-5,
               strict_weak_duality=False)
CFG_WIDE = dict(max_iters=50_000, check_every=8, eaj=1e-3, erj=1e-5,
                strict_weak_duality=False)
CFG_MIXED = dict(max_iters=50_000, check_every=8, accel_every=4, eaj=1e-3,
                 erj=1e-5, strict_weak_duality=False,
                 gap_from_complementarity=True)
CFG_SW = dict(max_iters=50_000, check_every=8, accel_every=4, y0=0.01,
              eaj=1e-4, erj=1e-5, erc=1e-5, eac=1e-5,
              strict_weak_duality=False)
#: the lane of the bad-lane case whose warm start is NaN
BAD_LANE = 3

WORKER = r"""
import sys
rank, world, store, inputs, out = sys.argv[1:]
rank, world = int(rank), int(world)
import time
T0 = time.perf_counter()
import numpy as np, torch
torch.set_num_threads(1)
import pqp_for_mpc_tpu_torch.parallel.distributed as dist
from pqp_for_mpc_tpu_torch import (PrimalQP, SolverConfig, dualize,
                                   solve_batched)
from pqp_for_mpc_tpu_torch.models import MPCSpec, double_integrator
from pqp_for_mpc_tpu_torch.models import solve_stagewise, stagewise_dual
from pqp_for_mpc_tpu_torch.parallel import (batch_sharding, local_shard,
                                            make_mesh, shard_batch,
                                            solve_row_sharded)
dist.initialize(init_method=f"file://{store}", num_processes=world,
                process_id=rank, device="cpu", timeout_s=120)
z = dict(np.load(inputs, allow_pickle=True))
res = {}
laps = [("start", T0), ("init", time.perf_counter())]

def lap(case):
    laps.append((case, time.perf_counter()))

def problem(name):
    t = lambda k: torch.as_tensor(z[f"{name}_{k}"])
    p = PrimalQP(Qp=t("Qp"), Qp_inv=t("Qp_inv"), Fp=t("Fp"), Mp=t("Mp"),
                 Gp=t("Gp"), Kp=t("Kp"))
    return p, dualize(p)

def cfg(name):
    return SolverConfig(**z[f"cfg_{name}"].item())

def keep(case, mesh, r):
    res[f"{case}_coord"] = np.array([mesh.get_local_rank("data"),
                                     mesh.get_local_rank("model")])
    for f in ("U", "Y", "iters", "converged", "diverged"):
        res[f"{case}_{f}"] = getattr(r, f).numpy()

def error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""

# -- the mesh -------------------------------------------------------------
res["mesh_model2"] = np.array(make_mesh(model=2, device_type="cpu").shape)
res["err_model3"] = error(lambda: make_mesh(model=3, device_type="cpu"))
res["err_4x4"] = error(lambda: make_mesh(data=4, model=4, device_type="cpu"))
res["err_2x2"] = error(lambda: make_mesh(data=2, model=2, device_type="cpu"))
res["slice16"] = np.array(
    [dist.process_local_batch_slice(16).start,
     dist.process_local_batch_slice(16).stop])
res["err_slice12"] = error(lambda: dist.process_local_batch_slice(12))

# -- data parallel: 8 x 1 -------------------------------------------------
mesh = make_mesh(model=1, device_type="cpu")
p, d = problem("dp")
pl, dl = shard_batch(p, d, mesh)
keep("dp", mesh, solve_batched(pl, dl, cfg=cfg("dp")))
res["err_indivisible"] = error(lambda: shard_batch(*problem("wide"), mesh))
lap("mesh+dp")

# -- row-sharded: 2 x 4 at N=32, its bad lane, and mixed at N=128 ---------
mesh24 = make_mesh(data=2, model=4, device_type="cpu")
p, d = problem("row")
keep("row", mesh24, solve_row_sharded(p, d, cfg=cfg("row"), mesh=mesh24))
lap("row")
keep("bad", mesh24, solve_row_sharded(p, d, Y0=torch.as_tensor(z["bad_Y0"]),
                                      cfg=cfg("row"), mesh=mesh24))
lap("bad")
p, d = problem("wide")
keep("f32", mesh24, solve_row_sharded(p, d, cfg=cfg("mixed"), mesh=mesh24))
lap("f32")
keep("mixed", mesh24, solve_row_sharded(p, d, cfg=cfg("mixed"), mesh=mesh24,
                                        mixed=True))
lap("mixed")
# -- row-sharded: 1 x 8 at N=128 ------------------------------------------
mesh18 = make_mesh(data=1, model=8, device_type="cpu")
keep("wide", mesh18, solve_row_sharded(p, d, cfg=cfg("wide"), mesh=mesh18))
lap("wide")

# -- the stage-wise solve, x0 over the 8 ranks ----------------------------
spec = MPCSpec(plant=double_integrator(), horizon=12, Qy=np.eye(1),
               R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
               u_max=np.ones(1), du_max=0.5 * np.ones(1))
c = cfg("sw")
sd = stagewise_dual(spec, theta_floor=c.theta_floor, device="cpu")
x0 = local_shard(torch.as_tensor(z["sw_x0"]), mesh, batch_sharding(mesh))
keep("sw", mesh, solve_stagewise(sd, x0, cfg=c))
lap("sw")

torch.distributed.destroy_process_group()
assert "jax" not in sys.modules
np.savez(out, **res)
print("RANK", rank, "OK", " ".join(
    f"{b[0]} {b[1] - a[1]:.2f}s" for a, b in zip(laps, laps[1:])), flush=True)
"""


def _numpy_problem(B, N, M, seed):
    """tests/test_sharding.py's ``_batched_problem`` as NumPy arrays."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    return dict(Qp=Qp, Qp_inv=np.linalg.inv(Qp).astype(np.float32),
                Gp=rng.integers(-1, 2, (N, M)).astype(np.float32),
                Kp=rng.uniform(1.0, 10.0, N).astype(np.float32),
                Fp=rng.standard_normal((M, B)).astype(np.float32) * 5,
                Mp=rng.standard_normal(B).astype(np.float32))


PROBLEMS = {"dp": (16, 32, 16, 0), "row": (8, 32, 16, 0),
            "wide": (4, 128, 32, 3)}


@functools.cache
def _inputs():
    """Every input of the ring's cases, NumPy arrays by name."""
    z = {}
    for name, shape in PROBLEMS.items():
        z.update({f"{name}_{k}": v
                  for k, v in _numpy_problem(*shape).items()})
    for name, c in (("dp", CFG_DP), ("row", CFG_ROW), ("wide", CFG_WIDE),
                    ("mixed", CFG_MIXED), ("sw", CFG_SW)):
        z[f"cfg_{name}"] = np.array(c, dtype=object)
    # the bad-lane case starts from the port's solution (every other lane
    # certifies at the first check) with one lane's warm start NaN
    Y0 = solve_batched(*_torch_problem("row"),
                       cfg=SolverConfig(**CFG_ROW)).Y.numpy()
    Y0[:, BAD_LANE] = np.nan
    z["bad_Y0"] = Y0
    z["sw_x0"] = np.random.default_rng(2).uniform(-2, 2, (2, 16)).astype(
        np.float32)
    return z


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """Run the worker on 8 ranks; per-rank dicts of its results."""
    tmp = tmp_path_factory.mktemp("ring")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    outs = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(tmp / "store"), inputs, outs[r]], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    # one deadline for the ring, which takes ~140 s inside the whole suite
    # under xdist -n 6 (~30 s alone); a rank stuck in a collective raises
    # after its process group's 120 s timeout
    deadline = t0 + 600
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"RANK {r} OK" in log
    # the ring's time and rank 0's per-case laps (shown under -s or -rP)
    print(f"ring: {time.perf_counter() - t0:.1f} s;",
          logs[0].strip().splitlines()[-1])
    return [dict(np.load(o)) for o in outs]


def _assemble(ring, case):
    """The global (U, Y, iters, converged, diverged) of a case from the
    ranks' blocks; every rank of a model group must hold the same U and
    per-lane vectors."""
    coords = np.stack([z[f"{case}_coord"] for z in ring])
    dp, mp = coords.max(axis=0) + 1
    first = ring[0]
    Nl, Bl = first[f"{case}_Y"].shape
    out = {"U": np.zeros((first[f"{case}_U"].shape[0], dp * Bl), np.float32),
           "Y": np.zeros((mp * Nl, dp * Bl), np.float32)}
    for f in ("iters", "converged", "diverged"):
        out[f] = np.zeros(dp * Bl, first[f"{case}_{f}"].dtype)
    for z, (di, mi) in zip(ring, coords):
        cols = slice(di * Bl, (di + 1) * Bl)
        out["Y"][mi * Nl:(mi + 1) * Nl, cols] = z[f"{case}_Y"]
        if mi == 0:
            out["U"][:, cols] = z[f"{case}_U"]
            for f in ("iters", "converged", "diverged"):
                out[f][cols] = z[f"{case}_{f}"]
    for z, (di, mi) in zip(ring, coords):
        cols = slice(di * Bl, (di + 1) * Bl)
        np.testing.assert_array_equal(z[f"{case}_U"], out["U"][:, cols])
        np.testing.assert_array_equal(z[f"{case}_iters"], out["iters"][cols])
    return out


def _jax_problem(name):
    a = _numpy_problem(*PROBLEMS[name])
    primal = JPrimal(**{k: jnp.asarray(v) for k, v in a.items()})
    return primal, jdualize(primal)


def _torch_problem(name):
    a = _numpy_problem(*PROBLEMS[name])
    primal = PrimalQP(**{k: torch.as_tensor(v) for k, v in a.items()})
    return primal, dualize(primal)


def _parity(got, want, check_every):
    """ROADMAP's parity bar against a JAX result."""
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(want.converged))
    it = np.asarray(want.iters).astype(np.int64)
    bar = -(-np.maximum(5, it // 5) // check_every) * check_every
    assert (np.abs(got["iters"].astype(np.int64) - it) <= bar).all(), (
        got["iters"], it)
    U = np.asarray(want.U)
    np.testing.assert_allclose(got["U"], U, rtol=0,
                               atol=5e-3 * max(1.0, np.abs(U).max()))


def test_mesh_shapes_and_errors(ring):
    assert dict(jmake_mesh(model=2).shape) == {"data": 4, "model": 2}
    for z in ring:
        np.testing.assert_array_equal(z["mesh_model2"], [4, 2])
    for key, kw in (("err_model3", dict(model=3)),
                    ("err_4x4", dict(data=4, model=4))):
        with pytest.raises(ValueError) as e:
            jmake_mesh(**kw)
        assert all(str(z[key]) == str(e.value) for z in ring), key
    # JAX takes the first 4 devices; the port's mesh spans the whole group
    assert dict(jmake_mesh(data=2, model=2).shape) == {"data": 2, "model": 2}
    assert all("must span the whole process group" in str(z["err_2x2"])
               for z in ring)


def test_process_local_batch_slice(ring):
    for r, z in enumerate(ring):
        np.testing.assert_array_equal(z["slice16"], [2 * r, 2 * r + 2])
        assert str(z["err_slice12"]) == (
            "global batch 12 not divisible by 8 processes — pad the batch "
            "(silently dropping the remainder would under-solve)")


def f64_gap_below_floor(a, dual, Y, lanes):
    """benchmarks/conformance.py's razor-edge audit of the NumPy problem
    ``a`` and JAX ``dual``: the explicit gap Jp + Jd of ``Y``'s lanes
    recomputed in float64 lies within the float32 noise floor of its
    cancellation (eps32 times its largest term)."""
    a = {k: v.astype(np.float64) for k, v in a.items()}
    Qd, Fd, Md = (np.asarray(x, np.float64) for x in (dual.Qd, dual.Fd,
                                                       dual.Md))
    Y = np.asarray(Y, np.float64)[:, lanes]
    Fp, Fd, Mp, Md = a["Fp"][:, lanes], Fd[:, lanes], a["Mp"][lanes], \
        Md[lanes]
    U = -a["Qp_inv"] @ (Fp + a["Gp"].T @ Y)
    terms = np.stack([0.5 * (U * (a["Qp"] @ U)).sum(0), (Fp * U).sum(0),
                      0.5 * Mp, 0.5 * (Y * (Qd @ Y)).sum(0),
                      (Fd * Y).sum(0), 0.5 * Md])
    floor = np.finfo(np.float32).eps * np.abs(terms).max(axis=0)
    return np.abs(terms.sum(axis=0)) <= floor


def test_data_parallel_matches_jax_single_device(ring):
    """Under JAX's strict config (eaj = 1e-6 on costs ~10) every lane's
    verdict sits at the float32 floor of the explicit gap, so the port and
    JAX certify different lanes whatever the sharding: the sharded run is
    held bit for bit to the port's unsharded one, and to JAX's with U
    within 1e-5, iterations within the parity bar where both certify, and
    each lane whose verdict differs audited below the float32 floor."""
    got = _assemble(ring, "dp")
    own = solve_batched(*_torch_problem("dp"), cfg=SolverConfig(**CFG_DP))
    for f in ("U", "iters", "converged"):
        np.testing.assert_array_equal(got[f], getattr(own, f).numpy())
    primal, dual = _jax_problem("dp")
    ref = jsolve_batched(primal, dual, cfg=JConfig(**CFG_DP))
    np.testing.assert_allclose(got["U"], np.asarray(ref.U), rtol=1e-5,
                               atol=1e-5)
    conv = np.asarray(ref.converged)
    both = conv & got["converged"]
    it, want = got["iters"][both].astype(np.int64), np.asarray(ref.iters)[
        both]
    assert (np.abs(it - want) <= np.maximum(5, want // 5)).all()
    for side, Y in ((got["converged"] & ~conv, own.Y.numpy()),
                    (conv & ~got["converged"], np.asarray(ref.Y))):
        assert f64_gap_below_floor(_numpy_problem(*PROBLEMS["dp"]),
                                   dual, Y, side).all()
    # the N=128 problem's B=4 lanes do not divide over 8 ranks
    assert all("not divisible by the 8 ranks of mesh dim 'data'"
               in str(z["err_indivisible"]) for z in ring)


def test_row_sharded_2x4_matches_jax_and_replicated(ring):
    got = _assemble(ring, "row")
    assert got["converged"].all()
    primal, dual = _jax_problem("row")
    jres = jsolve_row_sharded(primal, dual, cfg=JConfig(**CFG_ROW),
                              mesh=jmake_mesh(data=2, model=4))
    _parity(got, jres, CFG_ROW["check_every"])
    own = solve_batched(*_torch_problem("row"), cfg=SolverConfig(**CFG_ROW))
    assert bool(own.converged.all())
    np.testing.assert_allclose(got["U"], own.U.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got["iters"].astype(np.int64)
                  - own.iters.numpy()).max() <= 64


def test_row_sharded_1x8_large_n(ring):
    got = _assemble(ring, "wide")
    assert got["converged"].all()
    primal, dual = _jax_problem("wide")
    jres = jsolve_row_sharded(primal, dual, cfg=JConfig(**CFG_WIDE),
                              mesh=jmake_mesh(data=1, model=8))
    _parity(got, jres, CFG_WIDE["check_every"])
    own = solve_batched(*_torch_problem("wide"), cfg=SolverConfig(**CFG_WIDE))
    np.testing.assert_allclose(got["U"], own.U.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_row_sharded_mixed_matches_f32(ring):
    f32, mixed = _assemble(ring, "f32"), _assemble(ring, "mixed")
    assert f32["converged"].all() and mixed["converged"].all()
    np.testing.assert_allclose(mixed["U"], f32["U"], rtol=2e-3, atol=2e-3)
    assert mixed["iters"].min() > 0
    primal, dual = _jax_problem("wide")
    mesh = jmake_mesh(data=2, model=4)
    for got, flag in ((f32, False), (mixed, True)):
        jres = jsolve_row_sharded(primal, dual, cfg=JConfig(**CFG_MIXED),
                                  mesh=mesh, mixed=flag)
        _parity(got, jres, CFG_MIXED["check_every"])


def test_row_sharded_stamps_a_bad_lane_as_jax(ring):
    got = _assemble(ring, "bad")
    primal, dual = _jax_problem("row")
    Y0 = _inputs()["bad_Y0"]
    jres = jsolve_row_sharded(primal, dual, jnp.asarray(Y0),
                              cfg=JConfig(**CFG_ROW),
                              mesh=jmake_mesh(data=2, model=4))
    np.testing.assert_array_equal(got["diverged"], np.asarray(jres.diverged))
    np.testing.assert_array_equal(got["iters"][BAD_LANE],
                                  np.asarray(jres.iters)[BAD_LANE])
    assert got["iters"][BAD_LANE] == 0 and got["diverged"][BAD_LANE]
    assert not got["converged"][BAD_LANE]
    good = np.arange(8) != BAD_LANE
    _parity({k: v[..., good] for k, v in got.items()},
            type(jres)(**{f: getattr(jres, f)[..., good]
                          for f in ("U", "Y", "iters", "converged",
                                    "feasible", "Jp", "Jd", "diverged")}),
            CFG_ROW["check_every"])
    # solve_batched stamps the freeze (h = 1) instead
    own = solve_batched(*_torch_problem("row"), Y0=torch.as_tensor(Y0),
                        cfg=SolverConfig(**CFG_ROW))
    assert int(own.iters[BAD_LANE]) == 1 and bool(own.diverged[BAD_LANE])


def test_stagewise_data_parallel_matches_jax_single_device(ring):
    from pqp_for_mpc_tpu.models import MPCSpec, double_integrator
    from pqp_for_mpc_tpu.models.stagewise import (solve_stagewise,
                                                  stagewise_dual)
    got = _assemble(ring, "sw")
    assert got["converged"].all()
    spec = MPCSpec(
        plant=double_integrator(), horizon=12,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    cfg = JConfig(**CFG_SW)
    sd = stagewise_dual(spec, theta_floor=cfg.theta_floor)
    ref = solve_stagewise(sd, jnp.asarray(_inputs()["sw_x0"]), cfg=cfg,
                          pscan=True)
    np.testing.assert_allclose(got["U"], np.asarray(ref.U), rtol=1e-4,
                               atol=2e-4)
    assert (np.abs(got["iters"].astype(np.int64) - np.asarray(ref.iters))
            <= 4 * cfg.check_every).all()
