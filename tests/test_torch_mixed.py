"""Parity of the port's ``solve_mixed`` (bf16 bulk phase + float32
certification) with the JAX package's.

Workloads: ``_random_qp`` of ``tests/test_mixed_precision.py`` built by the
JAX package and carried across as NumPy arrays.  Bar: the oracle parity bar
of ``tests/test_native_oracle.py`` — converged verdicts equal, iteration
counts within max(5, iters/5) rounded up to whole checks (the bulk phase's
floor test and the accel acceptance compare float32 values whose summation
order differs, so a lane can hand off or accept a step one check apart), U
within 5e-3 * max(1, |U|max).  The whole slice — ``solve_mixed`` riding the
streamed kernel past residency — is held against the JAX package's run of
its own streamed kernel in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import solver as jsolver
from pqp_for_mpc_tpu.config import SolverConfig as JConfig
from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch import solver as tsolver
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import tiled_kernel

ACCEL = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                     strict_weak_duality=False,
                     gap_from_complementarity=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _random_qp(N=96, M=32, B=4, seed=0):
    """tests/test_mixed_precision.py's random QP: (JAX primal, JAX dual,
    port primal, port dual)."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    jp = JPrimal(
        Qp=jnp.asarray(Qp),
        Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
        Fp=jnp.asarray(rng.normal(0, 3, (M, B)).astype(np.float32)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(rng.normal(0, 1, (N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1, 10, N).astype(np.float32)))
    jd = jdualize(jp)
    return (jp, jd,
            convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"),
            convert.dual_from_numpy(convert.to_numpy(jd), device="cpu"))


def _parity(got, want, check_every):
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    it_g = got.iters.numpy().astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // check_every) * check_every
    assert (np.abs(it_g - it_w) <= bar).all(), (it_g, it_w)
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


CASES = {
    "accel": (ACCEL, 0),
    "no_accel": (dataclasses.replace(ACCEL, accel_every=0, y0=10.0), 2),
    "explicit_gap": (dataclasses.replace(
        ACCEL, gap_from_complementarity=False), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_mixed_matches_jax(case):
    cfg, seed = CASES[case]
    jp, jd, tp, td = _random_qp(seed=seed)
    want = jsolver.solve_mixed(jp, jd, cfg=_jcfg(cfg))
    got = tsolver.solve_mixed(tp, td, cfg=cfg)
    assert np.asarray(want.converged).all()
    _parity(got, want, cfg.check_every)


def test_solve_mixed_warm_start_matches_jax():
    jp, jd, tp, td = _random_qp(B=3, seed=1)
    ref = jsolver.solve_batched(jp, jd, cfg=_jcfg(ACCEL))
    Y0 = np.maximum(np.asarray(ref.Y), 0.01)
    want = jsolver.solve_mixed(jp, jd, Y0=jnp.asarray(Y0), cfg=_jcfg(ACCEL))
    got = tsolver.solve_mixed(tp, td, Y0=torch.tensor(Y0), cfg=ACCEL)
    assert bool(got.converged.all())
    # warm-started from the solution: few iterations in all
    assert int(got.iters.max()) <= 64
    _parity(got, want, ACCEL.check_every)


def test_solve_mixed_resets_a_nan_lane():
    """A lane whose phase-1 iterate is non-finite restarts phase 2 from the
    cold start (NaN is absorbing under the multiplicative update)."""
    jp, jd, tp, td = _random_qp(B=3, seed=4)
    Y0 = np.full((td.n_con, 3), 1000.0, np.float32)
    Y0[:, 1] = np.nan
    want = jsolver.solve_mixed(jp, jd, Y0=jnp.asarray(Y0), cfg=_jcfg(ACCEL))
    got = tsolver.solve_mixed(tp, td, Y0=torch.tensor(Y0), cfg=ACCEL)
    assert bool(got.converged.all()) and bool(torch.isfinite(got.U).all())
    _parity(got, want, ACCEL.check_every)


def test_solve_mixed_reports_both_phases_and_caps_each():
    # max_iters caps EACH phase: the reported sum may exceed it
    jp, jd, tp, td = _random_qp(seed=0)
    cfg = dataclasses.replace(ACCEL, max_iters=40)
    want = jsolver.solve_mixed(jp, jd, cfg=_jcfg(cfg))
    got = tsolver.solve_mixed(tp, td, cfg=cfg)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert int(got.iters.max()) > cfg.max_iters


def test_solve_mixed_distinct_geometry_matches_jax():
    """The shared random QP restated as distinct geometry — its matrices
    repeated per instance — runs the distinct half of solve_mixed (theta
    per instance, per-instance products) in both packages."""
    jp, jd, tp, td = _random_qp(B=2, seed=5)
    rep = lambda a: jnp.broadcast_to(a, (2,) + a.shape)
    jp3 = dataclasses.replace(jp, Qp=rep(jp.Qp), Qp_inv=rep(jp.Qp_inv),
                              Gp=rep(jp.Gp))
    jd3 = dataclasses.replace(jd, Qd=rep(jd.Qd), theta=rep(jd.theta),
                              Qdp_theta=rep(jd.Qdp_theta),
                              Qdn_theta=rep(jd.Qdn_theta))
    tp3 = convert.primal_from_numpy(convert.to_numpy(jp3), device="cpu")
    td3 = convert.dual_from_numpy(convert.to_numpy(jd3), device="cpu")
    want = jsolver.solve_mixed(jp3, jd3, cfg=_jcfg(ACCEL))
    got = tsolver.solve_mixed(tp3, td3, cfg=ACCEL)
    assert np.asarray(want.converged).all()
    _parity(got, want, ACCEL.check_every)
    # the same lanes as the shared-geometry solve of the same problem
    shared = tsolver.solve_mixed(tp, td, cfg=ACCEL)
    np.testing.assert_allclose(got.U.numpy(), shared.U.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_slice_solve_mixed_rides_the_streamed_kernel(monkeypatch):
    """The slice as a whole: past residency (N = 192 > 128) with
    ``use_pallas``, the port's bulk phase runs K3's bf16 mode and its
    refine K3's f32 mode (plain versions on the CPU); the JAX package runs
    its streamed kernel in interpret mode, with its VMEM fit test patched
    so that N = 192 counts as past residency there too."""
    from jax.experimental.pallas import tpu as pltpu
    from pqp_for_mpc_tpu.ops import kernels as jkernels

    jp, jd, tp, td = _random_qp(N=192, M=64, B=4, seed=6)
    cfg = dataclasses.replace(ACCEL, check_every=16, accel_every=16,
                              use_pallas=True)
    monkeypatch.setattr(jkernels, "fits_vmem", lambda n, budget=0: False)
    with pltpu.force_tpu_interpret_mode():
        want = jsolver.solve_mixed(jp, jd, cfg=_jcfg(cfg))
    calls = []
    real = tiled_kernel.streamed_pqp_iterations_reference

    def spy(Q, *args, **kwargs):
        calls.append(Q.dtype)
        return real(Q, *args, **kwargs)

    monkeypatch.setattr(tiled_kernel, "streamed_pqp_iterations_reference",
                        spy)
    got = tsolver.solve_mixed(tp, td, cfg=cfg)
    assert torch.bfloat16 in calls and torch.float32 in calls
    assert np.asarray(want.converged).all()
    _parity(got, want, cfg.check_every)
