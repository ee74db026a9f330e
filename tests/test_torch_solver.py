"""Parity of the PyTorch port's solver with the JAX package.

Workload: the double integrator condensed at horizon 7 (M=7, N=28), a batch
of initial states x0 ~ N(0, 0.5^2) from a NumPy seed, built by the JAX
package and carried to the port through ``pqp_for_mpc_tpu_torch.convert``.
The building blocks are held to rtol 1e-5; whole solves to the parity bar
of ``tests/test_native_oracle.py``: converged verdicts equal, iteration
counts within max(5, iters/5) rounded up to whole checks (a count reported
every ``check_every`` updates resolves no finer), U within
5e-3 * max(1, |U|max) (float32 accumulation order changes a trajectory
slightly, not its solution).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import solver as jsolver
from pqp_for_mpc_tpu.config import MPC_CONFIG as JMPC
from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch import solver as tsolver
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG, SolverConfig

B = 64
#: the slice's configuration (MPC_CONFIG's tolerances, the reference's
#: forcing-scale feasibility test, no acceleration)
SMOKE = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                            accel_every=0, max_iters=5000)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    """The JAX SolverConfig with the same fields."""
    from pqp_for_mpc_tpu.config import SolverConfig as JConfig
    return JConfig(**dataclasses.asdict(cfg))


def _workload(seed=0, materialize=True):
    spec = MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec)
    x = np.random.default_rng(seed).normal(0.0, 0.5, (2, B)) \
        .astype(np.float32)
    jp = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    jd = jdualize(jp, materialize_splits=materialize)
    tp = convert.primal_from_numpy(convert.to_numpy(jp))
    td = convert.dual_from_numpy(convert.to_numpy(jd))
    return jp, jd, tp, td


@pytest.fixture(scope="module")
def problem():
    return _workload()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol * scale)


def _parity(got, want, check_every):
    """The oracle parity bar between two batched SolveResults."""
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(_np(got.converged), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    it_g = _np(got.iters).astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // check_every) * check_every
    assert (np.abs(it_g - it_w) <= bar).all()
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(_np(got.U), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


def _uniform_Y(N, seed=1):
    return np.random.default_rng(seed).uniform(0.01, 10.0, (N, B)) \
        .astype(np.float32)


@pytest.mark.parametrize("materialize", [True, False])
def test_pqp_update_matches_jax(materialize):
    jp, jd, tp, td = _workload(materialize=materialize)
    Y = _uniform_Y(jd.n_con)
    want, got = jnp.asarray(Y), torch.as_tensor(Y)
    for _ in range(4):
        want = jsolver.pqp_update(jd, want, den_eps=1e-30)
        got = tsolver.pqp_update(td, got, den_eps=1e-30)
    _close(got, want)


def test_accel_step_matches_jax(problem):
    jp, jd, tp, td = problem
    Y = _uniform_Y(jd.n_con)
    done = np.arange(B) % 3 == 0
    want = jsolver.accel_step(jd, jnp.asarray(Y), jnp.asarray(done))
    got = tsolver.accel_step(td, torch.as_tensor(Y), torch.as_tensor(done))
    _close(got, want)
    np.testing.assert_array_equal(_np(got)[:, done], Y[:, done])


@pytest.mark.parametrize("gap_comp", [False, True])
@pytest.mark.parametrize("feas_grad", [False, True])
def test_check_terminate_matches_jax(problem, feas_grad, gap_comp):
    jp, jd, tp, td = problem
    cfg = dataclasses.replace(SMOKE, feas_from_dual_gradient=feas_grad,
                              gap_from_complementarity=gap_comp,
                              strict_weak_duality=not gap_comp)
    # iterates part-way to the solution, so the verdicts are mixed
    mid = jsolver.solve_batched(jp, jd, cfg=_jcfg(
        dataclasses.replace(cfg, max_iters=200)))
    Y = np.asarray(mid.Y)
    want = jsolver.check_terminate(jp, jd, jnp.asarray(Y), _jcfg(cfg))
    got = tsolver.check_terminate(tp, td, torch.tensor(Y), cfg)
    ok_w = np.asarray(want[0])
    assert 0 < ok_w.sum() < B
    np.testing.assert_array_equal(_np(got[0]), ok_w)
    _close(got[1], want[1])                     # U
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    # costs carry the Mp/Md constants: float32 noise scales with them
    mp = float(np.abs(np.asarray(jp.Mp)).max())
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * mp)


def _warm_start(jp, jd):
    """Multipliers of a neighbouring batch: a per-lane warm start."""
    jp2, jd2, _, _ = _workload(seed=5)
    res = jsolver.solve_batched(jp2, jd2, cfg=_jcfg(SMOKE))
    return np.maximum(np.asarray(res.Y), 1e-6)


def _poisoned_start(jp, jd):
    """A warm start with half its lanes at the absorbing zero."""
    Y = _warm_start(jp, jd)
    Y[:, ::2] = 0.0
    return Y


CASES = {
    "cold": (SMOKE, None, False),
    "warm": (SMOKE, _warm_start, False),
    # a check every 4 updates: iteration counts come in steps of the
    # check cadence, and the parity bar is 5 iterations at small counts
    "accel": (dataclasses.replace(SMOKE, check_every=4, accel_every=4),
              None, False),
    "accel_feas_from_dual_gradient": (
        dataclasses.replace(MPC_CONFIG, check_every=4), None, False),
    "retry_cold": (dataclasses.replace(SMOKE, max_iters=800),
                   _poisoned_start, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batched_matches_jax(problem, case):
    jp, jd, tp, td = problem
    cfg, start, retry = CASES[case]
    Y0 = None if start is None else start(jp, jd)
    want = jsolver.solve_batched(
        jp, jd, Y0=None if Y0 is None else jnp.asarray(Y0), cfg=_jcfg(cfg),
        retry_cold=retry)
    got = tsolver.solve_batched(
        tp, td, Y0=None if Y0 is None else torch.as_tensor(Y0), cfg=cfg,
        retry_cold=retry)
    assert np.asarray(want.converged).mean() > 0.9
    if retry:
        # the warm start alone leaves lanes uncertified: the retry runs
        alone = tsolver.solve_batched(tp, td, Y0=torch.as_tensor(Y0),
                                      cfg=cfg)
        assert not bool(alone.converged.all())
    _parity(got, want, cfg.check_every)
    np.testing.assert_array_equal(_np(got.diverged),
                                  np.asarray(want.diverged))


def test_solve_single_instance_matches_jax(problem):
    jp, jd, tp, td = problem
    jp1 = dataclasses.replace(jp, Fp=jp.Fp[:, 3], Mp=jp.Mp[3])
    tp1 = dataclasses.replace(tp, Fp=tp.Fp[:, 3], Mp=tp.Mp[3])
    want = jsolver.solve(jp1, cfg=_jcfg(SMOKE))
    got = tsolver.solve(tp1, cfg=SMOKE)
    assert bool(got.converged) == bool(want.converged)
    assert abs(int(got.iters) - int(want.iters)) <= max(5, int(want.iters) // 5)
    np.testing.assert_allclose(_np(got.U), np.asarray(want.U), atol=5e-3)
    with pytest.raises(ValueError, match="single-instance"):
        tsolver.solve(tp, cfg=SMOKE)


@pytest.mark.parametrize("horizon", [7, 33])
def test_use_pallas_on_cpu_runs_the_plain_update(horizon, monkeypatch):
    # CPU tensors take the kernels' plain versions: at N <= 128 K2's, which
    # is the plain update itself; past it (N = 132) K3's f32 mode, which
    # adds theta y outside the product, so the plain solve is made to run
    # that same update here.  Either way the two loops must agree
    from pqp_for_mpc_tpu_torch import dualize
    from pqp_for_mpc_tpu_torch.ops import tiled_kernel
    from pqp_for_mpc_tpu_torch.models import MPCSpec as TSpec
    from pqp_for_mpc_tpu_torch.models import condense as tcondense
    from pqp_for_mpc_tpu_torch.models import double_integrator as tplant
    spec = TSpec(tplant(), horizon=horizon, Qy=np.eye(1), R=0.05 * np.eye(1),
                 r=np.array([2.5]), u_min=-np.ones(1), u_max=np.ones(1),
                 du_max=0.5 * np.ones(1))
    data = tcondense(spec, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(0.0, 0.5, (2, 4))
                        .astype(np.float32))
    primal = data.assemble(x=x, Qp=data.qp())
    dual = dualize(primal)
    cfg = dataclasses.replace(SMOKE, max_iters=40)
    got = tsolver.solve_batched(primal, dual,
                                cfg=dataclasses.replace(cfg, use_pallas=True))
    if horizon == 33:
        Q, th = tiled_kernel.streamed_matrix(dual.Qd, dual.theta)
        monkeypatch.setattr(
            tsolver, "pqp_update",
            lambda d, Y, precision=None, den_eps=0.0:
            tiled_kernel.streamed_pqp_iterations_reference(
                Q, th, d.Fdn, d.Fdp, Y, 1, den_eps))
    want = tsolver.solve_batched(primal, dual, cfg=cfg)
    torch.testing.assert_close(got.Y, want.Y, rtol=1e-6, atol=0)
    assert bool((got.iters == want.iters).all())


def test_default_config_matches_jax_fields():
    assert dataclasses.asdict(SolverConfig()) == dataclasses.asdict(
        _jcfg(SolverConfig()))
    assert dataclasses.asdict(MPC_CONFIG) == dataclasses.asdict(JMPC)


def test_fan_out_edge_lanes_fail_alike():
    """Four lanes of the H=16 scenario fan-out (x0 ~ N(0, 1), B=4096,
    ``MPC_CONFIG``) that the port leaves uncertified at 50,001 iterations.
    Neither package certifies all of them, and which ones certify depends
    on summation order in both (ROADMAP queue 3): every lane either left
    uncertified is feasible with a relative gap far below ``erj`` and an
    absolute complementarity gap just above ``eaj = 1e-4`` — the float32
    floor of ``Y'(Qd Y + Fd)`` at |Jd| ~ 50.  Lanes 1100 and 1700 fail in
    both packages in this batch: the verdicts are held equal there."""
    spec = MPCSpec(double_integrator(), horizon=16, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec)
    lanes = [534, 770, 1100, 1700]
    x = np.random.default_rng(2).normal(0.0, 1.0, (2, 4096)) \
        .astype(np.float32)[:, lanes]
    jp = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    jd = jdualize(jp)
    tp = convert.primal_from_numpy(convert.to_numpy(jp))
    td = convert.dual_from_numpy(convert.to_numpy(jd))
    want = jsolver.solve_batched(jp, jd, cfg=JMPC)
    got = tsolver.solve_batched(tp, td, cfg=MPC_CONFIG)
    results = (
        (np.asarray(want.converged), np.asarray(want.feasible),
         np.asarray(jsolver.complementarity_gap(jd, want.Y)),
         np.asarray(want.Jd)),
        (_np(got.converged), _np(got.feasible),
         _np(tsolver.complementarity_gap(td, got.Y)), _np(got.Jd)))
    for conv, feas, gap, jd_ in results:
        left = ~conv
        assert left[2] and left[3]
        assert feas[left].all()
        assert (np.abs(gap[left]) / np.abs(jd_[left]) < 0.1 * JMPC.erj).all()
        assert (gap[left] > JMPC.eaj).all() and \
            (gap[left] <= 4 * JMPC.eaj).all()
