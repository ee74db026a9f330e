"""The port's real-time-iteration controller (``models/rti.py``) against
the JAX package's, on the CPU, on the cases of ``tests/test_rti.py`` and
the output-feedback capstone of ``tests/test_mhe.py``.

Bars: ``relinearize`` on new per-stage dynamics equals a fresh
``stagewise_dual`` build at the same band field by field (atol = rtol =
2e-5, JAX's bar), with the Jacobians from ``torch.func`` within 1e-5 of
``jax.jacobian``'s; the eager ``step`` loop equals ``rollout`` (atol = rtol
= 1e-5, JAX's bar); each closed loop against JAX's: u and x within 5e-3 *
max(1, |want|max) at every step, verdicts equal, iterations within max(5,
iters/5) rounded up to whole checks on at least 3/4 of the steps and the
mean within 10%; and the JAX tests' guarantees on the port's loops (the
pendulum swings up from 2.5 rad; the output-feedback loop holds the
upright pendulum, its estimate tracking the truth).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pqp_for_mpc_tpu import SolverConfig as JSolverConfig
from pqp_for_mpc_tpu import models as jmodels
from pqp_for_mpc_tpu_torch import SolverConfig, convert
from pqp_for_mpc_tpu_torch import models as tmodels
from pqp_for_mpc_tpu_torch.models import (NonlinearMHE, RTIController,
                                          output_feedback_rollout,
                                          relinearize, stagewise_dual)

CPU = torch.device("cpu")
IN_BAR_SHARE = 0.75
DT = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pendulum(stack, sin, g=10.0, damping=0.1):
    """tests/test_rti.py's upright pendulum (RK4), in either framework."""
    def f_cont(x, u):
        return stack([x[1], g * sin(x[0]) - damping * x[1] + u[0]])

    def f_disc(x, u):
        k1 = f_cont(x, u)
        k2 = f_cont(x + 0.5 * DT * k1, u)
        k3 = f_cont(x + 0.5 * DT * k2, u)
        k4 = f_cont(x + DT * k3, u)
        return x + (DT / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return f_disc


F_JAX = _pendulum(jnp.stack, jnp.sin)
F_TORCH = _pendulum(torch.stack, torch.sin)
# tests/test_mhe.py's capstone plant: g = 9.81, damping 0.2
F2_JAX = _pendulum(jnp.stack, jnp.sin, 9.81, 0.2)
F2_TORCH = _pendulum(torch.stack, torch.sin, 9.81, 0.2)


def _jacobians(f, x, u):
    A, B = torch.func.jacrev(f, argnums=(0, 1))(torch.as_tensor(x),
                                                torch.as_tensor(u))
    return A.numpy(), B.numpy()


def _spec(m, f, H, du_max=6.0, u_prev=None, R=0.02):
    A, B = _jacobians(f, np.zeros(2, np.float32), np.zeros(1, np.float32))
    plant = m.LTVPlant(A=np.tile(A[None], (H, 1, 1)),
                       B=np.tile(B[None], (H, 1, 1)),
                       E=np.tile(np.eye(2, dtype=np.float32)[None],
                                 (H, 1, 1)),
                       C=np.tile(np.array([[[1.0, 0.0]]], np.float32),
                                 (H, 1, 1)), name="pendulum")
    return m.MPCSpec(plant=plant, horizon=H,
                     Qy=np.eye(1, dtype=np.float32),
                     R=R * np.eye(1, dtype=np.float32),
                     r=np.zeros(1, np.float32),
                     u_min=np.array([-12.0], np.float32),
                     u_max=np.array([12.0], np.float32),
                     du_max=np.array([du_max], np.float32), u_prev=u_prev)


CFG = dict(max_iters=20_000, check_every=8, accel_every=4, y0=0.01,
           eaj=1e-3, erj=1e-4, erc=1e-4, eac=1e-4, strict_weak_duality=False)


def _close(got, want, what):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=0,
                               atol=5e-3 * max(1.0, float(np.abs(w).max())),
                               err_msg=what)


def _iters_in_bar(got, want):
    it_w, it_g = (np.asarray(a).astype(np.int64) for a in (want, got))
    bar = -(-np.maximum(5, it_w // 5) // 8) * 8
    assert (np.abs(it_g - it_w) <= bar).mean() >= IN_BAR_SHARE, (it_g, it_w)
    assert abs(it_g.mean() - it_w.mean()) <= 0.1 * it_w.mean()


def _assert_fields(a, b, atol, rtol, path=""):
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, dict):
            _assert_fields(va, vb, atol, rtol, path + k + ".")
        elif va is None:
            assert vb is None, path + k
        else:
            np.testing.assert_allclose(np.asarray(va), np.asarray(vb),
                                       atol=atol, rtol=rtol,
                                       err_msg=path + k)


def test_relinearize_matches_fresh_build():
    """tests/test_rti.py's pin of the relinearize/fresh-build equivalence
    on the port: dynamics linearized along a swing, a moved slew anchor."""
    H = 10
    spec0 = _spec(tmodels, F_TORCH, H)
    sd0 = stagewise_dual(spec0, theta_floor=5.0, device=CPU)
    rng = np.random.default_rng(7)
    xs = np.stack([np.array([2.5 * np.cos(0.3 * k), -0.7 * np.sin(0.3 * k)])
                   for k in range(H)]).astype(np.float32)
    us = rng.uniform(-3, 3, (H, 1)).astype(np.float32)
    A2, B2 = torch.func.vmap(torch.func.jacrev(F_TORCH, argnums=(0, 1)))(
        torch.from_numpy(xs), torch.from_numpy(us))
    jA2, jB2 = jax.vmap(lambda x, u: (jax.jacobian(F_JAX, 0)(x, u),
                                      jax.jacobian(F_JAX, 1)(x, u)))(
        jnp.asarray(xs), jnp.asarray(us))
    np.testing.assert_allclose(A2.numpy(), np.asarray(jA2), atol=1e-5)
    np.testing.assert_allclose(B2.numpy(), np.asarray(jB2), atol=1e-5)
    u_prev2 = np.array([0.37], np.float32)
    sd_rel = relinearize(sd0, A2, B2, u_prev=torch.from_numpy(u_prev2))
    plant2 = tmodels.LTVPlant(A=A2.numpy(), B=B2.numpy(),
                              E=np.asarray(spec0.plant.E),
                              C=np.asarray(spec0.plant.C), name="p2")
    spec2 = dataclasses.replace(spec0, plant=plant2, u_prev=u_prev2)
    sd_fresh = stagewise_dual(spec2, theta_floor=5.0, band=sd0.band,
                              device=CPU)
    assert (sd_rel.band, sd_rel.n_con) == (sd_fresh.band, sd_fresh.n_con)
    _assert_fields(convert.to_numpy(sd_rel), convert.to_numpy(sd_fresh),
                   atol=2e-5, rtol=2e-5)


def test_relinearize_infinite_du_max_no_nan():
    """tests/test_rti.py: +inf du_max keeps u_prev and the disabled slew
    rows (+inf) through relinearize, with no NaN anywhere."""
    u_prev = np.array([0.5], np.float32)
    spec = _spec(tmodels, F_TORCH, 6, du_max=np.inf, u_prev=u_prev)
    sd0 = stagewise_dual(spec, theta_floor=5.0, device=CPU)
    sd2 = relinearize(sd0, torch.from_numpy(spec.plant.A),
                      torch.from_numpy(spec.plant.B))
    np.testing.assert_allclose(sd2.u_prev.numpy(), u_prev)
    for name, v in convert.to_numpy(sd2).items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert not np.isnan(v).any(), name
    assert torch.isposinf(sd2.Kp[2]).all() and torch.isposinf(sd2.Kp[3]).all()


@pytest.fixture(scope="module")
def jax_swing():
    """JAX's 20-step swing (H=16, two SQP passes, tests/test_rti.py)."""
    ctrl = jmodels.RTIController(F_JAX, _spec(jmodels, F_TORCH, 16),
                                 cfg=JSolverConfig(**CFG), sqp_iters=2)
    return ctrl.rollout(np.array([2.5, 0.0], np.float32), 20)


def test_rti_rollout_matches_jax_and_swings_up(jax_swing):
    ctrl = RTIController(F_TORCH, _spec(tmodels, F_TORCH, 16),
                         cfg=SolverConfig(**CFG), sqp_iters=2, device=CPU)
    out = ctrl.rollout(np.array([2.5, 0.0], np.float32), 20)
    np.testing.assert_array_equal(out["converged"], jax_swing["converged"])
    _close(out["u"], jax_swing["u"], "u")
    _close(out["x"], jax_swing["x"], "x")
    _iters_in_bar(out["iters"], jax_swing["iters"])
    # tests/test_rti.py's bars: certified, |theta| halves and shrinks, |u|
    # within the certified slack max(erc * 12, eac) = 1.2e-3
    assert out["converged"].all()
    assert abs(out["x"][-1, 0]) < 1.25
    assert abs(out["x"][-1, 0]) < abs(out["x"][4, 0])
    assert np.abs(out["u"]).max() <= 12.0 + 1.5e-3


def test_rti_step_matches_rollout():
    x0 = np.array([1.2, -0.3], np.float32)
    ctrl = RTIController(F_TORCH, _spec(tmodels, F_TORCH, 12),
                         cfg=SolverConfig(**CFG), device=CPU)
    out = ctrl.rollout(x0, 6)
    x = torch.from_numpy(x0)
    for t in range(6):
        u0, res = ctrl.step(x)
        x = F_TORCH(x, u0)
        np.testing.assert_allclose(u0.numpy(), out["u"][t], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(x.numpy(), out["x"][t], atol=1e-5,
                                   rtol=1e-5)
    ctrl.reset()
    np.testing.assert_allclose(ctrl.step(torch.from_numpy(x0))[0].numpy(),
                               out["u"][0], atol=1e-5, rtol=1e-5)


def _capstone(m, f, steps):
    """tests/test_mhe.py's output-feedback capstone: the upright pendulum
    (g = 9.81) measured by angle only, RTI at H=24 with the relinearizing
    MHE (window 8), noise from seed 1, from [0.15, 0]."""
    H, N = 24, 8
    kw = {} if m is jmodels else dict(device=CPU)
    rti = m.RTIController(f, _spec(m, F2_TORCH, H, du_max=10.0, R=0.05),
                          sqp_iters=1, **kw)
    w_sd, v_sd = np.array([0.001, 0.005]), 0.01
    mhe = m.NonlinearMHE(f, np.array([[1.0, 0.0]], np.float32), window=N,
                         Qw=np.diag(w_sd ** 2), Rv=np.array([[v_sd ** 2]]),
                         u_lin=np.zeros(1), w_min=-5 * w_sd,
                         w_max=5 * w_sd, **kw)
    rng = np.random.default_rng(1)
    w_seq = rng.normal(0, w_sd, (60 + N, 2)).astype(np.float32)
    v_seq = rng.normal(0, v_sd, (60 + N, 1)).astype(np.float32)
    return m.output_feedback_rollout(rti, mhe,
                                     np.array([0.15, 0.0], np.float32),
                                     steps, w_seq[:steps + N],
                                     v_seq[:steps + N])


def test_output_feedback_rollout_matches_jax():
    """The first 12 steps of the capstone against JAX's, every step; then
    the port's loop alone to 30 steps: both solvers certify every step,
    the pendulum is held near upright and the estimate tracks the truth
    (the capstone's bars over its 60 steps, here over 30)."""
    want = _capstone(jmodels, F2_JAX, 12)
    got = _capstone(tmodels, F2_TORCH, 30)
    short = {k: v[:12] for k, v in got.items()}
    for k in ("conv_mhe", "conv_rti"):
        np.testing.assert_array_equal(short[k], want[k])
    for k in ("x", "x_hat", "u"):
        _close(short[k], want[k], k)
    _iters_in_bar(short["iters_rti"], want["iters_rti"])
    _iters_in_bar(short["iters_mhe"], want["iters_mhe"])
    assert got["conv_mhe"].all() and got["conv_rti"].all()
    tail = np.abs(got["x"][-5:])
    assert tail[:, 0].max() < 0.05 and tail[:, 1].max() < 0.15, tail
    err = np.sqrt(((got["x_hat"][10:] - got["x"][10:]) ** 2).mean(0))
    assert err[0] < 0.03 and err[1] < 0.1, err


def test_output_feedback_requires_shared_dynamics():
    spec = _spec(tmodels, F_TORCH, 8, du_max=10.0, R=0.05)
    rti = RTIController(F_TORCH, spec, device=CPU)
    mhe = NonlinearMHE(F2_TORCH, np.array([[1.0, 0.0]]), window=4,
                       Qw=np.eye(2) * 1e-4, Rv=np.array([[1e-4]]),
                       u_lin=np.zeros(1), device=CPU)
    with pytest.raises(ValueError, match="share f_disc"):
        output_feedback_rollout(rti, mhe, np.zeros(2, np.float32), 4)


def test_rti_needs_identity_e_and_a_card_by_default():
    spec = _spec(tmodels, F_TORCH, 6)
    bad = dataclasses.replace(spec, plant=dataclasses.replace(
        spec.plant, E=2.0 * spec.plant.E))
    with pytest.raises(ValueError, match="identity"):
        RTIController(F_TORCH, bad, device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RTIController(F_TORCH, spec)
