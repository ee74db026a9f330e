"""The port's steady-state Kalman filter (``models/estimator.py``) against
the JAX package's, on the CPU, on the cases of ``tests/test_estimator.py``.

Bars: ``filter_dare`` and ``kalman_gain`` are the JAX package's float64
NumPy code, copied, so they agree to 1e-10 (they give the same bits); the
filter's ``step`` is one float32 matmul chain in each package, so a
200-step estimate agrees to 1e-5 * max(1, |x_hat|max) at every step; the
JAX tests' own bars (DARE residual, filter stability, the filter beating
open-loop prediction, the output-feedback loop regulating) hold on the
port's outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.models import KalmanFilter as JKalmanFilter
from pqp_for_mpc_tpu.models import estimator as jest
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu_torch import SolverConfig
from pqp_for_mpc_tpu_torch.models import (KalmanFilter, MPCSpec,
                                          kalman_gain, plants)
from pqp_for_mpc_tpu_torch.models import estimator as port_est
from pqp_for_mpc_tpu_torch.models.stagewise import (solve_stagewise,
                                                    stagewise_dual)

CPU = torch.device("cpu")

#: (plant maker, Qw, Rv): tests/test_estimator.py's three noise models on
#: the double integrator (position measured), and the MIMO quadruple tank
CASES = {
    "di_gain": (lambda m: m.double_integrator(), 0.01 * np.eye(2),
                0.04 * np.eye(1)),
    "di_filter": (lambda m: m.double_integrator(), 0.005 * np.eye(2),
                  0.02 * np.eye(1)),
    "di_loop": (lambda m: m.double_integrator(), 0.002 * np.eye(2),
                0.01 * np.eye(1)),
    "quadruple_tank": (lambda m: m.quadruple_tank(), 1e-4 * np.eye(4),
                       1e-4 * np.eye(2)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dare_and_gain_match_jax(case):
    make, Qw, Rv = CASES[case]
    jp, tp = make(jplants), make(plants)
    P_j = jest.filter_dare(jp.A, jp.C, Qw, Rv)
    P_t = port_est.filter_dare(tp.A, tp.C, Qw, Rv)
    np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(kalman_gain(tp, Qw, Rv),
                               jest.kalman_gain(jp, Qw, Rv), rtol=0,
                               atol=1e-10)


def test_kalman_gain_solves_filter_dare():
    """tests/test_estimator.py's bar on the port's gain: L is the gain of
    the DARE fixed point (residual < 1e-10) and (I - L C) A is stable."""
    _, Qw, Rv = CASES["di_gain"]
    plant = plants.double_integrator()
    L = np.asarray(kalman_gain(plant, Qw, Rv), np.float64)
    A = np.asarray(plant.A, np.float64)
    C = np.asarray(plant.C, np.float64)
    P = port_est.filter_dare(A, C, Qw, Rv, tol=1e-14)
    resid = np.abs(A @ (P - P @ C.T @ np.linalg.solve(
        C @ P @ C.T + Rv, C @ P)) @ A.T + Qw - P).max()
    assert resid < 1e-10
    np.testing.assert_allclose(
        L, np.linalg.solve(C @ P @ C.T + Rv, C @ P).T, atol=1e-6)
    assert np.abs(np.linalg.eigvals((np.eye(2) - L @ C) @ A)).max() < 1.0


def test_filter_dare_raises_on_an_undetectable_pair():
    A = np.diag([1.2, 0.5])            # the unstable mode is not measured
    C = np.array([[0.0, 1.0]])
    with pytest.raises(ValueError, match="undetectable"):
        port_est.filter_dare(A, C, np.eye(2), np.eye(1), max_iters=200)
    with pytest.raises(ValueError, match="LTI"):
        kalman_gain(plants.stack_plant(plants.double_integrator(), 3),
                    np.eye(2), np.eye(1))


def _record(plant, steps, Qw, Rv, seed, d_scale=0.0):
    """tests/test_estimator.py's filter record: the true state from [1,
    -0.5] under u = 0.3 sin(0.1 t), process and measurement noise from
    seed, and (``d_scale``) a known disturbance through E."""
    rng = np.random.default_rng(seed)
    A, B, E, C = (np.asarray(m) for m in (plant.A, plant.B, plant.E,
                                          plant.C))
    Lw = np.linalg.cholesky(Qw).astype(np.float32)
    Lv = np.linalg.cholesky(Rv).astype(np.float32)
    x = np.array([1.0, -0.5], np.float32)
    xs, us, ys, ds = [], [], [], []
    for t in range(steps):
        u = np.array([0.3 * np.sin(0.1 * t)], np.float32)
        d = np.array([d_scale * np.cos(0.2 * t)], np.float32)
        w = (Lw @ rng.standard_normal(2)).astype(np.float32)
        v = (Lv @ rng.standard_normal(1)).astype(np.float32)
        x = A @ x + B @ u + E @ d + w
        xs.append(x)
        us.append(u)
        ds.append(d)
        ys.append(C @ x + v)
    return [np.stack(a).astype(np.float32) for a in (xs, us, ys, ds)]


@pytest.mark.parametrize("known_d", [False, True],
                         ids=["no_preview", "known_disturbance"])
def test_filter_steps_match_jax(known_d):
    """200 predict/correct steps from a wrong start: the port's estimate
    within 1e-5 * scale of JAX's at every step (with the gain computed, and
    with JAX's gain carried across through ``L``); without a known
    disturbance, tests/test_estimator.py's bars: the tail error under a
    quarter of open-loop prediction's and under 0.2."""
    _, Qw, Rv = CASES["di_filter"]
    X, U, Y, D = _record(plants.double_integrator(), 200, Qw, Rv, seed=0,
                         d_scale=0.5 if known_d else 0.0)
    jkf = JKalmanFilter(jplants.double_integrator(), Qw, Rv)
    kfs = [KalmanFilter(plants.double_integrator(), Qw, Rv, device=CPU),
           KalmanFilter(plants.double_integrator(), Qw, Rv,
                        L=np.asarray(jkf.L), device=CPU)]
    xj = jnp.zeros(2, jnp.float32)
    xt = [torch.zeros(2) for _ in kfs]
    want, got = [], [[] for _ in kfs]
    for t in range(len(Y)):
        dj = jnp.asarray(D[t]) if known_d else None
        xj = jkf.step(xj, jnp.asarray(U[t]), jnp.asarray(Y[t]), d=dj)
        want.append(np.asarray(xj))
        for i, kf in enumerate(kfs):
            dt = torch.from_numpy(D[t]) if known_d else None
            xt[i] = kf.step(xt[i], torch.from_numpy(U[t]),
                            torch.from_numpy(Y[t]), d=dt)
            got[i].append(xt[i].numpy())
    want = np.stack(want)
    for g in got:
        np.testing.assert_allclose(
            np.stack(g), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    if known_d:
        return
    A, B = (np.asarray(m) for m in (plants.double_integrator().A,
                                    plants.double_integrator().B))
    xo, err_o = np.zeros(2, np.float32), []
    for t in range(len(Y)):
        xo = A @ xo + B @ U[t]
        err_o.append(np.linalg.norm(xo - X[t]))
    err_f = np.linalg.norm(np.stack(got[0]) - X, axis=1)
    tail_f, tail_o = err_f[100:].mean(), np.mean(err_o[100:])
    assert tail_f < 0.25 * tail_o and tail_f < 0.2, (tail_f, tail_o)


def test_output_feedback_closed_loop():
    """tests/test_estimator.py's output-feedback loop on the port: the
    stage-wise MPC (H=16) acts on the filter's estimate only, from a wrong
    initial estimate under measurement noise, and still regulates: every
    step certified, the tail state norm < 0.3, the tail estimate error <
    0.15 (the JAX test's bars)."""
    plant = plants.double_integrator()
    H = 16
    spec = MPCSpec(plant=plant, horizon=H,
                   Qy=np.eye(1, dtype=np.float32),
                   R=0.1 * np.eye(1, dtype=np.float32),
                   r=np.zeros(1, np.float32),
                   u_min=np.array([-1.0], np.float32),
                   u_max=np.array([1.0], np.float32),
                   du_max=np.array([0.5], np.float32))
    cfg = SolverConfig(max_iters=20_000, check_every=8, accel_every=4,
                       y0=0.01, eaj=1e-3, erj=1e-4, erc=1e-4, eac=1e-4,
                       strict_weak_duality=False)
    sd = stagewise_dual(spec, theta_floor=cfg.theta_floor, device=CPU)
    _, Qw, Rv = CASES["di_loop"]
    kf = KalmanFilter(plant, Qw=Qw, Rv=Rv, device=CPU)
    A, B, C = (torch.from_numpy(np.asarray(m)) for m in (plant.A, plant.B,
                                                         plant.C))
    steps = 120
    vs = torch.from_numpy(0.1 * np.random.default_rng(3).standard_normal(
        (steps, 1)).astype(np.float32))
    x, xh = torch.tensor([2.0, 0.0]), torch.zeros(2)
    Y = torch.zeros((sd.n_con, 1))
    xs, xhs, conv = [], [], []
    for t in range(steps):
        res = solve_stagewise(sd, xh[:, None], Y0=torch.clamp(Y, min=0.01),
                              cfg=cfg)
        u0 = res.U[:1, 0]
        x = A @ x + B @ u0
        xh = kf.step(xh, u0, C @ x + vs[t])
        Y = res.Y
        xs.append(x.numpy())
        xhs.append(xh.numpy())
        conv.append(bool(res.converged[0]))
    xs, xhs = np.stack(xs), np.stack(xhs)
    assert all(conv)
    assert np.linalg.norm(xs[-10:], axis=1).mean() < 0.3
    assert np.linalg.norm(xhs - xs, axis=1)[-10:].mean() < 0.15


def test_filter_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KalmanFilter(plants.double_integrator(), np.eye(2), np.eye(1))
