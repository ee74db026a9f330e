"""The port's moving-horizon estimators (``models/mhe.py``) against the JAX
package's, on the CPU, on the cases of ``tests/test_mhe.py``.

Bars: a window's smoothed states and noise, and each record's estimates
(``run``), within 5e-3 * max(1, |want|max) of JAX's; verdicts equal (every
window certified); iterations within max(5, iters/5) rounded up to whole
checks on at least 3/4 of the windows and the mean within 10% (another
float32 summation order can take another accelerated step).  ``run`` against the eager ``step``
loop at 2e-4, JAX's own bar.  The JAX tests' guarantees (the noise-free
window recovers the truth, the Gaussian MHE tracks the Kalman filter, the
one-sided MHE beats it, the output bounds hold) on the port's estimates.
The nonlinear estimator (``NonlinearMHE``, the hanging pendulum measured by
angle only) is held to JAX on one record and to its own ``step`` loop at
rtol 1e-4, atol 2e-4 (JAX's bar), and to tests/test_mhe.py's tracking and
output-bound guarantees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.models import MovingHorizonEstimator as JMHE
from pqp_for_mpc_tpu.models import NonlinearMHE as JNonlinearMHE
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu_torch.models import (KalmanFilter,
                                          MovingHorizonEstimator,
                                          NonlinearMHE, plants)

CPU = torch.device("cpu")
IN_BAR_SHARE = 0.75


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _simulate(T, w_draw, v_sigma, seed=0):
    """tests/test_mhe.py's record on the double integrator: process noise
    from ``w_draw(rng, (T, 2))``, measurement noise N(0, v_sigma^2)."""
    plant = plants.double_integrator()
    rng = np.random.default_rng(seed)
    A, B, C = (np.asarray(m) for m in (plant.A, plant.B, plant.C))
    W = w_draw(rng, (T, 2)).astype(np.float32)
    V = (v_sigma * rng.standard_normal((T, 1))).astype(np.float32)
    U = (0.4 * np.sin(0.15 * np.arange(T))[:, None]).astype(np.float32)
    x = np.array([0.5, -0.2], np.float32)
    xs, ys = [], []
    for t in range(T):
        x = A @ x + B @ U[t] + W[t]
        xs.append(x)
        ys.append(C @ x + V[t])
    return U, np.stack(ys), np.stack(xs)


def _kf_errors(U, Y, X, Qw, Rv, x0):
    kf = KalmanFilter(plants.double_integrator(), Qw, Rv, device=CPU)
    xh = torch.from_numpy(x0)
    errs = []
    for t in range(len(Y)):
        xh = kf.step(xh, torch.from_numpy(U[t]), torch.from_numpy(Y[t]))
        errs.append(np.linalg.norm(xh.numpy() - X[t]))
    return np.array(errs)


def _close(got, want, what=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=0,
                               atol=5e-3 * max(1.0, float(np.abs(w).max())),
                               err_msg=what)


def _assert_record_parity(got, want):
    assert np.asarray(want["converged"]).all()
    np.testing.assert_array_equal(got["converged"], want["converged"])
    _close(got["x_hat"], want["x_hat"], "x_hat")
    it_w = np.asarray(want["iters"]).astype(np.int64)
    it_g = np.asarray(got["iters"]).astype(np.int64)
    bar = -(-np.maximum(5, it_w // 5) // 8) * 8
    assert (np.abs(it_g - it_w) <= bar).mean() >= IN_BAR_SHARE, (it_g, it_w)
    assert abs(it_g.mean() - it_w.mean()) <= 0.1 * it_w.mean()


def test_noise_free_window_recovers_truth_like_jax():
    U, Y, X = _simulate(12, lambda rng, s: np.zeros(s), 0.0)
    kw = dict(window=12, Qw=1e-3 * np.eye(2), Rv=1e-3 * np.eye(1))
    x_bar = np.array([0.5, -0.2], np.float32)
    x_hat, xs, res = MovingHorizonEstimator(
        plants.double_integrator(), device=CPU, **kw).step(x_bar, U, Y)
    jx_hat, jxs, jres = JMHE(jplants.double_integrator(), **kw).step(
        x_bar, U, Y)
    assert bool(res.converged.all()) and bool(np.asarray(jres.converged))
    _close(xs, jxs, "xs")
    _close(res.U[:, 0], np.asarray(jres.U).reshape(-1), "W")
    np.testing.assert_allclose(xs.numpy(), X, atol=5e-3)
    assert res.U.abs().max() < 5e-3


def _gaussian():
    Qw = np.diag([1e-4, 4e-3])
    Rv = np.array([[4e-4]])
    draw = lambda rng, s: rng.standard_normal(s) @ np.diag(
        np.sqrt(np.diag(Qw)))
    return _simulate(80, draw, 0.02, seed=1), Qw, Rv, {}, 30


def _one_sided():
    sig = 0.25

    def impulses(rng, s):
        kick = (rng.uniform(size=s[0]) < 0.1).astype(np.float64)
        return np.stack([np.zeros(s[0]),
                         kick * np.abs(sig * rng.standard_normal(s[0]))],
                        axis=1)
    Qw = np.diag([1e-6, sig ** 2])
    Rv = np.array([[1e-4]])
    bounds = dict(w_min=np.array([-1e-3, 0.0]), w_max=np.array([1e-3, 2.0]))
    return _simulate(90, impulses, 0.01, seed=2), Qw, Rv, bounds, 20


@pytest.mark.parametrize("record", ["gaussian", "one_sided"])
def test_record_run_matches_jax(record):
    """tests/test_mhe.py's two records (window 10): the port's run against
    JAX's, then its bars on the port's estimates — the Gaussian MHE within
    1.4x the Kalman filter's tail error and under 0.1; the one-sided MHE
    (w >= 0 on the velocity) under 0.8x the filter's, iterations < 5000."""
    (U, Y, X), Qw, Rv, bounds, tail = (_gaussian if record == "gaussian"
                                       else _one_sided)()
    x0 = np.zeros(2, np.float32)
    got = MovingHorizonEstimator(plants.double_integrator(), window=10,
                                 Qw=Qw, Rv=Rv, device=CPU,
                                 **bounds).run(x0, U, Y)
    want = JMHE(jplants.double_integrator(), window=10, Qw=Qw, Rv=Rv,
                **bounds).run(x0, U, Y)
    _assert_record_parity(got, want)
    kf_tail = _kf_errors(U, Y, X, Qw, Rv, x0)[9 + tail:].mean()
    mhe_tail = np.linalg.norm(got["x_hat"] - X[9:], axis=1)[tail:].mean()
    if record == "gaussian":
        assert mhe_tail < 1.4 * kf_tail and mhe_tail < 0.1
    else:
        assert got["iters"].max() < 5000
        assert mhe_tail < 0.8 * kf_tail, (mhe_tail, kf_tail)


def test_run_matches_eager_steps():
    Qw, Rv = 1e-3 * np.eye(2), np.array([[1e-3]])
    U, Y, _ = _simulate(20, lambda rng, s: 0.02 * rng.standard_normal(s),
                        0.02, seed=3)
    x0 = np.zeros(2, np.float32)
    N = 8
    mhe = MovingHorizonEstimator(plants.double_integrator(), window=N,
                                 Qw=Qw, Rv=Rv, device=CPU)
    out = mhe.run(x0, U, Y)
    x_bar = x0
    for k in range(len(Y) - N + 1):
        x_hat, xs, res = mhe.step(x_bar, U[k:k + N], Y[k:k + N])
        np.testing.assert_allclose(x_hat.numpy(), out["x_hat"][k],
                                   atol=2e-4)
        x_bar = xs[0]


def test_output_bounds_hold_and_match_jax():
    """Physical output bounds on the linear MHE (the condensed output
    rows): a sensor-bias episode pulls the unbounded
    estimate past the bound; the bounded port estimate holds it (within the
    certified slack) and equals JAX's."""
    Qw, Rv = np.diag([1e-4, 4e-3]), np.array([[4e-4]])
    U, Y, X = _simulate(30, lambda rng, s: 0.01 * rng.standard_normal(s),
                        0.02, seed=4)
    Y = Y.copy()
    Y[15:20] += 0.5
    bound = float(np.abs(X[:, 0]).max()) + 0.05
    kw = dict(window=8, Qw=Qw, Rv=Rv, y_min=np.array([-bound]),
              y_max=np.array([bound]))
    x0 = np.zeros(2, np.float32)
    free = MovingHorizonEstimator(plants.double_integrator(), window=8,
                                  Qw=Qw, Rv=Rv, device=CPU).run(x0, U, Y)
    got = MovingHorizonEstimator(plants.double_integrator(), device=CPU,
                                 **kw).run(x0, U, Y)
    want = JMHE(jplants.double_integrator(), **kw).run(x0, U, Y)
    _assert_record_parity(got, want)
    assert free["x_hat"][:, 0].max() > bound + 0.05
    assert got["x_hat"][:, 0].max() <= bound + 1e-3


def test_mhe_rejects_ltv_and_short_records():
    with pytest.raises(NotImplementedError):
        MovingHorizonEstimator(plants.stack_plant(
            plants.double_integrator(), 4), window=4, Qw=np.eye(2),
            Rv=np.eye(1), device=CPU)
    with pytest.raises(ValueError, match="window must be >= 2"):
        MovingHorizonEstimator(plants.double_integrator(), window=1,
                               Qw=np.eye(2), Rv=np.eye(1), device=CPU)
    mhe = MovingHorizonEstimator(plants.double_integrator(), window=10,
                                 Qw=np.eye(2), Rv=np.eye(1), device=CPU)
    with pytest.raises(ValueError, match="T >="):
        mhe.run(np.zeros(2, np.float32), np.zeros((5, 1), np.float32),
                np.zeros((5, 1), np.float32))


# ---------------------------------------------------------------------------
# The nonlinear (relinearizing) MHE
# ---------------------------------------------------------------------------

_DT, _G, _BD = 0.05, 9.81, 0.15


def _pend_hanging(stack, sin):
    """tests/test_mhe.py's hanging pendulum (RK4), in either framework."""
    def f_cont(x, u):
        return stack([x[1], -_G * sin(x[0]) - _BD * x[1] + u[0]])

    def f_disc(x, u):
        k1 = f_cont(x, u)
        k2 = f_cont(x + 0.5 * _DT * k1, u)
        k3 = f_cont(x + 0.5 * _DT * k2, u)
        k4 = f_cont(x + _DT * k3, u)
        return x + _DT / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return f_disc


F_JAX = _pend_hanging(jnp.stack, jnp.sin)
F_TORCH = _pend_hanging(torch.stack, torch.sin)
C_ANGLE = np.array([[1.0, 0.0]])


def _pendulum_record(T, x0, u_of_t, w_sd, v_sd, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(x0, dtype=torch.float32)
    xs, us, ys = [], [], []
    for t in range(T):
        u = np.array([u_of_t(t)], np.float32)
        x = F_TORCH(x, torch.from_numpy(u)) + torch.from_numpy(
            rng.normal(0, w_sd).astype(np.float32))
        xs.append(x.numpy())
        us.append(u)
        ys.append((C_ANGLE @ x.numpy()
                   + rng.normal(0, v_sd, 1)).astype(np.float32))
    return np.stack(xs), np.stack(us), np.stack(ys)


def test_nonlinear_record_matches_jax_and_its_steps():
    """tests/test_mhe.py's step-against-run record (T=18, window 6): the
    port's run against JAX's run, and against its own eager steps."""
    _, us, ys = _pendulum_record(18, [1.5, 0.3],
                                 lambda t: 0.2 * np.cos(0.3 * t),
                                 [0.002, 0.01], 0.02, seed=3)
    x_bar0 = np.array([1.4, 0.2], np.float32)
    kw = dict(window=6, Qw=np.diag([4e-6, 1e-4]), Rv=np.array([[4e-4]]),
              u_lin=np.zeros(1))
    mhe = NonlinearMHE(F_TORCH, C_ANGLE, device=CPU, **kw)
    got = mhe.run(x_bar0, us, ys)
    want = JNonlinearMHE(F_JAX, C_ANGLE, **kw).run(x_bar0, us, ys)
    _assert_record_parity(got, want)
    x_bar, eager = x_bar0, []
    for k in range(len(ys) - 6 + 1):
        x_hat, xs, res = mhe.step(x_bar, us[k:k + 6], ys[k:k + 6])
        assert bool(res.converged.all())
        eager.append(x_hat.numpy())
        x_bar = xs[0]
    np.testing.assert_allclose(got["x_hat"], np.stack(eager), rtol=1e-4,
                               atol=2e-4)


def test_nonlinear_mhe_tracks_pendulum_where_kf_cannot():
    """tests/test_mhe.py's large-angle swing (2.4 rad, angle measured): the
    relinearizing MHE (window 10, two passes) tracks both states while the
    origin-linearized Kalman filter fails — its bars on the port: MHE RMSE
    < [0.04, 0.2], KF RMSE > [0.2, 0.5], MHE < KF / 4 per state."""
    from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
    w_sd, v_sd = np.array([0.002, 0.01]), 0.02
    xs, us, ys = _pendulum_record(80, [2.4, 0.0],
                                  lambda t: 0.3 * np.sin(0.25 * t),
                                  w_sd, v_sd, seed=0)
    Qw, Rv = np.diag(w_sd ** 2), np.array([[v_sd ** 2]])
    A0, B0 = (j.numpy() for j in torch.func.jacrev(F_TORCH, (0, 1))(
        torch.zeros(2), torch.zeros(1)))
    kf = KalmanFilter(LinearPlant(A=A0, B=B0,
                                  E=np.zeros((2, 1), np.float32),
                                  C=C_ANGLE.astype(np.float32)), Qw, Rv,
                      device=CPU)
    x0_hat = xs[0] + np.array([0.1, -0.2], np.float32)
    xh, kf_est = torch.from_numpy(x0_hat), []
    for t in range(1, 80):
        xh = kf.step(xh, torch.from_numpy(us[t]), torch.from_numpy(ys[t]))
        kf_est.append(xh.numpy())
    out = NonlinearMHE(F_TORCH, C_ANGLE, window=10, Qw=Qw, Rv=Rv,
                       u_lin=np.zeros(1), w_min=-5 * w_sd, w_max=5 * w_sd,
                       sqp_iters=2, device=CPU).run(x0_hat, us, ys)
    assert out["converged"].all() and out["iters"].max() < 5000
    truth = xs[9:]
    e_mhe = np.sqrt(((out["x_hat"] - truth) ** 2).mean(0))
    e_kf = np.sqrt(((np.stack(kf_est)[8:] - truth) ** 2).mean(0))
    assert e_mhe[0] < 0.04 and e_mhe[1] < 0.2, e_mhe
    assert e_kf[0] > 0.2 and e_kf[1] > 0.5, e_kf
    assert (e_mhe < 0.25 * e_kf).all()


def test_nonlinear_output_bounds():
    """tests/test_mhe.py's bound test on the port: during a sensor-bias
    episode the unbounded estimate leaves the physical range, the bounded
    one holds it (0.02 slack: the bound is on the linearized window) and is
    more accurate."""
    w_sd, v_sd = np.array([0.02, 0.1]), 0.02
    xs, us, ys = _pendulum_record(40, [0.3, 0.0],
                                  lambda t: 0.1 * np.sin(0.3 * t),
                                  w_sd, v_sd, seed=0)
    ys = ys.copy()
    ys[20:28] += 0.6
    kw = dict(window=8, Qw=np.diag(w_sd ** 2), Rv=np.array([[v_sd ** 2]]),
              u_lin=np.zeros(1))
    bound = float(np.abs(xs[:, 0]).max()) + 0.08
    x0 = xs[0] + np.array([0.05, -0.05], np.float32)
    out_f = NonlinearMHE(F_TORCH, C_ANGLE, device=CPU, **kw).run(x0, us, ys)
    out_b = NonlinearMHE(F_TORCH, C_ANGLE, device=CPU,
                         y_max=np.array([bound], np.float32),
                         y_min=np.array([-bound], np.float32),
                         **kw).run(x0, us, ys)
    assert out_f["converged"].all() and out_b["converged"].all()
    assert out_f["x_hat"][:, 0].max() > bound + 0.05
    assert out_b["x_hat"][:, 0].max() <= bound + 0.02
    err_f = np.abs(out_f["x_hat"][:, 0] - xs[7:, 0])
    err_b = np.abs(out_b["x_hat"][:, 0] - xs[7:, 0])
    assert err_b.mean() < err_f.mean()


def test_nonlinear_mhe_argument_checks():
    with pytest.raises(ValueError, match="u_lin"):
        NonlinearMHE(F_TORCH, C_ANGLE, window=4, Qw=np.eye(2),
                     Rv=np.eye(1), device=CPU)
    with pytest.raises(ValueError, match="window must be >= 2"):
        NonlinearMHE(F_TORCH, C_ANGLE, window=1, Qw=np.eye(2),
                     Rv=np.eye(1), u_lin=np.zeros(1), device=CPU)


def test_estimators_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults build there")
    for build in (lambda: MovingHorizonEstimator(
                      plants.double_integrator(), window=4, Qw=np.eye(2),
                      Rv=np.eye(1)),
                  lambda: NonlinearMHE(F_TORCH, C_ANGLE, window=4,
                                       Qw=np.eye(2), Rv=np.eye(1),
                                       u_lin=np.zeros(1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
