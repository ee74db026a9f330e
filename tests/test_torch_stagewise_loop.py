"""The port's stage-wise controller (``MPCController(backend="stagewise")``)
against the JAX package's, on the CPU: ``step`` through the host loop
``rollout`` and the device loop ``rollout_jit``, each with
``warm_start="shift"``, 10 steps of the double integrator at H=16 from
x0 = [2, 0] (|u| <= 1, |du| <= 0.5, ``stagewise_mpc_config(16)``), and a
preview loop.

Bars, per step: ``converged`` equal, u within 5e-3 * max(1, |u|max) (the
oracle bar), the state within the bound that this u bar implies through
the plant.  Iterations: within max(5, iters/5) rounded up to whole checks
on at least 7 of the 10 steps, and the mean within 10%.  The accelerated
iteration keeps its momentum step when f(Y_new) <= f(Y), two float32
values equal to rounding near the optimum, so another summation order can
take another step there: the JAX package's own two loops (``rollout`` and
the ``lax.scan`` of ``rollout_jit``) differ past the bar on 1 of these 10
steps (41 against 73 iterations at step 4), the port against either on
2-3, with u within 5e-5 on every step (ROADMAP queue 3, summation order).
"""

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import MPCController as JController
from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu_torch.config import stagewise_mpc_config
from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec, plants

STEPS = 10
STEPS_IN_BAR = 7
X0 = np.array([2.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cls, plant, H, **extra):
    nu, ny = plant.n_input, plant.n_output
    kw = dict(Qy=np.eye(ny), R=0.05 * np.eye(nu), r=np.zeros(ny),
              u_min=-np.ones(nu), u_max=np.ones(nu),
              du_max=0.5 * np.ones(nu))
    kw.update(extra)
    return cls(plant, horizon=H, **kw)


def _bar(iters, check_every):
    bar = np.maximum(5, np.asarray(iters) // 5)
    return -(-bar // check_every) * check_every


def _x_bound(A, B, tol_u, steps):
    """Per-step bound on |x_t - x'_t| (inf-norm) when |u_k - u'_k| <= tol_u
    for every earlier step k, from x_{t+1} = A x_t + B u_t."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    gains, out = [B], []
    for _ in range(steps):
        out.append(sum(np.abs(g).sum(axis=1).max() for g in gains) * tol_u)
        gains.append(A @ gains[-1])
    return np.asarray(out)


def _assert_loop_parity(got, want, plant, check_every):
    # the JAX package's host loop reports no verdicts: its steps are held
    # to the port's, every one certified
    conv = np.asarray(want.get("converged", got["converged"])).astype(bool)
    assert conv.all()
    np.testing.assert_array_equal(np.asarray(got["converged"]), conv)
    tol_u = 5e-3 * max(1.0, float(np.abs(want["u"]).max()))
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=tol_u)
    x_w = np.asarray(want["x"])
    bound = _x_bound(plant.A, plant.B, tol_u, STEPS)[:, None] \
        + 1e-5 * (1.0 + np.abs(x_w))
    assert (np.abs(got["x"] - x_w) <= bound).all()
    it_w = np.asarray(want["iters"]).astype(np.int64)
    in_bar = np.abs(np.asarray(got["iters"]) - it_w) <= _bar(it_w,
                                                            check_every)
    assert in_bar.sum() >= STEPS_IN_BAR, (got["iters"], it_w)
    assert abs(np.mean(got["iters"]) - it_w.mean()) <= 0.1 * it_w.mean()


@pytest.mark.parametrize("loop", ["rollout", "rollout_jit"])
def test_stagewise_loop_matches_jax(loop):
    tc = MPCController(_spec(MPCSpec, plants.double_integrator(), 16),
                       backend="stagewise", warm_start="shift", device="cpu")
    jc = JController(_spec(JSpec, jplants.double_integrator(), 16),
                     backend="stagewise", warm_start="shift")
    assert tc.cfg == stagewise_mpc_config(16) and tc.data is None
    got = getattr(tc, loop)(X0, STEPS)
    want = getattr(jc, loop)(X0, STEPS)
    _assert_loop_parity(got, want, plants.double_integrator(),
                        tc.cfg.check_every)


def test_stagewise_loops_agree_and_reuse_buffers():
    """The device loop and the host loop solve the same QPs, step for step,
    with retry_cold on; a second rollout_jit reuses the buffers."""
    spec = _spec(MPCSpec, plants.double_integrator(), 16)
    ctrl = MPCController(spec, backend="stagewise", warm_start="shift",
                         retry_cold=True, device="cpu")
    a = ctrl.rollout_jit(X0, STEPS)
    b = MPCController(spec, backend="stagewise", warm_start="shift",
                      retry_cold=True, device="cpu").rollout(X0, STEPS)
    assert a["converged"].all() and b["converged"].all()
    np.testing.assert_allclose(a["u"], b["u"], atol=5e-3)
    again = ctrl.rollout_jit(X0, STEPS)
    np.testing.assert_array_equal(again["u"], a["u"])


def test_preview_loop_matches_jax():
    """A known-disturbance preview through the stage-wise rollout_jit
    (random stable plant, 4 states, 2 inputs, 1 disturbance, H=8)."""
    make = lambda m: m.random_stable(4, 2, n_dist=1)
    tp = make(plants)
    x0 = np.zeros(4, np.float32)
    x0[:2] = X0
    d = np.random.default_rng(11).uniform(-1.0, 1.0, (STEPS + 8, 1)).astype(
        np.float32)
    tc = MPCController(_spec(MPCSpec, tp, 8), backend="stagewise",
                       device="cpu")
    jc = JController(_spec(JSpec, make(jplants), 8), backend="stagewise")
    got = tc.rollout_jit(x0, STEPS, d_forecast=d)
    want = jc.rollout_jit(x0, STEPS, d_forecast=d)
    _assert_loop_parity(got, want, tp, tc.cfg.check_every)


@pytest.mark.parametrize("extra", [
    {}, dict(y_max=np.array([1.5])),
    dict(y_min=np.array([-1.5]), y_max=np.array([1.5]), soft_penalty=50.0)],
    ids=["inputs", "outputs", "soft"])
def test_shift_multipliers_on_the_stagewise_layout(extra):
    """The warm-start shift on the stage-wise layout, which has no
    condensed data: four (H, nu) input blocks, then two (H, ny) output
    blocks when the spec bounds the outputs (four when softened), each
    advanced one stage with its last stage repeated."""
    H = 6
    tc = MPCController(_spec(MPCSpec, plants.double_integrator(), H,
                             **extra), backend="stagewise", device="cpu")
    n_blocks = 4 + (2 if "y_max" in extra else 0) + \
        (2 if "soft_penalty" in extra else 0)
    assert tc.data is None and tc.n_con == n_blocks * H
    Y = np.random.default_rng(3).uniform(0, 1, (tc.n_con, 2)).astype(
        np.float32)
    blocks = Y.reshape(n_blocks, H, 2)
    want = np.concatenate([blocks[:, 1:], blocks[:, -1:]], axis=1)
    np.testing.assert_array_equal(
        tc._shift_multipliers(torch.from_numpy(Y)).numpy(),
        want.reshape(-1, 2))


def test_step_moves_the_slew_anchor():
    """step(x, u_prev=...) moves the stage-0 slew rows of the stage-wise
    dual by the delta from the spec's anchor (the JAX _sd_with_uprev), and
    the stored anchor with them."""
    tc = MPCController(_spec(MPCSpec, plants.double_integrator(), 8,
                             u_prev=np.array([0.1])),
                       backend="stagewise", device="cpu")
    up = np.array([0.4], np.float32)
    got = tc._sd_with_uprev(torch.from_numpy(up))
    want = tc._sd.Kp.clone()
    want[2, 0] += 0.3
    want[3, 0] -= 0.3
    np.testing.assert_allclose(got.Kp.numpy(), want.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(got.u_prev.numpy(), up)
    u0, res = tc.step(np.array([0.5, 0.0], np.float32), u_prev=up)
    assert bool(res.converged.all())
    assert abs(float(u0[0]) - 0.4) <= 0.5 + 1e-3
