"""The port's device-resident closed loop ``MPCController.rollout_jit``
against the JAX package's ``rollout_jit`` (one ``lax.scan``), step by step.

Every case runs 30 steps from x0 = [2, 0] (the first state entries for the
other plants) on the CPU under ``MPC_CONFIG``.  Per step the bars are the
oracle parity bar: ``converged`` equal, u within 5e-3 * max(1, |u|max),
iterations within max(5, iters/5) rounded up to whole checks — the last on
at least 26 of the 30 steps, with mean iterations within 10%.  MPC_CONFIG
accelerates, and the accel step is kept when f(Y_new) <= f(Y), two float32
values equal to rounding near the optimum: the two frameworks' summation
orders take different steps there, and on a few steps of an H=16 loop the
count moves by several check cadences (0-3 of 30 steps per case on the
CPU, max 104 iterations at mean 49, verdicts and u unaffected; ROADMAP
queue 3, first item).  The state
is compared to the bound that this u bar implies through the plant:
x_{t+1} = A x_t + B u_t + ..., so a u difference of at most ``tol_u`` per
step moves x_t by at most sum_k ||A^(t-1-k) B||_inf * tol_u (plus float32
rounding, 1e-5 * (1 + |x|)).
"""

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import MPCController as JController
from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec
from pqp_for_mpc_tpu_torch.models import plants as tplants
from pqp_for_mpc_tpu_torch.utils.state import load_state, save_state

STEPS = 30
#: steps of 30 whose iteration count must lie within the oracle bar
STEPS_IN_BAR = 26


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cls, plant, H, **extra):
    nu, ny = plant.n_input, plant.n_output
    return cls(plant, horizon=H, Qy=np.eye(ny), R=0.05 * np.eye(nu),
               r=np.zeros(ny), u_min=-np.ones(nu), u_max=np.ones(nu),
               du_max=0.5 * np.ones(nu), **extra)


def _bar(iters, check_every):
    bar = np.maximum(5, np.asarray(iters) // 5)
    return -(-bar // check_every) * check_every


def _x_bound(A, B, tol_u, steps):
    """Per-step bound on |x_t - x'_t| (inf-norm) when |u_k - u'_k| <=
    tol_u for every earlier step k, from x_{t+1} = A x_t + B u_t."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    gains, out, acc = [B], [], 0.0
    for t in range(steps):
        acc = sum(np.abs(g).sum(axis=1).max() for g in gains) * tol_u
        out.append(acc)
        gains.append(A @ gains[-1])
    return np.asarray(out)


# name -> (plant maker (module -> plant), horizon, spec extras,
#          controller kwargs, x0, with d_forecast, with w_seq)
CASES = {
    "warm": (lambda m: m.double_integrator(), 16, {}, {}, False, False),
    "shift": (lambda m: m.double_integrator(), 16, {},
              dict(warm_start="shift"), False, False),
    "cold": (lambda m: m.double_integrator(), 16, {},
             dict(warm_start=False), False, False),
    "retry_cold": (lambda m: m.double_integrator(), 16, {},
                   dict(retry_cold=True), False, False),
    "w_seq": (lambda m: m.double_integrator(), 16, {}, {}, False, True),
    "d_forecast": (lambda m: m.random_stable(4, 2, n_dist=1), 8, {}, {},
                   True, False),
    "moves": (lambda m: m.double_integrator(), 16, dict(moves=4), {}, False,
              False),
    "y_max": (lambda m: m.double_integrator(), 16,
              dict(y_max=np.array([2.2])), {}, False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_jit_matches_jax_step_by_step(case):
    make, H, extra, ckw, preview, with_w = CASES[case]
    tp, jp = make(tplants), make(jplants)
    x0 = np.zeros(tp.n_state, np.float32)
    x0[:2] = [2.0, 0.0]
    rng = np.random.default_rng(11)
    kw = {}
    if preview:
        kw["d_forecast"] = rng.uniform(-1.0, 1.0, (STEPS + H, tp.n_dist)) \
            .astype(np.float32)
    if with_w:
        kw["w_seq"] = rng.uniform(-0.02, 0.02, (STEPS, tp.n_state)) \
            .astype(np.float32)
    tc = MPCController(_spec(MPCSpec, tp, H, **extra), device="cpu", **ckw)
    jc = JController(_spec(JSpec, jp, H, **extra), **ckw)
    got = tc.rollout_jit(x0, STEPS, **kw)
    want = jc.rollout_jit(x0, STEPS, **kw)
    assert set(got) == set(want)
    assert got["x"].shape == want["x"].shape == (STEPS, tp.n_state)
    assert np.asarray(want["converged"]).all()
    np.testing.assert_array_equal(got["converged"], want["converged"])
    tol_u = 5e-3 * max(1.0, float(np.abs(want["u"]).max()))
    np.testing.assert_allclose(got["u"], want["u"], atol=tol_u, rtol=0)
    it_w = np.asarray(want["iters"]).astype(np.int64)
    in_bar = np.abs(got["iters"] - it_w) <= _bar(it_w, tc.cfg.check_every)
    assert in_bar.sum() >= STEPS_IN_BAR
    assert abs(got["iters"].mean() - it_w.mean()) <= 0.1 * it_w.mean()
    bound = _x_bound(tp.A, tp.B, tol_u, STEPS)[:, None] \
        + 1e-5 * (1.0 + np.abs(want["x"]))
    assert (np.abs(got["x"] - want["x"]) <= bound).all()


def test_rollout_jit_agrees_with_rollout():
    """The device loop and the host loop solve the same QPs: the same
    verdicts and u within the bar; the buffers are reused per steps."""
    spec = _spec(MPCSpec, tplants.double_integrator(), 16)
    ctrl = MPCController(spec, device="cpu")
    a = ctrl.rollout_jit([2.0, 0.0], 20)
    b = MPCController(spec, device="cpu").rollout([2.0, 0.0], 20)
    assert a["converged"].all() and b["converged"].all()
    np.testing.assert_allclose(a["u"], b["u"], atol=5e-3)
    ctrl.rollout_jit([1.0, 0.0], 20)
    assert list(ctrl._rollout_fns) == [(20, False, False)]


def test_rollout_jit_refuses_short_forecast_and_ltv():
    plant = tplants.random_stable(4, 2, n_dist=1)
    ctrl = MPCController(_spec(MPCSpec, plant, 8), device="cpu")
    with pytest.raises(ValueError, match="d_forecast needs"):
        ctrl.rollout_jit(np.zeros(4), 5, d_forecast=np.zeros((6, 1)))
    ltv = tplants.stack_plant(tplants.double_integrator(), 4)
    ctrl = MPCController(_spec(MPCSpec, ltv, 4), device="cpu")
    with pytest.raises(NotImplementedError, match="LTI"):
        ctrl.rollout_jit([1.0, 0.0], 3)


def test_state_round_trip(tmp_path):
    """save_state/load_state keep the warm start and its bookkeeping, and
    read the files the JAX package writes."""
    from pqp_for_mpc_tpu.utils.state import load_state as jload
    from pqp_for_mpc_tpu.utils.state import save_state as jsave
    ctrl = MPCController(_spec(MPCSpec, tplants.double_integrator(), 16),
                         device="cpu")
    _, res = ctrl.step(np.array([2.0, 0.0], np.float32))
    path = str(tmp_path / "state.npz")
    save_state(path, ctrl._Y, res.iters, meta={"step": 3, "h": 16})
    Y, iters, meta = load_state(path)
    np.testing.assert_array_equal(Y, ctrl._Y.numpy())
    np.testing.assert_array_equal(iters, res.iters.numpy())
    assert int(meta["step"]) == 3 and int(meta["h"]) == 16
    jY, jiters, jmeta = jload(path)
    np.testing.assert_array_equal(jY, Y)
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, Y)
    Y2, iters2, meta2 = load_state(jpath)
    np.testing.assert_array_equal(Y2, Y)
    assert iters2 is None and meta2 == {}
    # a restored warm start resumes the loop where it stopped
    ctrl2 = MPCController(ctrl.spec, device="cpu")
    ctrl2._Y = torch.as_tensor(Y2)
    u_a, _ = ctrl.step(np.array([1.9, -0.1], np.float32))
    u_b, _ = ctrl2.step(np.array([1.9, -0.1], np.float32))
    torch.testing.assert_close(u_a, u_b, rtol=0, atol=0)
