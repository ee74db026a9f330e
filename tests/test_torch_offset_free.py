"""The port's offset-free MPC (``models/offset_free.py``) against the JAX
package's, on the CPU, on the cases of ``tests/test_offset_free.py``.

The host builds (``disturbance_channels``, ``augment_plant``,
``target_maps``, the augmented filter's gain) are the JAX package's float64
NumPy code, copied: they agree to 1e-10.  Each closed loop
(``rollout_jit``) runs the same spec, disturbance and step count in both
packages.  Bars, per step: ``converged`` equal (every step certified), u
and d_hat within 5e-3 * max(1, |want|max), the measured y within the same
bar.  Iterations: within max(5, iters/5) rounded up to whole checks on at
least 3/4 of the steps (measured: 118-250 of 120-250 on these cases) and
the mean within 10%: a cold first step with acceleration can take another
momentum step under another float32 summation order (41 against 25
iterations at step 0 of the H=20 input loop; ROADMAP queue 3).  The JAX
tests' own guarantees (offset-free settling, d_hat locking on, bounds
honoured, the nominal loop's offset) hold on the port's trajectories.
Each JAX loop is run once per module (``jax_loops``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import OffsetFreeController as JOffsetFree
from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import offset_free as jof
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                          OffsetFreeController,
                                          augment_plant,
                                          check_offset_free_rank,
                                          disturbance_channels, plants,
                                          target_maps)

CPU = torch.device("cpu")
IN_BAR_SHARE = 0.75


def _spec(cls, plant, H=20, r=1.0, **extra):
    ny, nu = plant.n_output, plant.n_input
    return cls(plant=plant, horizon=H,
               Qy=np.eye(ny, dtype=np.float32),
               R=0.1 * np.eye(nu, dtype=np.float32),
               r=np.full(ny, r, np.float32),
               u_min=np.full(nu, -2.0, np.float32),
               u_max=np.full(nu, 2.0, np.float32),
               du_max=np.full(nu, 1.0, np.float32), **extra)


def _di(m):
    return m.double_integrator()


def _qt(m):
    return m.quadruple_tank()


#: tests/test_offset_free.py's loops: (plant maker, spec kwargs, controller
#: kwargs, steps, d_true)
LOOPS = {
    "input_di": (_di, dict(H=20, r=1.0), dict(kind="input"), 120, [0.3]),
    "output_qt": (_qt, dict(H=30, r=0.2), dict(kind="output"), 250,
                  [0.1, -0.05]),
    "stagewise_di": (_di, dict(H=32, r=1.0),
                     dict(kind="input", backend="stagewise"), 100, [0.25]),
    "y_max_di": (_di, dict(H=20, r=1.0,
                           y_max=np.array([1.05], np.float32)),
                 dict(kind="input"), 120, [0.2]),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(pkg, case):
    make, skw, ckw, steps, d_true = LOOPS[case]
    if pkg == "jax":
        ctrl = JOffsetFree(_spec(JSpec, make(jplants), **skw), **ckw)
    else:
        ctrl = OffsetFreeController(_spec(MPCSpec, make(plants), **skw),
                                    device=CPU, **ckw)
    ns = make(plants).n_state
    return ctrl.rollout_jit(np.zeros(ns, np.float32), steps,
                            np.asarray(d_true, np.float32))


@pytest.fixture(scope="module")
def jax_loops():
    return {}


def _jax(jax_loops, case):
    if case not in jax_loops:
        jax_loops[case] = _run("jax", case)
    return jax_loops[case]


def assert_loop_parity(got, want):
    """The module docstring's bars between two rollout_jit outputs."""
    assert want["converged"].all()
    np.testing.assert_array_equal(got["converged"], want["converged"])
    for k in ("u", "d_hat", "y"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=5e-3 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
    it_w = np.asarray(want["iters"]).astype(np.int64)
    it_g = np.asarray(got["iters"]).astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // 8) * 8
    assert (np.abs(it_g - it_w) <= bar).mean() >= IN_BAR_SHARE, \
        (it_g, it_w)
    assert abs(it_g.mean() - it_w.mean()) <= 0.1 * it_w.mean()


@pytest.mark.parametrize("kind", ["output", "input"])
@pytest.mark.parametrize("make", [_di, _qt], ids=["di", "qt"])
def test_host_builds_match_jax(make, kind):
    jp, tp = make(jplants), make(plants)
    if kind == "output" and make is _di:
        # the integrator's output disturbance is undetectable in both
        Bd, Cd = jof.disturbance_channels(jp, kind)
        with pytest.raises(ValueError, match="undetectable"):
            jof.check_offset_free_rank(jp, Bd, Cd)
        with pytest.raises(ValueError, match="undetectable"):
            check_offset_free_rank(tp, *disturbance_channels(tp, kind))
        return
    Bd, Cd = disturbance_channels(tp, kind)
    Bd_j, Cd_j = jof.disturbance_channels(jp, kind)
    np.testing.assert_array_equal(Bd, Bd_j)
    np.testing.assert_array_equal(Cd, Cd_j)
    for got, want in zip(target_maps(tp, Bd, Cd),
                         jof.target_maps(jp, Bd_j, Cd_j)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    aug, aug_j = augment_plant(tp, Bd, Cd), jof.augment_plant(jp, Bd_j,
                                                             Cd_j)
    for f in ("A", "B", "E", "C"):
        np.testing.assert_array_equal(getattr(aug, f), getattr(aug_j, f))
    spec = _spec(MPCSpec, tp)
    ctrl = OffsetFreeController(spec, kind=kind, device=CPU)
    jctrl = JOffsetFree(_spec(JSpec, jp), kind=kind)
    for got, want in ((ctrl._Gd, jctrl._Gd), (ctrl._Gr, jctrl._Gr),
                      (ctrl.estimator.L, jctrl.estimator.L)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)


def test_target_maps_satisfy_equations():
    """tests/test_offset_free.py's bar on the port's maps: the targets
    solve the steady-state equations to 1e-4 for both kinds."""
    plant = plants.quadruple_tank()
    rng = np.random.default_rng(0)
    A, B, C = (np.asarray(m, np.float64) for m in (plant.A, plant.B,
                                                   plant.C))
    for kind in ("output", "input"):
        Bd, Cd = disturbance_channels(plant, kind)
        Gd, Gr = (np.asarray(m, np.float64)
                  for m in target_maps(plant, Bd, Cd))
        for _ in range(3):
            d = rng.standard_normal(Bd.shape[1])
            r = rng.standard_normal(plant.n_output)
            t = Gd @ d + Gr @ r
            x_ss, u_ss = t[:plant.n_state], t[plant.n_state:]
            np.testing.assert_allclose(A @ x_ss + B @ u_ss + Bd @ d, x_ss,
                                       atol=1e-4)
            np.testing.assert_allclose(C @ x_ss + Cd @ d, r, atol=1e-4)


def test_rank_and_shape_checks():
    plant = plants.double_integrator()
    with pytest.raises(ValueError, match="undetectable"):
        OffsetFreeController(_spec(MPCSpec, plant), kind="output",
                             device=CPU)
    with pytest.raises(ValueError, match="nd=2 > ny=1"):
        check_offset_free_rank(plant, np.eye(2), np.zeros((1, 2)))
    with pytest.raises(ValueError, match="unknown disturbance kind"):
        disturbance_channels(plant, "state")
    with pytest.raises(ValueError, match="constant"):
        OffsetFreeController(
            dataclasses.replace(_spec(MPCSpec, plant),
                                r=np.zeros((20, 1), np.float32)),
            kind="input", device=CPU)


def _nominal_offset(steps=60):
    """Nominal full-state MPC under the unmodelled input disturbance 0.3
    (tests/test_offset_free.py's contrast): its mean tail offset."""
    plant = plants.double_integrator()
    ctrl = MPCController(_spec(MPCSpec, plant), warm_start="shift",
                         device=CPU)
    A, B, C = (np.asarray(m) for m in (plant.A, plant.B, plant.C))
    x = np.zeros(2, np.float32)
    u_prev = np.zeros(1, np.float32)
    ys = []
    for _ in range(steps):
        u0 = ctrl.step(x, u_prev=u_prev)[0].numpy().reshape(-1)
        x = (A @ x + B @ (u0 + 0.3)).astype(np.float32)
        u_prev = u0
        ys.append(C @ x)
    return float(np.abs(np.stack(ys)[-5:] - 1.0).mean())


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_closed_loop_matches_jax(jax_loops, case):
    got = _run("torch", case)
    want = _jax(jax_loops, case)
    assert_loop_parity(got, want)
    d_true = np.asarray(LOOPS[case][4])
    r = LOOPS[case][1]["r"]
    y_tail = got["y"][-10:]
    tol = 1e-2 if case == "stagewise_di" else 5e-3
    # tests/test_offset_free.py's guarantees on the port's loop
    assert np.abs(y_tail - r).max() < tol, y_tail[-1]
    assert np.abs(got["d_hat"][-10:] - d_true).max() < tol
    # |u| <= 2 within the slack the solve certifies, max(erc |Kp|, eac) =
    # 2e-4 under MPC_CONFIG: the cold accelerated first step stops at 25
    # iterations here (41 in JAX) with its slew row 4.5e-5 past 1, and the
    # next step's box row 6.2e-5 past 2 (JAX: 4e-7, -1.3e-6)
    assert np.abs(got["u"]).max() <= 2.0 + 2e-4
    if case == "y_max_di":
        assert got["y"].max() <= 1.05 + 1e-3
    if case == "input_di":
        nominal = _nominal_offset()
        assert nominal > 10 * np.abs(y_tail - 1.0).mean()
        assert nominal > 2e-2, nominal


def test_eager_control_matches_rollout_first_step():
    """tests/test_offset_free.py's bar (the eager ``control`` equals the
    loop's first input to 1e-5) on the port, and its u0 against JAX's."""
    spec = _spec(MPCSpec, plants.double_integrator(), H=16, r=0.5)
    out = OffsetFreeController(spec, kind="input", device=CPU).rollout_jit(
        np.zeros(2, np.float32), 3, np.array([0.1], np.float32))
    u0, res = OffsetFreeController(spec, kind="input", device=CPU).control(
        np.zeros(2, np.float32), np.zeros(1, np.float32))
    np.testing.assert_allclose(u0.numpy(), out["u"][0], atol=1e-5)
    assert bool(res.converged.all())
    ju0, jres = JOffsetFree(_spec(JSpec, jplants.double_integrator(), H=16,
                                  r=0.5), kind="input").control(
        np.zeros(2, np.float32), np.zeros(1, np.float32))
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), atol=5e-3)


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_steps_leave_the_controller_bounds_unchanged(backend):
    """Each step shifts a COPY of the deviation controller's bounds: after
    ``control`` calls and a ``rollout_jit``, ``data.Kp`` (condensed) or
    ``_sd.Kp``/``_sd.y_max``/``_sd.y_min`` (stage-wise) hold their built
    values bit for bit, and a rerun of the loop repeats its inputs."""
    spec = _spec(MPCSpec, plants.double_integrator(), H=12, r=1.0,
                 y_max=np.array([1.05], np.float32))
    ctrl = OffsetFreeController(spec, kind="input", backend=backend,
                                device=CPU)
    inner = ctrl._ctrl
    held = ({"Kp": inner.data.Kp} if backend == "condensed" else
            {k: getattr(inner._sd, k) for k in ("Kp", "y_max", "y_min")})
    before = {k: v.clone() for k, v in held.items()}
    for _ in range(3):
        ctrl.control(np.array([0.5, 0.1]), np.array([0.2]),
                     u_prev=np.array([0.3]))
    first = ctrl.rollout_jit(np.zeros(2, np.float32), 10,
                             np.array([0.2], np.float32))
    now = ({"Kp": inner.data.Kp} if backend == "condensed" else
           {k: getattr(inner._sd, k) for k in ("Kp", "y_max", "y_min")})
    for k, v in before.items():
        assert torch.equal(now[k], v), k
    again = ctrl.rollout_jit(np.zeros(2, np.float32), 10,
                             np.array([0.2], np.float32))
    np.testing.assert_array_equal(again["u"], first["u"])


def test_controller_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffsetFreeController(_spec(MPCSpec, plants.double_integrator()),
                             kind="input")
