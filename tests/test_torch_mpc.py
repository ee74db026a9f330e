"""Parity of the port's condensation and receding-horizon controller with
the JAX package.

``condense`` runs the same float64 host build in both packages, so its
float32 blocks must agree exactly.  The closed loop (double integrator,
H=16, |u| <= 1, |du| <= 0.5, 20 steps from x0 = [2, 0], MPC_CONFIG) is held
to u within 1e-3 per step and iterations within the oracle bar
max(5, iters/5) rounded up to whole checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import MPCController as JController
from pqp_for_mpc_tpu.models import MPCSpec
from pqp_for_mpc_tpu.models import condense as jcondense
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch.models import MPCController, condense
from pqp_for_mpc_tpu_torch.models import plants as tplants
from pqp_for_mpc_tpu_torch.models import MPCSpec as TSpec


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(plant, H, r, cls=MPCSpec, **extra):
    nu = plant.n_input
    return cls(plant, horizon=H, Qy=np.eye(plant.n_output),
               R=0.05 * np.eye(nu), r=np.full(plant.n_output, r),
               u_min=-np.ones(nu), u_max=np.ones(nu),
               du_max=0.5 * np.ones(nu), **extra)


PLANTS = {
    "double_integrator_h7": (tplants.double_integrator, 7, {}),
    "thermal_rc_h1": (tplants.thermal_rc, 1, {}),
    # output bounds (state-dependent Kp) and move blocking
    "mass_spring_h6_outputs_moves": (
        lambda: tplants.mass_spring_damper(2), 6,
        dict(y_max=np.full(2, 0.8), moves=3)),
}


def _bar(iters, check_every):
    bar = np.maximum(5, np.asarray(iters) // 5)
    return -(-bar // check_every) * check_every


@pytest.mark.parametrize("case", sorted(PLANTS))
def test_condense_matches_jax(case):
    make, H, extra = PLANTS[case]
    want = convert.to_numpy(jcondense(_spec(make(), H, 0.5, **extra)))
    got = convert.to_numpy(condense(_spec(make(), H, 0.5, cls=TSpec,
                                          **extra), device="cpu"))
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _loop_spec(cls):
    return _spec(tplants.double_integrator(), 16, 0.0, cls=cls)


def test_rollout_matches_jax():
    ctrl = MPCController(_loop_spec(TSpec), device="cpu")
    got = ctrl.rollout([2.0, 0.0], 20)
    want = JController(_loop_spec(MPCSpec)).rollout([2.0, 0.0], 20)
    assert got["converged"].all()
    assert (got["iters"] < 2000).all() and np.isfinite(got["x"]).all()
    np.testing.assert_allclose(got["u"], want["u"], atol=1e-3)
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-3)
    assert (np.abs(got["iters"] - want["iters"])
            <= _bar(want["iters"], ctrl.cfg.check_every)).all()


def test_scenario_fan_out_with_shifted_warm_start_matches_jax():
    import jax.numpy as jnp
    x = np.random.default_rng(4).normal(0.0, 0.5, (2, 32)).astype(np.float32)
    tc = MPCController(_loop_spec(TSpec), warm_start="shift", device="cpu")
    jc = JController(_loop_spec(MPCSpec), warm_start="shift")
    for step in range(2):
        u_t, r_t = tc.step(x, u_prev=np.full(1, 0.1 * step))
        u_j, r_j = jc.step(jnp.asarray(x), u_prev=jnp.full(1, 0.1 * step))
        np.testing.assert_array_equal(r_t.converged.numpy(),
                                      np.asarray(r_j.converged))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-3)
        x = 0.9 * x
    Y = tc._Y
    np.testing.assert_allclose(tc._shift_multipliers(Y).numpy(),
                               np.asarray(jc._shift_multipliers(
                                   jnp.asarray(Y.numpy()))))


def test_controller_refuses_what_is_not_ported():
    spec = _loop_spec(TSpec)
    # the stage-wise backend is ported (tests/test_torch_stagewise*.py);
    # move blocking on it is refused, as in the JAX package
    with pytest.raises(NotImplementedError, match="move blocking"):
        MPCController(dataclasses.replace(spec, moves=4),
                      backend="stagewise", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        MPCController(spec, backend="sparse", device="cpu")
    assert MPCController(spec, backend="stagewise",
                         device="cpu").data is None
    ctrl = MPCController(spec, device="cpu")
    # the device-resident closed loop is ported (tests/test_torch_rollout.py)
    out = ctrl.rollout_jit([2.0, 0.0], 5)
    assert out["converged"].all() and out["x"].shape == (5, 2)
    assert dataclasses.is_dataclass(ctrl.data)


def test_entry_points_default_to_the_card():
    """Without a card, an entry point that was not asked for the CPU
    raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults build there")
    spec = _loop_spec(TSpec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPCController(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        condense(spec)
    arrays = convert.to_numpy(condense(spec, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.condensed_from_numpy(arrays)
