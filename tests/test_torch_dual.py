"""Parity of the PyTorch port's problem build with the JAX package.

The same NumPy inputs, made from a seed, go to both packages (the port's
through ``pqp_for_mpc_tpu_torch.convert``); every field of ``assemble``,
``dual_geometry``, ``dualize_forcing`` (with and without materialized
splits) and ``primal_from_dual`` is compared at rtol 1e-5 (float32 products
summed in another order; atol covers entries that cancel to ~0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import dual as jdual
from pqp_for_mpc_tpu.io.generator import generate_instance, to_primal_arrays
from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import condense as jcondense
from pqp_for_mpc_tpu.models import double_integrator, thermal_rc
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch import dual as tdual

RTOL, ATOL = 1e-5, 1e-4
B = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL, scale=None):
    """``scale`` — the magnitude the value was computed from, where that
    exceeds the value itself (Md = Fp'Qp^-1 Fp - Mp cancels terms of |Mp|'s
    size, so its float32 noise floor scales with |Mp|)."""
    if want is None:
        assert got is None
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()), scale or 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _spec(plant, H, r):
    nu = plant.n_input
    return JSpec(plant, horizon=H, Qy=np.eye(plant.n_output),
                 R=0.05 * np.eye(nu), r=np.full(plant.n_output, r),
                 u_min=-np.ones(nu), u_max=np.ones(nu),
                 du_max=0.5 * np.ones(nu))


def _condensed_case(plant, H, r, seed):
    """(JAX condensed data, x (ns, B)) for a condensed-MPC case."""
    data = jcondense(_spec(plant, H, r))
    x = np.random.default_rng(seed).normal(
        0.0, 0.5, (plant.n_state, B)).astype(np.float32)
    return data, x


def _jax_primal(case):
    """The JAX PrimalQP of a case (a batch of B instances)."""
    if case.startswith("gen"):
        M, N = {"gen_12x30": (12, 30), "gen_25x60": (25, 60)}[case]
        qp, qpi, fp, mp, gp, kp = to_primal_arrays(
            generate_instance(M, N, seed=N))
        rng = np.random.default_rng(M)
        Fp = (fp[:, None] + rng.normal(0.0, 5.0, (M, B))).astype(np.float32)
        Mp = (mp + rng.normal(0.0, 1.0, B)).astype(np.float32)
        primal = JPrimal(Qp=jnp.asarray(qp), Qp_inv=jnp.asarray(qpi),
                         Fp=jnp.asarray(Fp), Mp=jnp.asarray(Mp),
                         Gp=jnp.asarray(gp), Kp=jnp.asarray(kp))
        return primal
    data, x = CONDENSED[case]()
    return data.assemble(x=jnp.asarray(x), Qp=data.qp())


CONDENSED = {
    "di_h7": lambda: _condensed_case(double_integrator(), 7, 2.5, 0),
    "thermal_h1": lambda: _condensed_case(thermal_rc(), 1, 0.0, 1),
}
CASES = ["di_h7", "thermal_h1", "gen_12x30", "gen_25x60"]


@pytest.mark.parametrize("case", sorted(CONDENSED))
def test_assemble_matches_jax(case):
    data, x = CONDENSED[case]()
    want = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    tdata = convert.condensed_from_numpy(convert.to_numpy(data), device="cpu")
    got = tdata.assemble(x=torch.as_tensor(x), Qp=tdata.qp())
    for field, w in convert.to_numpy(want).items():
        _close(getattr(got, field), w)
    # one unbatched state: the batch axis is squeezed as in JAX
    want1 = data.assemble(x=jnp.asarray(x[:, 0]), Qp=data.qp())
    got1 = tdata.assemble(x=torch.as_tensor(x[:, 0]), Qp=tdata.qp())
    _close(got1.Fp, want1.Fp)
    _close(got1.Mp, want1.Mp)


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_dual_geometry_matches_jax(case, materialize):
    jp = _jax_primal(case)
    tp = convert.primal_from_numpy(convert.to_numpy(jp), device="cpu")
    want = jdual.dual_geometry(jp.Gp, jp.Qp_inv, theta_floor=5.0,
                               materialize_splits=materialize)
    got = tdual.dual_geometry(tp.Gp, tp.Qp_inv, theta_floor=5.0,
                              materialize_splits=materialize)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w)


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_dualize_forcing_matches_jax(case, materialize):
    jp = _jax_primal(case)
    tp = convert.primal_from_numpy(convert.to_numpy(jp), device="cpu")
    want = jdual.dualize(jp, materialize_splits=materialize)
    got = tdual.dualize(tp, materialize_splits=materialize)
    mp_scale = float(np.abs(np.asarray(jp.Mp)).max())
    for field, w in convert.to_numpy(want).items():
        _close(getattr(got, field), w,
               scale=mp_scale if field == "Md" else None)
    # the per-instance half alone, from a shared geometry
    geom = tdual.dual_geometry(tp.Gp, tp.Qp_inv,
                               materialize_splits=materialize)
    part = tdual.dualize_forcing(geom, tp.Fp, tp.Mp, tp.Kp)
    _close(part.Fd, want.Fd)
    _close(part.Md, want.Md, scale=mp_scale)


@pytest.mark.parametrize("case", CASES)
def test_primal_from_dual_matches_jax(case):
    jp = _jax_primal(case)
    tp = convert.primal_from_numpy(convert.to_numpy(jp), device="cpu")
    N = int(jp.Gp.shape[0])
    Y = np.random.default_rng(3).uniform(0.0, 2.0, (N, B)).astype(np.float32)
    want = jdual.primal_from_dual(jp, jnp.asarray(Y))
    _close(tdual.primal_from_dual(tp, torch.as_tensor(Y)), want)


def test_convert_round_trip_keeps_fields_and_none():
    jp = _jax_primal("di_h7")
    dual_np = convert.to_numpy(jdual.dualize(jp, materialize_splits=False))
    td = convert.dual_from_numpy(dual_np, device="cpu")
    assert td.Qdp_theta is None and td.Qdn_theta is None
    back = convert.to_numpy(td)
    assert set(back) == set(dual_np)
    for k, v in dual_np.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="no fields"):
        convert.primal_from_numpy({"Qd": dual_np["Qd"]}, device="cpu")
