"""The port's stage-wise geometry (``models/stagewise.py``) and the public
builders of ``models/mpc.py`` against the JAX package, on the CPU.

The same specs (built from the same NumPy arrays in both packages) go
through both packages' functions.  Bars:

* ``prediction_matrices``/``input_constraints``: float32 sums in both,
  within 1e-6 * max(1, |want|max) (``input_constraints`` exactly);
* the Riccati factor, ``kkt_solve`` and ``rollout_states`` sequentially:
  rtol 1e-4, atol 1e-5 (the JAX package's bar for its Riccati recursion
  against the dense inverse, ``tests/test_stagewise.py``);
* the log-depth scans (``pscan=True``, H=37): rtol 1e-4, atol 1e-5 against
  JAX's ``lax.associative_scan`` and against the port's own sequential
  recursion, JAX's own bar for pscan against sequential;
* the Riccati factor's fields within 1e-4 * max(1, |field|max), and the
  auto band width EQUAL to JAX's at H=512 (the ratio test runs on float32
  data, so a one-step difference would change the split).

The dual geometry and the solve are held to JAX in
``test_torch_stagewise_solve.py`` (no bounds, slew, terminal weight) and
``test_torch_stagewise_outputs.py`` (output bounds, soft, MIMO).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import condense as jcondense
from pqp_for_mpc_tpu.models import input_constraints as j_input_constraints
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu.models import prediction_matrices as j_prediction
from pqp_for_mpc_tpu.models import stagewise as js
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec, condense,
                                          input_constraints, plants,
                                          prediction_matrices)
from pqp_for_mpc_tpu_torch.models import stagewise as ts

CPU = torch.device("cpu")


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


def _both(make, H, **extra):
    """(JAX spec, port spec) of one plant maker (module -> plant)."""
    return (_spec(JSpec, make(jplants), H, **extra),
            _spec(MPCSpec, make(plants), H, **extra))


def _di(m):
    return m.double_integrator()


def _assert_fields_close(want: dict, got: dict, rel=1e-4, path=""):
    assert set(want) == set(got), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_fields_close(w, g, rel, path + k + ".")
            continue
        if w is None:
            assert g is None, path + k
            continue
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape, path + k
        if w.ndim == 0:          # meta fields: ints and floats, equal
            assert g == w, path + k
            continue
        tol = rel * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=path + k)


@pytest.mark.parametrize("case", ["double_integrator_h12", "ltv_h6",
                                  "random_stable_h9"])
def test_prediction_matrices_match_jax(case):
    H = {"double_integrator_h12": 12, "ltv_h6": 6, "random_stable_h9": 9}[case]
    if case == "ltv_h6":
        make = lambda m: m.stack_plant(m.mass_spring_damper(2), H)
    elif case == "random_stable_h9":
        make = lambda m: m.random_stable(4, 2, n_dist=2)
    else:
        make = _di
    want = j_prediction(make(jplants), H)
    got = prediction_matrices(make(plants), H, device=CPU)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("case", ["constant", "per_stage", "u_prev_mimo"])
def test_input_constraints_match_jax(case):
    extra = {"constant": {},
             "per_stage": dict(u_max=np.linspace(1.0, 0.5, 8).reshape(8, 1),
                               du_max=np.full((8, 1), 0.3)),
             "u_prev_mimo": dict(u_prev=np.array([0.1, -0.2, 0.7]))}[case]
    make = (lambda m: m.mass_spring_damper(3)) if case == "u_prev_mimo" \
        else _di
    jspec, tspec = _both(make, 8, **extra)
    Gw, Kw = j_input_constraints(jspec)
    Gg, Kg = input_constraints(tspec, device=CPU)
    np.testing.assert_array_equal(Gg.numpy(), np.asarray(Gw))
    np.testing.assert_array_equal(Kg.numpy(), np.asarray(Kw))
    # the condensed host build lays its rows out the same way
    data = condense(tspec, device=CPU)
    np.testing.assert_array_equal(data.Gp.numpy(), Gg.numpy())


def test_kkt_solve_matches_dense_inverse_and_jax():
    """Qp^-1 v through the Riccati recursion == the condensed Hessian's
    dense inverse (H=8), and the JAX package's recursion."""
    jspec, tspec = _both(_di, 8)
    f = ts.riccati_factor(tspec, device=CPU)
    jf = js.riccati_factor(jspec)
    _assert_fields_close(convert.to_numpy(jf), convert.to_numpy(f))
    v = np.random.default_rng(0).standard_normal((8, 1, 3)).astype(
        np.float32)
    u = ts.kkt_solve(f, torch.from_numpy(v)).numpy()
    want = np.asarray(jcondense(jspec).Qp_inv, np.float64) @ v.reshape(8, 3)
    np.testing.assert_allclose(u.reshape(8, 3), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(u, np.asarray(js.kkt_solve(jf, jnp.asarray(v))),
                               rtol=1e-4, atol=1e-5)


def test_qd_diag_matches_condensed():
    """r_i^2 (the Cauchy-Schwarz radii) equals diag(Qd) of the port's
    condensed dual, and theta dominates the condensed theta."""
    from pqp_for_mpc_tpu_torch import dualize
    _, tspec = _both(_di, 8)
    sd = ts.stagewise_dual(tspec, device=CPU)
    data = condense(tspec, device=CPU)
    dual = dualize(data.assemble(Qp=data.qp()))
    r2 = sd.r_vec.reshape(-1).numpy() ** 2
    np.testing.assert_allclose(r2, np.diag(dual.Qd.numpy()), rtol=2e-3,
                               atol=1e-5)
    assert (sd.theta.reshape(-1) >= dual.theta - 1e-3).all()


def test_pscan_matches_jax_and_sequential():
    """The log-depth scans (H=37, odd and not a power of two) against JAX's
    associative scans and the port's sequential recursions: kkt_solve,
    rollout_states and the output adjoint with a terminal seed."""
    H = 37
    jspec, tspec = _both(_di, H, P=np.eye(2))
    f, jf = ts.riccati_factor(tspec, device=CPU), js.riccati_factor(jspec)
    rng = np.random.default_rng(5)
    v = rng.standard_normal((H, 1, 4)).astype(np.float32)
    x0 = rng.standard_normal((2, 4)).astype(np.float32)
    e = rng.standard_normal((H, 1, 4)).astype(np.float32)
    g = rng.standard_normal((2, 4)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (lambda p: ts.kkt_solve(f, t(v), pscan=p),
         js.kkt_solve(jf, jnp.asarray(v), pscan=True)),
        (lambda p: ts.rollout_states(f, t(x0), t(v), pscan=p),
         js.rollout_states(jf, jnp.asarray(x0), jnp.asarray(v), pscan=True)),
        (lambda p: ts._su_adjoint(f, t(e), pscan=p, g_last=t(g)),
         js._su_adjoint(jf, jnp.asarray(e), pscan=True,
                        g_last=jnp.asarray(g))),
    ]
    for run, want in pairs:
        par = run(True).numpy()
        np.testing.assert_allclose(par, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(par, run(False).numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_affine_cumulative_composes_in_order():
    """Position i of the inclusive scan is step 0..i composed (step 0
    first), at every length around the powers of two."""
    rng = np.random.default_rng(2)
    for H in (1, 2, 3, 7, 8, 9):
        Ms = rng.standard_normal((H, 3, 3)).astype(np.float64)
        cs = rng.standard_normal((H, 3, 2)).astype(np.float64)
        M, c = ts._affine_cumulative(torch.from_numpy(Ms),
                                     torch.from_numpy(cs))
        Mi, ci = np.eye(3), np.zeros((3, 2))
        for i in range(H):
            Mi, ci = Ms[i] @ Mi, Ms[i] @ ci + cs[i]
            np.testing.assert_allclose(M[i].numpy(), Mi, rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_allclose(c[i].numpy(), ci, rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("b", [0, 2, 5])
def test_extract_band_matches_jax(b):
    K = np.random.default_rng(b).standard_normal((6 * 2, 6 * 3)).astype(
        np.float32)
    want = js._extract_band(K, 6, 2, b, 3)
    np.testing.assert_array_equal(
        ts._extract_band(torch.from_numpy(K), 6, 2, b, 3).numpy(), want)


def test_stagewise_dual_round_trips_through_numpy():
    """to_numpy -> stagewise_dual_from_numpy keeps every array (float32)
    and the meta fields as Python numbers; an unknown field is refused.
    (The JAX package's own dual carried across is solved in
    test_torch_stagewise_outputs.py.)"""
    _, tspec = _both(_di, 8, y_min=np.full(1, -1.9), y_max=np.full(1, 1.9),
                     soft_penalty=50.0)
    sd = ts.stagewise_dual(tspec, device=CPU)
    arrays = convert.to_numpy(sd)
    again = convert.stagewise_dual_from_numpy(arrays, device=CPU)
    assert isinstance(again.factor.H, int) and again.factor.H == 8
    assert isinstance(again.soft_rho, float) and again.has_soft
    assert again.theta_soft.dtype == torch.float32
    _assert_fields_close(arrays, convert.to_numpy(again), rel=0.0)
    with pytest.raises(ValueError, match="no fields"):
        convert.stagewise_dual_from_numpy(dict(arrays, bogus=1), device=CPU)


def test_auto_backend_reaches_the_stagewise_backend():
    """Past the n_con line (4*H*nu >= 1536: H >= 384 for the double
    integrator) backend="auto" builds the stage-wise backend instead of
    raising, and never builds the condensed blocks; below it, condensed."""
    spec = _spec(MPCSpec, plants.double_integrator(), 384)
    ctrl = MPCController(spec, backend="auto", warm_start="shift",
                         device=CPU)
    assert ctrl.backend == "stagewise" and ctrl.data is None
    assert ctrl.n_con == 4 * 384
    u0, res = ctrl.step(np.array([2.0, 0.0], np.float32))
    assert bool(res.converged.all()) and abs(float(u0[0])) <= 1.0 + 1e-3
    short = MPCController(_spec(MPCSpec, plants.double_integrator(), 16),
                          backend="auto", device=CPU)
    assert short.backend == "condensed" and short.data is not None


def test_stagewise_refuses_move_blocking():
    spec = _spec(MPCSpec, plants.double_integrator(), 16, moves=4)
    with pytest.raises(NotImplementedError, match="move blocking"):
        MPCController(spec, backend="stagewise", device=CPU)
    with pytest.raises(NotImplementedError, match="move blocking"):
        ts.stagewise_dual(spec, device=CPU)


def test_entry_points_default_to_the_card():
    """Without a card, a stage-wise entry point that was not asked for the
    CPU raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults build there")
    spec = _spec(MPCSpec, plants.double_integrator(), 12)
    for build in (lambda: ts.stagewise_dual(spec),
                  lambda: ts.riccati_factor(spec),
                  lambda: MPCController(spec, backend="stagewise"),
                  lambda: prediction_matrices(spec.plant, 12),
                  lambda: input_constraints(spec)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    arrays = convert.to_numpy(ts.stagewise_dual(spec, device=CPU))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.stagewise_dual_from_numpy(arrays)


def test_stagewise_build_at_h512_picks_jax_band():
    """H=512 (n_con = 2048, the long-horizon drive's spec): the JAX
    package's band (the full band, H - 1); the factor stays O(H) and the
    band blocks O(H * band), never the (2048, 2048) condensed Qd."""
    jspec, tspec = _both(_di, 512)
    sd = ts.stagewise_dual(tspec, device=CPU)
    assert sd.band == js.stagewise_dual(jspec).band == 511
    assert sd.n_con == 2048
    assert sd.band_abs.shape == (2, 2, 512, 1023, 1, 1)
    factor = [getattr(sd.factor, f.name)
              for f in dataclasses.fields(sd.factor)]
    assert max(t.numel() for t in factor
               if isinstance(t, torch.Tensor)) <= 512 * 4


@pytest.mark.parametrize("build", ["stagewise_dual", "relinearize"])
def test_the_build_takes_no_pscan(build):
    """The port's build always runs the sequential recursions: unlike the
    JAX package's (``stagewise.py:791,868``), ``stagewise_dual`` and
    ``relinearize`` take no ``pscan``, and a JAX-style call with one raises
    ``TypeError``.  No caller passes it in either package: the estimators
    and RTI (``models/mhe.py``, ``models/rti.py``) call both without."""
    spec = _spec(MPCSpec, plants.double_integrator(), 8)
    sd = ts.stagewise_dual(spec, device=CPU)
    calls = {"stagewise_dual": lambda **kw: ts.stagewise_dual(
                 spec, device=CPU, **kw),
             "relinearize": lambda **kw: ts.relinearize(
                 sd, sd.factor.A, sd.factor.Bm, **kw)}
    calls[build]()
    with pytest.raises(TypeError, match="pscan"):
        calls[build](pscan=True)
