"""The port's stage-wise dual and ``solve_stagewise`` against the JAX
package on specs without output bounds, on the CPU.

Bars.  Every tensor field of ``stagewise_dual`` within
1e-4 * max(1, |field|max) and the band width equal.  A solve: the same
verdict on every lane, iterations within the oracle bar max(5, iters/5)
rounded up to whole checks, U within 5e-3 * max(1, |U|max) (ROADMAP's
parity bar), and Jp within 1e-3 * max(1, |Jp|).  The inputs are the same
NumPy arrays in both packages; the specs are those of
``tests/test_stagewise.py`` at H=12 (one horizon, so the JAX package's
eager scans compile once for the file).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqp_for_mpc_tpu as jpqp
from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu.models import stagewise as js
import pqp_for_mpc_tpu_torch as tpqp
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch.models import MPCSpec, plants
from pqp_for_mpc_tpu_torch.models import stagewise as ts

CPU = torch.device("cpu")
H = 12
#: the cfg of tests/test_stagewise.py's solves
CFG = dict(max_iters=100_000, check_every=8, accel_every=4, y0=0.01,
           eaj=1e-4, erj=1e-5, erc=1e-5, eac=1e-5, strict_weak_duality=False)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cls, plant, **extra):
    nu, ny = plant.n_input, plant.n_output
    kw = dict(Qy=np.eye(ny), R=0.05 * np.eye(nu), r=np.zeros(ny),
              u_min=-np.ones(nu), u_max=np.ones(nu),
              du_max=0.5 * np.ones(nu))
    kw.update(extra)
    return cls(plant, horizon=H, **kw)


#: name -> spec extras (double integrator, H=12)
SPECS = {
    "plain": {},
    "slew_uprev": dict(du_max=np.array([0.25]), u_prev=np.array([0.5])),
    "terminal_stage_weights": dict(
        P=np.diag([3.0, 1.0]), Qy=np.linspace(0.5, 2.0, H).reshape(H, 1, 1),
        r=np.linspace(0.0, 1.0, H).reshape(H, 1)),
}
_JAX = {}


def _duals(case):
    """(JAX dual, port dual) of a SPECS case; the JAX one built once."""
    extra = SPECS[case]
    if case not in _JAX:
        _JAX[case] = js.stagewise_dual(
            _spec(JSpec, jplants.double_integrator(), **extra))
    return _JAX[case], ts.stagewise_dual(
        _spec(MPCSpec, plants.double_integrator(), **extra), device=CPU)


def _assert_fields_close(want: dict, got: dict, path=""):
    assert set(want) == set(got), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_fields_close(w, g, path + k + ".")
        elif w is None:
            assert g is None, path + k
        elif np.ndim(w) == 0:                 # meta fields, equal
            assert g == w, path + k
        else:
            np.testing.assert_allclose(
                np.asarray(g, np.float64), np.asarray(w, np.float64),
                rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())),
                err_msg=path + k)


def _solve_both(jsd, tsd, x0, cfg=CFG, Y0=None, **kw):
    """The two packages' solve_stagewise on the same inputs (NumPy)."""
    want = js.solve_stagewise(jsd, jnp.asarray(x0), cfg=jpqp.SolverConfig(
        **cfg), Y0=None if Y0 is None else jnp.asarray(Y0), **kw)
    got = ts.solve_stagewise(tsd, torch.from_numpy(x0), cfg=tpqp.SolverConfig(
        **cfg), Y0=None if Y0 is None else torch.from_numpy(Y0), **kw)
    return want, got


def _assert_solve_parity(want, got, check_every):
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // check_every) * check_every
    assert (np.abs(got.iters.numpy() - it_w) <= bar).all(), \
        (got.iters.numpy(), it_w)
    U_w = np.asarray(want.U)
    np.testing.assert_allclose(got.U.numpy(), U_w, rtol=0,
                               atol=5e-3 * max(1.0, np.abs(U_w).max()))
    Jp_w = np.asarray(want.Jp)
    np.testing.assert_allclose(got.Jp.numpy(), Jp_w, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(Jp_w).max()))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_stagewise_dual_matches_jax(case):
    jsd, tsd = _duals(case)
    assert tsd.band == jsd.band and tsd.n_con == jsd.n_con
    _assert_fields_close(convert.to_numpy(jsd), convert.to_numpy(tsd))


def _x0(seed, B=4):
    return np.random.default_rng(seed).uniform(-2, 2, (2, B)).astype(
        np.float32)


@pytest.mark.parametrize("pscan", [False, True])
def test_cold_batch_matches_jax(pscan):
    """A batch of 4 initial states, cold, each recursion form."""
    want, got = _solve_both(*_duals("plain"), _x0(0), pscan=pscan)
    assert np.asarray(want.converged).all()
    _assert_solve_parity(want, got, CFG["check_every"])


def test_warm_start_matches_jax():
    """Warm from the JAX package's multipliers of nearby states (one column
    seeding the batch, and one per lane)."""
    jsd, tsd = _duals("plain")
    x0 = _x0(1)
    seed_Y = np.asarray(js.solve_stagewise(
        jsd, jnp.asarray(x0 + 0.05), cfg=jpqp.SolverConfig(**CFG)).Y)
    for Y0 in (seed_Y[:, :1].copy(), seed_Y):
        want, got = _solve_both(jsd, tsd, x0, Y0=np.maximum(Y0, 1e-6))
        assert np.asarray(want.converged).all()
        _assert_solve_parity(want, got, CFG["check_every"])


def test_slew_with_u_prev_matches_jax():
    """Slew rows + nonzero u_prev: |u_0 - u_prev| <= du honoured, the JAX
    solution (the feasibility slack of tests/test_stagewise.py's case)."""
    cfg = dict(CFG, erc=1e-4, eac=1e-4)
    x0 = np.array([[2.0], [0.0]], np.float32)
    want, got = _solve_both(*_duals("slew_uprev"), x0, cfg=cfg)
    assert np.asarray(want.converged).all()
    _assert_solve_parity(want, got, cfg["check_every"])
    U = got.U.numpy()[:, 0]
    assert abs(U[0] - 0.5) <= 0.25 + 1e-3
    assert np.abs(np.diff(U)).max() <= 0.25 + 1e-3


def test_terminal_weight_and_stage_weights_match_jax():
    want, got = _solve_both(*_duals("terminal_stage_weights"), _x0(2))
    assert np.asarray(want.converged).all()
    _assert_solve_parity(want, got, CFG["check_every"])


def test_retry_cold_rescues_a_poisoned_warm_start_like_jax():
    """A warm start far from the multipliers fails certification within
    max_iters on every lane; retry_cold re-solves the failed lanes from the
    cold start, in both packages alike, and the merged result equals the
    cold solve's."""
    jsd, tsd = _duals("plain")
    cfg = dict(CFG, max_iters=200)
    x0 = _x0(3, B=3)
    Y0 = np.full((jsd.n_con, 3), 1e4, np.float32)
    want_w, got_w = _solve_both(jsd, tsd, x0, cfg=cfg, Y0=Y0)
    assert not np.asarray(want_w.converged).any()
    assert not got_w.converged.any()
    want, got = _solve_both(jsd, tsd, x0, cfg=cfg, Y0=Y0, retry_cold=True)
    assert np.asarray(want.converged).all()
    _assert_solve_parity(want, got, cfg["check_every"])
    cold = ts.solve_stagewise(tsd, torch.from_numpy(x0),
                              cfg=tpqp.SolverConfig(**cfg))
    np.testing.assert_array_equal(got.U.numpy(), cold.U.numpy())
    np.testing.assert_array_equal(got.iters.numpy(), cold.iters.numpy())


def test_warm_start_batch_mismatch_raises():
    _, tsd = _duals("plain")
    with pytest.raises(ValueError, match="warm start batch"):
        ts.solve_stagewise(tsd, torch.from_numpy(_x0(0)),
                           Y0=torch.ones(tsd.n_con, 3))


def test_solution_is_the_condensed_solution():
    """The same QP through the port's condensed path (dense dual): the
    solution of tests/test_stagewise.py::
    test_stagewise_matches_condensed_solution."""
    _, tsd = _duals("plain")
    tspec = _spec(MPCSpec, plants.double_integrator())
    data = tpqp.models.condense(tspec, device=CPU)
    x0 = _x0(0)
    primal = data.assemble(x=torch.from_numpy(x0), Qp=data.qp())
    cfg = tpqp.SolverConfig(**CFG)
    ref = tpqp.solve_batched(primal, tpqp.dualize(primal), cfg=cfg)
    res = ts.solve_stagewise(tsd, torch.from_numpy(x0), cfg=cfg)
    assert ref.converged.all() and res.converged.all()
    np.testing.assert_allclose(res.U.numpy(), ref.U.numpy(), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(res.Jp.numpy(), ref.Jp.numpy(), rtol=1e-4,
                               atol=1e-4)
