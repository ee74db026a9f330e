"""The port's stage-wise dual and ``solve_stagewise`` with OUTPUT bounds
against the JAX package, on the CPU (double integrator at H=20, one horizon
so the JAX package's eager scans compile once for the file).

Cases: the y-bounded spec of ``tests/test_stagewise.py`` (reference 2.5
above the bound y <= 1.9, so the bound is active), a per-stage y-bound
schedule (``tests/test_robust.py``), the same y-bounded spec at an explicit
band of 2 stages (the rank-1 Cauchy-Schwarz tail carries everything
off-band; the auto band is the full H-1), ``relinearize`` on new dynamics,
and a solve on the JAX package's own dual carried across
(``convert.stagewise_dual_from_numpy``), which separates the solve's parity
from the build's.  Bars as ``test_torch_stagewise_solve.py``: dual fields
within 1e-4 * max(1, |field|max) and the band equal; the same verdicts,
iterations within max(5, iters/5) rounded up to whole checks, U within
5e-3 * max(1, |U|max), Jp within 1e-3 * max(1, |Jp|).
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
H = 20
#: tests/test_stagewise.py's output-constrained cfg (erc = 1e-3: the
#: condensed comparator's own float32 floor there)
CFG = dict(max_iters=100_000, check_every=8, accel_every=4, y0=0.01,
           eaj=1e-3, erj=1e-5, erc=1e-3, eac=1e-3, strict_weak_duality=False)
X0 = np.array([[1.0, -1.0], [0.2, -0.3]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cls, plant, **extra):
    kw = dict(Qy=np.eye(1), R=0.05 * np.eye(1), r=np.full(1, 2.5),
              u_min=-np.ones(1), u_max=np.ones(1), du_max=0.5 * np.ones(1),
              y_min=np.full(1, -1.9), y_max=np.full(1, 1.9))
    kw.update(extra)
    return cls(plant, horizon=H, **kw)


#: name -> (spec extras, explicit band or None)
SPECS = {
    "y_bounds": ({}, None),
    "y_schedule": (dict(r=np.array([1.05]), y_min=None,
                        y_max=np.linspace(1.1, 0.75, H).reshape(H, 1)),
                   None),
    "band2": ({}, 2),
}
_JAX = {}


def _duals(case):
    extra, band = SPECS[case]
    if case not in _JAX:
        _JAX[case] = js.stagewise_dual(
            _spec(JSpec, jplants.double_integrator(), **extra), band=band)
    return _JAX[case], ts.stagewise_dual(
        _spec(MPCSpec, plants.double_integrator(), **extra), band=band,
        device=CPU)


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


def _assert_solve_parity(want, got, check_every):
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
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


def _solve_both(jsd, tsd, x0=X0, cfg=CFG):
    want = js.solve_stagewise(jsd, jnp.asarray(x0),
                              cfg=jpqp.SolverConfig(**cfg))
    got = ts.solve_stagewise(tsd, torch.from_numpy(x0),
                             cfg=tpqp.SolverConfig(**cfg))
    assert np.asarray(want.converged).all()
    _assert_solve_parity(want, got, cfg["check_every"])
    return got


@pytest.mark.parametrize("case", sorted(SPECS))
def test_stagewise_dual_matches_jax(case):
    jsd, tsd = _duals(case)
    assert tsd.band == jsd.band and tsd.n_con == jsd.n_con == 6 * H
    _assert_fields_close(convert.to_numpy(jsd), convert.to_numpy(tsd))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_output_bounded_solve_matches_jax(case):
    """The solve, and the bound honoured on the predicted outputs (and
    active from the first state).  The narrow band runs the second state
    only: its looser split takes 1.5-1.9x the full band's iterations (433
    against 281 there, 1,121 against 593 on the first state)."""
    jsd, tsd = _duals(case)
    x0 = X0[:, 1:] if case == "band2" else X0
    got = _solve_both(jsd, tsd, x0)
    xs = ts.rollout_states(tsd.factor, torch.from_numpy(x0),
                           got.U.reshape(H, 1, -1))
    y = xs[:, 0, :].numpy()
    y_max = tsd.y_max.numpy()                  # (H, 1) per stage
    assert (y <= y_max + 2e-3).all()
    if case == "y_bounds":
        assert y.max() > 1.85                  # the bound is active


def test_solve_on_the_jax_dual_carried_across():
    """The port's solve on the JAX package's own geometry: the solve's
    parity apart from the build's."""
    jsd, _ = _duals("y_bounds")
    carried = convert.stagewise_dual_from_numpy(convert.to_numpy(jsd),
                                                device=CPU)
    assert isinstance(carried.band, int) and carried.has_y
    _solve_both(jsd, carried)


def test_relinearize_matches_jax():
    """New per-stage dynamics under the same structure and a moved slew
    anchor: the port's relinearize (a tensor function, no host round trip)
    against JAX's, and a solve on each."""
    jsd, tsd = _duals("y_bounds")
    rng = np.random.default_rng(7)
    A = np.asarray(jsd.factor.A) + 0.01 * rng.standard_normal(
        (H, 2, 2)).astype(np.float32)
    B = (np.asarray(jsd.factor.Bm)
         * (1.0 + 0.1 * rng.uniform(size=(H, 1, 1)))).astype(np.float32)
    up = np.array([0.3], np.float32)
    want = js.relinearize(jsd, jnp.asarray(A), jnp.asarray(B),
                          u_prev=jnp.asarray(up))
    got = ts.relinearize(tsd, torch.from_numpy(A), torch.from_numpy(B),
                         u_prev=torch.from_numpy(up))
    assert got.band == want.band
    _assert_fields_close(convert.to_numpy(want), convert.to_numpy(got))
    _solve_both(want, got)
