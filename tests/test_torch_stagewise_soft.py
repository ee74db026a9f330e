"""The port's stage-wise dual and ``solve_stagewise`` with slack-softened
outputs (H=24) and a MIMO plant (H=10) against the JAX package, on the CPU
— the two remaining specs of ``tests/test_stagewise.py``.

Soft: the double integrator from x0 = [1.8, 0.5] cannot brake inside
y <= 1.9 under the slew-limited input (the hard dual diverges), so the soft
QP is the only well-posed form; the slack-borne Qd couplings are the
closed-form terms of ``_with_soft``.  MIMO: a 3-input/3-output
mass-spring-damper chain with output bounds, which exercises the band
tensors' (nu, nu), (nu, ny) and (ny, ny) blocks.  Bars as
``test_torch_stagewise_solve.py``: dual fields within
1e-4 * max(1, |field|max) and the band equal; the same verdicts,
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
#: tests/test_stagewise.py's cfg for both specs
CFG = dict(max_iters=100_000, check_every=8, accel_every=4, y0=0.01,
           eaj=1e-3, erj=1e-5, erc=1e-3, eac=1e-3, strict_weak_duality=False)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _soft(cls, m):
    return cls(m.double_integrator(), horizon=24, Qy=np.eye(1),
               R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
               u_max=np.ones(1), du_max=0.5 * np.ones(1),
               y_min=np.full(1, -1.9), y_max=np.full(1, 1.9),
               soft_penalty=50.0)


def _mimo(cls, m):
    return cls(m.mass_spring_damper(3), horizon=10, Qy=np.eye(3),
               R=0.05 * np.eye(3), r=np.array([0.3, -0.2, 0.1]),
               u_min=-np.ones(3), u_max=np.ones(3), du_max=0.4 * np.ones(3),
               y_min=np.full(3, -0.25), y_max=np.full(3, 0.25))


def _mimo_x0():
    # positions well inside the y-bound (it applies from stage 1)
    rng = np.random.default_rng(4)
    return np.concatenate([rng.uniform(-0.12, 0.12, (3, 2)),
                           rng.uniform(-0.3, 0.3, (3, 2))]).astype(np.float32)


#: name -> (spec maker (class, plants module) -> spec, x0, n_con)
CASES = {
    "soft_h24": (_soft, np.array([[1.8], [0.5]], np.float32), 4 * 24 + 4 * 24),
    "mimo_h10": (_mimo, _mimo_x0(), 4 * 10 * 3 + 2 * 10 * 3),
}
_JAX = {}


def _duals(case):
    make = CASES[case][0]
    if case not in _JAX:
        _JAX[case] = js.stagewise_dual(make(JSpec, jplants))
    return _JAX[case], ts.stagewise_dual(make(MPCSpec, plants), device=CPU)


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_stagewise_dual_matches_jax(case):
    jsd, tsd = _duals(case)
    assert tsd.band == jsd.band
    assert tsd.n_con == jsd.n_con == CASES[case][2]
    assert tsd.has_soft == jsd.has_soft == (case == "soft_h24")
    _assert_fields_close(convert.to_numpy(jsd), convert.to_numpy(tsd))


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case):
    jsd, tsd = _duals(case)
    x0 = CASES[case][1]
    want = js.solve_stagewise(jsd, jnp.asarray(x0),
                              cfg=jpqp.SolverConfig(**CFG))
    got = ts.solve_stagewise(tsd, torch.from_numpy(x0),
                             cfg=tpqp.SolverConfig(**CFG))
    conv = np.asarray(want.converged)
    assert conv.all()
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // CFG["check_every"]) * CFG["check_every"]
    assert (np.abs(got.iters.numpy() - it_w) <= bar).all(), \
        (got.iters.numpy(), it_w)
    U_w = np.asarray(want.U)
    np.testing.assert_allclose(got.U.numpy(), U_w, rtol=0,
                               atol=5e-3 * max(1.0, np.abs(U_w).max()))
    Jp_w = np.asarray(want.Jp)
    np.testing.assert_allclose(got.Jp.numpy(), Jp_w, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(Jp_w).max()))
    if case == "soft_h24":
        # the soft bound is exceeded: that is what the slack buys
        xs = ts.rollout_states(tsd.factor, torch.from_numpy(x0),
                               got.U.reshape(24, 1, 1))
        assert float(xs[:, 0, 0].max()) > 1.9
