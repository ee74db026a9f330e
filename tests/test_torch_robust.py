"""The port's robust constraint tightening (``models/robust.py``) against
the JAX package's, and its closed loops under a worst-case disturbance, on
the CPU.

The margins are a float64 NumPy host build in both packages, so
``lqr_gain``, ``tube_margins`` and every bound of ``robust_spec`` must be
EQUAL.  The loops are those of ``tests/test_robust.py`` (lines 64 and 144,
H <= 32): under the adversarial disturbance w = w_box on every step the
nominal loop crosses the output bound y <= 1 and the tightened loop never
does (1e-4 of certification slack), on the condensed and the stage-wise
backend, and ``rollout_jit(w_seq=...)`` is the host loop's
``rollout(noise=...)`` to 1e-3 on both.
"""

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu.models import MPCSpec as JSpec
from pqp_for_mpc_tpu.models import lqr_gain as j_lqr_gain
from pqp_for_mpc_tpu.models import plants as jplants
from pqp_for_mpc_tpu.models import robust_spec as j_robust_spec
from pqp_for_mpc_tpu.models import tube_margins as j_tube_margins
from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec, lqr_gain,
                                          plants, robust_spec, tube_margins)

W_BOX = np.array([0.005, 0.02])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(cls, plant, H, **kw):
    args = dict(Qy=np.eye(1, dtype=np.float32),
                R=0.05 * np.eye(1, dtype=np.float32),
                r=np.array([0.95], np.float32),
                u_min=np.array([-1.0], np.float32),
                u_max=np.array([1.0], np.float32),
                du_max=np.array([0.5], np.float32))
    args.update(kw)
    return cls(plant, horizon=H, **args)


def _loop_spec(cls, m, H):
    """tests/test_robust.py's adversarial spec: y <= 1, wide input box."""
    return _spec(cls, m.double_integrator(), H,
                 y_max=np.array([1.0], np.float32),
                 u_min=np.array([-2.0], np.float32),
                 u_max=np.array([2.0], np.float32),
                 du_max=np.array([2.0], np.float32))


@pytest.mark.parametrize("plant", ["double_integrator", "mass_spring_damper"])
def test_margins_equal_jax(plant):
    jp, tp = getattr(jplants, plant)(), getattr(plants, plant)()
    nu, ny = tp.n_input, tp.n_output
    K = lqr_gain(tp, np.eye(ny), 0.05 * np.eye(nu))
    np.testing.assert_array_equal(K, j_lqr_gain(jp, np.eye(ny),
                                                0.05 * np.eye(nu)))
    w = np.linspace(0.002, 0.01, tp.n_state)
    for got, want in zip(tube_margins(tp, K, w, 12),
                         j_tube_margins(jp, K, w, 12)):
        np.testing.assert_array_equal(got, want)
    m_u, m_y = tube_margins(tp, K, w, 12)
    assert (m_u[0] == 0).all() and (m_y[0] == 0).all()
    np.testing.assert_allclose(m_y[1], np.abs(tp.C) @ w, atol=1e-12)


@pytest.mark.parametrize("case", ["inputs", "y_max", "y_both_slack"])
def test_robust_spec_equals_jax(case):
    extra = {"inputs": {},
             "y_max": dict(y_max=np.array([1.0], np.float32)),
             "y_both_slack": dict(y_max=np.array([1.0], np.float32),
                                  y_min=np.array([-1.0], np.float32))}[case]
    slack = 5e-4 if case == "y_both_slack" else 0.0
    want = j_robust_spec(_spec(JSpec, jplants.double_integrator(), 12,
                               **extra), W_BOX * 0.2, slack=slack)
    got = robust_spec(_spec(MPCSpec, plants.double_integrator(), 12,
                            **extra), W_BOX * 0.2, slack=slack)
    for f in ("u_min", "u_max", "du_max", "y_min", "y_max"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.u_max.shape == (12, 1)
    assert got.u_max[0, 0] == 1.0 - slack     # e_0 = 0: no tube margin


def test_impossible_tightening_raises_like_jax():
    for fn, cls, m in ((robust_spec, MPCSpec, plants),
                       (j_robust_spec, JSpec, jplants)):
        with pytest.raises(ValueError, match="consume"):
            fn(_spec(cls, m.double_integrator(), 40), np.array([0.5, 2.0]))
    with pytest.raises(ValueError, match="w_box"):
        robust_spec(_spec(MPCSpec, plants.double_integrator(), 8),
                    np.array([0.1]))


def test_robust_loop_respects_bound_under_worst_case():
    """tests/test_robust.py:64 (condensed, H=24, 50 steps)."""
    spec = _loop_spec(MPCSpec, plants, 24)
    noise = lambda t: W_BOX.astype(np.float32)
    x0 = np.zeros(2, np.float32)
    out_n = MPCController(spec, warm_start="shift", device="cpu").rollout(
        x0, 50, noise=noise)
    assert out_n["x"][:, 0].max() > 1.0 + 1e-4       # nominal is pushed over
    tight = MPCController(robust_spec(spec, W_BOX), warm_start="shift",
                          device="cpu")
    out_r = tight.rollout(x0, 50, noise=noise)
    assert out_r["converged"].all()
    assert out_r["x"][:, 0].max() <= 1.0 + 1e-4, out_r["x"][:, 0].max()
    assert out_r["x"][-1, 0] > 0.85                  # and still tracks


def test_robust_loop_stagewise_respects_bound():
    """tests/test_robust.py:144 (stage-wise, H=32, 40 steps)."""
    spec = robust_spec(_loop_spec(MPCSpec, plants, 32), W_BOX)
    tight = MPCController(spec, backend="stagewise", warm_start="shift",
                          device="cpu")
    out_r = tight.rollout(np.zeros(2, np.float32), 40,
                          noise=lambda t: W_BOX.astype(np.float32))
    assert out_r["converged"].all()
    assert out_r["x"][:, 0].max() <= 1.0 + 1e-4, out_r["x"][:, 0].max()
    assert out_r["x"][-1, 0] > 0.85


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_rollout_jit_w_seq_matches_eager_noise(backend):
    """tests/test_robust.py:161 on the port: the device loop's process
    disturbance is the host loop's noise."""
    spec = robust_spec(_loop_spec(MPCSpec, plants, 16), W_BOX)
    steps = 12
    w_seq = np.broadcast_to(W_BOX.astype(np.float32), (steps, 2)).copy()
    jit_out = MPCController(spec, backend=backend, warm_start="shift",
                            device="cpu").rollout_jit(
        np.zeros(2, np.float32), steps, w_seq=w_seq)
    eager = MPCController(spec, backend=backend, warm_start="shift",
                          device="cpu").rollout(
        np.zeros(2, np.float32), steps, noise=lambda t: W_BOX)
    np.testing.assert_allclose(jit_out["x"], eager["x"], rtol=1e-3,
                               atol=1e-3)
    assert jit_out["x"][:, 0].max() <= 1.0 + 1e-4
