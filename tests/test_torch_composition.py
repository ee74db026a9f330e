"""The production stack (``tests/test_composition.py``) on the port: robust
tube tightening, offset-free estimation and targets, a known-disturbance
preview and ``retry_cold`` in one ``OffsetFreeController.rollout_jit``,
against the JAX package's loop, on the CPU and on both backends.

The plant is the double integrator with a real disturbance channel (E =
[0.005, 0.1]'), H = 20, |u| <= 3, |du| <= 3, y <= 1; the spec is
``robust_spec(spec(r=0.92), 1.3 * W_BOX)``; the truth sees box-corner
process noise switching every 8 steps, a 0.5 sin(0.15 t) forecast through
E and a constant unmeasured input disturbance 0.4, over 80 steps.

Bars: those of ``tests/test_torch_offset_free.py`` (u, d_hat and y within
5e-3 * scale per step, verdicts equal, iterations within the oracle bar on
3/4 of the steps — measured 64 and 77 of 80 — and the mean within 10%),
then tests/test_composition.py's guarantees on the port's trajectory:
every step certified, the ORIGINAL bound y <= 1 held (1e-4; 1e-3 on the
stage-wise backend, as there), d_hat's mean over the last 16 steps within
0.02 of 0.4 (condensed), the mean output over the last 42 steps within 0.02
of r and above 0.82.  Without the tightening the same loop crosses the
bound (> 1 + 3e-3), in both packages.
"""

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu import models as jmodels
from pqp_for_mpc_tpu_torch import models as tmodels

from test_torch_offset_free import assert_loop_parity

W_BOX = np.array([0.003, 0.012])
STEPS = 80
R_TIGHT = 0.92


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(m, r, tight):
    dt = 0.1
    plant = m.LinearPlant(A=np.array([[1, dt], [0, 1]], np.float32),
                          B=np.array([[0.5 * dt * dt], [dt]], np.float32),
                          E=np.array([[0.005], [0.1]], np.float32),
                          C=np.array([[1.0, 0.0]], np.float32), name="di_e")
    spec = m.MPCSpec(plant=plant, horizon=20,
                     Qy=np.eye(1, dtype=np.float32),
                     R=0.05 * np.eye(1, dtype=np.float32),
                     r=np.array([r], np.float32),
                     u_min=np.array([-3.0], np.float32),
                     u_max=np.array([3.0], np.float32),
                     du_max=np.array([3.0], np.float32),
                     y_max=np.array([1.0], np.float32))
    return m.robust_spec(spec, 1.3 * W_BOX) if tight else spec


def _disturbances(H=20):
    t = np.arange(STEPS)
    blocks = np.where((t // 8) % 2 == 0, 1.0, -1.0)[:, None]
    w_seq = (blocks * W_BOX[None, :]).astype(np.float32)
    d_fc = (0.5 * np.sin(0.15 * np.arange(STEPS + H)))[:, None]
    return w_seq, d_fc.astype(np.float32), np.array([0.4], np.float32)


def _stack(m, backend, r=R_TIGHT, tight=True):
    kw = dict(kind="input", retry_cold=True, backend=backend)
    if m is tmodels:
        kw["device"] = "cpu"
    ctrl = m.OffsetFreeController(_spec(m, r, tight), **kw)
    w_seq, d_fc, d_true = _disturbances()
    return ctrl.rollout_jit(np.zeros(2, np.float32), STEPS, d_true,
                            w_seq=w_seq, d_forecast=d_fc)


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_production_stack_matches_jax_and_holds_its_guarantees(backend):
    got = _stack(tmodels, backend)
    assert_loop_parity(got, _stack(jmodels, backend))
    y = got["x"][:, 0]
    assert got["converged"].all()
    assert y.max() <= 1.0 + (1e-4 if backend == "condensed" else 1e-3), \
        y.max()
    if backend == "condensed":
        np.testing.assert_allclose(got["d_hat"][-16:].mean(), 0.4,
                                   atol=0.02)
    assert abs(y[-42:].mean() - R_TIGHT) < 0.02, y[-42:].mean()
    assert y[-42:].min() > 0.82


def test_nominal_stack_violates_where_tightened_does_not():
    """tests/test_composition.py's contrast on the port: without the tube
    the worst-case disturbance pushes y over the ORIGINAL bound."""
    out = _stack(tmodels, "condensed", r=0.95, tight=False)
    assert out["converged"].all()
    assert out["x"][:, 0].max() > 1.0 + 3e-3, out["x"][:, 0].max()
