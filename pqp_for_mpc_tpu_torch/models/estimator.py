"""Steady-state Kalman filtering for output-feedback MPC.

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/estimator.py``.  Real
plants expose measurements ``y = C x + v``; closing the MPC loop then needs
a state estimator.  The standard LTI answer is the steady-state Kalman
filter, split as the rest of the package splits its work:

* the GAIN is computed ONCE per plant on the HOST in float64 (value
  iteration on the filter DARE; the JAX package's NumPy code, copied);
* the per-step update is a pure tensor function on the filter's device —
  one tiny matmul chain — so it drops into the same device loops as the
  controllers (estimate → solve → actuate → measure).

Predict/correct form (current estimator):

    x_pred = A x_hat + B u
    x_hat+ = x_pred + L (y_next - C x_pred)

with ``L = P C' (C P C' + Rv)^-1`` and ``P`` the unique stabilizing
solution of the filter DARE
``P = A (P - P C'(C P C'+Rv)^-1 C P) A' + Qw``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.problem import resolve_device


def filter_dare(A, C, Qw, Rv, max_iters: int = 10_000,
                tol: float = 1e-12) -> np.ndarray:
    """Steady-state one-step prediction covariance ``P (ns, ns)`` —
    float64 value iteration on the filter DARE
    ``P = A (P - P C'(C P C'+Rv)^-1 C P) A' + Qw`` (host-side, once
    per plant).  Single source of truth for :func:`kalman_gain` and
    the MHE arrival priors (models/mhe.py); raises on non-convergence
    instead of silently returning a miscalibrated prior."""
    A = np.asarray(A, np.float64)
    C = np.asarray(C, np.float64)
    Qw = np.asarray(Qw, np.float64)
    Rv = np.asarray(Rv, np.float64)
    P = Qw.copy()
    for _ in range(max_iters):
        S = C @ P @ C.T + Rv
        K = np.linalg.solve(S, C @ P).T          # P C' S^-1
        P_next = A @ (P - K @ C @ P) @ A.T + Qw
        P_next = 0.5 * (P_next + P_next.T)
        if np.abs(P_next - P).max() <= tol * max(1.0, np.abs(P).max()):
            return P_next
        P = P_next
    raise ValueError("filter DARE value iteration did not converge "
                     "(undetectable (A, C)?)")


def kalman_gain(plant: LinearPlant, Qw, Rv,
                max_iters: int = 10_000,
                tol: float = 1e-12) -> np.ndarray:
    """Steady-state Kalman gain ``L (ns, ny)`` (float32 NumPy) for
    ``x+ = A x + B u + w``, ``y = C x + v`` with ``cov(w) = Qw``,
    ``cov(v) = Rv`` (:func:`filter_dare` + one solve).  LTI only."""
    A = np.asarray(plant.A, np.float64)
    C = np.asarray(plant.C, np.float64)
    if A.ndim != 2:
        raise ValueError("kalman_gain needs an LTI plant")
    Rv = np.asarray(Rv, np.float64)
    P = filter_dare(A, C, Qw, Rv, max_iters=max_iters, tol=tol)
    S = C @ P @ C.T + Rv
    return np.linalg.solve(S, C @ P).T.astype(np.float32)


class KalmanFilter:
    """Steady-state Kalman filter whose :meth:`step` is a pure tensor
    function on ``device`` (default CUDA; without a card that raises — pass
    ``device="cpu"``).  ``L`` overrides the computed gain (e.g. one carried
    across from another build)."""

    def __init__(self, plant: LinearPlant, Qw, Rv,
                 L: Optional[np.ndarray] = None, device=None):
        self.plant = plant
        self.device = resolve_device(device)
        f32 = lambda m: torch.tensor(np.asarray(m, np.float32),
                                     device=self.device)
        self.L = f32(L if L is not None else kalman_gain(plant, Qw, Rv))
        self._A = f32(plant.A)
        self._B = f32(plant.B)
        self._E = f32(plant.E)
        self._C = f32(plant.C)

    def step(self, x_hat: torch.Tensor, u: torch.Tensor,
             y_next: torch.Tensor,
             d: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One predict/correct update (see module docstring), on tensors on
        the filter's device.  ``d``: optional KNOWN disturbance through the
        plant's E channel (disturbance-preview loops feed the previewed
        value here so the prediction does not misattribute it to estimation
        error)."""
        x_pred = self._A @ x_hat + self._B @ u
        if d is not None:
            x_pred = x_pred + self._E @ d
        return x_pred + self.L @ (y_next - self._C @ x_pred)
