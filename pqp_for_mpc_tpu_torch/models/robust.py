"""Robust constraint-tightening MPC (tube margins on bound schedules).

A copy of ``pqp_for_mpc_tpu/models/robust.py`` on this port's
:class:`~pqp_for_mpc_tpu_torch.models.mpc.MPCSpec` (NumPy only; importing
the JAX module would import JAX).  A persistent bounded disturbance
``|w_i| <= w_box_i`` walks the real state off the nominal prediction; the
rigid-tube tightening (Chisci, Rossiter & Zappa 2001) shrinks the stage-k
bounds by the worst-case k-step error the ancillary feedback ``u = v + K e``
can accumulate:

    e_{k+1} = (A + B K) e_k + w_k,   e_0 = 0   (re-anchored each solve)
    margin_u(k) = support of K . sum_j Phi^j W     (input rows)
    margin_y(k) = support of C . sum_j Phi^j W     (output rows)

The margins are exact box supports, built in float64 on the host, and land
as the spec's per-stage bound schedules (``u_min/u_max/du_max`` as
``(H, nu)``, ``y_min/y_max`` as ``(H, ny)``), so every controller feature and
both backends apply unchanged.  Each step re-anchors at the measured state,
so the realized trajectory respects the ORIGINAL bounds for every admissible
disturbance sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pqp_for_mpc_tpu_torch.models.mpc import MPCSpec, dare_terminal_weight
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant


def lqr_gain(plant: LinearPlant, Qy, R) -> np.ndarray:
    """Infinite-horizon LQR feedback ``K (nu, ns)`` for the tracking cost
    (``u = K x`` stabilizes ``A + B K``), the standard ancillary gain for
    the tube; float64 host build through :func:`dare_terminal_weight`."""
    P = np.asarray(dare_terminal_weight(plant, Qy, R), np.float64)
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    R64 = np.asarray(R, np.float64)
    return (-np.linalg.solve(R64 + B.T @ P @ B, B.T @ P @ A)).astype(
        np.float32)


def tube_margins(plant: LinearPlant, K, w_box, H: int):
    """Per-stage worst-case error margins under ``u = v + K e`` and
    ``|w_i| <= w_box_i`` additive state disturbance.

    Returns ``(m_u (H, nu), m_y (H+1, ny))``: ``m_u[k]`` bounds ``|K e_k|``
    componentwise (e_0 = 0), ``m_y[k]`` bounds ``|C e_k|`` (the output rows
    constrain x_1..x_H, i.e. ``m_y[1..H]``)."""
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    K = np.asarray(K, np.float64)
    w = np.asarray(w_box, np.float64).reshape(-1)
    if w.shape != (plant.n_state,):
        raise ValueError(f"w_box must be ({plant.n_state},) state-noise "
                         f"half-widths, got {w.shape}")
    Phi = A + B @ K
    nu, ny, ns = plant.n_input, plant.n_output, plant.n_state
    m_u = np.zeros((H, nu))
    m_y = np.zeros((H + 1, ny))
    # su/sy accumulate sum_j |row . Phi^j| w — exact box supports
    Pj = np.eye(ns)
    su = np.zeros(nu)
    sy = np.zeros(ny)
    for k in range(1, H + 1):
        su = su + np.abs(K @ Pj) @ w          # adds the j = k-1 term
        sy = sy + np.abs(C @ Pj) @ w
        if k < H:
            m_u[k] = su
        m_y[k] = sy
        Pj = Phi @ Pj
    return m_u, m_y


def robust_spec(spec: MPCSpec, w_box, K=None,
                slack: float = 0.0) -> MPCSpec:
    """Tighten ``spec``'s bounds into the constraint-tightening robust MPC
    problem for additive state disturbances ``|w_i| <= w_box_i``.

    ``K`` — ancillary feedback; default = the LQR gain for the spec's own
    (Qy, R) (stage-0 weights if schedules).  Raises if the margins consume
    a bound entirely.  ``slack`` — extra constant margin on every bound,
    covering the QP certification slack ``max(erc*|Kp|, eac)`` by which a
    loop riding the tightened bound can exceed the original one."""
    plant, H = spec.plant, spec.horizon
    if np.asarray(plant.A).ndim == 3:
        raise NotImplementedError("robust tightening needs an LTI plant")
    if spec.moves is not None:
        raise NotImplementedError("compose tightening BEFORE blocking is "
                                  "unsupported (margins are per stage)")
    nu, ny = plant.n_input, plant.n_output
    if K is None:
        Qy = np.asarray(spec.Qy, np.float64)
        R = np.asarray(spec.R, np.float64)
        K = lqr_gain(plant, Qy[0] if Qy.ndim == 3 else Qy,
                     R[0] if R.ndim == 3 else R)
    m_u, m_y = tube_margins(plant, K, w_box, H)
    if slack:
        m_u = m_u + float(slack)
        m_y = m_y + float(slack)

    def stack(v, n):
        a = np.asarray(v, np.float64)
        return a if a.ndim == 2 else np.broadcast_to(a, (H, n)).copy()

    u_min = stack(spec.u_min, nu) + m_u
    u_max = stack(spec.u_max, nu) - m_u
    if (u_max <= u_min).any():
        raise ValueError("input margins consume the bound: disturbance "
                         "too large for this horizon/gain")
    # slew rows couple consecutive errors: |du real - du nominal|
    # <= |K e_k| + |K e_{k-1}|
    m_du = m_u + np.vstack([np.zeros((1, nu)), m_u[:-1]])
    du_max = stack(spec.du_max, nu) - m_du
    if (du_max <= 0).any():
        raise ValueError("slew margins consume the bound")
    kw = dict(u_min=u_min.astype(np.float32),
              u_max=u_max.astype(np.float32),
              du_max=du_max.astype(np.float32))
    if spec.y_max is not None:
        y_max = stack(spec.y_max, ny) - m_y[1:]
        if spec.y_min is not None and (
                y_max <= stack(spec.y_min, ny) + m_y[1:]).any():
            raise ValueError("output margins consume the bound")
        kw["y_max"] = y_max.astype(np.float32)
    if spec.y_min is not None:
        kw["y_min"] = (stack(spec.y_min, ny) + m_y[1:]).astype(np.float32)
    return dataclasses.replace(spec, **kw)
