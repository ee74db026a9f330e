"""The plain reference of a ``condensed_mpc`` configuration: the tracking
MPC QP condensed from the configuration's numbers, in float64 PyTorch.

For the LTI plant ``x+ = A x + B u`` (``y = C x``) over ``H`` steps, with
``X = Sx x0 + Su U`` the states x_1..x_H:

    J(U) = sum_k (y_k - r)'Qy(y_k - r) + u_k'R u_k
         = 1/2 U'Qp U + Fp'U + 1/2 Mp,
    Qp = 2 (CSu'Qbar CSu + Rbar),  Fp = 2 CSu'Qbar c,  Mp = 2 c'Qbar c,
    c  = CSx x0 - rbar,

under the box and slew rows ``[I; -I; T; -T] U <= [u_max; -u_min;
du_max + e1 u_prev; du_max - e1 u_prev]`` (``T`` the first difference).
Imports nothing of the program.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _t(a, device):
    return torch.as_tensor(a, dtype=F64, device=device)


def qp(conf: dict, lanes: dict, device):
    """(Qp, Gp, Fp, Kp, Mp) in float64 for the lanes' ``x0`` (ns, B) and
    ``u_prev`` (nu, B)."""
    p = conf["plant"]
    A, Bm, C = _t(p["A"], device), _t(p["B"], device), _t(p["C"], device)
    H = conf["horizon"]
    ns, nu = Bm.shape
    ny = C.shape[0]
    x0 = lanes["x0"].to(device, F64)
    u_prev = lanes["u_prev"].to(device, F64)
    powers = [torch.eye(ns, dtype=F64, device=device)]
    for _ in range(H):
        powers.append(A @ powers[-1])
    Sx = torch.cat(powers[1:], dim=0)                         # (H ns, ns)
    Su = torch.zeros(H * ns, H * nu, dtype=F64, device=device)
    for k in range(H):                                        # x_{k+1}
        for j in range(k + 1):
            Su[k * ns:(k + 1) * ns, j * nu:(j + 1) * nu] = \
                powers[k - j] @ Bm
    eye_h = torch.eye(H, dtype=F64, device=device)
    Cs = torch.kron(eye_h, C)
    Qbar = torch.kron(eye_h, _t(conf["Qy"], device))
    Rbar = torch.kron(eye_h, _t(conf["R"], device))
    rbar = _t(conf["r"], device).repeat(H)
    CSu, CSx = Cs @ Su, Cs @ Sx
    Qp = 2.0 * (CSu.T @ Qbar @ CSu + Rbar)
    c = CSx @ x0 - rbar[:, None]
    Fp = 2.0 * CSu.T @ (Qbar @ c)
    Mp = 2.0 * (c * (Qbar @ c)).sum(0)
    M = H * nu
    eye = torch.eye(M, dtype=F64, device=device)
    T = eye - torch.diag(torch.ones(M - nu, dtype=F64, device=device), -nu)
    Gp = torch.cat([eye, -eye, T, -T], dim=0)
    rep = lambda v: _t(v, device).repeat(H)[:, None].expand(M, x0.shape[1])
    e1u = torch.zeros(M, x0.shape[1], dtype=F64, device=device)
    e1u[:nu] = u_prev
    du = rep(conf["du_max"])
    Kp = torch.cat([rep(conf["u_max"]), -rep(conf["u_min"]), du + e1u,
                    du - e1u], dim=0)
    return Qp, Gp, Fp, Kp, Mp


def scale(conf: dict, U_ref: torch.Tensor) -> torch.Tensor:
    """Per lane, what an error in U is measured against: the larger of the
    lane's largest input and the largest input bound."""
    bound = max(max(abs(v) for v in conf["u_min"]),
                max(abs(v) for v in conf["u_max"]))
    return torch.clamp(U_ref.abs().amax(0), min=bound)
