"""Primal -> dual transform and the PQP matrix splits.

The PyTorch counterpart of ``pqp_for_mpc_tpu/dual.py``: the reference's
problem-build layer (``convertToDual`` PQP_CPU.c:489-498, ``computeTheta``
PQP_CPU.c:503-519, ``computeQdp_theta``/``computeQdn_theta``
PQP_CPU.c:524-537 and the Fd split at PQP_CPU.c:703-704).  A handful of
matrix products and elementwise splits, left to PyTorch; no kernel here.
``precision`` is accepted for the JAX signature; products run in full
float32 (TF32 stays off).
"""

from __future__ import annotations

import torch

from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu_torch.utils import tracing


def dualize(primal: PrimalQP, theta_floor: float = 5.0,
            precision: str = "highest",
            materialize_splits: bool = True) -> DualQP:
    """Build the non-negative dual QP and its PQP split from the primal.

    * ``Qd = Gp Qp^-1 Gp'``        (computeQd, PQP_CPU.c:440-443)
    * ``Fd = Gp Qp^-1 Fp + Kp``    (computeFd, PQP_CPU.c:456-460)
    * ``Md = Fp' Qp^-1 Fp - Mp``   (computeMd, PQP_CPU.c:472-479)
    * ``theta_i = max(rowsum(max(0,-Qd))_i, theta_floor)``
    * ``Qd^{+/-} + theta`` and ``Fd^{+/-}`` elementwise splits.

    ``materialize_splits=False`` leaves the two ``Qd^{+/-} + theta``
    matrices ``None``; :func:`~pqp_for_mpc_tpu_torch.solver.pqp_update`
    then builds the splits from ``Qd`` on the fly.
    """
    geom = dual_geometry(primal.Gp, primal.Qp_inv, theta_floor=theta_floor,
                         precision=precision,
                         materialize_splits=materialize_splits)
    return dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp,
                           precision=precision)


def dual_geometry(Gp: torch.Tensor, Qp_inv: torch.Tensor,
                  theta_floor: float = 5.0, precision: str = "highest",
                  materialize_splits: bool = True) -> dict:
    """The instance-invariant half of :func:`dualize`: ``GQi = Gp Qp^-1``,
    ``Qd``, ``theta`` and the Qd splits.  Compute once per geometry and
    reuse across steps and scenario batches via :func:`dualize_forcing`."""
    GQi = Gp @ Qp_inv                                      # (N, M)
    Qd = GQi @ Gp.T                                        # (N, N)
    Qd_neg = torch.clamp(-Qd, min=0.0)
    theta = torch.clamp(Qd_neg.sum(dim=1), min=theta_floor)
    if not materialize_splits:
        return dict(GQi=GQi, Qd=Qd, theta=theta,
                    Qdp_theta=None, Qdn_theta=None, Qp_inv=Qp_inv)
    eye_theta = torch.diag(theta)
    return dict(GQi=GQi, Qd=Qd, theta=theta,
                Qdp_theta=torch.clamp(Qd, min=0.0) + eye_theta,
                Qdn_theta=Qd_neg + eye_theta, Qp_inv=Qp_inv)


def dualize_forcing(geom: dict, Fp: torch.Tensor, Mp: torch.Tensor,
                    Kp: torch.Tensor, precision: str = "highest") -> DualQP:
    """The per-instance half of :func:`dualize`: ``Fd = GQi Fp + Kp``,
    ``Md = Fp'Qp^-1 Fp - Mp`` and the Fd split.  ``Fp`` may be ``(M,)`` or
    ``(M, B)``; ``Mp`` scalar or ``(B,)``."""
    with tracing.span("build.dualize_forcing", device=Fp):
        batched = Fp.dim() == 2 or Kp.dim() == 2
        Fp2 = Fp if Fp.dim() == 2 else Fp[:, None]
        Kp2 = Kp if Kp.dim() == 2 else Kp[:, None]
        Fd = geom["GQi"] @ Fp2 + Kp2
        QiF = geom["Qp_inv"] @ Fp2
        Md = (Fp2 * QiF).sum(dim=0) - Mp
        if not batched:
            Fd = Fd[:, 0]
            Md = Md[0] if Md.dim() else Md
        return DualQP(Qd=geom["Qd"], Fd=Fd, Md=Md, theta=geom["theta"],
                      Qdp_theta=geom["Qdp_theta"],
                      Qdn_theta=geom["Qdn_theta"],
                      Fdp=torch.clamp(Fd, min=0.0),
                      Fdn=torch.clamp(-Fd, min=0.0))


def dualize_distinct(primal: PrimalQP, theta_floor: float = 5.0,
                     precision: str = "highest",
                     materialize_splits: bool = True) -> DualQP:
    """:func:`dualize` for a batch of fully distinct instances, one random
    geometry each (the reference generator's workload,
    testing/test_generator.c:997-998).

    Matrices carry a LEADING batch axis (``Qp (B, M, M)``, ``Gp
    (B, N, M)``), vectors a TRAILING one (``Fp (M, B)`` or shared ``(M,)``,
    ``Kp (N, B)`` or shared ``(N,)``).  The result has ``Qd (B, N, N)``,
    ``theta (B, N)``, ``Fd (N, B)``, ``Md (B,)`` and, unless
    ``materialize_splits=False``, the splits ``Qd^{+/-} + theta``
    ``(B, N, N)``.
    """
    B = primal.Qp_inv.shape[0]
    N = primal.Gp.shape[1]
    M = primal.Gp.shape[2]
    Fp2 = primal.Fp if primal.Fp.dim() == 2 else \
        primal.Fp[:, None].expand(M, B)
    Kp2 = primal.Kp if primal.Kp.dim() == 2 else primal.Kp[:, None]
    GQi = torch.bmm(primal.Gp, primal.Qp_inv)                  # (B, N, M)
    Qd = torch.bmm(GQi, primal.Gp.transpose(1, 2))             # (B, N, N)
    theta = torch.clamp(torch.clamp(-Qd, min=0.0).sum(dim=2),
                        min=theta_floor)                       # (B, N)
    Fd = torch.einsum("bnm,mb->nb", GQi, Fp2) + Kp2
    QiF = torch.einsum("bmk,kb->mb", primal.Qp_inv, Fp2)
    Md = (Fp2 * QiF).sum(dim=0) - primal.Mp
    Qdp_theta = Qdn_theta = None
    if materialize_splits:
        eye = torch.eye(N, dtype=Qd.dtype, device=Qd.device)
        Qdp_theta = torch.clamp(Qd, min=0.0) + theta[:, :, None] * eye
        Qdn_theta = torch.clamp(-Qd, min=0.0) + theta[:, :, None] * eye
    return DualQP(Qd=Qd, Fd=Fd, Md=Md, theta=theta, Qdp_theta=Qdp_theta,
                  Qdn_theta=Qdn_theta, Fdp=torch.clamp(Fd, min=0.0),
                  Fdn=torch.clamp(-Fd, min=0.0))


def primal_from_dual(primal: PrimalQP, Y: torch.Tensor,
                     precision: str = "highest") -> torch.Tensor:
    """Recover the primal iterate ``U = -Qp^-1 (Fp + Gp' Y)``
    (computeUfromY, PQP_CPU.c:352-360).  ``Y`` may be ``(N,)`` or ``(N, B)``.
    """
    Yc = Y if Y.dim() == 2 else Y[:, None]
    Fp = primal.Fp if primal.Fp.dim() == 2 else primal.Fp[:, None]
    U = -(primal.Qp_inv @ (primal.Gp.T @ Yc + Fp))
    return U if Y.dim() == 2 else U[:, 0]
