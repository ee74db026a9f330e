"""QP problem containers (frozen dataclasses of tensors).

The PyTorch counterpart of ``pqp_for_mpc_tpu/problem.py``: the same three
containers with the same fields, holding ``torch.Tensor`` in place of JAX
arrays.

* :class:`CondensedMPCData` — the 16-matrix condensed-MPC instance the
  reference reads from ``example/*.txt`` (``PQP_CPU.c:757-930``).
* :class:`PrimalQP` — the assembled primal QP
  ``min 1/2 U'Qp U + Fp'U + 1/2 Mp  s.t.  Gp U <= Kp`` (``PQP_CPU.c:5-6``).
* :class:`DualQP` — its non-negative dual plus the precomputed PQP split
  (Qd^+ + theta, Qd^- + theta, Fd^+, Fd^-), ref ``PQP_CPU.c:503-537,703-708``.

Shapes keep the JAX package's batch-last layout: ``M`` primal variables,
``N`` constraints (the dual dimension), ``Y: (N, B)``, ``Fp: (M, B)``.
Every tensor of one container lives on one device; functions take the
device from their inputs.  Entry points that build tensors from host data
(``models.condense``, ``models.MPCController``, ``convert.*_from_numpy``)
place them on the card unless the caller asks for the CPU
(:func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.utils import tracing


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device``, or ``"cuda"`` when
    it is ``None``.  A CUDA device without a card raises instead of
    quietly running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested (the default) but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class PrimalQP:
    """Primal QP:  min_U 1/2 U'Qp U + Fp'U + 1/2 Mp   s.t.  Gp U <= Kp.

    ``Qp_inv`` is carried alongside ``Qp`` because both the dualization
    (``convertToDual``, PQP_CPU.c:489-498) and the primal recovery
    (``computeUfromY``, PQP_CPU.c:352-360) consume the inverse, while the
    primal cost (``computeCost``, PQP_CPU.c:648-666) consumes Qp itself.
    """

    Qp: Optional[torch.Tensor]   # (M, M), or (B, M, M) distinct
    Qp_inv: torch.Tensor         # like Qp
    Fp: torch.Tensor             # (M,) or (M, B)
    Mp: torch.Tensor             # () or (B,)
    Gp: torch.Tensor             # (N, M), or (B, N, M) distinct
    Kp: torch.Tensor             # (N,) or (N, B)

    def qp(self) -> torch.Tensor:
        """The stored ``Qp`` when present, else the inverse of ``Qp_inv``."""
        return torch.linalg.inv(self.Qp_inv) if self.Qp is None else self.Qp

    @property
    def n_var(self) -> int:
        return self.Gp.shape[-1]

    @property
    def n_con(self) -> int:
        return self.Gp.shape[-2]


@dataclasses.dataclass(frozen=True)
class DualQP:
    """Dual QP  min_{Y>=0} 1/2 Y'Qd Y + Fd'Y + 1/2 Md  with the PQP split.

    Built by :func:`pqp_for_mpc_tpu_torch.dual.dualize`; the fields are
    those of the JAX ``DualQP`` (see its docstring for the formulas).
    ``Qdp_theta``/``Qdn_theta`` are ``None`` for a split-free dual
    (``dualize(materialize_splits=False)``).  A distinct-geometry batch
    (:func:`~pqp_for_mpc_tpu_torch.dual.dualize_distinct`) carries its
    matrices with a leading batch axis and its vectors with a trailing one.
    """

    Qd: torch.Tensor                    # (N, N), or (B, N, N) distinct
    Fd: torch.Tensor                    # (N,) or (N, B)
    Md: torch.Tensor                    # () or (B,)
    theta: torch.Tensor                 # (N,), or (B, N) distinct
    Qdp_theta: Optional[torch.Tensor]   # like Qd, or None
    Qdn_theta: Optional[torch.Tensor]   # like Qd, or None
    Fdp: torch.Tensor                   # like Fd
    Fdn: torch.Tensor                   # like Fd

    @property
    def n_con(self) -> int:
        return self.Qd.shape[-1]


@dataclasses.dataclass(frozen=True)
class CondensedMPCData:
    """A condensed-MPC instance in math orientation.

    ``assemble(x, D)`` builds the :class:`PrimalQP`:

    * ``Fp = Fp1 D + Fp2 x - Fp3``           (computeFp, PQP_CPU.c:373-382)
    * ``Mp`` per computeMp's actual arithmetic (PQP_CPU.c:395-428): every
      assembled term carries +1/2, as in the reference code.
    * ``Kp(x, D) = Kp + Kx x + Kd D`` when output constraints are present.
    """

    Qp_inv: torch.Tensor   # (M, M)
    Fp1: torch.Tensor      # (M, nDis)
    Fp2: torch.Tensor      # (M, nState)
    Fp3: torch.Tensor      # (M,)
    Mp1: torch.Tensor      # (nState, nState)
    Mp2: torch.Tensor      # (nDis, nState)
    Mp3: torch.Tensor      # (nDis, nDis)
    Mp4: torch.Tensor      # (nState,)
    Mp5: torch.Tensor      # (nDis,)
    Mp6: torch.Tensor      # ()
    Gp: torch.Tensor       # (N, M)
    Kp: torch.Tensor       # (N,)
    Z: torch.Tensor        # (nOutput, nState) — file-format parity only
    ThetaOut: torch.Tensor  # (nOutput, nDis) — file-format parity only
    x: torch.Tensor        # (nState,)
    D: torch.Tensor        # (nDis,)
    Kx: Optional[torch.Tensor] = None   # (N, nState)
    Kd: Optional[torch.Tensor] = None   # (N, H*nDis)
    Qp: Optional[torch.Tensor] = None   # (M, M), exactly built when present

    def qp(self) -> torch.Tensor:
        """The stored exactly-built ``Qp`` when present, else the inverse of
        ``Qp_inv`` (the reference's Gauss_Jordan step, PQP_CPU.c:989)."""
        return torch.linalg.inv(self.Qp_inv) if self.Qp is None else self.Qp

    @property
    def n_var(self) -> int:
        return self.Gp.shape[-1]

    @property
    def n_con(self) -> int:
        return self.Gp.shape[-2]

    def assemble(self, x: Optional[torch.Tensor] = None,
                 D: Optional[torch.Tensor] = None,
                 Qp: Optional[torch.Tensor] = None,
                 precision=None) -> PrimalQP:
        """Build the PrimalQP for state ``x`` / disturbance ``D``.

        Batched: ``x`` may be ``(nState, B)`` and/or ``D`` ``(nDis, B)``;
        then ``Fp`` is ``(M, B)`` and ``Mp`` is ``(B,)``.  ``precision`` is
        accepted for the JAX signature and ignored (full float32).
        """
        with tracing.span("build.assemble", device=self.Gp):
            x = self.x if x is None else x
            D = self.D if D is None else D
            batched = x.dim() == 2 or D.dim() == 2
            xc = x if x.dim() == 2 else x[:, None]          # (nState, B)
            Dc = D if D.dim() == 2 else D[:, None]          # (nDis, B)
            if xc.shape[-1] != Dc.shape[-1]:
                b = max(xc.shape[-1], Dc.shape[-1])
                xc = xc.expand(xc.shape[0], b)
                Dc = Dc.expand(Dc.shape[0], b)

            # Fp = Fp1 D + Fp2 x - Fp3            (PQP_CPU.c:373-382)
            Fp = self.Fp1 @ Dc + self.Fp2 @ xc - self.Fp3[:, None]
            # Mp per computeMp's actual arithmetic (PQP_CPU.c:395-428)
            xMp1x = torch.einsum("sb,st,tb->b", xc, self.Mp1, xc)
            DMp2x = torch.einsum("db,ds,sb->b", Dc, self.Mp2, xc)
            Mp4x = (self.Mp4[None, :] @ xc)[0]
            DMp3D = torch.einsum("db,de,eb->b", Dc, self.Mp3, Dc)
            Mp5D = (self.Mp5[None, :] @ Dc)[0]
            Mp = 0.5 * (xMp1x + DMp2x + Mp4x + DMp3D + Mp5D + self.Mp6)

            if Qp is None:
                Qp = self.qp()
            Kp = self.Kp
            if self.Kx is not None:
                Kp = Kp[:, None] + self.Kx @ xc
                if self.Kd is not None:
                    Kp = Kp + self.Kd @ Dc
                if not batched:
                    Kp = Kp[:, 0]
            if not batched:
                Fp = Fp[:, 0]
                Mp = Mp[0]
            return PrimalQP(Qp=Qp, Qp_inv=self.Qp_inv, Fp=Fp, Mp=Mp,
                            Gp=self.Gp, Kp=Kp)
