"""Differentiable QP solving: gradients THROUGH the PQP solution.

The PyTorch counterpart of ``pqp_for_mpc_tpu/diff.py``.  The optimal
``U*(Qp, Fp, Gp, Kp)`` is a differentiable function by implicit
differentiation of the KKT conditions at the converged active set
``A = {i : y*_i > active_tol}``::

    Qp U* + Fp + Gp_A' y_A = 0
    Gp_A U*               = Kp_A

With inactive rows replaced by an identity block so shapes stay static, the
masked KKT matrix

    K = [[Qp,        Gp' D_a],
         [D_a Gp,    -(I - D_a)]],     D_a = diag(active mask)

gives the vector-Jacobian product of ``U*`` as one linear solve with ``K'``
(the OptNet construction).  The forward pass is the PQP solver
(``dualize`` then ``solve_batched``) and is never differentiated through its
iterations; :class:`_ImplicitQP` swaps in the one-solve backward.

Batches: ``torch.func.vmap`` over ``Fp`` (and ``Kp``) runs ONE
``solve_batched`` over the batch's columns and one batched KKT solve in the
backward (:meth:`_ImplicitQP.vmap`), as ``jax.vmap`` batches the JAX
package's solve; batched ``Qp``/``Gp`` ride the distinct geometry
(``dualize_distinct``).  Gradients of inputs shared by the batch are summed
over it.
"""

from __future__ import annotations

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dualize, dualize_distinct
from pqp_for_mpc_tpu_torch.problem import PrimalQP
from pqp_for_mpc_tpu_torch.solver import solve_batched


def _solve_forward(Qp, Fp, Gp, Kp, cfg: SolverConfig):
    """``(U (M, B), Y (N, B))`` of the batch ``Fp (M, B)``: ``Qp``/``Gp``
    shared (2-D) or one per lane (3-D, batch leading), ``Kp`` shared
    ``(N,)`` or per lane ``(N, B)``."""
    M, B = Fp.shape
    Mp = torch.zeros(B, dtype=Fp.dtype, device=Fp.device)
    if Qp.dim() == 2 and Gp.dim() == 2:
        primal = PrimalQP(Qp=Qp, Qp_inv=torch.linalg.inv(Qp), Fp=Fp, Mp=Mp,
                          Gp=Gp, Kp=Kp)
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
    else:
        Qp = Qp.expand(B, M, M) if Qp.dim() == 2 else Qp
        Gp = Gp.expand(B, *Gp.shape) if Gp.dim() == 2 else Gp
        primal = PrimalQP(Qp=Qp, Qp_inv=torch.linalg.inv(Qp), Fp=Fp, Mp=Mp,
                          Gp=Gp, Kp=Kp)
        dual = dualize_distinct(primal, theta_floor=cfg.theta_floor,
                                precision=cfg.precision)
    res = solve_batched(primal, dual, cfg=cfg)
    return res.U, res.Y


def _kkt_vjp(Qp, Gp, U, Y, gU, active_tol: float):
    """Per-lane gradients of ``<gU, U*>``: ``(gQp (B, M, M), gFp (M, B),
    gGp (B, N, M), gKp (N, B))`` from the masked-KKT min-norm solve.

    Least squares with a 1e-6 ridge: the active rows of Gp can be linearly
    dependent at degenerate vertices (a box bound and a slew bound active
    at once), making K singular; a plain solve would then poison the whole
    gradient with NaN."""
    M, B = U.shape
    N = Gp.shape[-2]
    dt, dev = Qp.dtype, Qp.device
    Qb = Qp.expand(B, M, M) if Qp.dim() == 2 else Qp
    Gb = Gp.expand(B, N, M) if Gp.dim() == 2 else Gp
    active = (Y > active_tol).to(dt)                         # (N, B)
    Da = torch.diag_embed(active.T)                          # (B, N, N)
    eye_n = torch.eye(N, dtype=dt, device=dev)
    K = torch.cat([torch.cat([Qb, Gb.mT @ Da], dim=-1),
                   torch.cat([Da @ Gb, -(eye_n - Da)], dim=-1)], dim=-2)
    rhs = torch.cat([gU, torch.zeros((N, B), dtype=dt, device=dev)]).T
    ridge = 1e-6 * torch.eye(M + N, dtype=dt, device=dev)
    z = torch.linalg.solve(K @ K.mT + ridge, (K @ rhs[..., None]))[..., 0]
    dU = z[:, :M].T                                          # (M, B)
    dlam = z[:, M:].T * active        # only active multipliers move
    yA = Y * active
    outer = lambda a, b: torch.einsum("ib,jb->bij", a, b)
    gQp = -0.5 * (outer(dU, U) + outer(U, dU))
    gGp = -(outer(dlam, U) + outer(yA, dU))
    return gQp, -dU, gGp, dlam


class _ImplicitQP(torch.autograd.Function):
    """``(U, Y) = PQP solve of (Qp, Fp, Gp, Kp)`` with the implicit-KKT
    backward.  ``Fp (M,)`` is one instance; ``Fp (M, B)`` a batch (the
    layout :meth:`vmap` hands it).  ``cfg`` and ``active_tol`` are not
    differentiable; ``Y`` carries no gradient."""

    @staticmethod
    def forward(Qp, Fp, Gp, Kp, cfg, active_tol):
        if Fp.dim() == 1:
            U, Y = _solve_forward(Qp, Fp[:, None], Gp, Kp, cfg)
            return U[:, 0], Y[:, 0]
        return _solve_forward(Qp, Fp, Gp, Kp, cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        Qp, Fp, Gp, Kp, cfg, active_tol = inputs
        U, Y = output
        ctx.save_for_backward(Qp, Gp, U, Y)
        ctx.active_tol = active_tol
        ctx.single = Fp.dim() == 1
        ctx.kp_shared = Kp.dim() == 1
        ctx.mark_non_differentiable(Y)

    @staticmethod
    def backward(ctx, gU, gY):
        Qp, Gp, U, Y = ctx.saved_tensors
        col = (lambda t: t[:, None]) if ctx.single else (lambda t: t)
        gQp, gFp, gGp, gKp = _kkt_vjp(Qp, Gp, col(U), col(Y), col(gU),
                                      ctx.active_tol)
        # inputs shared by the batch get the batch's summed gradient
        gQp = gQp.sum(dim=0) if Qp.dim() == 2 else gQp
        gGp = gGp.sum(dim=0) if Gp.dim() == 2 else gGp
        gKp = gKp.sum(dim=1) if ctx.kp_shared else gKp
        gFp = gFp[:, 0] if ctx.single else gFp
        return gQp, gFp, gGp, gKp, None, None

    @staticmethod
    def vmap(info, in_dims, Qp, Fp, Gp, Kp, cfg, active_tol):
        """One batched solve for a ``torch.func.vmap`` batch: per-lane
        matrices move their batch axis first, per-lane vectors last (the
        port's layouts), and the Function runs once on the whole batch."""
        dQ, dF, dG, dK = in_dims[:4]
        Qp = Qp if dQ is None else Qp.movedim(dQ, 0)
        Gp = Gp if dG is None else Gp.movedim(dG, 0)
        Kp = Kp if dK is None else Kp.movedim(dK, -1)
        Fp = (Fp[:, None].expand(-1, info.batch_size) if dF is None
              else Fp.movedim(dF, -1))
        if Fp.dim() != 2 or Kp.dim() > 2 or Qp.dim() > 3 or Gp.dim() > 3:
            raise NotImplementedError(
                "solve_qp_implicit takes one vmap level over single "
                "instances")
        U, Y = _ImplicitQP.apply(Qp, Fp, Gp, Kp, cfg, active_tol)
        return (U, Y), (1, 1)


def solve_qp_implicit(Qp: torch.Tensor, Fp: torch.Tensor, Gp: torch.Tensor,
                      Kp: torch.Tensor, cfg: SolverConfig = SolverConfig(),
                      active_tol: float = 1e-6) -> torch.Tensor:
    """Differentiable ``U*(Qp, Fp, Gp, Kp)`` for a single instance
    (``torch.func.vmap`` for batches).  Forward = the PQP solver; backward
    = one masked KKT solve.  ``active_tol`` thresholds ``y*`` for the active
    set.  The solve runs on the device of the inputs."""
    return _ImplicitQP.apply(Qp, Fp, Gp, Kp, cfg, active_tol)[0]
