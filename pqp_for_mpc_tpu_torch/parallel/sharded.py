"""Sharded PQP solvers: data-parallel instance batches and model-parallel
(row-sharded dual Hessian) iteration.

The counterpart of ``pqp_for_mpc_tpu/parallel/sharded.py`` on
``torch.distributed``.  Every rank holds the global problem (as in the JAX
package's multi-process test) and works on its own block of it; what
comes back is that rank's block, not a global array.

* :func:`shard_batch` + :func:`pqp_for_mpc_tpu_torch.solver.solve_batched`
  — data parallelism: the batch (lane) axis of ``Y/Fd/Fp/Mp/Md`` is cut
  over the ``data`` mesh axis, the small shared matrices are kept whole,
  and each rank solves its lanes with no communication at all.

* :func:`solve_row_sharded` — tensor parallelism for a large dual
  dimension N: each rank owns a row block of ``Qd^{+/-}+theta``
  (N/mp, N) and the matching block of Y; each update all-gathers Y along
  ``model`` (the TP matvec pattern), computes its row block of both
  products and applies the elementwise update to its rows.  Convergence
  reductions (Gp'Y, feasibility violations, dual cost) are all-reduced
  partial sums.  U is recovered replicated over ``model`` (M is small).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.parallel.mesh import batch_sharding, replicated
from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu_torch.solver import SolveResult, _as2d


def local_shard(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``placements`` (one per
    mesh dim, as :func:`~pqp_for_mpc_tpu_torch.parallel.mesh.
    batch_sharding` gives them): a view, cut with no communication.  A
    sharded dim must divide evenly over its mesh dim."""
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            n, size = mesh.size(mesh_dim), x.shape[p.dim]
            if size % n:
                raise ValueError(
                    f"dim {p.dim} of size {size} is not divisible by the "
                    f"{n} ranks of mesh dim {mesh.mesh_dim_names[mesh_dim]!r}"
                    " — pad the batch")
            per = size // n
            x = x.narrow(p.dim, mesh.get_local_rank(mesh_dim) * per, per)
    return x


def shard_batch(primal: PrimalQP, dual: DualQP, mesh: DeviceMesh,
                axis: str = "data"):
    """This rank's block of a batched (primal, dual) pair: 2-D ``(., B)``
    arrays keep the rank's columns of the ``axis`` mesh dim, 1-D ``(B,)``
    arrays its entries, and the instance-shared matrices stay whole.
    Returns new containers of views; feed them to
    :func:`pqp_for_mpc_tpu_torch.solver.solve_batched`.

    Each lane then gets exactly what the unsharded solve gives it, in the
    same iterations: a lane's update, check and verdict read only its own
    column.  The port's loop stops when ITS lanes are done, where the JAX
    package's all-reduces ``all(done)`` over the mesh; that only changes
    how many times frozen lanes pass through the loop, never a lane's
    result.  A state-dependent ``Kp (N, B)`` loses columns too (the JAX
    package replicates it and lets GSPMD pick the columns).  Distinct
    geometry (3-D ``Qd``) is refused."""
    if dual.Qd.dim() == 3:
        raise ValueError("shard_batch takes shared geometry; a distinct "
                         "(3-D Qd) batch is not supported")
    col = batch_sharding(mesh, axis)
    vec = tuple(Shard(0) if isinstance(p, Shard) else p for p in col)
    rep = replicated(mesh)

    def place(x, ndim, sh):
        return local_shard(x, mesh, sh if x.dim() == ndim else rep)

    primal = PrimalQP(
        Qp=primal.Qp, Qp_inv=primal.Qp_inv, Fp=place(primal.Fp, 2, col),
        Mp=place(primal.Mp, 1, vec), Gp=primal.Gp,
        Kp=place(primal.Kp, 2, col))
    dual = dataclasses.replace(
        dual, Fd=place(dual.Fd, 2, col), Md=place(dual.Md, 1, vec),
        Fdp=place(dual.Fdp, 2, col), Fdn=place(dual.Fdn, 2, col))
    return primal, dual


def solve_row_sharded(primal: PrimalQP, dual: DualQP,
                      Y0: Optional[torch.Tensor] = None,
                      cfg: SolverConfig = SolverConfig(),
                      *, mesh: DeviceMesh,
                      data_axis: str = "data",
                      model_axis: str = "model",
                      mixed: bool = False,
                      floor_frac: float = 0.25,
                      floor_checks: int = 2) -> SolveResult:
    """Tensor-parallel PQP solve with the dual dimension N row-sharded over
    ``model_axis`` and the batch sharded over ``data_axis``; every rank
    holds the global problem and returns its blocks: ``U (M, B/dp)``
    (replicated over ``model``), ``Y (N/mp, B/dp)`` and the per-lane
    vectors ``(B/dp,)``.

    Requires the MATERIALIZED Qd splits (each rank reads its row blocks of
    them), an instance-shared ``Kp``, N divisible by the model size and B
    by the data size (pad the batch; padded rows with identity diagonal
    and Y=1 are fixed points).

    The loop is the JAX package's: a check, then ``check_every`` updates
    (with the accelerated step every ``accel_every``), until every lane of
    the whole mesh is done; each check all-reduces the count of unsolved
    lanes over all ranks, and every rank reads it on the host, so all
    ranks make the same trips.  Its feasibility test is always the
    explicit ``Gp U <= Kp + max(erc Kp, eac)``, as in the JAX package.  A
    lane's ``iters`` is stamped when it certifies; a lane frozen
    non-finite keeps 0 (plus the bf16 phase's count), as JAX's sharded
    solve stamps it, where ``solve_batched`` stamps the freeze.

    ``mixed=True`` prepends the bfloat16 bulk phase of
    :func:`pqp_for_mpc_tpu_torch.solver.solve_mixed` in row-sharded form:
    ``Qd`` rounded once to bf16 and split exactly, theta from the ROUNDED
    negative row sums, the per-update all-gather of Y in bf16 (half the
    interconnect bytes), products of the rounded values summed in float32,
    the bf16-floor freeze, and non-finite lanes reset to the cold start
    before the float32 phase certifies on the true problem.
    ``cfg.precision`` is accepted and ignored: products run in full
    float32 (TF32 off)."""
    N = dual.n_con
    dims = mesh.mesh_dim_names
    mp = mesh.size(dims.index(model_axis))
    dp = mesh.size(dims.index(data_axis))
    Fd2 = _as2d(dual.Fd)
    B = Fd2.shape[1]
    if N % mp or B % dp:
        raise ValueError(f"N={N} % model={mp} or B={B} % data={dp} != 0")
    if primal.Kp.dim() != 1:
        raise ValueError("solve_row_sharded requires instance-shared Kp; "
                         "use solve_batched for state-dependent bounds")
    if dual.Qdn_theta is None:
        raise ValueError(
            "solve_row_sharded needs the MATERIALIZED Qd splits (each "
            "device holds its row blocks); rebuild the dual with "
            "dualize(materialize_splits=True)")
    group = mesh.get_group(model_axis)
    mi = mesh.get_local_rank(model_axis)
    if dist.get_group_rank(group, dist.get_rank()) != mi:
        raise ValueError("the model sub-group's rank order differs from the "
                         "mesh's model coordinate")
    Nl, Bl = N // mp, B // dp
    di = mesh.get_local_rank(data_axis)
    rows, cols = slice(mi * Nl, (mi + 1) * Nl), slice(di * Bl, (di + 1) * Bl)
    dev = dual.Qd.device

    def panel(a):           # the rank's block of an (N, B) panel
        return _as2d(a).expand(N, B)[rows, cols]

    Qd_b, Qdn_b, Qdp_b = (a[rows] for a in (dual.Qd, dual.Qdn_theta,
                                            dual.Qdp_theta))
    Fd_b, Fdp_b, Fdn_b = panel(dual.Fd), panel(dual.Fdp), panel(dual.Fdn)
    Kp_b, Gp_b = primal.Kp[rows], primal.Gp[rows]
    Qp, Qp_inv = primal.qp(), primal.Qp_inv
    Fp_l = _as2d(primal.Fp).expand(-1, B)[:, cols]
    Mp_l = primal.Mp.reshape(-1).expand(B)[cols]
    Md_l = dual.Md.reshape(-1).expand(B)[cols]
    if Y0 is None:
        Y_b = torch.full((Nl, Bl), cfg.y0, dtype=torch.float32, device=dev)
    else:
        Y_b = panel(Y0).clone(memory_format=torch.contiguous_format)
    k = cfg.check_every

    def gather(Yb, dtype=torch.float32):
        # all-gather along model of the rank's rows (in ``dtype`` on the
        # wire), returned as float32 (N, Bl)
        out = torch.empty((N, Bl), dtype=dtype, device=dev)
        dist.all_gather_into_tensor(out, Yb.to(dtype).contiguous(),
                                    group=group)
        return out.float()

    def psum(*parts):
        # one all-reduce over model for several partial sums
        flat = torch.cat([p.reshape(-1).float() for p in parts])
        dist.all_reduce(flat, group=group)
        return flat.split([p.numel() for p in parts])

    def global_unsolved(done) -> int:
        # every rank reads the same count, so every rank makes the same trip
        n = (~done).sum().reshape(1)
        dist.all_reduce(n)
        return int(n.item())

    slack_b = Kp_b + torch.clamp(cfg.erc * Kp_b, min=cfg.eac)

    def check(Yb):
        """(ok, U, feas, Jp, Jd, gap, nbad): the four-part verdict on the
        true problem and the count of non-finite entries per lane."""
        (GtY,) = psum(Gp_b.T @ Yb)
        U = -(Qp_inv @ (GtY.view(-1, Bl) + Fp_l))
        QdY_b = Qd_b @ gather(Yb)
        nviol, Jd, gap, nbad = psum(
            ((Gp_b @ U) > slack_b[:, None]).sum(dim=0),
            0.5 * (Yb * QdY_b).sum(dim=0) + (Fd_b * Yb).sum(dim=0),
            (Yb * (QdY_b + Fd_b)).sum(dim=0),
            (~torch.isfinite(Yb)).sum(dim=0))
        feas = nviol == 0
        Jd = Jd + 0.5 * Md_l
        Jp = (0.5 * (U * (Qp @ U)).sum(dim=0) + (Fp_l * U).sum(dim=0)
              + 0.5 * Mp_l)
        if cfg.gap_from_complementarity:
            weak = gap > 0.0
        else:
            gap = Jp + Jd
            weak = Jp > -Jd
        fail = ~feas | (gap > cfg.eaj) | (gap / Jd.abs() > cfg.erj)
        if cfg.strict_weak_duality:
            fail = fail | weak
        return ~fail, U, feas, Jp, Jd, gap, nbad

    def update(Yb, frozen, Qn, Qp_, wire, th):
        Yf = gather(Yb, wire)
        num, den = Qn @ Yf, Qp_ @ Yf
        if th is not None:          # the bf16 phase's float32 diagonal
            tY = th[:, None] * Yb
            num, den = num + tY, den + tY
        num, den = num + Fdn_b, den + Fdp_b
        if cfg.den_eps:
            den = torch.clamp(den, min=cfg.den_eps)
        return torch.where(frozen[None, :], Yb, (num / den) * Yb)

    def accel(Yb, frozen, Q, wire):
        """Row-sharded rendition of solver.accel_step: the direction and
        line-search quotients are all-reduced partial sums, with two more
        all-gathers (p, the candidate) along model."""
        grad_b = Q @ gather(Yb, wire) + Fd_b
        p_b = torch.where((Yb > 0.0) | (grad_b < 0.0), -grad_b,
                          torch.zeros_like(grad_b))
        pQp, p2, fY = psum((p_b * (Q @ gather(p_b, wire))).sum(dim=0),
                           (p_b * p_b).sum(dim=0),
                           (0.5 * Yb * (grad_b + Fd_b)).sum(dim=0))
        alpha = torch.where(pQp > 0, p2 / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        Yn_b = torch.clamp(Yb + alpha[None, :] * p_b, min=0.0)
        (fYn,) = psum((0.5 * Yn_b * (Q @ gather(Yn_b, wire))
                       + Fd_b * Yn_b).sum(dim=0))
        keep = (fYn <= fY) & ~frozen
        return torch.where(keep[None, :], Yn_b, Yb)

    def run_updates(Yb, frozen, Qn, Qp_, Q, wire, th=None):
        n_acc = k // cfg.accel_every if cfg.accel_every else 1
        n_mult = cfg.accel_every if cfg.accel_every else k
        for _ in range(n_acc):
            for _ in range(n_mult):
                Yb = update(Yb, frozen, Qn, Qp_, wire, th)
            if cfg.accel_every:
                Yb = accel(Yb, frozen, Q, wire)
        return Yb

    zeros_i = lambda: torch.zeros(Bl, dtype=torch.int32, device=dev)
    zeros_b = lambda: torch.zeros(Bl, dtype=torch.bool, device=dev)
    it_mix = zeros_i()
    if mixed:
        # consistent rounding (see solver.solve_mixed): ONE cast of Qd,
        # an exact split, theta from the ROUNDED negative row sums applied
        # as a separate float32 diagonal term; the rounded values are kept
        # in float32 so every product sums in float32
        Qbf_b = Qd_b.to(torch.bfloat16).float()
        Qnbf_b, Qpbf_b = torch.clamp(-Qbf_b, min=0.0), torch.clamp(Qbf_b,
                                                                   min=0.0)
        thm_b = torch.clamp(Qnbf_b.sum(dim=1), min=cfg.theta_floor)
        frozen, slow, h, unsolved = zeros_b(), zeros_i(), 0, 1
        while unsolved > 0 and h <= cfg.max_iters:
            ok, _, _, _, _, gap, nbad = check(Y_b)
            (g_bf,) = psum((Y_b * (Qbf_b @ gather(Y_b, torch.bfloat16)
                                   + Fd_b)).sum(dim=0))
            bad = (nbad > 0) & ~frozen
            slow = torch.where(g_bf.abs() < floor_frac * gap.abs(), slow + 1,
                               torch.zeros_like(slow))
            newly = (ok | bad | (slow >= floor_checks)) & ~frozen
            it_mix = torch.where(newly, h, it_mix)
            frozen = frozen | newly
            Y_b = run_updates(Y_b, frozen, Qnbf_b, Qpbf_b, Qbf_b,
                              torch.bfloat16, thm_b)
            h += k
            unsolved = global_unsolved(frozen)
        it_mix = torch.where(frozen, it_mix, h).to(torch.int32)
        # non-finite phase-1 lanes would poison the float32 warm start
        # (NaN is absorbing): reset them to the cold start
        (nbad,) = psum((~torch.isfinite(Y_b)).sum(dim=0))
        Y_b = torch.where((nbad == 0)[None, :], Y_b,
                          torch.full_like(Y_b, cfg.y0))

    done, div, iters, h, unsolved = zeros_b(), zeros_b(), zeros_i(), 1, 1
    while unsolved > 0 and h <= cfg.max_iters:
        ok, _, _, _, _, _, nbad = check(Y_b)
        bad = (nbad > 0) & ~done
        newly = ok & ~done & ~bad
        iters = torch.where(newly, h, iters)
        done = done | ok | bad
        div = div | bad
        Y_b = run_updates(Y_b, done, Qdn_b, Qdp_b, Qd_b, torch.float32)
        h += k
        unsolved = global_unsolved(done)

    ok, U, feas, Jp, Jd, _, nbad = check(Y_b)
    bad = (nbad > 0) & ~done
    div = div | bad
    newly = ok & ~done & ~bad
    iters = torch.where(newly, h, iters)
    done = done | ok | bad
    iters = (torch.where(done, iters, h) + it_mix).to(torch.int32)
    return SolveResult(U=U, Y=Y_b, iters=iters, converged=done & ~div,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)
