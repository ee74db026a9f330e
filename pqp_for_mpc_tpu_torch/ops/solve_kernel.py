"""K1: the whole batched PQP solve in one kernel launch.

The counterpart of ``pqp_for_mpc_tpu/ops/solve_kernel.py``: multiplicative
updates, the periodic four-part termination check with the recovered U,
optional safeguarded acceleration, the stall freeze and the early exit, all
inside one launch.  The kernel is ``csrc/full_solve.cu`` (one CUDA thread
per lane, geometry staged in shared memory; see the note at the top of the
source); :func:`fused_full_solve_reference` is its plain PyTorch version, a
vectorised rendition of the TPU kernel's body.

Outputs of :func:`fused_full_solve`: ``Y (N, B)``, ``U = -Qp^-1(Fp+Gp'Y)
(M, B)``, ``iters (B,)`` int32 and a per-lane int32 state code (the TPU
kernel's codes): 0 = hit max_iters while active, 1 = certified by the
in-kernel termination test, 2 = stall-frozen at a fixed point without
certificate, 3 = batch padding (never produced here: the kernel needs no
padding).  :func:`solve_fused` wraps it into a
:class:`~pqp_for_mpc_tpu_torch.solver.SolveResult`.

The TPU kernel's batch-block picker and VMEM budgets have no meaning on the
GPU and are not ported; :func:`fits_resident` is the shared-memory fit
test.  Dispatch: CPU tensors go to the plain version; CUDA tensors launch
the kernel, and a failed build or launch raises.
``fused_full_solve.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (N_MAX, SMEM_LIMIT_BYTES,
                                               _matrix, _on_cuda, _panel,
                                               _round4)

LANE_MAX_ITERS, LANE_CERTIFIED, LANE_STALLED, LANE_PADDING = 0, 1, 2, 3


def smem_bytes(n: int, m: int) -> int:
    """Shared memory of one block: Qd^-+th, Qd^++th, Qd, Gp, Gp', Qp,
    Qp^-1 with rows padded to 4 floats."""
    ldn, ldm = _round4(n), _round4(m)
    return (3 * n * ldn + n * ldm + m * ldn + 2 * m * ldm) * 4


def fits_resident(n: int, m: int) -> bool:
    """Does the whole-solve kernel take an ``N=n``, ``M=m`` problem?"""
    return (1 <= n <= N_MAX and 1 <= m <= N_MAX
            and smem_bytes(n, m) <= SMEM_LIMIT_BYTES)


def fused_full_solve_reference(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                               Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                               max_iters: int, check_every: int,
                               accel_every: int = 0, eaj: float = 1e-6,
                               erj: float = 1e-6, strict: bool = True,
                               den_eps: float = 1e-30,
                               precision: str = "highest",
                               gap_comp: bool = False):
    """The plain PyTorch version of the kernel: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/solve_kernel.py:_kernel``) over the whole batch,
    looping until no lane is active or ``h > max_iters``.  Panels may be
    per lane or shared, as for :func:`fused_full_solve`.  The matrices may
    also be per instance (``(B, N, N)``, ...): this body is then the plain
    version of the distinct-geometry kernel K5 too
    (:mod:`pqp_for_mpc_tpu_torch.ops.distinct_kernel`)."""
    from pqp_for_mpc_tpu_torch.solver import _mv, _mvT

    N, B = Y0.shape
    M = Gp.shape[-1]
    lanes = lambda t, r: t.reshape(r, -1).expand(r, B)
    fp, fd = lanes(Fp, M), lanes(Fd, N)
    fdp, fdn, kps = lanes(Fdp, N), lanes(Fdn, N), lanes(Kp_slack, N)
    mp = Mp.reshape(-1).expand(B)
    md = Md.reshape(-1).expand(B)

    def one_update(y, done):
        num = _mv(Qdn_theta, y) + fdn
        den = _mv(Qdp_theta, y) + fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        return torch.where(done, y, (num / den) * y)

    def accel(y, done):
        grad = _mv(Qd, y) + fd
        p = torch.where((y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * _mv(Qd, p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        yn = torch.clamp(y + alpha * p, min=0.0)
        fY = 0.5 * (y * (grad + fd)).sum(dim=0)
        fYn = 0.5 * (yn * _mv(Qd, yn)).sum(dim=0) + (fd * yn).sum(dim=0)
        keep = (fYn <= fY) & ~done
        return torch.where(keep, yn, y)

    def check(y):
        u = -_mv(Qp_inv, _mvT(Gp, y) + fp)
        feas = ~(_mv(Gp, u) > kps).any(dim=0)
        s1 = (y * _mv(Qd, y)).sum(dim=0)
        s2 = (fd * y).sum(dim=0)
        jd = 0.5 * s1 + s2 + 0.5 * md
        jp = 0.5 * (u * _mv(Qp, u)).sum(dim=0) + (fp * u).sum(dim=0) + 0.5 * mp
        if gap_comp:
            gap = s1 + s2
            weak_fail = gap > 0.0
        else:
            gap = jp + jd
            weak_fail = jp > -jd
        fail = ~feas | (gap > eaj) | (gap / jd.abs() > erj)
        if strict:
            fail = fail | weak_fail
        return ~fail, u

    n_chunks = max(1, check_every // max(accel_every, 1)) \
        if accel_every else 1
    y = Y0
    st = torch.zeros(B, dtype=torch.int32, device=Y0.device)
    it = torch.zeros(B, dtype=torch.int32, device=Y0.device)
    h, unsolved = 1, B
    while unsolved > 0 and h <= max_iters:
        done = st > 0
        ok, _ = check(y)
        newly = ok & ~done
        it = torch.where(newly, h, it)
        st = torch.where(newly, LANE_CERTIFIED, st)
        done = done | ok
        y_prev = y
        if accel_every:
            for _ in range(n_chunks):
                for _ in range(accel_every):
                    y = one_update(y, done)
                y = accel(y, done)
        else:
            for _ in range(check_every):
                y = one_update(y, done)
        # stall freeze: a bit-identical iterate after a whole block
        stalled = (y - y_prev).abs().sum(dim=0) == 0.0
        newly_stalled = stalled & (st == LANE_MAX_ITERS)
        it = torch.where(newly_stalled, h + check_every, it)
        st = torch.where(newly_stalled, LANE_STALLED, st)
        unsolved = int((st == LANE_MAX_ITERS).sum())
        h += check_every

    ok, u = check(y)
    newly = ok & (st == LANE_MAX_ITERS)
    it = torch.where(newly, h, it)
    st = torch.where(newly, LANE_CERTIFIED, st)
    it = torch.where(st > 0, it, h)
    return y, u, it.to(torch.int32), st.to(torch.int32)


def fused_full_solve(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                     Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                     max_iters: int, check_every: int,
                     accel_every: int = 0, eaj: float = 1e-6,
                     erj: float = 1e-6, strict: bool = True,
                     den_eps: float = 1e-30, precision: str = "highest",
                     gap_comp: bool = False):
    """Run the full batched PQP solve in one launch.

    Matrices ``(N, N)``/``(N, M)``/``(M, M)``; ``Y0 (N, B)``; the panels
    ``Fp (M, .)``, ``Fd``/``Fdp``/``Fdn``/``Kp_slack (N, .)`` and ``Mp``/
    ``Md (.)`` are per lane (``B`` columns) or shared by every lane.
    ``Kp_slack`` is the pre-slackened threshold ``Kp + max(erc*Kp, eac)``
    (compare, PQP_CPU.c:334-343).  Returns ``(Y, U, iters, lane_state)``.
    """
    kw = dict(max_iters=max_iters, check_every=check_every,
              accel_every=accel_every, eaj=eaj, erj=erj, strict=strict,
              den_eps=den_eps, precision=precision, gap_comp=gap_comp)
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_reference(
            Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
            Kp_slack, Mp, Md, Y0, **kw)
    if Y0.dim() != 2 or Gp.dim() != 2:
        raise ValueError("fused_full_solve: expected Y0 (N, B), Gp (N, M)")
    N, B = Y0.shape
    M = Gp.shape[1]
    if not fits_resident(N, M):
        raise ValueError(
            f"fused_full_solve: N={N}, M={M} exceed the whole-solve "
            f"kernel's shared memory (max(N, M) <= {N_MAX} and "
            f"{SMEM_LIMIT_BYTES} bytes); use solve_batched")
    if check_every < 1 or accel_every < 0:
        raise ValueError("check_every must be >= 1 and accel_every >= 0")
    dev = Y0.device
    mats = [_matrix(Qdn_theta, (N, N), "Qdn_theta", dev),
            _matrix(Qdp_theta, (N, N), "Qdp_theta", dev),
            _matrix(Qd, (N, N), "Qd", dev),
            _matrix(Gp, (N, M), "Gp", dev),
            _matrix(Qp, (M, M), "Qp", dev),
            _matrix(Qp_inv, (M, M), "Qp_inv", dev)]
    panels = [_panel(Fp, M, B, "Fp", dev), _panel(Fd, N, B, "Fd", dev),
              _panel(Fdp, N, B, "Fdp", dev), _panel(Fdn, N, B, "Fdn", dev),
              _panel(Kp_slack, N, B, "Kp_slack", dev),
              _panel(Mp.reshape(1, -1), 1, B, "Mp", dev),
              _panel(Md.reshape(1, -1), 1, B, "Md", dev),
              _panel(Y0, N, B, "Y0", dev)]
    y = torch.empty((N, B), dtype=torch.float32, device=dev)
    u = torch.empty((M, B), dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return y, u, iters, state
    lib = build.load_library()
    args = [t.data_ptr() for t in mats]
    for t, lane in panels:
        args += [t.data_ptr(), lane]
    code = lib.full_solve_f32(
        *args, y.data_ptr(), u.data_ptr(), iters.data_ptr(),
        state.data_ptr(), N, M, B, int(max_iters), int(check_every),
        int(accel_every), float(eaj), float(erj), int(bool(strict)),
        float(den_eps), int(bool(gap_comp)), build.stream_handle(dev))
    build.check(code, "fused_full_solve")
    fused_full_solve.launches += 1
    return y, u, iters, state


fused_full_solve.launches = 0


def fused_inputs(primal, dual, Y0: Optional[torch.Tensor] = None,
                 cfg: Optional[SolverConfig] = None,
                 name: str = "solve_fused"):
    """The arguments :func:`solve_fused` hands the kernel for this problem:
    ``(args, kwargs)`` for :func:`fused_full_solve` or, identically, for
    :func:`fused_full_solve_reference` (and the packed kernel K8, whose
    entry point ``name`` the errors then give).  Panels shared by every
    lane stay shared (stride-0 views)."""
    from pqp_for_mpc_tpu_torch.solver import _as2d

    cfg = cfg or SolverConfig()
    if dual.Qd.dim() != 2:
        raise ValueError(f"{name} requires shared Qd geometry")
    if dual.Qdn_theta is None:
        raise ValueError(
            f"{name} holds the MATERIALIZED Qd splits in shared memory "
            "— rebuild the dual with dualize(materialize_splits=True), or "
            "use solve_batched (it never needs them)")
    N = dual.n_con
    Fd2 = _as2d(dual.Fd)
    B = Fd2.shape[1]
    if Y0 is None:
        Y0 = torch.full((N, B), cfg.y0, dtype=torch.float32,
                        device=dual.Qd.device)
    else:
        Y0 = _as2d(Y0)
        if Y0.shape[1] == 1 and B > 1:
            Y0 = Y0.expand(N, B)
        elif B > 1 and Y0.shape[1] != B:
            raise ValueError(
                f"warm start batch {Y0.shape[1]} != instance batch {B}")
        B = max(B, Y0.shape[1])
    M = primal.Gp.shape[1]
    kp_slack = primal.Kp + torch.clamp(cfg.erc * primal.Kp, min=cfg.eac)
    if kp_slack.dim() == 2 and kp_slack.shape[1] not in (1, B):
        raise ValueError(
            f"Kp batch {kp_slack.shape[1]} != instance batch {B}")
    args = (dual.Qdn_theta, dual.Qdp_theta, dual.Qd, primal.Gp, primal.Qp,
            primal.Qp_inv, _as2d(primal.Fp).expand(M, B), Fd2.expand(N, B),
            _as2d(dual.Fdp).expand(N, B), _as2d(dual.Fdn).expand(N, B),
            kp_slack, primal.Mp.reshape(-1).expand(B),
            dual.Md.reshape(-1).expand(B), Y0)
    kwargs = dict(max_iters=cfg.max_iters, check_every=cfg.check_every,
                  accel_every=cfg.accel_every, eaj=cfg.eaj, erj=cfg.erj,
                  strict=cfg.strict_weak_duality, den_eps=cfg.den_eps,
                  precision=cfg.precision,
                  gap_comp=cfg.gap_from_complementarity)
    return args, kwargs


def fused_result(primal, dual, cfg: Optional[SolverConfig], Y, U, iters,
                 lane_state):
    """A :class:`~pqp_for_mpc_tpu_torch.solver.SolveResult` from the
    kernel's outputs.  The exit-time costs and feasibility are recomputed
    in PyTorch, and a lane the kernel did not certify (stall-frozen or out
    of iterations) counts as converged when its exit state passes the
    verdict there — the rescue of
    ``pqp_for_mpc_tpu/ops/solve_kernel.py:464-490``."""
    from pqp_for_mpc_tpu_torch.solver import (SolveResult,
                                              complementarity_gap, costs,
                                              feasibility, termination_fail)

    cfg = cfg or SolverConfig()
    feas = feasibility(primal, U, cfg.erc, cfg.eac)
    Jp, Jd = costs(primal, dual, Y, U)
    div = ~torch.isfinite(Y).all(dim=0)
    cert = lane_state == LANE_CERTIFIED
    gap = (complementarity_gap(dual, Y)
           if cfg.gap_from_complementarity else None)
    fail = termination_fail(feas, Jp, Jd, cfg, gap)
    conv = (cert | ~fail) & ~div
    return SolveResult(U=U, Y=Y, iters=iters, converged=conv,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def solve_fused(primal, dual, Y0: Optional[torch.Tensor] = None,
                cfg: Optional[SolverConfig] = None):
    """Drop-in analog of :func:`pqp_for_mpc_tpu_torch.solver.solve_batched`
    running the whole solve in one launch (shared geometry only); see
    :func:`fused_inputs` and :func:`fused_result`."""
    args, kwargs = fused_inputs(primal, dual, Y0, cfg)
    return fused_result(primal, dual, cfg, *fused_full_solve(*args, **kwargs))
