"""K4: the whole batched PQP solve in one launch, Hessian streamed.

The counterpart of ``pqp_for_mpc_tpu/ops/tiled_solve_kernel.py``: for N
past the resident kernels, rounds of one check pass (recover U, feasibility
against the slack panel, costs or complementarity gap, the four-part
verdict) and ``check_every`` Jacobi update passes with per-lane done masks;
optionally the safeguarded projected-gradient step at the check cadence
(three more passes over the matrix); the stall freeze; the early exit once
no lane is active; and the final check.  The matrix is ``Qd_hat`` of
:func:`pqp_for_mpc_tpu_torch.ops.tiled_kernel.streamed_matrix`, its splits
rebuilt by relu.

The kernel is ``csrc/full_solve_tiled.cu``, a cooperative persistent
kernel whose every matrix phase runs one float32 tile on the CUDA cores
(``csrc/fma_tile.cuh``, a ``cp.async`` ring) over the tiles of
:func:`k4_plan`: 32 rows as wide as the batch, so at B <= 128 an update
reads each row of ``Qd_hat`` once (see the note at the top of the source);
:func:`fused_full_solve_tiled_reference` is its plain PyTorch version, the
TPU kernel's body vectorised over the batch.  Outputs and lane codes are
K1's (:mod:`pqp_for_mpc_tpu_torch.ops.solve_kernel`).  Restrictions, as the
TPU kernel: shared geometry, ``check_every`` even (the ping-pong returns to
the primary iterate at each round's end), ``accel_every`` 0 or
``check_every``.  :func:`solve_fused_tiled` is an explicit entry point:
:func:`~pqp_for_mpc_tpu_torch.routing.solve_auto` does not pick it.
Dispatch: CPU tensors run the plain version; CUDA tensors launch the
kernel, and a failed build or a refused launch raises.
``fused_full_solve_tiled.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import (certificate_slack, kernel_kwargs,
                                         lane_batch, lane_panels)
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (_aligned16, _matrix,
                                               _on_cuda)
from pqp_for_mpc_tpu_torch.ops.solve_kernel import (LANE_CERTIFIED,
                                                    LANE_MAX_ITERS,
                                                    LANE_STALLED,
                                                    fused_result)
from pqp_for_mpc_tpu_torch.ops.tiled_kernel import (FMA_THREADS,
                                                    FMA_TILE_ROWS,
                                                    fma_smem_bytes,
                                                    fma_tile_lanes,
                                                    streamed_matrix)
from pqp_for_mpc_tpu_torch.utils import tracing

#: rows of one partial per-lane sum in the kernel (``kChunk``) and the most
#: sums one of its lane phases carries (``kMaxSums``)
_CHUNK, _MAX_SUMS = 256, 5


def k4_plan(n: int, m: int, B: int) -> dict:
    """K4's tile plan for ``n`` constraints, ``m`` variables and ``B``
    lanes, as the kernel computes it: 32-row tiles of the narrowest lane
    width (32, 64 or 128) that holds the batch, else 128; the grid is one
    block per update tile, capped on the card at the blocks that fit at
    once.  ``q_reads_per_update`` is how often an update streams each row
    of ``Qd_hat`` (once per lane tile); ``vector_staging`` whether every
    product stages 16-byte chunks (n, m and B multiples of 4) rather than
    entry by entry."""
    if n < 1 or m < 1 or B < 1:
        raise ValueError(f"k4_plan needs n, m, B >= 1, got {n}, {m}, {B}")
    lanes = fma_tile_lanes(B)
    lane_tiles = -(-B // lanes)
    tiles = lambda rows: -(-rows // FMA_TILE_ROWS) * lane_tiles
    return dict(tile_rows=FMA_TILE_ROWS, tile_lanes=lanes,
                threads=FMA_THREADS, blocks=tiles(n),
                check_tiles=tiles(n) + tiles(m),
                q_reads_per_update=lane_tiles,
                smem_bytes=fma_smem_bytes(lanes),
                vector_staging=n % 4 == 0 and m % 4 == 0 and B % 4 == 0)


def _check_args(check_every: int) -> None:
    if check_every < 2 or check_every % 2:
        raise ValueError("fused_full_solve_tiled needs even check_every "
                         ">= 2 (Jacobi ping-pong round alignment)")


def fused_full_solve_tiled_reference(Qd, theta, Gp, Qp, Qp_inv, Fp, Fd, Fdp,
                                     Fdn, Kp_slack, Mp, Md, Y0, *,
                                     max_iters: int, check_every: int,
                                     accel: bool = False, eaj: float = 1e-6,
                                     erj: float = 1e-6, strict: bool = True,
                                     den_eps: float = 1e-30,
                                     precision: str = "highest",
                                     gap_comp: bool = False):
    """The plain PyTorch version of the kernel: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/tiled_solve_kernel.py:_kernel``) over the whole
    batch.  Panels are per lane or shared, as for
    :func:`fused_full_solve_tiled`."""
    _check_args(check_every)
    Qh, th = streamed_matrix(Qd, theta, "float32")
    q_neg, q_pos = torch.clamp(-Qh, min=0.0), torch.clamp(Qh, min=0.0)
    th = th[:, None]
    N, B = Y0.shape
    M = Gp.shape[1]
    lanes = lambda t, r: t.reshape(r, -1).expand(r, B)
    fp, fd = lanes(Fp, M), lanes(Fd, N)
    fdp, fdn, kps = lanes(Fdp, N), lanes(Fdn, N), lanes(Kp_slack, N)
    mp = Mp.reshape(-1).expand(B)
    md = Md.reshape(-1).expand(B)
    dev = Y0.device

    def qd_col(x):          # Qd (diagonal clamped) x
        return Qh @ x - th * x

    def update(y, done):
        num = q_neg @ y + th * y + fdn
        den = q_pos @ y + fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        return torch.where(done, y, (num / den) * y)

    def check(y, h, st, it):
        qdy = qd_col(y)
        u = -(Qp_inv @ (Gp.T @ y + fp))
        feas = ~(Gp @ u > kps).any(dim=0)
        s1 = (y * qdy).sum(dim=0)
        s2 = (fd * y).sum(dim=0)
        jd = 0.5 * s1 + s2 + 0.5 * md
        jp = 0.5 * (u * (Qp @ u)).sum(dim=0) + (fp * u).sum(dim=0) + 0.5 * mp
        if gap_comp:
            gap = s1 + s2
            weak_fail = gap > 0.0
        else:
            gap = jp + jd
            weak_fail = jp > -jd
        fail = ~feas | (gap > eaj) | (gap / jd.abs() > erj)
        if strict:
            fail = fail | weak_fail
        newly = ~fail & (st == LANE_MAX_ITERS)
        it = torch.where(newly, h, it)
        st = torch.where(newly, LANE_CERTIFIED, st)
        return st, it, u

    def accel_step(y, done):
        grad = qd_col(y) + fd
        p = torch.where((y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * qd_col(p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        yn = torch.clamp(y + alpha * p, min=0.0)
        fY = 0.5 * (y * (grad + fd)).sum(dim=0)
        fYn = 0.5 * (yn * qd_col(yn)).sum(dim=0) + (fd * yn).sum(dim=0)
        keep = (fYn <= fY) & ~done
        yn = torch.where(keep, yn, y)
        return yn, (yn - y).abs().sum(dim=0)

    y = Y0
    st = torch.zeros(B, dtype=torch.int32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    h, unsolved = 1, B
    while unsolved > 0 and h <= max_iters:
        st, it, _ = check(y, h, st, it)
        done = st > 0
        for _ in range(check_every):
            y_prev, y = y, update(y, done)
        diff = (y - y_prev).abs().sum(dim=0)       # the last sweep's move
        if accel:
            y, moved = accel_step(y, done)
            diff = diff + moved
        stalled = (diff == 0.0) & (st == LANE_MAX_ITERS)
        it = torch.where(stalled, h + check_every, it)
        st = torch.where(stalled, LANE_STALLED, st)
        unsolved = int((st == LANE_MAX_ITERS).sum())
        h += check_every

    active = st == LANE_MAX_ITERS
    st, it, u = check(y, h, st, it)
    it = torch.where(active, h, it)
    return y, u, it.to(torch.int32), st.to(torch.int32)


def fused_full_solve_tiled(Qd, theta, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
                           Kp_slack, Mp, Md, Y0, *, max_iters: int,
                           check_every: int, accel: bool = False,
                           eaj: float = 1e-6, erj: float = 1e-6,
                           strict: bool = True, den_eps: float = 1e-30,
                           precision: str = "highest",
                           gap_comp: bool = False):
    """Whole-solve launch with the Hessian streamed.  Takes the UNSPLIT
    ``Qd (N, N)`` and ``theta (N,)`` (the streamed ``Qd_hat`` is built here,
    once per solve), ``Gp (N, M)``, ``Qp``/``Qp_inv (M, M)``, panels
    ``Fp (M, .)``, ``Fd``/``Fdp``/``Fdn``/``Kp_slack (N, .)``, ``Mp``/
    ``Md (.)`` per lane or shared, ``Y0 (N, B)``.  Returns
    ``(Y, U, iters, lane_state)`` with K1's state codes."""
    kw = dict(max_iters=max_iters, check_every=check_every, accel=accel,
              eaj=eaj, erj=erj, strict=strict, den_eps=den_eps,
              precision=precision, gap_comp=gap_comp)
    _check_args(check_every)
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_tiled_reference(
            Qd, theta, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md,
            Y0, **kw)
    if Y0.dim() != 2 or Gp.dim() != 2:
        raise ValueError("fused_full_solve_tiled: expected Y0 (N, B), "
                         "Gp (N, M)")
    N, B = Y0.shape
    M = Gp.shape[1]
    dev = Y0.device
    Qh, th = streamed_matrix(_matrix(Qd, (N, N), "Qd", dev),
                             _matrix(theta, (N,), "theta", dev), "float32")
    mats = [Qh, th, _matrix(Gp, (N, M), "Gp", dev),
            _matrix(Qp, (M, M), "Qp", dev),
            _matrix(Qp_inv, (M, M), "Qp_inv", dev)]

    def lanes(t, rows, name):
        t = _matrix(t, tuple(t.shape), name, dev)
        if t.numel() not in (rows, rows * B):
            raise ValueError(f"{name}: expected {rows} or {rows * B} "
                             f"entries, got {tuple(t.shape)}")
        return t.reshape(rows, -1).expand(rows, B).contiguous()

    panels = [lanes(Fp, M, "Fp"), lanes(Fd, N, "Fd"), lanes(Fdp, N, "Fdp"),
              lanes(Fdn, N, "Fdn"), lanes(Kp_slack, N, "Kp_slack"),
              lanes(Mp, 1, "Mp"), lanes(Md, 1, "Md"), lanes(Y0, N, "Y0")]
    # the tile stages the matrices in 16-byte chunks; the kernel reads the
    # panels entry by entry, and the tile's right-hand sides are the
    # scratch below
    mats = [_aligned16(t) for t in mats]
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((N, B), **f32)
    u = torch.empty((M, B), **f32)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = [torch.empty((N, B), **f32) for _ in range(5)]  # yb qdy w g p
    scratch += [torch.empty((M, B), **f32),                   # v
                torch.empty(4 * B, **f32),                    # lane
                torch.empty(-(-(N + M) // _CHUNK) * _MAX_SUMS * B, **f32)]
    args = (*[t.data_ptr() for t in mats + panels],
            y.data_ptr(), u.data_ptr(), iters.data_ptr(), state.data_ptr(),
            *[t.data_ptr() for t in scratch], N, M, B, int(max_iters),
            int(check_every), int(bool(accel)), float(eaj), float(erj),
            int(bool(strict)), float(den_eps), int(bool(gap_comp)),
            build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k4", device=dev):
        code = lib.full_solve_tiled_f32(*args)
        build.check(code, "fused_full_solve_tiled")
        fused_full_solve_tiled.launches += 1
    return y, u, iters, state


fused_full_solve_tiled.launches = 0


def tiled_inputs(primal, dual, Y0: Optional[torch.Tensor] = None,
                 cfg: Optional[SolverConfig] = None):
    """The arguments :func:`solve_fused_tiled` hands the kernel for this
    problem: ``(args, kwargs)`` for :func:`fused_full_solve_tiled` or,
    identically, for :func:`fused_full_solve_tiled_reference`.  Raises the
    JAX wrapper's two ValueErrors: ``accel_every`` not in
    ``{0, check_every}`` here, an odd ``check_every`` in the kernel's
    wrapper."""
    cfg = cfg or SolverConfig()
    if cfg.accel_every not in (0, cfg.check_every):
        raise ValueError(
            "solve_fused_tiled supports accel_every in {0, check_every} "
            "(the accel runs at the check cadence; each step costs three "
            "extra Hessian streams)")
    if dual.Qd.dim() != 2:
        raise ValueError("solve_fused_tiled requires shared Qd geometry")
    Y0, B = lane_batch(dual, Y0, cfg)
    kp_slack = primal.Kp + certificate_slack(primal.Kp, cfg.erc, cfg.eac)
    Fp, Fd, Fdp, Fdn, Mp, Md = lane_panels(primal, dual, B)
    args = (dual.Qd, dual.theta, primal.Gp, primal.Qp, primal.Qp_inv, Fp,
            Fd, Fdp, Fdn, kp_slack, Mp, Md, Y0)
    return args, dict(kernel_kwargs(cfg), accel=cfg.accel_every > 0,
                      gap_comp=cfg.gap_from_complementarity)


def solve_fused_tiled(primal, dual, Y0: Optional[torch.Tensor] = None,
                      cfg: Optional[SolverConfig] = None):
    """Drop-in analog of the plain engine's ``solver.solve_batched``
    for N past residency: the whole solve in one launch, Hessian streamed.
    ``cfg.accel_every`` must be 0 or ``check_every``, and ``check_every``
    even (:func:`tiled_inputs`).  A lane the kernel did not certify counts
    as converged when its exit state passes the verdict in PyTorch (the
    rescue of ``pqp_for_mpc_tpu/ops/tiled_solve_kernel.py:490-500``)."""
    args, kwargs = tiled_inputs(primal, dual, Y0, cfg)
    return fused_result(primal, dual, cfg,
                        *fused_full_solve_tiled(*args, **kwargs))
