"""K8: the whole batched solve with G instances packed per lane column.

The counterpart of ``pqp_for_mpc_tpu/ops/packed_kernel.py``.  On the TPU,
``G = 128 // n_pad`` instances of one geometry are packed block-diagonally
(``kron(I_G, A)``) to fill the MXU's 128-deep contraction axis; every
reduction of the check, the accel step and the stall test becomes a
segment reduction (products with the 0/1 indicator ``E`` and ``E'``), and
lane state and iteration stamps live per segment.  The function is K1's
(:mod:`pqp_for_mpc_tpu_torch.ops.solve_kernel`), instance by instance.

* :func:`fused_full_solve_packed_reference` is the plain PyTorch version:
  the TPU kernel's body literally — kronned matrices, packed panels,
  segment reductions through ``E`` — looping until no segment is active
  or ``h > max_iters``.
* :func:`fused_full_solve_packed` takes K1's arguments.  CPU tensors go to
  the plain version; CUDA tensors launch ``csrc/full_solve_packed.cu`` (one
  warp per packed column, the geometry un-kronned in shared memory; see the
  note at the top of the source), and a failed build or launch raises.
  ``fused_full_solve_packed.launches`` counts the launches.
* :func:`solve_fused_packed` wraps it into a
  :class:`~pqp_for_mpc_tpu_torch.solver.SolveResult` with the rescue of
  :func:`~pqp_for_mpc_tpu_torch.ops.solve_kernel.fused_result`.  Nothing
  routes to it (nor in the JAX package): it is an explicit entry point.

Lane-state codes are int32, as K1's; the padding code 3 never leaves the
wrapper.  The TPU kernel's VMEM accounting (``packed_batch_block``) and its
``block_b``/``interpret`` arguments have no counterpart: :func:`fits_packed`
is the shared-memory fit test.
"""

from __future__ import annotations

from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (SMEM_LIMIT_BYTES, _matrix,
                                               _on_cuda, _panel)
from pqp_for_mpc_tpu_torch.ops.solve_kernel import (LANE_CERTIFIED,
                                                    LANE_MAX_ITERS,
                                                    LANE_PADDING,
                                                    LANE_STALLED,
                                                    fused_inputs,
                                                    fused_result)

#: the TPU's (8, 128) tile: sublane quantum and contraction depth
_SUBLANE, _LANE = 8, 128

#: packed columns per block of the CUDA kernel, and the per-warp segment
#: sums it stages (csrc/full_solve_packed.cu: kPackedWarps, kRedSlots)
_WARPS, _RED_SLOTS = 8, 5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_factor(n: int) -> int:
    """How many instances of dual dimension ``n`` pack into one 128-deep
    lane column (the JAX function).  1 means packing buys nothing (use
    ``solve_fused``)."""
    n_pad = _round_up(max(n, _SUBLANE), _SUBLANE)
    return max(1, _LANE // n_pad)


def smem_bytes(n: int, m: int) -> int:
    """Shared memory of one block of the kernel: the seven un-kronned
    matrices with rows padded to an odd stride, and per warp the staging
    slices of its G instances and the segment sums."""
    ldn, ldm = n | 1, m | 1
    G = pack_factor(n)
    mats = 3 * n * ldn + n * ldm + m * ldn + 2 * m * ldm
    per_warp = 2 * G * ldn + 2 * G * ldm + _RED_SLOTS * 32
    return (mats + _WARPS * per_warp) * 4


def fits_packed(n: int, m: int) -> bool:
    """Does the packed kernel take an ``N=n``, ``M=m`` problem: ``n``
    packs (G >= 2) and one block's shared memory holds the geometry?"""
    return (n >= 1 and m >= 1 and pack_factor(n) > 1
            and smem_bytes(n, m) <= SMEM_LIMIT_BYTES)


def _pack_panel(X, n_pad, G, Bc, row_fill=0.0, col_fill=0.0):
    """(N, B) -> (G*n_pad, Bc): instance g of packed column c is original
    lane g*Bc + c (contiguous batch groups), rows padded to n_pad with
    ``row_fill``, padded lanes filled with ``col_fill``."""
    N, B = X.shape
    Xp = torch.full((n_pad, G * Bc), float(col_fill), dtype=X.dtype,
                    device=X.device)
    Xp[:N, :B] = X
    Xp[N:, :B] = float(row_fill)
    return Xp.reshape(n_pad, G, Bc).transpose(0, 1).reshape(G * n_pad, Bc)


def _unpack_panel(P, n_pad, G, N, B):
    """Inverse of :func:`_pack_panel` (drops padding)."""
    Bc = P.shape[1]
    X = P.reshape(G, n_pad, Bc).transpose(0, 1).reshape(n_pad, G * Bc)
    return X[:N, :B]


def _pad_sq(A, size, diag):
    n = A.shape[0]
    if size == n:
        return A
    out = torch.zeros((size, size), dtype=torch.float32, device=A.device)
    out[:n, :n] = A
    if diag:
        idx = torch.arange(n, size, device=A.device)
        out[idx, idx] = float(diag)
    return out


def _does_not_pack(N: int, n_pad: int) -> ValueError:
    return ValueError(f"fused_full_solve_packed: N={N} pads to {n_pad} which "
                      "does not pack (G=1); use fused_full_solve")


def fused_full_solve_packed_reference(Qdn_theta, Qdp_theta, Qd, Gp, Qp,
                                      Qp_inv, Fp, Fd, Fdp, Fdn, Kp_slack,
                                      Mp, Md, Y0, *, max_iters: int,
                                      check_every: int,
                                      accel_every: int = 0,
                                      eaj: float = 1e-6, erj: float = 1e-6,
                                      strict: bool = True,
                                      den_eps: float = 1e-30,
                                      precision: str = "highest",
                                      gap_comp: bool = False):
    """The plain PyTorch version of the kernel: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/packed_kernel.py:_kernel``) on the whole packed
    batch at once.  Arguments as :func:`fused_full_solve_packed`."""
    N, B = Y0.shape
    M = Gp.shape[1]
    n_pad = _round_up(max(N, _SUBLANE), _SUBLANE)
    m_pad = _round_up(max(M, _SUBLANE), _SUBLANE)
    G = _LANE // n_pad
    if G <= 1:
        raise _does_not_pack(N, n_pad)
    Bc = -(-B // G)
    dev, f32 = Y0.device, torch.float32
    NP = G * n_pad

    eyeG = torch.eye(G, dtype=f32, device=dev)
    kron = lambda A: torch.kron(eyeG, A)
    # padded dual/primal coordinates: identity diagonal and zero forcing,
    # exact update fixed points that add 0 to every segment reduction
    qdn = kron(_pad_sq(Qdn_theta, n_pad, 1.0))
    qdp = kron(_pad_sq(Qdp_theta, n_pad, 1.0))
    qd = kron(_pad_sq(Qd, n_pad, 0.0))
    gp_pad = torch.zeros((n_pad, m_pad), dtype=f32, device=dev)
    gp_pad[:N, :M] = Gp
    gp = kron(gp_pad)
    qp = kron(_pad_sq(Qp, m_pad, 1.0))
    qpi = kron(_pad_sq(Qp_inv, m_pad, 1.0))

    lanes = lambda t, r: t.reshape(r, -1).expand(r, B)
    pack_n = lambda X, **kw: _pack_panel(X, n_pad, G, Bc, **kw)
    fp = _pack_panel(lanes(Fp, M), m_pad, G, Bc)
    fd = pack_n(lanes(Fd, N))
    fdp = pack_n(lanes(Fdp, N))
    fdn = pack_n(lanes(Fdn, N))
    kps = pack_n(lanes(Kp_slack, N), row_fill=float("inf"),
                 col_fill=float("inf"))
    y = pack_n(Y0, row_fill=1.0, col_fill=1.0)

    def seg_row(v):  # (B,) per-instance scalars -> (G, Bc)
        out = torch.zeros(G * Bc, dtype=f32, device=dev)
        out[:B] = v.reshape(-1).expand(B)
        return out.reshape(G, Bc)

    mp, md = seg_row(Mp), seg_row(Md)
    valid = seg_row(torch.ones(1, dtype=f32, device=dev))

    # segment indicators: E[g, i] = 1 iff i // pad == g
    seg_of = lambda pad: (torch.arange(G * pad, device=dev)[None, :] // pad
                          == torch.arange(G, device=dev)[:, None]).to(f32)
    En, Em = seg_of(n_pad), seg_of(m_pad)
    EnT = En.T.contiguous()
    seg_n = lambda x: En @ x          # (NP, Bc) -> (G, Bc)
    seg_m = lambda x: Em @ x
    rep_n = lambda s: EnT @ s         # (G, Bc) -> (NP, Bc)

    def one_update(y, done_full):
        num = qdn @ y + fdn
        den = qdp @ y + fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        return torch.where(done_full, y, (num / den) * y)

    def accel(y, done_seg):
        grad = qd @ y + fd
        p = torch.where((y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = seg_n(p * (qd @ p))
        alpha = torch.where(pQp > 0,
                            seg_n(p * p) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        yn = torch.clamp(y + rep_n(alpha) * p, min=0.0)
        fY = 0.5 * seg_n(y * (grad + fd))
        fYn = 0.5 * seg_n(yn * (qd @ yn)) + seg_n(fd * yn)
        keep = (fYn <= fY) & ~done_seg
        return torch.where(rep_n(keep.to(f32)) > 0.5, yn, y)

    def check(y):
        u = -(qpi @ (gp.T @ y + fp))                       # (MP, Bc)
        nviol = seg_n((gp @ u > kps).to(f32))
        feas = nviol == 0.0
        s1 = seg_n(y * (qd @ y))
        s2 = seg_n(fd * y)
        jd = 0.5 * s1 + s2 + 0.5 * md
        jp = 0.5 * seg_m(u * (qp @ u)) + seg_m(fp * u) + 0.5 * mp
        if gap_comp:
            gap = s1 + s2
            weak_fail = gap > 0.0
        else:
            gap = jp + jd
            weak_fail = jp > -jd
        fail = ~feas | (gap > eaj) | (gap / jd.abs() > erj)
        if strict:
            fail = fail | weak_fail
        return ~fail, u                                    # (G, Bc)

    n_chunks = max(1, check_every // max(accel_every, 1)) \
        if accel_every else 1
    i32 = torch.int32
    st = torch.where(valid == 0.0, LANE_PADDING, LANE_MAX_ITERS).to(i32)
    it = torch.zeros((G, Bc), dtype=i32, device=dev)
    h = 1
    while h <= max_iters and bool((st == LANE_MAX_ITERS).any()):
        done_seg = st > 0
        ok_seg, _ = check(y)
        newly = ok_seg & ~done_seg
        it = torch.where(newly, h, it)
        st = torch.where(newly, LANE_CERTIFIED, st)
        done_seg = done_seg | ok_seg
        done_full = rep_n(done_seg.to(f32)) > 0.5
        y_prev = y
        if accel_every:
            for _ in range(n_chunks):
                for _ in range(accel_every):
                    y = one_update(y, done_full)
                y = accel(y, done_seg)
        else:
            for _ in range(check_every):
                y = one_update(y, done_full)
        # per-segment stall freeze
        stalled = seg_n((y - y_prev).abs()) == 0.0
        newly_stalled = stalled & (st == LANE_MAX_ITERS)
        it = torch.where(newly_stalled, h + check_every, it)
        st = torch.where(newly_stalled, LANE_STALLED, st)
        h += check_every

    ok_seg, u = check(y)
    newly = ok_seg & (st == LANE_MAX_ITERS)
    it = torch.where(newly, h, it)
    st = torch.where(newly, LANE_CERTIFIED, st)
    it = torch.where(st > 0, it, h)
    return (_unpack_panel(y, n_pad, G, N, B), _unpack_panel(u, m_pad, G, M, B),
            it.reshape(G * Bc)[:B].to(i32), st.reshape(G * Bc)[:B].to(i32))


def fused_full_solve_packed(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                            Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                            max_iters: int, check_every: int,
                            accel_every: int = 0, eaj: float = 1e-6,
                            erj: float = 1e-6, strict: bool = True,
                            den_eps: float = 1e-30,
                            precision: str = "highest",
                            gap_comp: bool = False):
    """Run the full batched PQP solve with ``pack_factor(N)`` instances per
    packed column.  The contract of
    :func:`~pqp_for_mpc_tpu_torch.ops.solve_kernel.fused_full_solve`
    (shared geometry, panels per lane or shared, per-lane ``Kp_slack``);
    ``N`` must pack (``pack_factor(N) > 1``), else ``ValueError``.
    Returns ``(Y, U, iters, lane_state)``."""
    kw = dict(max_iters=max_iters, check_every=check_every,
              accel_every=accel_every, eaj=eaj, erj=erj, strict=strict,
              den_eps=den_eps, precision=precision, gap_comp=gap_comp)
    N, B = Y0.shape
    if pack_factor(N) <= 1:
        raise _does_not_pack(N, _round_up(max(N, _SUBLANE), _SUBLANE))
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_packed_reference(
            Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
            Kp_slack, Mp, Md, Y0, **kw)
    if Gp.dim() != 2:
        raise ValueError("fused_full_solve_packed: expected Gp (N, M)")
    M = Gp.shape[1]
    if not fits_packed(N, M):
        raise ValueError(
            f"fused_full_solve_packed: N={N}, M={M} need "
            f"{smem_bytes(N, M)} bytes of shared memory (limit "
            f"{SMEM_LIMIT_BYTES}); use solve_fused or solve_batched")
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
    code = lib.full_solve_packed_f32(
        *args, y.data_ptr(), u.data_ptr(), iters.data_ptr(),
        state.data_ptr(), N, M, B, int(max_iters), int(check_every),
        int(accel_every), float(eaj), float(erj), int(bool(strict)),
        float(den_eps), int(bool(gap_comp)), build.stream_handle(dev))
    build.check(code, "fused_full_solve_packed")
    fused_full_solve_packed.launches += 1
    return y, u, iters, state


fused_full_solve_packed.launches = 0


def solve_fused_packed(primal, dual, Y0: Optional[torch.Tensor] = None,
                       cfg: Optional[SolverConfig] = None):
    """Drop-in analog of
    :func:`~pqp_for_mpc_tpu_torch.ops.solve_kernel.solve_fused` on the
    packed kernel: shared geometry with ``pack_factor(N) > 1`` only, warm
    start and per-lane ``Kp`` as there.  A split-free dual raises a
    ``ValueError`` that names the fix (the JAX package fails on it with
    an opaque error)."""
    args, kwargs = fused_inputs(primal, dual, Y0, cfg,
                                name="solve_fused_packed")
    return fused_result(primal, dual, cfg,
                        *fused_full_solve_packed(*args, **kwargs))
