"""K6 and K7: distinct-geometry solves with each instance's Hessian streamed.

The counterpart of ``pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py``, for
instances past the resident kernel K5.  Both stream ONE matrix per instance
and rebuild the two splits by relu on the fly, as K3 does for shared
geometry (:mod:`pqp_for_mpc_tpu_torch.ops.tiled_kernel`):

* :func:`distinct_streamed_matrix` builds it once per solve: in
  ``"float32"`` mode ``Qd_hat = Qd`` with diagonal ``max(diag, 0) + theta``
  (theta folded in); in ``"bfloat16"`` mode the diagonal-clamped ``Qd``
  rounded ONCE to bfloat16, theta kept out of the matrix and raised to each
  instance's rounded negative rowsums (``solve_mixed``'s consistency rule);
* K7, :func:`distinct_streamed_iterations` (``csrc/
  pqp_iterations_distinct_tiled.cu``): ``num_iters`` updates on that
  matrix in one cooperative launch, counted per stream type in
  ``distinct_streamed_iterations.launches``; the bulk engine of
  ``solve_mixed`` on 3-D ``Qd``.  The matrices are read from device memory
  once per launch: each block keeps as many of its rows as fit in shared
  memory for the later updates (:func:`k7_plan`).
  :func:`fused_pqp_iterations_distinct_tiled` keeps the JAX signature
  (unsplit ``Qd`` and ``theta``) and builds the matrix on every call;
* K6, :func:`fused_full_solve_distinct_tiled` (``csrc/
  full_solve_distinct_tiled.cu``): the whole solve in one cooperative
  launch — check pass with ``Y'Qd_hat``, ``Y'Gp`` and the ``Gp U``
  feasibility rows, either gap, accel at the check cadence, stall freeze
  over the whole round, per-instance early exit.  Each instance is spread
  over many blocks that keep its rows of ``Qd_hat`` in their shared memory
  as far as they fit, a few instances side by side (:func:`k6_plan`).  :func:`solve_fused_distinct_tiled` is an explicit
  entry point: the router never picks it.  It takes a split-free dual.

The TPU's slab heights (``BLOCK_N``, ``BLOCK_N_BF16``) and its padding rule
are TPU artefacts and are not ported.  Dispatch: CPU tensors run the plain
versions (the ``*_reference`` functions); CUDA tensors launch the kernels,
and a failed build or a refused launch raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import (_as2d, _mv, _mvT, certificate_slack,
                                         kernel_kwargs, lane_batch,
                                         lane_panels)
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.distinct_kernel import (aligned,
                                                       instance_matrix,
                                                       instance_rows)
from pqp_for_mpc_tpu_torch.ops.kernels import (SMEM_LIMIT_BYTES, _matrix,
                                               _on_cuda)
from pqp_for_mpc_tpu_torch.ops.solve_kernel import (LANE_CERTIFIED,
                                                    LANE_MAX_ITERS,
                                                    LANE_STALLED,
                                                    fused_result)
from pqp_for_mpc_tpu_torch.ops.tiled_kernel import STREAM_DTYPES
from pqp_for_mpc_tpu_torch.utils import tracing

#: largest N of K7: the product's copy of one instance's y in shared memory
K7_N_MAX = SMEM_LIMIT_BYTES // 4
#: SMs of an H100 SXM: the plans' default (the wrappers pass the card's)
H100_SMS = 132
#: threads of a K6 or K7 block (one block per SM); K6's instance sums run in
#: the order of the previous design's blocks per instance, at most
#: K6_RANKS (``csrc/full_solve_distinct_tiled.cu``: ``kK6MaxRanks``), with
#: at most K6_MAX_SUMS values per reduction (``kK6MaxK``)
K67_THREADS, K6_RANKS, K6_MAX_SUMS = 512, 16, 3
#: bytes of Qd_hat rows that instances side by side may re-read from global
#: memory on every pass: half the 50 MB L2 (K6's plan; at N=2048 13.0 MB
#: per update paid more than 29.8 MB, 46.6 MB lost)
K6_L2_BUDGET = 25_000_000


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _resident_total(total: int, blocks: int, resident: int) -> int:
    """Rows kept in shared memory when ``total`` rows are split evenly over
    ``blocks`` (``split_rows``) and each keeps at most ``resident``."""
    base, rem = divmod(total, blocks)
    return rem * min(base + 1, resident) + (blocks - rem) * min(base,
                                                                 resident)


def k7_plan(n: int, B: int, dtype: str = "bfloat16",
            sms: int = H100_SMS) -> dict:
    """K7's layout for ``B`` instances of ``n`` rows with a ``dtype`` stream
    on a card of ``sms`` SMs, as the kernel runs it: one block of
    :data:`K67_THREADS` threads per SM; the ``B n`` rows split evenly over
    the blocks in instance-major order; each block keeps its last
    ``resident_rows`` rows in shared memory (after y, staged in the stream's
    type), the most that fit :data:`SMEM_LIMIT_BYTES`.  ``resident_bytes``
    are read from device memory once per launch, ``l2_remainder_bytes`` on
    every update (from L2 where they fit it)."""
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"dtype must be one of {tuple(STREAM_DTYPES)}, "
                         f"got {dtype!r}")
    if not 1 <= n <= K7_N_MAX or B < 1 or sms < 1:
        raise ValueError(f"k7_plan needs 1 <= n <= {K7_N_MAX}, B, sms >= 1; "
                         f"got n={n}, B={B}, sms={sms}")
    size = 2 if dtype == "bfloat16" else 4
    row = n * size
    x_bytes = -(-row // 16) * 16
    total = B * n
    rows = -(-total // sms)
    resident = min(rows, (SMEM_LIMIT_BYTES - x_bytes) // row)
    kept = _resident_total(total, sms, resident)
    return dict(n=n, batch=B, dtype=dtype, blocks=sms, threads=K67_THREADS,
                rows_per_block=rows, resident_rows=resident,
                smem_bytes=x_bytes + resident * row,
                matrix_bytes=total * row, resident_bytes=kept * row,
                l2_remainder_bytes=(total - kept) * row,
                vector_rows=n % (16 // size) == 0)


@functools.lru_cache(maxsize=None)
def _k7_launch(n: int, B: int, dtype: str, sms: int) -> tuple:
    """(blocks, resident rows) of :func:`k7_plan`: the solve launches K7
    once per check, so the plan is worked out once per shape."""
    plan = k7_plan(n, B, dtype, sms)
    return plan["blocks"], plan["resident_rows"]


def k6_smem_bytes(n: int, m: int, per_inst: int, resident: int,
                  staged: bool = True) -> int:
    """Shared memory of one K6 block (``csrc/full_solve_distinct_tiled.cu``:
    ``k6_smem_floats``): ``resident`` rows of ``Qd_hat``; y, p, yn, y at the
    check and Fd; t, U and Fp; when ``staged``, the exchanged rows a
    reduction reads; five own-row vectors; the reductions."""
    rows = -(-n // per_inst)
    vectors = (7 if staged else 5) * _round4(n) + \
        (4 if staged else 3) * _round4(m)
    return 4 * (_round4(resident * n) + vectors + 5 * _round4(rows)
                + K6_RANKS * K6_MAX_SUMS * (K67_THREADS // 32 + 1)
                + K6_MAX_SUMS + 2 * (K6_RANKS + 4))


def k6_plan(n: int, m: int, B: int, sms: int = H100_SMS) -> dict:
    """K6's layout for ``B`` instances (``N=n``, ``M=m``) on a card of
    ``sms`` SMs, as the kernel runs it: one block of :data:`K67_THREADS`
    threads per SM, grouped into ``slots`` of ``blocks_per_instance``; a
    slot solves instances one after the other (``waves`` of them).  Each
    block keeps ``resident_rows`` of its ``rows_per_block`` rows of
    ``Qd_hat`` in shared memory and reads the rest from global memory on
    every pass (``streamed_rows`` per instance).  The plan takes the fewest
    waves among the layouts whose streamed rows, over all slots, stay within
    :data:`K6_L2_BUDGET` (one slot is always allowed), then the fewest
    streamed rows: at N=2048, M=512, B=8 on an H100 two instances side by
    side, each over 66 blocks with 13 of 32 rows streamed, ran 1.30x faster
    than one over all 132 blocks with every row resident, three 1.24x, four
    0.97x (``tools/probe_k6.py --slots``).  ``staged``: whether the reductions
    copy the exchanged rows into shared memory (else they read them from
    L2: the layout that leaves room for the largest N).  ``ranks``: the
    row ranges whose order every instance sum keeps (the previous design's
    16 blocks per instance, fewer below N = 16); ``exchange_floats``: half
    of a slot's exchange buffer."""
    if n < 1 or m < 1 or B < 1 or sms < 1:
        raise ValueError(f"k6_plan needs n, m, B, sms >= 1, got {n}, {m}, "
                         f"{B}, {sms}")
    best = None
    for staged in (True, False):
        for slots in range(1, min(B, sms) + 1):
            per_inst = min(n, sms // slots)   # every block owns a row
            resident = -(-n // per_inst)
            while resident >= 0 and k6_smem_bytes(
                    n, m, per_inst, resident, staged) > SMEM_LIMIT_BYTES:
                resident -= 1
            if resident < 0:
                continue
            streamed = n - _resident_total(n, per_inst, resident)
            if slots > 1 and slots * streamed * 4 * n > K6_L2_BUDGET:
                continue
            key = (-(-B // slots), streamed, slots)
            if best is None or key < best[0]:
                best = (key, slots, per_inst, resident)
        if best is not None:
            break
    if best is None:
        raise ValueError(
            f"fused_full_solve_distinct_tiled: N={n}, M={m} need "
            f"{k6_smem_bytes(n, m, min(n, sms), 0, False)} bytes of shared "
            f"memory per block before any row of Qd_hat, more than "
            f"{SMEM_LIMIT_BYTES}")
    (waves, streamed, _), slots, per_inst, resident = best
    ranks = min(K6_RANKS, 1 << (n.bit_length() - 1))
    return dict(n=n, m=m, batch=B, blocks=slots * per_inst, slots=slots,
                blocks_per_instance=per_inst, threads=K67_THREADS,
                rows_per_block=-(-n // per_inst), resident_rows=resident,
                streamed_rows=streamed, staged=staged,
                smem_bytes=k6_smem_bytes(n, m, per_inst, resident, staged),
                waves=waves, ranks=ranks,
                exchange_floats=_round4(max(2 * n + m, ranks * m)))

def distinct_streamed_matrix(Qd: torch.Tensor, theta: torch.Tensor,
                             dtype: str = "float32"):
    """``(Q (B, N, N), theta (B, N))`` that the streamed distinct kernels
    take for ``Qd (B, N, N)`` and ``theta (B, N)`` (see the module
    docstring).  Build it once per solve: at B = 8, N = 2048 the float32
    matrix is 134 MB."""
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"dtype must be one of {tuple(STREAM_DTYPES)}, "
                         f"got {dtype!r}")
    if Qd.dim() != 3:
        raise ValueError(f"Qd: expected (B, N, N), got {tuple(Qd.shape)}")
    q = Qd.to(torch.float32).clone()
    diag = torch.clamp(torch.diagonal(q, dim1=1, dim2=2), min=0.0)
    theta = theta.to(torch.float32).expand(q.shape[:2])
    if dtype == "bfloat16":
        torch.diagonal(q, dim1=1, dim2=2).copy_(diag)
        q = q.to(torch.bfloat16)
        theta = torch.maximum(
            theta, torch.clamp(-q.float(), min=0.0).sum(dim=2))
    else:
        torch.diagonal(q, dim1=1, dim2=2).copy_(diag + theta)
    return q.contiguous(), theta.contiguous()


def distinct_streamed_iterations_reference(Q, theta, Fdn, Fdp, Y,
                                           num_iters: int,
                                           den_eps: float = 0.0):
    """The plain PyTorch version of K7 on a matrix from
    :func:`distinct_streamed_matrix`: K3's update
    (``tiled_kernel.streamed_pqp_iterations_reference``) with per-instance
    products.  A bf16 ``Q`` runs the bf16 mode: the product is
    ``Q.float()`` times ``Y.bfloat16().float()``, each bf16 x bf16 product
    exact in float32 and summed in float32."""
    sym = Q.dtype == torch.bfloat16
    Qf = Q.float()
    q_neg = torch.clamp(-Qf, min=0.0)
    q_pos = torch.clamp(Qf, min=0.0)
    th = theta.T
    Fdn, Fdp = _as2d(Fdn), _as2d(Fdp)
    for _ in range(num_iters):
        x = Y.bfloat16().float() if sym else Y
        tY = th * Y
        num = _mv(q_neg, x) + tY + Fdn
        den = (_mv(q_pos, x) + tY + Fdp) if sym else (_mv(q_pos, x) + Fdp)
        if den_eps:
            den = torch.clamp(den, min=den_eps)        # NaN stays NaN
        Y = (num / den) * Y
    return Y


def distinct_streamed_iterations(Q, theta, Fdn, Fdp, Y, num_iters: int,
                                 den_eps: float = 0.0):
    """``num_iters`` updates of ``Y (N, B)`` on a per-instance streamed
    matrix ``Q (B, N, N)`` (float32 or bfloat16, from
    :func:`distinct_streamed_matrix`) with ``theta (B, N)``; ``Fdn``/
    ``Fdp`` ``(N, B)`` or shared.  Returns a new tensor; semantically
    :func:`distinct_streamed_iterations_reference` up to float32 summation
    order.  One call is one cooperative launch (:func:`k7_plan`)."""
    if not _on_cuda(Y, "Y"):
        return distinct_streamed_iterations_reference(Q, theta, Fdn, Fdp, Y,
                                                      num_iters, den_eps)
    if Y.dim() != 2:
        raise ValueError(f"Y: expected (N, B), got {tuple(Y.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    N, B = Y.shape
    dev = Y.device
    mode = {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(Q.dtype)
    if mode is None or Q.device != dev or tuple(Q.shape) != (B, N, N):
        raise ValueError(f"Q: expected float32 or bfloat16 ({B}, {N}, {N}) "
                         f"on {dev}, got {Q.dtype} {tuple(Q.shape)} on "
                         f"{Q.device}")
    if N > K7_N_MAX:
        raise ValueError(f"distinct_streamed_iterations: N={N} exceeds "
                         f"{K7_N_MAX} (one instance's y in shared memory)")
    q = aligned(Q.contiguous())
    th = _matrix(theta, (B, N), "theta", dev)
    fdn = instance_rows(Fdn, N, B, "Fdn", dev)
    fdp = instance_rows(Fdp, N, B, "Fdp", dev)
    y = instance_rows(Y, N, B, "Y", dev)
    if num_iters == 0 or B == 0:
        return y.T.clone()
    out = torch.empty_like(y)
    tmp = torch.empty_like(y) if num_iters > 1 else out
    blocks, resident = _k7_launch(N, B, mode, _sm_count(dev))
    args = (q.data_ptr(), int(mode == "bfloat16"), th.data_ptr(),
            fdn.data_ptr(), fdp.data_ptr(), y.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), N, B, int(num_iters), float(den_eps), blocks,
            resident, build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k7", device=dev):
        code = lib.pqp_iterations_distinct_tiled(*args)
        build.check(code, "distinct_streamed_iterations")
        distinct_streamed_iterations.launches[mode] += 1
    return out.T


distinct_streamed_iterations.launches = {"float32": 0, "bfloat16": 0}


def fused_pqp_iterations_distinct_tiled_reference(Qd, theta, Fdn, Fdp, Y,
                                                  num_iters: int,
                                                  den_eps: float = 0.0,
                                                  dtype: str = "float32"):
    """The plain version of :func:`fused_pqp_iterations_distinct_tiled`."""
    Q, th = distinct_streamed_matrix(Qd, theta, dtype)
    return distinct_streamed_iterations_reference(Q, th, Fdn, Fdp, Y,
                                                  num_iters, den_eps)


def fused_pqp_iterations_distinct_tiled(Qd, theta, Fdn, Fdp, Y,
                                        num_iters: int,
                                        den_eps: float = 0.0,
                                        dtype: str = "float32"):
    """``num_iters`` PQP updates for B distinct instances, each instance's
    Hessian streamed, in the JAX package's signature: the unsplit
    ``Qd (B, N, N)`` and ``theta (B, N)``, panels ``(N, B)``.  Builds the
    streamed matrix on every call — a solve builds it once with
    :func:`distinct_streamed_matrix` and calls
    :func:`distinct_streamed_iterations` per check instead."""
    Q, th = distinct_streamed_matrix(Qd, theta, dtype)
    return distinct_streamed_iterations(Q, th, Fdn, Fdp, Y, num_iters,
                                        den_eps)


def _check_args(check_every: int) -> None:
    if check_every < 1:
        raise ValueError("check_every must be >= 1")


def fused_full_solve_distinct_tiled_reference(Qd, theta, Gp, Qp, Qp_inv, Fp,
                                              Fd, Fdp, Fdn, Kp_slack, Mp,
                                              Md, Y0, *, max_iters: int,
                                              check_every: int,
                                              accel: bool = False,
                                              eaj: float = 1e-6,
                                              erj: float = 1e-6,
                                              strict: bool = True,
                                              den_eps: float = 1e-30,
                                              precision: str = "highest",
                                              gap_comp: bool = False):
    """The plain PyTorch version of K6: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py:_kernel``) over all
    instances.  The stall test compares the iterate after the whole round
    (updates and accel) with the one at its check."""
    _check_args(check_every)
    Qh, th = distinct_streamed_matrix(Qd, theta, "float32")
    q_neg, q_pos = torch.clamp(-Qh, min=0.0), torch.clamp(Qh, min=0.0)
    th = th.T
    N, B = Y0.shape
    M = Gp.shape[-1]
    lanes = lambda t, r: t.reshape(r, -1).expand(r, B)
    fp, fd = lanes(Fp, M), lanes(Fd, N)
    fdp, fdn, kps = lanes(Fdp, N), lanes(Fdn, N), lanes(Kp_slack, N)
    mp = Mp.reshape(-1).expand(B)
    md = Md.reshape(-1).expand(B)
    dev = Y0.device

    def qd_col(x):          # Qd (diagonal clamped) x, per instance
        return _mv(Qh, x) - th * x

    def update(y, done):
        num = _mv(q_neg, y) + th * y + fdn
        den = _mv(q_pos, y) + fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        return torch.where(done, y, (num / den) * y)

    def check(y):
        qdy = qd_col(y)
        u = -_mv(Qp_inv, _mvT(Gp, y) + fp)
        feas = ~(_mv(Gp, u) > kps).any(dim=0)
        s1 = (y * qdy).sum(dim=0)
        s2 = (fd * y).sum(dim=0)
        jd = 0.5 * s1 + s2 + 0.5 * md
        jp = (0.5 * (u * _mv(Qp, u)).sum(dim=0) + (fp * u).sum(dim=0)
              + 0.5 * mp)
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
        return torch.where(keep, yn, y)

    y = Y0
    st = torch.zeros(B, dtype=torch.int32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    h, unsolved = 1, B
    while unsolved > 0 and h <= max_iters:
        ok, _ = check(y)
        newly = ok & (st == LANE_MAX_ITERS)
        it = torch.where(newly, h, it)
        st = torch.where(newly, LANE_CERTIFIED, st)
        done = st > 0
        y_old = y
        for _ in range(check_every):
            y = update(y, done)
        if accel:
            y = accel_step(y, done)
        stalled = ((y - y_old).abs().sum(dim=0) == 0.0) \
            & (st == LANE_MAX_ITERS)
        it = torch.where(stalled, h + check_every, it)
        st = torch.where(stalled, LANE_STALLED, st)
        unsolved = int((st == LANE_MAX_ITERS).sum())
        h += check_every

    ok, u = check(y)
    active = st == LANE_MAX_ITERS
    st = torch.where(ok & active, LANE_CERTIFIED, st)
    it = torch.where(active, h, it)
    return y, u, it.to(torch.int32), st.to(torch.int32)


def fused_full_solve_distinct_tiled(Qd, theta, Gp, Qp, Qp_inv, Fp, Fd, Fdp,
                                    Fdn, Kp_slack, Mp, Md, Y0, *,
                                    max_iters: int, check_every: int,
                                    accel: bool = False, eaj: float = 1e-6,
                                    erj: float = 1e-6, strict: bool = True,
                                    den_eps: float = 1e-30,
                                    precision: str = "highest",
                                    gap_comp: bool = False):
    """Whole-solve launch for B distinct instances, each instance's
    ``Qd_hat`` streamed (built here, once per solve, from the unsplit
    ``Qd (B, N, N)`` and ``theta (B, N)``).  ``Gp (B, N, M)``, ``Qp``/
    ``Qp_inv (B, M, M)`` (or shared 2-D), panels per instance or shared.
    Returns ``(Y (N, B), U (M, B), iters, lane_state)`` with K1's codes."""
    kw = dict(max_iters=max_iters, check_every=check_every, accel=accel,
              eaj=eaj, erj=erj, strict=strict, den_eps=den_eps,
              precision=precision, gap_comp=gap_comp)
    _check_args(check_every)
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_distinct_tiled_reference(
            Qd, theta, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md,
            Y0, **kw)
    if Y0.dim() != 2 or Qd.dim() != 3:
        raise ValueError("fused_full_solve_distinct_tiled: expected "
                         "Y0 (N, B) and Qd (B, N, N)")
    N, B = Y0.shape
    M = Gp.shape[-1]
    dev = Y0.device
    Qh, th = distinct_streamed_matrix(_matrix(Qd, (B, N, N), "Qd", dev),
                                      _matrix(theta, (B, N), "theta", dev),
                                      "float32")
    gp, gp_stride = instance_matrix(Gp, B, N, M, "Gp", dev)
    qp, qp_stride = instance_matrix(Qp, B, M, M, "Qp", dev)
    qpi, qpi_stride = instance_matrix(Qp_inv, B, M, M, "Qp_inv", dev)
    if qpi_stride != qp_stride:
        raise ValueError("Qp and Qp_inv must both be shared or both per "
                         "instance")
    panels = [instance_rows(t, r, B, name, dev) for t, r, name in (
        (Fp, M, "Fp"), (Fd, N, "Fd"), (Fdp, N, "Fdp"), (Fdn, N, "Fdn"),
        (Kp_slack, N, "Kp_slack"), (Mp, 1, "Mp"), (Md, 1, "Md"),
        (Y0, N, "Y0"))]
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, N), **f32)
    u = torch.empty((B, M), **f32)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return y.T, u.T, iters, state
    plan = k6_plan(N, M, B, _sm_count(dev))
    xch = torch.empty(plan["slots"] * 2 * plan["exchange_floats"], **f32)
    arrive = torch.zeros(plan["slots"], dtype=torch.int32, device=dev)
    qh = aligned(Qh)
    args = (qh.data_ptr(), th.data_ptr(), gp.data_ptr(), gp_stride,
            qp.data_ptr(), qpi.data_ptr(), qp_stride,
            *[t.data_ptr() for t in panels], y.data_ptr(), u.data_ptr(),
            iters.data_ptr(), state.data_ptr(), xch.data_ptr(),
            arrive.data_ptr(), N, M, B, int(max_iters), int(check_every),
            int(bool(accel)), float(eaj), float(erj), int(bool(strict)),
            float(den_eps), int(bool(gap_comp)), plan["blocks_per_instance"],
            plan["slots"], plan["resident_rows"], int(plan["staged"]),
            plan["ranks"],
            plan["exchange_floats"], build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k6", device=dev):
        code = lib.full_solve_distinct_tiled_f32(*args)
        build.check(code, "fused_full_solve_distinct_tiled")
        fused_full_solve_distinct_tiled.launches += 1
    return y.T, u.T, iters, state


fused_full_solve_distinct_tiled.launches = 0


def distinct_tiled_inputs(primal, dual, Y0: Optional[torch.Tensor] = None,
                          cfg: Optional[SolverConfig] = None):
    """The arguments :func:`solve_fused_distinct_tiled` hands the kernel:
    ``(args, kwargs)`` for :func:`fused_full_solve_distinct_tiled` or,
    identically, for its plain version.  Raises the JAX wrapper's two
    ValueErrors: ``accel_every`` not in ``{0, check_every}``, ``Qd`` not
    3-D."""
    cfg = cfg or SolverConfig()
    if cfg.accel_every not in (0, cfg.check_every):
        raise ValueError(
            "solve_fused_distinct_tiled supports accel_every in "
            "{0, check_every} (the accel runs at the check cadence; each "
            "step costs three extra Hessian streams)")
    if dual.Qd.dim() != 3:
        raise ValueError("solve_fused_distinct_tiled needs Qd (B, N, N)")
    Y0, B = lane_batch(dual, Y0, cfg)
    theta = dual.theta.reshape(-1, dual.n_con).expand(B, dual.n_con)
    kp_slack = primal.Kp + certificate_slack(primal.Kp, cfg.erc, cfg.eac)
    Fp, Fd, Fdp, Fdn, Mp, Md = lane_panels(primal, dual, B)
    args = (dual.Qd, theta, primal.Gp, primal.Qp, primal.Qp_inv, Fp, Fd,
            Fdp, Fdn, kp_slack, Mp, Md, Y0)
    return args, dict(kernel_kwargs(cfg), accel=cfg.accel_every > 0,
                      gap_comp=cfg.gap_from_complementarity)


def solve_fused_distinct_tiled(primal, dual,
                               Y0: Optional[torch.Tensor] = None,
                               cfg: Optional[SolverConfig] = None):
    """Drop-in analog of the plain engine's ``solver.solve_batched``
    for distinct instances past K5: the whole solve in one launch, each
    instance's geometry streamed.  Takes a split-free dual
    (``dualize_distinct(materialize_splits=False)``).  A lane the kernel did
    not certify counts as converged when its exit state passes the verdict
    in PyTorch with the gap ``cfg`` asks for (the rescue of
    ``pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py:410-420``)."""
    args, kwargs = distinct_tiled_inputs(primal, dual, Y0, cfg)
    return fused_result(primal, dual, cfg,
                        *fused_full_solve_distinct_tiled(*args, **kwargs))
