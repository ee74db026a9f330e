"""K3: multiplicative PQP updates with the Hessian streamed, past residency.

The counterpart of ``pqp_for_mpc_tpu/ops/tiled_kernel.py:
fused_pqp_iterations_tiled``.  Past the resident kernels (N > 128 here)
the update streams ONE matrix per sweep instead of the two materialized
splits and rebuilds both splits by relu on the fly:

* ``dtype="float32"``: ``Qd_hat = Qd + diag(max(diag, 0) - diag + theta)``
  (diagonal clamped at 0, theta folded in);
  ``num = relu(-Qd_hat) y + theta y + Fd^-``, ``den = relu(Qd_hat) y + Fd^+``
  — exact against the materialized splits whenever ``diag(Qd) >= 0``
  (``Qd = Gp Qp^-1 Gp'`` is PSD);
* ``dtype="bfloat16"`` (``solve_mixed``'s bulk phase): the clamped ``Qd``
  rounded ONCE to bfloat16, theta kept out of the matrix, raised to the
  rounded negative rowsums and applied as the same f32 term on both sides;
  ``y`` is rounded to bf16 for the product only, each bf16 x bf16 product is
  exact in float32 and summed in float32, the iterate stays float32.

:func:`streamed_matrix` builds the streamed matrix and its theta once per
solve; :func:`streamed_pqp_iterations` runs the updates on them (the CUDA
kernel ``csrc/pqp_iterations_tiled.cu`` for CUDA tensors, its plain PyTorch
version :func:`streamed_pqp_iterations_reference` for CPU tensors), and
counts its launches per stream type in
``streamed_pqp_iterations.launches``.  :func:`fused_pqp_iterations_tiled`
keeps the JAX signature (unsplit ``Qd`` and ``theta``) for the tests.  The
TPU's slab picker and VMEM budgets (``pick_tiled_blocks``) are not ported.
The float32 mode runs K4's float32 FMA tile on the CUDA cores over the
tiles of :func:`k3_f32_plan`; the bfloat16 mode runs its products on the
tensor cores (bf16 MMAs with float32 accumulation) over the tiles of
:func:`k3_bf16_plan` (see the source).
"""

from __future__ import annotations

import torch

from pqp_for_mpc_tpu_torch.lanes import _as2d
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (_aligned16, _matrix,
                                               _on_cuda, _panel)
from pqp_for_mpc_tpu_torch.utils import tracing

STREAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def streamed_matrix(Qd: torch.Tensor, theta: torch.Tensor,
                    dtype: str = "float32"):
    """``(Q, theta)`` that the streamed update takes for ``Qd (N, N)`` and
    ``theta (N,)``: ``Qd_hat`` and ``theta`` for ``"float32"``; the once-
    rounded clamped ``Qd`` and ``max(theta, rounded negative rowsums)`` for
    ``"bfloat16"``.  Build it once per solve: at N = 4096 the f32 matrix is
    67 MB."""
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"dtype must be one of {tuple(STREAM_DTYPES)}, "
                         f"got {dtype!r}")
    q = Qd.to(torch.float32).clone()
    diag = torch.clamp(torch.diagonal(q), min=0.0)     # NaN stays NaN
    theta = theta.to(torch.float32)
    if dtype == "bfloat16":
        q.diagonal().copy_(diag)
        q = q.to(torch.bfloat16)
        theta = torch.maximum(
            theta, torch.clamp(-q.float(), min=0.0).sum(dim=1))
    else:
        q.diagonal().copy_(diag + theta)
    return q.contiguous(), theta.contiguous()


#: streaming multiprocessors of an H100 SXM: the bf16 tile plan's target
#: block count (one block per SM at least)
H100_SMS = 132

#: the float32 FMA tile of K4 and of K3's float32 mode
#: (``csrc/fma_tile.cuh``: ``BM``, ``kThreads``, ``kStages``, ``BK``)
FMA_TILE_ROWS, FMA_THREADS, FMA_STAGES, FMA_BK = 32, 256, 3, 64


def fma_tile_lanes(B: int) -> int:
    """The narrowest of 32, 64 and 128 lanes that holds ``B``, else 128
    (``fma::tile_lanes``)."""
    return 32 if B <= 32 else 64 if B <= 64 else 128


def fma_smem_bytes(lanes: int) -> int:
    """Shared memory of one FMA-tile block of ``lanes`` lanes: the ring
    of A slabs (row-major rows padded to 68 floats, or transposed rows to
    36) and of X slabs."""
    a_slab = max(FMA_TILE_ROWS * (FMA_BK + 4), FMA_BK * (FMA_TILE_ROWS + 4))
    return 4 * FMA_STAGES * (a_slab + FMA_BK * lanes)


def k3_f32_plan(n: int, B: int) -> dict:
    """The float32 mode's tile plan for ``Y (n, B)``: K4's, 32-row tiles
    of the FMA tile as wide as :func:`fma_tile_lanes` makes them.  At
    N = 4096, B = 128 that is 128 blocks of 32 x 128, one per SM, Q read
    once per update; measured on an H100 (``tools/probe_k3.py``) they beat
    64 lanes over 256 blocks (4 x 4 FMAs per thread against 4 x 2).  Each
    entry's sum is one FMA chain in ascending k whatever the plan, so
    every plan gives the same bits."""
    if n < 1 or B < 1:
        raise ValueError(f"k3_f32_plan needs n, B >= 1, got {n}, {B}")
    lanes = fma_tile_lanes(B)
    return dict(tile_rows=FMA_TILE_ROWS, tile_lanes=lanes,
                threads=FMA_THREADS,
                blocks=-(-n // FMA_TILE_ROWS) * -(-B // lanes),
                smem_bytes=fma_smem_bytes(lanes),
                staged_by_cp_async=n % 4 == 0 and B % 4 == 0)


def k3_bf16_plan(n: int, B: int, sms: int = H100_SMS) -> dict:
    """The bf16 mode's tile plan for ``Y (n, B)``: the widest lane tile
    (16, 32 or 64 lanes) that the batch fills, then the tallest row tile
    (64, 32 or 16 rows) that still gives ``sms`` blocks, else 16 rows.  A
    warp covers 16 rows x 16 lanes of the tile (the fastest warp tile at
    N = 4096, B = 128 in ``tools/probe_k3.py``).  No depth split: at
    N = 4096, B = 128 the 32-row tiles give 256 blocks."""
    if n < 1 or B < 1:
        raise ValueError(f"k3_bf16_plan needs n, B >= 1, got {n}, {B}")
    lanes = 16 if B <= 16 else 32 if B <= 32 else 64
    lane_tiles = -(-B // lanes)
    rows = next((r for r in (64, 32, 16) if -(-n // r) * lane_tiles >= sms),
                16)
    return dict(tile_rows=rows, tile_lanes=lanes, threads=rows * lanes // 8,
                blocks=-(-n // rows) * lane_tiles,
                staged_by_cp_async=n % 8 == 0 and B % 8 == 0)


def streamed_pqp_iterations_reference(Q: torch.Tensor, theta: torch.Tensor,
                                      Fdn: torch.Tensor, Fdp: torch.Tensor,
                                      Y: torch.Tensor, num_iters: int,
                                      den_eps: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel on a streamed matrix from
    :func:`streamed_matrix`.  A bf16 ``Q`` runs the bf16 mode: the product
    is ``Q.float() @ Y.bfloat16().float()`` — each bf16 x bf16 product is
    exact in float32 and the sum stays float32, where ``Q @ Y.bfloat16()``
    would round the sum to bf16."""
    sym = Q.dtype == torch.bfloat16
    Qf = Q.float()
    q_neg = torch.clamp(-Qf, min=0.0)
    q_pos = torch.clamp(Qf, min=0.0)
    th = theta[:, None]
    Fdn, Fdp = _as2d(Fdn), _as2d(Fdp)
    for _ in range(num_iters):
        x = Y.bfloat16().float() if sym else Y
        tY = th * Y
        num = q_neg @ x + tY + Fdn
        den = (q_pos @ x + tY + Fdp) if sym else (q_pos @ x + Fdp)
        if den_eps:
            den = torch.clamp(den, min=den_eps)        # NaN stays NaN
        Y = (num / den) * Y
    return Y


def streamed_pqp_iterations(Q: torch.Tensor, theta: torch.Tensor,
                            Fdn: torch.Tensor, Fdp: torch.Tensor,
                            Y: torch.Tensor, num_iters: int,
                            den_eps: float = 0.0) -> torch.Tensor:
    """``num_iters`` updates of ``Y (N, B)`` on a streamed matrix ``Q``
    (float32 or bfloat16, from :func:`streamed_matrix`).  ``Fdn``/``Fdp``
    are ``(N, B)`` or shared ``(N,)``/``(N, 1)``.  Returns a new tensor;
    semantically :func:`streamed_pqp_iterations_reference` up to float32
    summation order.  One call is one kernel launch per update."""
    if not _on_cuda(Y, "Y"):
        return streamed_pqp_iterations_reference(Q, theta, Fdn, Fdp, Y,
                                                 num_iters, den_eps)
    if Y.dim() != 2:
        raise ValueError(f"Y: expected (N, B), got {tuple(Y.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    N, B = Y.shape
    dev = Y.device
    mode = {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(Q.dtype)
    if mode is None or Q.device != dev or tuple(Q.shape) != (N, N):
        raise ValueError(f"Q: expected float32 or bfloat16 ({N}, {N}) on "
                         f"{dev}, got {Q.dtype} {tuple(Q.shape)} on "
                         f"{Q.device}")
    q = Q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()                       # the kernels read 16-byte rows
    th = _matrix(theta, (N,), "theta", dev)
    fdn, fdn_lane = _panel(Fdn, N, B, "Fdn", dev)
    fdp, fdp_lane = _panel(Fdp, N, B, "Fdp", dev)
    if fdn_lane != fdp_lane:
        # one lane flag serves both forcing panels
        fdn = fdn if fdn_lane else fdn[:, None].expand(N, B).contiguous()
        fdp = fdp if fdp_lane else fdp[:, None].expand(N, B).contiguous()
        fdn_lane = 1
    y = _matrix(Y, (N, B), "Y", dev)
    if num_iters == 0 or B == 0:
        return y.clone()
    out = torch.empty_like(y)
    tmp = torch.empty_like(y) if num_iters > 1 else out
    yb = None
    if mode == "bfloat16":
        # the iterate's bf16 rounding, ping-pong, for the tensor cores
        plan = k3_bf16_plan(N, B)
        yb = torch.empty((2, N, B), dtype=torch.bfloat16, device=dev)
    else:
        plan = k3_f32_plan(N, B)
        y = _aligned16(y)                   # the tile stages y by cp.async
    rows, lanes = plan["tile_rows"], plan["tile_lanes"]
    args = (q.data_ptr(), int(mode == "bfloat16"), th.data_ptr(),
            fdn.data_ptr(), fdp.data_ptr(), fdn_lane, y.data_ptr(),
            out.data_ptr(), tmp.data_ptr(),
            None if yb is None else yb[0].data_ptr(),
            None if yb is None else yb[1].data_ptr(), N, B, int(num_iters),
            float(den_eps), rows, lanes, build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k3", device=dev):
        code = lib.pqp_iterations_tiled(*args)
        build.check(code, "streamed_pqp_iterations")
        streamed_pqp_iterations.launches[mode] += 1
    return out


streamed_pqp_iterations.launches = {"float32": 0, "bfloat16": 0}


def fused_pqp_iterations_tiled_reference(Qd, theta, Fdn, Fdp, Y,
                                         num_iters: int,
                                         den_eps: float = 0.0,
                                         dtype: str = "float32"):
    """The plain version of :func:`fused_pqp_iterations_tiled`."""
    Q, th = streamed_matrix(Qd, theta, dtype)
    return streamed_pqp_iterations_reference(Q, th, Fdn, Fdp, Y, num_iters,
                                             den_eps)


def fused_pqp_iterations_tiled(Qd, theta, Fdn, Fdp, Y, num_iters: int,
                               den_eps: float = 0.0,
                               dtype: str = "float32"):
    """``num_iters`` PQP updates with the Hessian streamed, in the JAX
    package's signature: the unsplit ``Qd (N, N)`` and ``theta (N,)``,
    panels ``(N, B)``.  Builds the streamed matrix on every call — a solve
    builds it once with :func:`streamed_matrix` and calls
    :func:`streamed_pqp_iterations` per check instead."""
    Q, th = streamed_matrix(Qd, theta, dtype)
    return streamed_pqp_iterations(Q, th, Fdn, Fdp, Y, num_iters, den_eps)
