"""K2: ``num_iters`` multiplicative PQP updates in one kernel launch.

The counterpart of ``pqp_for_mpc_tpu/ops/kernels.py:fused_pqp_iterations``
(a Pallas kernel that keeps both split matrices and a Y panel in VMEM).
Here the kernel is ``csrc/pqp_iterations.cu``, register-blocked: a block
owns a tile of lanes and every row, both splits and its tile of Y in shared
memory for all ``num_iters`` updates; a thread computes 4 rows x 4 lanes
with its forcing entries in registers (:func:`k2_plan`; see the note at the
top of the source).

Dispatch: a CPU tensor goes to :func:`fused_pqp_iterations_reference`, the
plain PyTorch version; a CUDA tensor launches the kernel, and a failed
build or launch raises.  ``fused_pqp_iterations.launches`` counts the
launches.
"""

from __future__ import annotations

import torch

from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.utils import tracing

#: largest N the register-resident kernels take (their NMAX templates)
N_MAX = 128

#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT_BYTES = 232448


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def fits_resident(n: int) -> bool:
    """Can the update kernel hold both ``(n, n)`` splits in one block's
    shared memory (rows padded to 4 floats) with ``y`` in registers?
    Replaces the JAX package's ``fits_vmem``."""
    return 1 <= n <= N_MAX and 2 * n * _round4(n) * 4 <= SMEM_LIMIT_BYTES


#: a K2 thread's rows and lanes, and the most threads and lane groups of a
#: block (``csrc/pqp_iterations.cu``: ``R``, ``L``, ``kMaxThreads``,
#: ``kMaxLaneGroups``)
K2_ROWS, K2_LANES, K2_MAX_THREADS, K2_MAX_LANE_GROUPS = 4, 4, 256, 32


def k2_plan(n: int, B: int) -> dict:
    """K2's launch plan for ``Y (n, B)``, as the kernel computes it: rows
    padded to a multiple of ``K2_ROWS``, one row group per ``K2_ROWS`` rows,
    the largest power-of-two count of lane groups (``K2_LANES`` lanes each)
    that keeps the block within ``K2_MAX_THREADS`` threads and
    ``K2_MAX_LANE_GROUPS`` groups, one block per lane tile; shared memory
    holds both splits (n x padded n) and two (n x lanes) iterate tiles."""
    if not fits_resident(n) or B < 1:
        raise ValueError(f"k2_plan needs 1 <= n <= {N_MAX} and B >= 1, got "
                         f"{n}, {B}")
    rows = -(-n // K2_ROWS) * K2_ROWS
    row_groups = rows // K2_ROWS
    lane_groups = 1
    while (2 * lane_groups <= K2_MAX_LANE_GROUPS
           and 2 * lane_groups * row_groups <= K2_MAX_THREADS):
        lane_groups *= 2
    lanes = K2_LANES * lane_groups
    return dict(rows_per_thread=K2_ROWS, lanes_per_thread=K2_LANES,
                row_groups=row_groups, lane_groups=lane_groups,
                threads=row_groups * lane_groups, lanes_per_block=lanes,
                blocks=-(-B // lanes),
                smem_bytes=4 * (2 * n * rows + 2 * n * lanes))


def _matrix(t: torch.Tensor, shape: tuple, name: str,
            device: torch.device) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _panel(t: torch.Tensor, rows: int, B: int, name: str,
           device: torch.device):
    """A batch-last panel for a kernel: ``(rows, B)`` per lane, or
    ``(rows,)``/``(rows, 1)``/a stride-0 ``(rows, B)`` view shared by
    every lane.  Returns (contiguous tensor, lane flag 1 or 0)."""
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() == 1 and t.shape[0] == rows:
        return t.contiguous(), 0
    if t.dim() == 2 and t.shape[0] == rows and t.shape[1] in (1, B):
        if t.shape[1] == 1 or (B > 1 and t.stride(1) == 0):
            return t[:, 0].contiguous(), 0
        return t.contiguous(), 1
    raise ValueError(f"{name}: expected ({rows},), ({rows}, 1) or "
                     f"({rows}, {B}), got {tuple(t.shape)}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start 16-byte aligned
    (a contiguous view at an odd storage offset): the kernels read such
    operands as 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} lies on {t.device}: the kernels take CUDA "
                     "tensors and their plain versions CPU tensors")


def fused_pqp_iterations_reference(Qdn_theta: torch.Tensor,
                                   Qdp_theta: torch.Tensor,
                                   Fdn: torch.Tensor, Fdp: torch.Tensor,
                                   Y: torch.Tensor, num_iters: int,
                                   den_eps: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``num_iters`` updates
    ``Y <- Y * (Qdn Y + Fdn) / max(Qdp Y + Fdp, den_eps)`` (no clamp when
    ``den_eps`` is 0; NaN propagates).  ``Fdn``/``Fdp`` are ``(N, B)`` or
    shared ``(N,)``/``(N, 1)``."""
    Fdn = Fdn if Fdn.dim() == 2 else Fdn[:, None]
    Fdp = Fdp if Fdp.dim() == 2 else Fdp[:, None]
    for _ in range(num_iters):
        num = Qdn_theta @ Y + Fdn
        den = Qdp_theta @ Y + Fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        Y = (num / den) * Y
    return Y


def fused_pqp_iterations(Qdn_theta: torch.Tensor, Qdp_theta: torch.Tensor,
                         Fdn: torch.Tensor, Fdp: torch.Tensor,
                         Y: torch.Tensor, num_iters: int,
                         den_eps: float = 0.0) -> torch.Tensor:
    """Run ``num_iters`` PQP updates in one launch.  Matrices ``(N, N)``,
    ``Y (N, B)``; ``Fdn``/``Fdp`` ``(N, B)`` or shared by every lane.
    Returns a new ``(N, B)`` tensor; semantically
    :func:`fused_pqp_iterations_reference` up to float32 summation order.
    """
    if not _on_cuda(Y, "Y"):
        return fused_pqp_iterations_reference(Qdn_theta, Qdp_theta, Fdn,
                                              Fdp, Y, num_iters, den_eps)
    if Y.dim() != 2:
        raise ValueError(f"Y: expected (N, B), got {tuple(Y.shape)}")
    N, B = Y.shape
    if not fits_resident(N):
        raise ValueError(f"fused_pqp_iterations: N={N} exceeds the "
                         f"resident kernel (N <= {N_MAX})")
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    dev = Y.device
    qdn = _matrix(Qdn_theta, (N, N), "Qdn_theta", dev)
    qdp = _matrix(Qdp_theta, (N, N), "Qdp_theta", dev)
    fdn, fdn_lane = _panel(Fdn, N, B, "Fdn", dev)
    fdp, fdp_lane = _panel(Fdp, N, B, "Fdp", dev)
    if fdn_lane != fdp_lane:
        # one lane flag serves both forcing panels
        fdn = fdn if fdn_lane else fdn[:, None].expand(N, B).contiguous()
        fdp = fdp if fdp_lane else fdp[:, None].expand(N, B).contiguous()
        fdn_lane = 1
    y = _matrix(Y, (N, B), "Y", dev)
    # the kernel reads each thread's lanes of Y and the panels as vectors
    fdn, fdp, y = (_aligned16(t) for t in (fdn, fdp, y))
    out = torch.empty_like(y)
    if B == 0:
        return out
    args = (qdn.data_ptr(), qdp.data_ptr(), fdn.data_ptr(), fdp.data_ptr(),
            fdn_lane, y.data_ptr(), out.data_ptr(), N, B, int(num_iters),
            float(den_eps), build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k2", device=dev):
        code = lib.pqp_iterations_f32(*args)
        build.check(code, "fused_pqp_iterations")
        fused_pqp_iterations.launches += 1
    return out


fused_pqp_iterations.launches = 0
