"""K5: the whole PQP solve for a batch of DISTINCT instances in one launch.

The counterpart of ``pqp_for_mpc_tpu/ops/distinct_kernel.py``: one geometry
per instance (``Qd``, its splits ``(B, N, N)``, ``Gp (B, N, M)``, ``Qp``/
``Qp^-1 (B, M, M)``, as :func:`~pqp_for_mpc_tpu_torch.dual.dualize_distinct`
builds them), and for each instance the whole solve — multiplicative
updates, the four-part check with the recovered U and the EXPLICIT gap
``Jp + Jd``, the safeguarded acceleration in ``accel_every`` chunks, the
stall freeze and a per-instance early exit.  The kernel is
``csrc/full_solve_distinct.cu``: one instance per thread-block cluster, its
``Qd`` rows resident in the cluster's shared memory where they fit, the
splits rebuilt from ``Qd`` and the splits' diagonals (see the note at the
top of the source); :func:`fused_full_solve_distinct_reference` is its plain
PyTorch version, the TPU kernel's body vectorised over the instances.  Lane
codes are K1's (0 max_iters, 1 certified, 2 stalled).

:func:`distinct_fits_resident` is the port's routing line for this kernel.
:func:`k5_plan` says whether the kernel keeps an instance's ``Qd`` rows
in shared memory for an ``(N, M)`` and which cluster sizes hold it; the
kernel takes any ``(N, M)`` the plan covers (:func:`fits_kernel`; N <=
:data:`K5_N_MAX` at M = N/4) and raises past it.  Dispatch: CPU tensors
run the plain version; CUDA tensors launch the kernel, and a failed build
or a launch the card refuses raises.
``fused_full_solve_distinct.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import (SolveResult, certificate_slack, costs,
                                         feasibility, kernel_kwargs,
                                         lane_batch, lane_panels,
                                         termination_fail)
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (SMEM_LIMIT_BYTES, _matrix,
                                               _on_cuda, _round4)
from pqp_for_mpc_tpu_torch.ops.solve_kernel import (LANE_CERTIFIED,
                                                    LANE_STALLED,
                                                    fused_full_solve_reference)
from pqp_for_mpc_tpu_torch.utils import tracing

#: one instance's matrices (three Qd splits, Gp twice, Qp twice) the router
#: lets K5 take.  The TPU kernel's per-grid-step VMEM operand budget
#: (``pqp_for_mpc_tpu/ops/distinct_kernel.py:52-69``), carried over as a
#: provisional line.  Counted without the TPU's (8, 128) padding it crosses
#: near N = 1,200 at M = N/4 (the TPU's padded count, near 1,150).  An H100
#: cell is to re-derive it (ROADMAP item 4.5c).
DISTINCT_OPERAND_BUDGET = 20 * 1024 * 1024

def distinct_fits_resident(n: int, m: int) -> bool:
    """Does the router send a distinct batch of ``N=n``, ``M=m`` to K5?
    True when one instance's matrices (``3 n^2 + 2 n m + 2 m^2`` floats)
    fit :data:`DISTINCT_OPERAND_BUDGET`."""
    return (3 * n * n + 2 * n * m + 2 * m * m) * 4 <= DISTINCT_OPERAND_BUDGET


#: cluster sizes K5 may take (blocks per instance; above 8 non-portable)
CLUSTER_SIZES = (16, 8, 4, 2, 1)


def cluster_smem_bytes(n: int, m: int, C: int, resident: bool) -> int:
    """Shared memory of one K5 block (``csrc/cluster_solve.cuh:
    cluster_smem_floats``) with C blocks per instance: its Qd rows when
    ``resident`` (rows zero-padded to a multiple of 4 floats), three
    N-vectors and two M-vectors, nine own-row vectors, two exchange slots and
    the reductions."""
    mat = -(-n // C) * _round4(n) if resident else 0
    own = _round4(-(-max(n, m) // C))
    slot = _round4(max(m, -(-n // C), 8))
    return 4 * (mat + 3 * _round4(n) + 2 * _round4(m)
                + 9 * own + 2 * slot + 8 * 32 + 8)


def k5_plan(n: int, m: int) -> dict:
    """Where K5 keeps the Qd rows for ``N=n``, ``M=m`` on an H100, whose
    blocks hold :data:`SMEM_LIMIT_BYTES` of shared memory and whose clusters
    take :data:`CLUSTER_SIZES`: ``resident`` (in shared memory) when they
    fit some size, else streamed from global memory; ``sizes`` maps the
    cluster sizes that hold that layout to their shared memory per block.
    The launcher picks the size on the card
    (``cudaOccupancyMaxActiveClusters``, fewest waves times rows per block;
    :func:`card_cluster`).  Raises a ValueError past the largest ``(N, M)``
    any size holds."""
    if n < 1 or m < 1:
        raise ValueError(f"K5 needs N, M >= 1, got N={n}, M={m}")
    for resident in (True, False):
        fits = {C: b for C in CLUSTER_SIZES if C <= n and (
            b := cluster_smem_bytes(n, m, C, resident)) <= SMEM_LIMIT_BYTES}
        if fits:
            return dict(n=n, m=m, resident=resident, sizes=fits)
    C = max(CLUSTER_SIZES)
    raise ValueError(
        f"fused_full_solve_distinct: N={n}, M={m} need "
        f"{cluster_smem_bytes(n, m, C, False)} bytes of shared memory per "
        f"block at {C} blocks per instance, more than a block's "
        f"{SMEM_LIMIT_BYTES} (K5 takes N <= {K5_N_MAX} at M = N/4); use "
        "solve_fused_distinct_tiled or solve_batched")


def fits_kernel(n: int, m: int) -> bool:
    """Does K5 take an ``N=n``, ``M=m`` problem at all?"""
    try:
        k5_plan(n, m)
    except ValueError:
        return False
    return True


def _n_max() -> int:
    """The largest N whose plan exists at M = N/4 (rounded up)."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cluster_smem_bytes(mid, -(-mid // 4), max(CLUSTER_SIZES),
                              False) <= SMEM_LIMIT_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


#: the largest N that K5 takes at M = N/4 (streamed, 16 blocks per instance)
K5_N_MAX = _n_max()


def card_cluster(n: int, m: int, B: int, resident: bool) -> dict:
    """What the K5 launcher picks on this card for ``B`` instances with the
    Qd rows ``resident`` or not: blocks per instance, clusters the card
    holds at once and shared memory per block.  Needs the card."""
    import ctypes
    out = (ctypes.c_int * 3)()
    build.check(build.load_library().full_solve_distinct_cluster(
        n, m, B, int(bool(resident)), out), "full_solve_distinct_cluster")
    return dict(blocks_per_instance=out[0], active_clusters=out[1],
                smem_bytes=out[2])


def fused_full_solve_distinct_reference(Qdn_theta, Qdp_theta, Qd, Gp, Qp,
                                        Qp_inv, Fp, Fd, Fdp, Fdn, Kp_slack,
                                        Mp, Md, Y0, *, max_iters: int,
                                        check_every: int,
                                        accel_every: int = 0,
                                        eaj: float = 1e-6, erj: float = 1e-6,
                                        strict: bool = True,
                                        den_eps: float = 1e-30,
                                        precision: str = "highest"):
    """The plain PyTorch version of the kernel: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/distinct_kernel.py:_kernel``) over all instances
    — K1's body with per-instance products and the explicit gap."""
    return fused_full_solve_reference(
        Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
        Kp_slack, Mp, Md, Y0, max_iters=max_iters, check_every=check_every,
        accel_every=accel_every, eaj=eaj, erj=erj, strict=strict,
        den_eps=den_eps, precision=precision, gap_comp=False)


def instance_rows(t: torch.Tensor, rows: int, B: int, name: str,
                  device) -> torch.Tensor:
    """A batch-last panel ``(rows, B)`` (or shared ``(rows,)``/
    ``(rows, 1)``, or per-instance scalars for ``rows == 1``) as the
    ``(B, rows)`` instance-major float32 copy the distinct kernels read,
    16-byte aligned."""
    t = _matrix(t, tuple(t.shape), name, device)
    if t.numel() not in (rows, rows * B):
        raise ValueError(f"{name}: expected {rows} or {rows * B} entries, "
                         f"got {tuple(t.shape)}")
    return t.reshape(rows, -1).expand(rows, B).T.contiguous()


def instance_matrix(t: torch.Tensor, B: int, r: int, c: int, name: str,
                    device):
    """A per-instance ``(B, r, c)`` matrix, or one ``(r, c)`` shared by every
    instance: ``(contiguous 16-byte aligned tensor, instance stride)``."""
    if t.dim() == 2:
        out, stride = _matrix(t, (r, c), name, device), 0
    else:
        out, stride = _matrix(t, (B, r, c), name, device), r * c
    return aligned(out), stride


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when its data does not start on 16 bytes (the kernels
    read rows as 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def split_diagonal(split: torch.Tensor, qd: torch.Tensor, sign: float,
                   name: str, device) -> torch.Tensor:
    """The diagonal ``(B, N)`` of a materialized split, the only part of it
    K5 reads, after checking on the first instance that its other entries
    are ``relu(sign * Qd)`` (the kernel rebuilds them from ``Qd``)."""
    B, N, _ = qd.shape
    if split.device != device or split.dtype != torch.float32 or \
            tuple(split.shape) != (B, N, N):
        raise ValueError(f"{name}: expected float32 ({B}, {N}, {N}) on "
                         f"{device}, got {split.dtype} {tuple(split.shape)} "
                         f"on {split.device}")
    if B:
        off = ~torch.eye(N, dtype=torch.bool, device=device)
        got, want = split[0][off], torch.clamp(sign * qd[0], min=0.0)[off]
        if not bool(((got == want) | (got.isnan() & want.isnan())).all()):
            raise ValueError(
                f"fused_full_solve_distinct: {name} is not relu("
                f"{'-' if sign < 0 else ''}Qd) off the diagonal; the kernel "
                "rebuilds the splits from Qd (build them with "
                "dualize_distinct)")
    return torch.diagonal(split, dim1=1, dim2=2).contiguous()


def fused_full_solve_distinct(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                              Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                              max_iters: int, check_every: int,
                              accel_every: int = 0, eaj: float = 1e-6,
                              erj: float = 1e-6, strict: bool = True,
                              den_eps: float = 1e-30,
                              precision: str = "highest"):
    """One-launch whole solve for B distinct instances.

    Matrices ``(B, N, N)`` (the splits and ``Qd``), ``Gp (B, N, M)`` and
    ``Qp``/``Qp_inv (B, M, M)`` (the primal ones may also be shared, 2-D);
    panels ``(M, B)``/``(N, B)`` per instance or shared; ``Mp``/``Md (B,)``;
    ``Kp_slack`` the pre-slackened threshold.  Returns ``(Y (N, B),
    U (M, B), iters (B,) int32, lane_state (B,) int32)``.

    The kernel reads only the diagonals of ``Qdn_theta`` and ``Qdp_theta``
    and rebuilds their other entries as ``relu(-Qd)`` and ``relu(Qd)``, as
    :func:`~pqp_for_mpc_tpu_torch.dual.dualize_distinct` builds them; on a
    CUDA tensor a pair of splits that differs from that off the diagonal
    (checked on the first instance) raises a ValueError.  The plain version
    takes any splits."""
    kw = dict(max_iters=max_iters, check_every=check_every,
              accel_every=accel_every, eaj=eaj, erj=erj, strict=strict,
              den_eps=den_eps, precision=precision)
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_distinct_reference(
            Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
            Kp_slack, Mp, Md, Y0, **kw)
    if Y0.dim() != 2 or Qd.dim() != 3:
        raise ValueError("fused_full_solve_distinct: expected Y0 (N, B) and "
                         "Qd (B, N, N)")
    N, B = Y0.shape
    M = Gp.shape[-1]
    plan = k5_plan(N, M)
    if check_every < 1 or accel_every < 0:
        raise ValueError("check_every must be >= 1 and accel_every >= 0")
    dev = Y0.device
    qd = aligned(_matrix(Qd, (B, N, N), "Qd", dev))
    dn, dp = (split_diagonal(t, qd, sign, name, dev) for t, sign, name in (
        (Qdn_theta, -1.0, "Qdn_theta"), (Qdp_theta, 1.0, "Qdp_theta")))
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
    args = (dn.data_ptr(), dp.data_ptr(), qd.data_ptr(), gp.data_ptr(),
            gp_stride, qp.data_ptr(), qpi.data_ptr(), qp_stride,
            *[t.data_ptr() for t in panels], y.data_ptr(), u.data_ptr(),
            iters.data_ptr(), state.data_ptr(), N, M, B, int(max_iters),
            int(check_every), int(accel_every), float(eaj), float(erj),
            int(bool(strict)), float(den_eps), int(plan["resident"]),
            build.stream_handle(dev))
    lib = build.load_library()
    with tracing.span("kernel.k5", device=dev):
        code = lib.full_solve_distinct_f32(*args)
        build.check(code, "fused_full_solve_distinct")
        fused_full_solve_distinct.launches += 1
    return y.T, u.T, iters, state


fused_full_solve_distinct.launches = 0


def distinct_inputs(primal, dual, Y0: Optional[torch.Tensor] = None,
                    cfg: Optional[SolverConfig] = None):
    """The arguments :func:`solve_fused_distinct` hands the kernel:
    ``(args, kwargs)`` for :func:`fused_full_solve_distinct` or,
    identically, for :func:`fused_full_solve_distinct_reference`.  Raises
    on 2-D ``Qd``, on a split-free dual and on a warm start whose batch is
    neither 1 nor B."""
    cfg = cfg or SolverConfig()
    if dual.Qd.dim() != 3:
        raise ValueError("solve_fused_distinct needs Qd (B, N, N); use "
                         "solve_fused for shared geometry")
    if dual.Qdn_theta is None:
        raise ValueError(
            "solve_fused_distinct reads the MATERIALIZED Qd splits — build "
            "the dual with dualize_distinct(materialize_splits=True), or use "
            "solve_fused_distinct_tiled (it never needs them); the JAX "
            "package fails here with an opaque TypeError")
    Y0, B = lane_batch(dual, Y0, cfg)
    kp_slack = primal.Kp + certificate_slack(primal.Kp, cfg.erc, cfg.eac)
    Fp, Fd, Fdp, Fdn, Mp, Md = lane_panels(primal, dual, B)
    args = (dual.Qdn_theta, dual.Qdp_theta, dual.Qd, primal.Gp, primal.Qp,
            primal.Qp_inv, Fp, Fd, Fdp, Fdn, kp_slack, Mp, Md, Y0)
    return args, dict(kernel_kwargs(cfg), accel_every=cfg.accel_every)


def distinct_result(primal, dual, cfg: Optional[SolverConfig], Y, U, iters,
                    lane_state):
    """A :class:`~pqp_for_mpc_tpu_torch.lanes.SolveResult` from K5's
    outputs, with the JAX wrapper's rescue
    (``pqp_for_mpc_tpu/ops/distinct_kernel.py:351-360``): feasibility and
    costs recomputed in PyTorch, and a stall-frozen instance counts as
    converged when its exit state passes the verdict with the explicit
    gap, the kernel's own certificate."""
    cfg = cfg or SolverConfig()
    feas = feasibility(primal, U, cfg.erc, cfg.eac)
    Jp, Jd = costs(primal, dual, Y, U)
    div = ~torch.isfinite(Y).all(dim=0)
    cert = lane_state == LANE_CERTIFIED
    stalled = lane_state == LANE_STALLED
    fail = termination_fail(feas, Jp, Jd, cfg)
    conv = (cert | (stalled & ~fail)) & ~div
    return SolveResult(U=U, Y=Y, iters=iters, converged=conv,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def solve_fused_distinct(primal, dual, Y0: Optional[torch.Tensor] = None,
                         cfg: Optional[SolverConfig] = None):
    """Drop-in analog of the plain engine's ``solver.solve_batched``
    for distinct-geometry batches in one launch; see
    :func:`distinct_inputs` and :func:`distinct_result`."""
    args, kwargs = distinct_inputs(primal, dual, Y0, cfg)
    return distinct_result(primal, dual, cfg,
                           *fused_full_solve_distinct(*args, **kwargs))
