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
TPU's slab picker and VMEM budgets (``pick_tiled_blocks``) are not ported:
the kernel's tile plan is fixed (32-row x 64-lane tiles, see the source).
"""

from __future__ import annotations

import torch

from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import _matrix, _on_cuda, _panel
from pqp_for_mpc_tpu_torch.solver import _as2d

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
    lib = build.load_library()
    code = lib.pqp_iterations_tiled(
        q.data_ptr(), int(mode == "bfloat16"), th.data_ptr(), fdn.data_ptr(),
        fdp.data_ptr(), fdn_lane, y.data_ptr(), out.data_ptr(),
        tmp.data_ptr(), N, B, int(num_iters), float(den_eps),
        build.stream_handle(dev))
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
