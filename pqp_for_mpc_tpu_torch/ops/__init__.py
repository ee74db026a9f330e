"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
one module per TPU kernel of the JAX package's ``ops/``:
:mod:`~pqp_for_mpc_tpu_torch.ops.kernels` (K2, the fused updates),
:mod:`~pqp_for_mpc_tpu_torch.ops.solve_kernel` (K1, the whole solve),
:mod:`~pqp_for_mpc_tpu_torch.ops.tiled_kernel` (K3) and
:mod:`~pqp_for_mpc_tpu_torch.ops.tiled_solve_kernel` (K4), the streamed
large-N kernels, :mod:`~pqp_for_mpc_tpu_torch.ops.distinct_kernel` (K5) and
:mod:`~pqp_for_mpc_tpu_torch.ops.distinct_tiled_kernel` (K6, K7), the
distinct-geometry kernels, and :mod:`~pqp_for_mpc_tpu_torch.ops.
packed_kernel` (K8, the whole solve with instances packed per warp);
:mod:`~pqp_for_mpc_tpu_torch.ops.build` compiles and loads them."""
from pqp_for_mpc_tpu_torch.ops.packed_kernel import (  # noqa: F401
    solve_fused_packed)
