"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:
:mod:`~pqp_for_mpc_tpu_torch.ops.kernels` (K2, the fused updates) and
:mod:`~pqp_for_mpc_tpu_torch.ops.solve_kernel` (K1, the whole solve);
:mod:`~pqp_for_mpc_tpu_torch.ops.build` compiles and loads them."""
