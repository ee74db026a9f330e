"""Utilities: solver-state checkpointing (:mod:`~pqp_for_mpc_tpu_torch.utils.
state`) and profiling (:mod:`~pqp_for_mpc_tpu_torch.utils.profiling`:
``trace`` and ``timed``)."""
