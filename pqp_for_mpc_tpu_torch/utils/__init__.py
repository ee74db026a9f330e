"""Utilities: solver-state checkpointing (:mod:`~pqp_for_mpc_tpu_torch.utils.
state`)."""
