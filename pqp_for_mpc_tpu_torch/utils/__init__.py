"""Utilities: solver-state checkpointing (:mod:`~pqp_for_mpc_tpu_torch.utils.
state`), the port's spans and counters (:mod:`~pqp_for_mpc_tpu_torch.utils.
tracing`, on while a ``torch.profiler`` session records) and profiling
(:mod:`~pqp_for_mpc_tpu_torch.utils.profiling`: ``trace``, a Chrome trace
with those spans)."""
