"""Runnable twins of the repository's ``examples/`` (the JAX package's),
each ``python -m pqp_for_mpc_tpu_torch.examples.<name> [args]
[--device cpu]``: the JAX example's positional arguments, its printed
lines, and ``--device`` (default ``cuda``, which raises without a card)."""
