"""Data- and tensor-parallel solves on ``torch.distributed`` (the JAX
package's ``parallel/``): :mod:`~pqp_for_mpc_tpu_torch.parallel.mesh`,
:mod:`~pqp_for_mpc_tpu_torch.parallel.distributed` and
:mod:`~pqp_for_mpc_tpu_torch.parallel.sharded`."""
from pqp_for_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
)
from pqp_for_mpc_tpu_torch.parallel.sharded import (  # noqa: F401
    local_shard,
    shard_batch,
    solve_row_sharded,
)
