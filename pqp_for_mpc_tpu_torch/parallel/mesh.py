"""Device-mesh construction.

The counterpart of ``pqp_for_mpc_tpu/parallel/mesh.py`` on
``torch.distributed``: one rank holds one device, so the mesh is a
``(data, model)`` grid of the ranks of the process group
(``torch.distributed.device_mesh.init_device_mesh``).  The scaling axes:

* ``data``  — independent QP instances (scenarios / initial states);
* ``model`` — rows of the dual Hessian Qd for large-N instances
  (see :mod:`pqp_for_mpc_tpu_torch.parallel.sharded`).

Start the process group first (:func:`~pqp_for_mpc_tpu_torch.parallel.
distributed.initialize`).  The placements below describe which block of a
global array a rank holds; :func:`~pqp_for_mpc_tpu_torch.parallel.sharded.
local_shard` cuts it.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Create a ``(data, model)`` mesh over the ranks of the process group.

    ``data=None`` uses all ranks left after the model axis.  The model axis
    is innermost (consecutive ranks), so on one host its all-gathers stay
    between neighbouring cards.  The mesh must span the whole group: every
    rank takes part in the solvers' collectives."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "pqp_for_mpc_tpu_torch.parallel.distributed.initialize() first")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if data * model < n:
        raise ValueError(
            f"mesh {data}x{model} leaves {n - data * model} of the {n} ranks "
            "out: a mesh must span the whole process group")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """Placements for (feature, batch)-layout arrays: tensor dim 1 (the
    batch) sharded over ``axis``, replicated over the other mesh dims (the
    JAX package's ``P(None, axis)``)."""
    return tuple(Shard(1) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of an array every rank holds whole (``P()``)."""
    return (Replicate(),) * mesh.ndim
