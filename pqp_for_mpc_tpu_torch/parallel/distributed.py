"""Multi-process entry points on ``torch.distributed``.

The counterpart of ``pqp_for_mpc_tpu/parallel/distributed.py``: run the
batched and row-sharded solvers over several processes, one device per
process (one rank per card on a GPU host, a gloo ring of CPU processes for
testing), with the ``data`` axis spanning them.

Typical use, one process per card under ``torchrun``::

    import pqp_for_mpc_tpu_torch.parallel.distributed as dist
    dev = dist.initialize()                  # env:// from torchrun
    mesh = dist.global_mesh(model=1)         # data axis spans every rank
    primal, dual = shard_batch(primal, dual, mesh)
    res = solve_batched(primal, dual, cfg=cfg)

A CPU ring for testing (what ``tests/test_torch_parallel.py`` does)::

    dist.initialize(init_method=f"file://{path}", num_processes=8,
                    process_id=rank, device="cpu")
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh


def initialize(init_method: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout_s: float = 120.0) -> torch.device:
    """``torch.distributed.init_process_group`` wrapper; returns the device
    this rank runs on.

    With no arguments it reads ``torchrun``'s environment (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  Otherwise
    pass ``init_method`` (``"file://..."`` or ``"tcp://host:port"``), the
    number of processes and this one's id.  A CUDA ``device`` runs NCCL and
    binds the rank to ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` from the
    environment, else ``process_id``, else 0); ``device="cpu"`` runs gloo.
    A failed start raises: there is no fallback to gloo or to the CPU.
    ``timeout_s`` bounds every collective, so a rank whose peer died
    raises instead of waiting forever."""
    device = torch.device(device)
    kwargs = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kwargs.update(init_method=init_method, world_size=num_processes,
                      rank=process_id)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') but no CUDA device "
                               "is available; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        tdist.init_process_group("nccl", device_id=device, **kwargs)
    else:
        tdist.init_process_group("gloo", **kwargs)
    return device


def global_mesh(model: int = 1, data: Optional[int] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the job, on the device
    type of the group's backend (NCCL: ``cuda``, gloo: ``cpu``).  The model
    axis is innermost so its all-gathers stay between neighbouring
    ranks."""
    from pqp_for_mpc_tpu_torch.parallel.mesh import make_mesh
    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return make_mesh(data=data, model=model, device_type=device_type)


def process_local_batch_slice(global_batch: int) -> slice:
    """The half-open range of the global batch this process should
    materialize (one rank, one device: its block of the ``data`` axis
    when ``model == 1``)."""
    n = tdist.get_world_size()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{n} processes — pad the batch (silently dropping the "
            "remainder would under-solve)")
    per = global_batch // n
    r = tdist.get_rank()
    return slice(r * per, (r + 1) * per)
