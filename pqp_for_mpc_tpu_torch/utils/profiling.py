"""Profiling helpers.

The counterpart of ``pqp_for_mpc_tpu/utils/profiling.py``:

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome/Perfetto trace of the wrapped region;
* :func:`timed` — wall-clock a thunk, fenced with
  ``torch.cuda.synchronize`` on the result's device (PyTorch returns
  before the card finishes, so an unfenced clock times the enqueue).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace('/tmp/pqp_trace'): run()`` then open
    ``logdir/trace.json`` in ui.perfetto.dev or chrome://tracing.  Traces
    the CPU and, where a card is present, CUDA."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _fence(result) -> None:
    """Wait for the card behind every CUDA tensor in ``result`` (a tensor,
    a dataclass or a sequence of them); nothing on the CPU."""
    leaves = [result]
    devices = set()
    while leaves:
        x = leaves.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            leaves.extend(x)
        elif isinstance(x, dict):
            leaves.extend(x.values())
        elif hasattr(x, "__dataclass_fields__"):
            leaves.extend(getattr(x, f) for f in x.__dataclass_fields__)
    for d in devices:
        torch.cuda.synchronize(d)


def timed(thunk, repeats: int = 3, warmup: int = 1):
    """Return ``(best_seconds, last_result)`` with device fencing."""
    result = None
    for _ in range(warmup):
        result = thunk()
        _fence(result)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = thunk()
        _fence(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
