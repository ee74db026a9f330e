"""Solver-state checkpointing.

The counterpart of ``pqp_for_mpc_tpu/utils/state.py``.  The reference has
no checkpoint/resume — its domain analog is warm starting, which
:class:`pqp_for_mpc_tpu_torch.models.MPCController` does in memory.  These
helpers persist that state (the dual iterate and bookkeeping) to an
``.npz`` so a receding-horizon process can stop and resume, or ship
multipliers between machines.  Tensors may lie on any device; what comes
back is NumPy (``torch.as_tensor(Y, device=...)`` puts it back).
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path: str, Y, iters=None, meta: dict | None = None) -> None:
    """Persist a dual iterate (and optional per-instance iteration counts
    / metadata scalars) to ``path`` (.npz)."""
    arrays = {"Y": _numpy(Y)}
    if iters is not None:
        arrays["iters"] = _numpy(iters)
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = _numpy(v)
    np.savez(path, **arrays)


def load_state(path: str):
    """Load ``(Y, iters, meta)`` saved by :func:`save_state`; ``iters``
    is None if absent."""
    with np.load(path) as z:
        Y = z["Y"]
        iters = z["iters"] if "iters" in z.files else None
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return Y, iters, meta
