"""Carry problem data across between the JAX package and this port.

Each container is moved as a dict of NumPy arrays keyed by its field
names, i.e. what ``{f: np.asarray(getattr(obj, f))}`` gives for the JAX
container.  :func:`primal_from_numpy`, :func:`dual_from_numpy`,
:func:`condensed_from_numpy` and :func:`stagewise_dual_from_numpy` build the
torch containers on ``device`` (default CUDA; without a card that raises —
pass ``device="cpu"``); :func:`to_numpy` goes the other way.  ``None``
fields stay ``None``; every array becomes float32, the working type of both
packages.  Arrays keep their shapes, so a distinct-geometry batch
(``Qd (B, N, N)``, ``Gp (B, N, M)``) carries across as it is.  A nested
container (a ``StagewiseDual``'s ``factor``) is a nested dict, and its
integer and float meta fields (``H``, ``band``, ``soft_rho``, ...) stay
Python numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.models.stagewise import (StagewiseDual,
                                                    StagewiseFactor)
from pqp_for_mpc_tpu_torch.problem import (CondensedMPCData, DualQP,
                                           PrimalQP, resolve_device)


def _tensor(v, device):
    if v is None:
        return None
    return torch.tensor(np.asarray(v, np.float32), device=device)


#: meta fields (Python numbers, not arrays) of the stage-wise containers
_META = dict(H=int, ns=int, nu=int, ny=int, n_con=int, band=int,
             soft_rho=float, theta_floor=float)


def _build(cls, arrays: dict, device, **given):
    names = [f.name for f in dataclasses.fields(cls)]
    unknown = set(arrays) - set(names)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    device = resolve_device(device)
    return cls(**given, **{
        n: _META[n](arrays[n]) if n in _META
        else _tensor(arrays.get(n), device)
        for n in names if n not in given})


def primal_from_numpy(arrays: dict, device=None) -> PrimalQP:
    """:class:`PrimalQP` from a dict of NumPy arrays (``Qp`` may be None)."""
    return _build(PrimalQP, arrays, device)


def dual_from_numpy(arrays: dict, device=None) -> DualQP:
    """:class:`DualQP` from a dict of NumPy arrays (``Qdp_theta`` and
    ``Qdn_theta`` may be None: a split-free dual)."""
    return _build(DualQP, arrays, device)


def condensed_from_numpy(arrays: dict, device=None) -> CondensedMPCData:
    """:class:`CondensedMPCData` from a dict of NumPy arrays."""
    return _build(CondensedMPCData, arrays, device)


def stagewise_dual_from_numpy(arrays: dict, device=None) -> StagewiseDual:
    """:class:`~pqp_for_mpc_tpu_torch.models.stagewise.StagewiseDual` from
    a dict of NumPy arrays (``to_numpy`` of the JAX package's), with the
    factor as a nested dict: its arrays become float32 tensors, its meta
    fields (``H``, ``ns``, ``nu``, ``ny``; the dual's ``n_con``, ``band``,
    ``soft_rho``, ``theta_floor``) Python ints and floats."""
    return _build(StagewiseDual, arrays, device,
                  factor=_build(StagewiseFactor, arrays["factor"], device))


def to_numpy(obj) -> dict:
    """Any container of this port (or of the JAX package) as a dict of
    NumPy arrays keyed by field name; a nested container becomes a nested
    dict."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v):
            v = to_numpy(v)
        elif v is not None:
            v = np.asarray(v)
        out[f.name] = v
    return out
