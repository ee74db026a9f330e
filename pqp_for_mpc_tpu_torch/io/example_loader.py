"""Loader for the reference's ``example/`` text-file problem format.

File format (see e.g. ``example/Kp.txt``): whitespace-separated ASCII floats,
terminated by a literal ``#`` sentinel token.  The reference's ``input()``
(``PQP_CPU.c:757-930``) fills each logical ``(rows, cols)`` matrix by looping
``i`` over ``cols`` (outer) and ``j`` over ``rows`` (inner) and storing
``mat[j*cols_outer + i] = next_token`` — i.e. **the file holds the transpose
of the logical matrix**, so the logical matrix is
``tokens.reshape(cols, rows).T``.  Vectors are read in order.

Reproducing this transposed-read exactly is required to match the
reference's U* on ``example/`` (the matrices are not all symmetric:
Fp2, Gp, Mp2 are rectangular).

A NumPy copy of ``pqp_for_mpc_tpu/io/example_loader.py``;
:func:`load_example_dir` builds this port's :class:`CondensedMPCData` on a
device (default CUDA; without a card that raises — pass ``device="cpu"``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

import torch

from pqp_for_mpc_tpu_torch.problem import CondensedMPCData, resolve_device

#: Problem dimensions of the shipped example instance
#: (ref ``PQP_CPU.c:13-17``): horizon 1, 29 states, 7 inputs, 7 outputs,
#: 1 disturbance; M = pHorizon*nInput, N = 4*pHorizon*nInput
#: (ref ``PQP_CPU.c:940-941``).
EXAMPLE_DIMS = dict(pHorizon=1, nState=29, nInput=7, nOutput=7, nDis=1)


def read_matrix_file(path: str, rows: int, cols: int, dtype=np.float32) -> np.ndarray:
    """Read one reference-format matrix file into logical ``(rows, cols)``.

    Tokens after a ``#`` sentinel are ignored (the reference's ``fscanf``
    simply stops after reading rows*cols floats; the ``#`` marks the end of
    data in every shipped file).
    """
    with open(path, "r") as f:
        raw = f.read()
    toks = []
    for t in raw.split():
        if t.startswith("#"):
            break
        toks.append(t)
    need = rows * cols
    if len(toks) < need:
        raise ValueError(f"{path}: expected {need} values, found {len(toks)}")
    vals = np.array([float(t) for t in toks[:need]], dtype=dtype)
    if cols == 1:
        return vals.reshape(rows, 1)
    if rows == 1:
        return vals.reshape(1, cols)
    # input() reads the file as the transpose of the logical matrix
    # (column-major fill, PQP_CPU.c:764-773 and siblings).
    return vals.reshape(cols, rows).T.copy()


def read_vector_file(path: str, n: int, dtype=np.float32) -> np.ndarray:
    return read_matrix_file(path, n, 1, dtype=dtype).reshape(n)


def write_matrix_file(path: str, mat: np.ndarray) -> None:
    """Write a matrix in the reference's file format: the TRANSPOSE of the
    logical matrix as whitespace-separated floats, terminated by ``#``
    (the exact inverse of :func:`read_matrix_file`)."""
    m = _numpy(mat)
    flat = m if m.ndim == 1 else m.T.reshape(-1)
    with open(path, "w") as f:
        # significant-digit format, not fixed-point: %.6f would flush
        # entries below ~5e-7 (stiff/finely-discretized plants) to zero,
        # silently changing the exported problem.  The reference's
        # fscanf("%f") accepts scientific notation (PQP_CPU.c:764-773).
        f.write(" ".join(f"{v:.8g}" for v in flat) + " #\n")


def write_example_dir(path: str, data: CondensedMPCData) -> None:
    """Export a condensed instance as a reference-format directory — the
    inverse of :func:`load_example_dir`, so problems condensed by
    :func:`pqp_for_mpc_tpu.models.condense` can be fed to the original
    C/CUDA executables (the reference has no writer of its own).

    Output-constrained problems (``Kx``/``Kd`` set) cannot be expressed
    in the reference's constant-Kp format — exporting one would silently
    change its feasible set, so it is an error."""
    if getattr(data, "Kx", None) is not None:
        raise ValueError(
            "cannot export an output-constrained problem: the reference "
            "format has constant Kp, but this instance's bounds depend "
            "on (x, D) via Kx/Kd")
    os.makedirs(path, exist_ok=True)
    j = lambda name: os.path.join(path, name)
    w = lambda name, m: write_matrix_file(j(name), m)
    w("Qp_inv.txt", data.Qp_inv)
    w("Fp1.txt", data.Fp1)
    w("Fp2.txt", data.Fp2)
    w("Fp3.txt", data.Fp3)
    w("Mp1.txt", data.Mp1)
    w("Mp2.txt", data.Mp2)
    w("Mp3.txt", data.Mp3)
    w("Mp4.txt", data.Mp4)
    w("Mp5.txt", data.Mp5)
    w("Mp6.txt", np.atleast_1d(_numpy(data.Mp6)))
    w("Gp.txt", data.Gp)
    w("Kp.txt", data.Kp)
    w("Z.txt", data.Z)
    w("Theta.txt", data.ThetaOut)
    w("x.txt", data.x)
    w("D.txt", data.D)


def load_example_dir(path: str, dims: Dict[str, int] | None = None,
                     dtype=np.float32, device=None) -> CondensedMPCData:
    """Load a full condensed-MPC instance from a reference-format directory.

    Mirrors ``input()`` (``PQP_CPU.c:757-930``) file by file, producing
    math-orientation arrays wrapped in :class:`CondensedMPCData` as float32
    tensors on ``device`` (default CUDA, :func:`resolve_device`).
    """
    device = resolve_device(device)
    d = dict(EXAMPLE_DIMS if dims is None else dims)
    P, S, I, O, W = (d["pHorizon"], d["nState"], d["nInput"], d["nOutput"], d["nDis"])
    M = P * I           # primal vars
    N = 4 * P * I       # constraints
    nd = W * P

    j = lambda name: os.path.join(path, name)
    arrays = dict(
        Qp_inv=read_matrix_file(j("Qp_inv.txt"), M, M, dtype),
        Fp1=read_matrix_file(j("Fp1.txt"), M, nd, dtype),
        Fp2=read_matrix_file(j("Fp2.txt"), M, S, dtype),
        Fp3=read_vector_file(j("Fp3.txt"), M, dtype),
        Mp1=read_matrix_file(j("Mp1.txt"), S, S, dtype),
        Mp2=read_matrix_file(j("Mp2.txt"), nd, S, dtype),
        Mp3=read_matrix_file(j("Mp3.txt"), nd, nd, dtype),
        Mp4=read_vector_file(j("Mp4.txt"), S, dtype),
        Mp5=read_vector_file(j("Mp5.txt"), nd, dtype),
        Mp6=read_vector_file(j("Mp6.txt"), 1, dtype)[0],
        Gp=read_matrix_file(j("Gp.txt"), N, M, dtype),
        Kp=read_vector_file(j("Kp.txt"), N, dtype),
        Z=read_matrix_file(j("Z.txt"), O * P, S, dtype),
        ThetaOut=read_matrix_file(j("Theta.txt"), O * P, nd, dtype),
        x=read_vector_file(j("x.txt"), S, dtype),
        D=read_vector_file(j("D.txt"), nd, dtype),
    )
    return CondensedMPCData(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in arrays.items()})


def _numpy(v) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
