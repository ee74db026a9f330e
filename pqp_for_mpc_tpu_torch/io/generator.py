"""Random QP instance generation in the reference's benchmark format.

The reference generator (``testing/test_generator.c:936-987``) emits:

* header line ``M N``
* ``M`` values — the diagonal of ``Qp_inv`` (uniform ``|100*rand/RAND_MAX|``)
* ``M`` values — ``Fp``
* ``1`` value — ``Mp``
* ``N`` values — ``Kp``
* ``N`` rows of ``M`` integers in ``{-1, 0, 1}`` — ``Gp``

Shipped fixtures: ``testing/sample test/test{1,2,3}.txt`` with headers
``500 1500``, ``100 400``, ``800 1200``.

Reader quirks of the reference harness (``testing/CPU version/
PQP_CPU_test.c:936-976``) that we deliberately do NOT inherit (documented
for the conformance notes):

* it overwrites the file's ``Kp`` with fresh random values (line 957);
* it re-applies the ``%3`` remap to already-remapped ``{-1,0,1}`` entries,
  which in C maps ``-1 -> 1`` (C's ``%`` keeps sign), silently flipping
  every ``-1``.

Our reader takes the file at face value; :func:`read_generator_file` has a
``reference_quirks=True`` mode reproducing both quirks for byte-parity
experiments against the harness.

A NumPy copy of ``pqp_for_mpc_tpu/io/generator.py``: the same draws from
the same seed, so both packages write byte-identical files.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GeneratedQP:
    """A generator-format instance.  ``Qp_inv`` is diagonal, stored dense."""

    qp_inv_diag: np.ndarray  # (M,)
    Fp: np.ndarray           # (M,)
    Mp: float
    Kp: np.ndarray           # (N,)
    Gp: np.ndarray           # (N, M) in {-1, 0, 1}

    @property
    def M(self) -> int:
        return self.qp_inv_diag.shape[0]

    @property
    def N(self) -> int:
        return self.Kp.shape[0]


def generate_instance(M: int, N: int, seed: int = 0,
                      dtype=np.float32) -> GeneratedQP:
    """Synthesize a random instance with the generator's distributions:

    uniform ``[0, 100]`` for diag(Qp_inv)/Fp/Mp/Kp and iid ``{-1,0,1}`` for
    Gp (the generator draws ``rand()`` and maps ``%3`` to ``{0,-1,1}``,
    ``testing/test_generator.c:969-983``).
    """
    rng = np.random.default_rng(seed)
    return GeneratedQP(
        qp_inv_diag=rng.uniform(0.0, 100.0, M).astype(dtype),
        Fp=rng.uniform(0.0, 100.0, M).astype(dtype),
        Mp=float(rng.uniform(0.0, 100.0)),
        Kp=rng.uniform(0.0, 100.0, N).astype(dtype),
        Gp=rng.integers(-1, 2, size=(N, M)).astype(dtype),
    )


def write_generator_file(path: str, inst: GeneratedQP) -> None:
    """Write an instance in the exact reference file layout."""
    with open(path, "w") as f:
        f.write(f"{inst.M} {inst.N}\n")
        f.write(" ".join(f"{v:f}" for v in inst.qp_inv_diag) + " \n")
        f.write(" ".join(f"{v:f}" for v in inst.Fp) + " \n")
        f.write(f"{inst.Mp:f}\n")
        f.write(" ".join(f"{v:f}" for v in inst.Kp) + " \n")
        for row in inst.Gp.astype(np.int64):
            f.write(" ".join(str(int(v)) for v in row) + " \n")


def read_generator_file(path: str, reference_quirks: bool = False,
                        seed: int = 0, dtype=np.float32) -> GeneratedQP:
    """Read a generator-format file.

    ``reference_quirks=True`` reproduces the harness reader's behavior
    (fresh random ``|10*rand|`` Kp; ``-1`` entries flipped to ``1``).
    """
    with open(path, "r") as f:
        toks = f.read().split()
    it = iter(toks)
    M = int(next(it))
    N = int(next(it))
    take = lambda n: np.array([float(next(it)) for _ in range(n)], dtype=dtype)
    qdiag = take(M)
    Fp = take(M)
    Mp = float(next(it))
    Kp = take(N)
    Gp = np.array([int(next(it)) for _ in range(N * M)], dtype=np.int64)
    Gp = Gp.reshape(N, M)
    if reference_quirks:
        rng = np.random.default_rng(seed)
        Kp = np.abs(10.0 * rng.random(N)).astype(dtype)
        # C's `%` is sign-preserving: -1 % 3 == -1, hitting the final else
        # branch (value 1) in the harness reader.
        Gp = np.where(Gp % 3 == 0, 0, np.where(Gp % 3 == 2, -1, 1))
    return GeneratedQP(qp_inv_diag=qdiag, Fp=Fp, Mp=Mp, Kp=Kp,
                       Gp=Gp.astype(dtype))


def to_primal_arrays(inst: GeneratedQP):
    """Dense (Qp, Qp_inv, Fp, Mp, Gp, Kp) float32 arrays for the solver."""
    qpi = np.diag(inst.qp_inv_diag).astype(inst.Fp.dtype)
    qp = np.diag(1.0 / inst.qp_inv_diag).astype(inst.Fp.dtype)
    return qp, qpi, inst.Fp, np.asarray(inst.Mp, inst.Fp.dtype), inst.Gp, inst.Kp
