"""The lane contract that every solve engine shares.

A solve runs ``B`` lanes side by side, batch last: ``Y (N, B)``.  The plain
loop (:mod:`pqp_for_mpc_tpu_torch.solver`), the kernel wrappers
(:mod:`pqp_for_mpc_tpu_torch.ops`) and the stage-wise backend
(:mod:`pqp_for_mpc_tpu_torch.models.stagewise`) decide the following the
same way, here, once:

* the lane batch (:func:`lane_batch`): how many lanes a solve runs and the
  ``Y0 (N, B)`` it starts from — the cold start ``y0`` everywhere
  (:func:`cold_start`, PQP_CPU.c:710), or a warm start whose one column
  seeds every lane;
* the certificate's slack ``max(erc*Kp, eac)`` (:func:`certificate_slack`,
  compare, PQP_CPU.c:334-343);
* the per-lane panels and the cfg fields every whole-solve kernel takes
  (:func:`lane_panels`, :func:`kernel_kwargs`);
* the exit verdict: :class:`SolveResult`, the recovery of U, the costs and
  the four-part test (``terminate``, PQP_CPU.c:673-687) with its two
  certificates (:func:`certificate`);
* the batched products (:func:`_mv`, :func:`_mvT`) and the cache keyed on
  tensor identities (:func:`remember`) that K1's geometry layout and the
  plain loop's CUDA graphs keep.

It imports no engine: the engines import it.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Per-instance solve outputs (batched shapes shown; ``solver.solve``
    squeezes the batch axis away)."""

    U: torch.Tensor           # (M, B) primal solution
    Y: torch.Tensor           # (N, B) dual solution
    iters: torch.Tensor       # (B,) int32 — the value of h (starting at 1)
                              # at the first passing check
                              # (PQP_CPU.c:714,739-741)
    converged: torch.Tensor   # (B,) bool
    feasible: torch.Tensor    # (B,) bool — constraint check at exit
    Jp: torch.Tensor          # (B,) primal cost at exit
    Jd: torch.Tensor          # (B,) dual cost at exit
    diverged: Optional[torch.Tensor] = None  # (B,) bool — non-finite iterate

    def stats(self) -> dict:
        """Structured solve observability as plain Python scalars."""
        a = lambda t: t.detach().cpu().numpy()
        gap = a(self.Jp) + a(self.Jd)
        jd = np.abs(a(self.Jd))
        return {
            "batch": int(a(self.iters).size),
            "converged": int(a(self.converged).sum()),
            "feasible": int(a(self.feasible).sum()),
            "iters_mean": float(a(self.iters).mean()),
            "iters_max": int(a(self.iters).max()),
            "gap_abs_max": float(np.abs(gap).max()),
            "gap_rel_max": float((np.abs(gap) / np.maximum(jd, 1e-30)).max()),
        }


def _as2d(v: torch.Tensor) -> torch.Tensor:
    return v if v.dim() == 2 else v[:, None]


def _mv(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Matrix-vector over the batch: ``A (N, N)`` or per-instance
    ``(B, N, N)``, ``Y (N, B)`` -> ``(N, B)``."""
    if A.dim() == 2:
        return A @ Y
    return torch.einsum("bij,jb->ib", A, Y)


def _mvT(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Transposed matrix-vector over the batch: ``A (N, M)`` or
    ``(B, N, M)``, ``Y (N, B)`` -> ``A' Y (M, B)``."""
    if A.dim() == 2:
        return A.T @ Y
    return torch.einsum("bij,ib->jb", A, Y)


# --- the lane batch ---------------------------------------------------------

def cold_start(N: int, B: int, cfg: SolverConfig, device) -> torch.Tensor:
    """The reference's cold start ``Y = y0 * ones`` (PQP_CPU.c:710),
    ``(N, B)`` float32 on ``device``."""
    return torch.full((N, B), cfg.y0, dtype=torch.float32, device=device)


def lane_batch(dual, Y0: Optional[torch.Tensor], cfg: SolverConfig,
               x0: Optional[torch.Tensor] = None):
    """``(Y0 (N, B), B)``: the lanes a solve runs and where they start.

    B is the instances' batch: ``Qd``'s leading axis on distinct geometry
    (3-D ``Qd``), ``x0``'s columns on the stage-wise backend (``x0``
    given), else ``Fd``'s columns (1 for a vector).  With no ``Y0`` every
    lane starts cold (:func:`cold_start`).  A width-1 ``Y0`` seeds every
    lane (a stride-0 view); a batched ``Y0`` over a single shared-geometry
    instance widens B to its width; any other width that is not B raises a
    ``ValueError`` naming both (recycling a lane would be a quiet wrong
    answer)."""
    N = dual.n_con
    if x0 is not None:
        B, dev, widens = x0.shape[1], x0.device, False
    elif dual.Qd.dim() == 3:
        B, dev, widens = dual.Qd.shape[0], dual.Qd.device, False
    else:
        B = dual.Fd.shape[1] if dual.Fd.dim() == 2 else 1
        dev, widens = dual.Qd.device, B == 1     # one shared instance
    if Y0 is None:
        return cold_start(N, B, cfg, dev), B
    Y0 = _as2d(Y0)
    if Y0.shape[1] == 1 and B > 1:
        return Y0.expand(N, B), B
    if Y0.shape[1] > 1 and widens:
        return Y0, Y0.shape[1]
    if Y0.shape[1] != B:
        raise ValueError(
            f"warm start batch {Y0.shape[1]} != instance batch {B}")
    return Y0, B


def lane_panels(primal, dual, B: int):
    """``(Fp, Fd, Fdp, Fdn, Mp, Md)`` over B lanes: ``(M, B)``, three
    ``(N, B)`` and two ``(B,)``, each a view (a panel shared by every lane
    stays stride 0: at 2^22 lanes a copy of ``Fd`` is 0.47 GB)."""
    N, M = dual.n_con, primal.n_var
    return (_as2d(primal.Fp).expand(M, B), _as2d(dual.Fd).expand(N, B),
            _as2d(dual.Fdp).expand(N, B), _as2d(dual.Fdn).expand(N, B),
            primal.Mp.reshape(-1).expand(B), dual.Md.reshape(-1).expand(B))


def kernel_kwargs(cfg: SolverConfig) -> dict:
    """The cfg fields every whole-solve kernel takes, under the kernels'
    keyword names."""
    return dict(max_iters=cfg.max_iters, check_every=cfg.check_every,
                eaj=cfg.eaj, erj=cfg.erj, strict=cfg.strict_weak_duality,
                den_eps=cfg.den_eps, precision=cfg.precision)


# --- the exit verdict -------------------------------------------------------

def certificate_slack(Kp: torch.Tensor, erc: float,
                      eac: float) -> torch.Tensor:
    """The certificate's slack ``max(erc*Kp, eac)`` (compare,
    PQP_CPU.c:334-343 — no |Kp|, as in the reference).  The forcing-scale
    test's threshold is ``Kp +`` it; the dual-gradient test takes it
    alone."""
    return torch.clamp(erc * Kp, min=eac)


def costs(primal, dual, Y: torch.Tensor, U: torch.Tensor, precision=None):
    """Batched primal/dual costs (computeCost, PQP_CPU.c:648-666):
    ``J = 1/2 Z'QZ + F'Z + M/2``.  Returns (Jp, Jd), each (B,)."""
    QdY = _mv(dual.Qd, Y)
    Jd = (0.5 * (Y * QdY).sum(dim=0)
          + (_as2d(dual.Fd) * Y).sum(dim=0) + 0.5 * dual.Md)
    QpU = _mv(primal.Qp, U)
    Jp = (0.5 * (U * QpU).sum(dim=0)
          + (_as2d(primal.Fp) * U).sum(dim=0) + 0.5 * primal.Mp)
    return Jp, Jd


def recover_U(primal, Y: torch.Tensor, precision=None) -> torch.Tensor:
    """``U = -Qp^-1 (Fp + Gp' Y)`` (computeUfromY, PQP_CPU.c:352-360)."""
    return -_mv(primal.Qp_inv, _mvT(primal.Gp, Y) + _as2d(primal.Fp))


def feasibility(primal, U: torch.Tensor, erc: float, eac: float,
                precision=None) -> torch.Tensor:
    """Elementwise-all feasibility ``Gp U <= Kp + max(erc*Kp, eac)``.
    ``Kp`` may be ``(N,)`` or ``(N, B)``.  Returns (B,)."""
    slack = primal.Kp + certificate_slack(primal.Kp, erc, eac)
    return (_mv(primal.Gp, U) <= _as2d(slack)).all(dim=0)


def termination_fail(feas: torch.Tensor, Jp: torch.Tensor, Jd: torch.Tensor,
                     cfg: SolverConfig,
                     gap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The four-part verdict of ``terminate`` (PQP_CPU.c:673-687) in the
    reference's negated form (``fail if x > tol``), so a NaN comparison is
    false and that test passes, as in C.  ``gap`` — a precomputed
    complementarity gap, or ``None`` for the explicit ``Jp + Jd`` (then the
    weak-duality test is the reference's ``Jp > -Jd``)."""
    if gap is None:
        gap = Jp + Jd
        weak_fail = lambda: Jp > -Jd
    else:
        weak_fail = lambda: gap > 0.0
    fail = ~feas | (gap > cfg.eaj) | (gap / Jd.abs() > cfg.erj)
    if cfg.strict_weak_duality:
        fail = fail | weak_fail()
    return fail


def complementarity_gap(dual, Y: torch.Tensor,
                        precision=None) -> torch.Tensor:
    """Duality gap of the recovered primal via ``Y'(Qd Y + Fd)``
    (see ``SolverConfig.gap_from_complementarity``).  Returns (B,)."""
    return (Y * (_mv(dual.Qd, Y) + _as2d(dual.Fd))).sum(dim=0)


def check_terminate(primal, dual, Y: torch.Tensor, cfg: SolverConfig,
                    precision=None):
    """The four-part test of ``terminate`` (PQP_CPU.c:673-687), batched.

    Returns (ok, U, feas, Jp, Jd).  With ``cfg.feas_from_dual_gradient``
    the feasibility residual is read from the identity
    ``Gp U - Kp = -(Qd Y + Fd)`` (exact for the recovered U), at dual
    scale instead of forcing scale — see the JAX ``check_terminate``.
    """
    U = recover_U(primal, Y)
    fail, feas, Jp, Jd = certificate(primal, dual, Y, U, cfg)
    return ~fail, U, feas, Jp, Jd


def certificate(primal, dual, Y: torch.Tensor, U: torch.Tensor,
                cfg: SolverConfig):
    """The verdict of :func:`check_terminate` on ``Y`` and its recovered
    ``U`` (the whole-solve kernels return theirs): ``(fail, feas, Jp,
    Jd)``, each (B,)."""
    if cfg.feas_from_dual_gradient:
        QdY = _mv(dual.Qd, Y)
        g = QdY + _as2d(dual.Fd)                    # = Kp - Gp U exactly
        slack = certificate_slack(primal.Kp, cfg.erc, cfg.eac)
        feas = (g >= -_as2d(slack)).all(dim=0)
        Jd = (0.5 * (Y * QdY).sum(dim=0)
              + (_as2d(dual.Fd) * Y).sum(dim=0) + 0.5 * dual.Md)
        Jp = (0.5 * (U * _mv(primal.Qp, U)).sum(dim=0)
              + (_as2d(primal.Fp) * U).sum(dim=0) + 0.5 * primal.Mp)
        gap = (Y * g).sum(dim=0) if cfg.gap_from_complementarity else None
    else:
        feas = feasibility(primal, U, cfg.erc, cfg.eac)
        Jp, Jd = costs(primal, dual, Y, U)
        gap = (complementarity_gap(dual, Y)
               if cfg.gap_from_complementarity else None)
    return termination_fail(feas, Jp, Jd, cfg, gap), feas, Jp, Jd


# --- the identity cache -----------------------------------------------------

class IdentityEntry:
    """A cache entry keyed on some tensors' identities (``id`` of each):
    weak references to them (a dead one means its id may now name another
    tensor), where their data lay when ``value`` was made (``places``, the
    caller's choice of stamp) and ``value``.  It keeps no caller's tensors
    alive.  The plain solver's graphs and K1's geometry layout
    (``ops.solve_kernel.geometry_layout``) are cached in such entries."""

    __slots__ = ("refs", "places", "value")

    def __init__(self, ts: tuple):
        self.refs = tuple(None if t is None else weakref.ref(t) for t in ts)
        self.places = self.value = None

    def alive(self) -> bool:
        return all(r is None or r() is not None for r in self.refs)


def remember(cache: "collections.OrderedDict", key, ts: tuple,
             keep: int) -> IdentityEntry:
    """A new :class:`IdentityEntry` of ``ts`` under ``key``, the most
    recently used of ``cache``; entries whose tensors died are dropped,
    then the least recently used past ``keep``."""
    for k in [k for k, e in cache.items() if not e.alive()]:
        del cache[k]
    cache[key] = entry = IdentityEntry(ts)
    cache.move_to_end(key)
    while len(cache) > keep:
        cache.popitem(last=False)
    return entry
