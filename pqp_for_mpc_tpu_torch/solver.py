"""The PQP multiplicative-update dual solver.

The PyTorch counterpart of ``pqp_for_mpc_tpu/solver.py`` (the reference hot
loop ``solveQuadraticDual``, PQP_CPU.c:694-750):

* the solve is a Python ``while`` whose body performs one convergence
  check followed by ``check_every`` multiplicative updates; the host reads
  ``done.all()`` once per check (the JAX package's ``lax.while_loop``
  condition).  The update never reads the check's outputs
  (PQP_CPU.c:718-724), so the iterate trajectory is the reference's;
* instances are batched with the batch last, ``Y (N, B)``, so each update
  is two ``(N, N) @ (N, B)`` products and an elementwise multiply;
* per-instance masks freeze solved lanes (``torch.where(done, Y, Y_next)``);
* with ``cfg.use_pallas`` the updates between checks run in one call of a
  hand-written kernel: the resident K2 of
  :mod:`pqp_for_mpc_tpu_torch.ops.kernels` where N fits shared memory, the
  streamed K3 of :mod:`pqp_for_mpc_tpu_torch.ops.tiled_kernel` past it
  (its matrix built once per solve).  On CPU tensors the kernels' plain
  versions run.

Convergence test (``terminate``, PQP_CPU.c:673-687), as the JAX package:

1. feasibility: ``Gp U <= Kp + max(erc*Kp, eac)`` elementwise;
2. weak duality: ``Jp <= -Jd``;
3. absolute gap:  ``Jp + Jd <= eaj``;
4. relative gap:  ``(Jp + Jd)/|Jd| <= erj``.

:func:`solve_mixed` runs a bfloat16 bulk phase, then certifies in float32
through :func:`solve_batched`.  Shared (2-D) geometry only: the distinct-
geometry einsum path is a later slice of the port (ROADMAP queue 1, item 8).
``precision`` arguments are accepted for the JAX signatures and ignored:
products run in full float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Per-instance solve outputs (batched shapes shown; :func:`solve`
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


def _shared_only(dual: DualQP):
    if dual.Qd.dim() != 2:
        raise NotImplementedError(
            "distinct (3-D) geometry is not ported yet (ROADMAP queue 1, "
            "item 8)")


def pqp_update(dual: DualQP, Y: torch.Tensor, precision=None,
               den_eps: float = 0.0) -> torch.Tensor:
    """One multiplicative update
    ``Y <- Y * ((Qd^- + th) Y + Fd^-) / ((Qd^+ + th) Y + Fd^+)``
    (updateY2 + updY, PQP_CPU.c:603-618, 590-596).  Y: (N, B).

    A split-free dual builds the splits from ``Qd`` and applies theta as a
    separate elementwise term on both sides, as the JAX package does.
    """
    if dual.Qdn_theta is None:
        tY = dual.theta.reshape(-1, 1) * Y
        num = torch.clamp(-dual.Qd, min=0.0) @ Y + tY + _as2d(dual.Fdn)
        den = torch.clamp(dual.Qd, min=0.0) @ Y + tY + _as2d(dual.Fdp)
    else:
        num = dual.Qdn_theta @ Y + _as2d(dual.Fdn)
        den = dual.Qdp_theta @ Y + _as2d(dual.Fdp)
    if den_eps:
        den = torch.clamp(den, min=den_eps)        # NaN stays NaN
    return (num / den) * Y


def accel_step(dual: DualQP, Y: torch.Tensor, done: torch.Tensor,
               precision=None) -> torch.Tensor:
    """Projected steepest-descent step with exact line search on the dual
    objective ``f(Y) = 1/2 Y'Qd Y + Fd'Y`` over ``Y >= 0``, accepted per
    lane only when it does not increase f (the corrected form of the
    reference's acceleration branch, PQP_CPU.c:545-630; see the JAX
    ``accel_step``)."""
    Fd = _as2d(dual.Fd)
    grad = dual.Qd @ Y + Fd                                     # (N, B)
    p = torch.where((Y > 0.0) | (grad < 0.0), -grad, torch.zeros_like(grad))
    pQp = (p * (dual.Qd @ p)).sum(dim=0)                        # (B,)
    alpha = torch.where(pQp > 0,
                        (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                        torch.zeros_like(pQp))
    Yn = torch.clamp(Y + alpha[None, :] * p, min=0.0)
    fY = 0.5 * (Y * (grad + Fd)).sum(dim=0)
    fYn = 0.5 * (Yn * (dual.Qd @ Yn)).sum(dim=0) + (Fd * Yn).sum(dim=0)
    keep = (fYn <= fY) & ~done
    return torch.where(keep[None, :], Yn, Y)


def costs(primal: PrimalQP, dual: DualQP, Y: torch.Tensor, U: torch.Tensor,
          precision=None):
    """Batched primal/dual costs (computeCost, PQP_CPU.c:648-666):
    ``J = 1/2 Z'QZ + F'Z + M/2``.  Returns (Jp, Jd), each (B,)."""
    QdY = dual.Qd @ Y
    Jd = (0.5 * (Y * QdY).sum(dim=0)
          + (_as2d(dual.Fd) * Y).sum(dim=0) + 0.5 * dual.Md)
    QpU = primal.Qp @ U
    Jp = (0.5 * (U * QpU).sum(dim=0)
          + (_as2d(primal.Fp) * U).sum(dim=0) + 0.5 * primal.Mp)
    return Jp, Jd


def recover_U(primal: PrimalQP, Y: torch.Tensor,
              precision=None) -> torch.Tensor:
    """``U = -Qp^-1 (Fp + Gp' Y)`` (computeUfromY, PQP_CPU.c:352-360)."""
    return -(primal.Qp_inv @ (primal.Gp.T @ Y + _as2d(primal.Fp)))


def feasibility(primal: PrimalQP, U: torch.Tensor, erc: float, eac: float,
                precision=None) -> torch.Tensor:
    """Elementwise-all feasibility with the reference's slack
    ``Kp + max(erc*Kp, eac)`` (compare, PQP_CPU.c:334-343 — no |Kp|, as in
    the reference).  ``Kp`` may be ``(N,)`` or ``(N, B)``.  Returns (B,)."""
    slack = primal.Kp + torch.clamp(erc * primal.Kp, min=eac)
    return (primal.Gp @ U <= _as2d(slack)).all(dim=0)


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


def complementarity_gap(dual: DualQP, Y: torch.Tensor,
                        precision=None) -> torch.Tensor:
    """Duality gap of the recovered primal via ``Y'(Qd Y + Fd)``
    (see ``SolverConfig.gap_from_complementarity``).  Returns (B,)."""
    return (Y * (dual.Qd @ Y + _as2d(dual.Fd))).sum(dim=0)


def check_terminate(primal: PrimalQP, dual: DualQP, Y: torch.Tensor,
                    cfg: SolverConfig, precision=None):
    """The four-part test of ``terminate`` (PQP_CPU.c:673-687), batched.

    Returns (ok, U, feas, Jp, Jd).  With ``cfg.feas_from_dual_gradient``
    the feasibility residual is read from the identity
    ``Gp U - Kp = -(Qd Y + Fd)`` (exact for the recovered U), at dual
    scale instead of forcing scale — see the JAX ``check_terminate``.
    """
    U = recover_U(primal, Y)
    if cfg.feas_from_dual_gradient:
        QdY = dual.Qd @ Y
        g = QdY + _as2d(dual.Fd)                    # = Kp - Gp U exactly
        slack = torch.clamp(cfg.erc * primal.Kp, min=cfg.eac)
        feas = (g >= -_as2d(slack)).all(dim=0)
        Jd = (0.5 * (Y * QdY).sum(dim=0)
              + (_as2d(dual.Fd) * Y).sum(dim=0) + 0.5 * dual.Md)
        Jp = (0.5 * (U * (primal.Qp @ U)).sum(dim=0)
              + (_as2d(primal.Fp) * U).sum(dim=0) + 0.5 * primal.Mp)
        gap = (Y * g).sum(dim=0) if cfg.gap_from_complementarity else None
    else:
        feas = feasibility(primal, U, cfg.erc, cfg.eac)
        Jp, Jd = costs(primal, dual, Y, U)
        gap = (complementarity_gap(dual, Y)
               if cfg.gap_from_complementarity else None)
    fail = termination_fail(feas, Jp, Jd, cfg, gap)
    return ~fail, U, feas, Jp, Jd


def merge_lanes(ok: torch.Tensor, res_a: SolveResult,
                res_b: SolveResult) -> SolveResult:
    """Per-lane select between two :class:`SolveResult`\\ s: lane ``i``
    takes ``res_a`` where ``ok[i]`` else ``res_b``."""
    def pick(a, b):
        if a is None:
            return b
        m = ok[None, :] if a.dim() == 2 else ok
        return torch.where(m, a, b)
    return SolveResult(**{f.name: pick(getattr(res_a, f.name),
                                       getattr(res_b, f.name))
                          for f in dataclasses.fields(SolveResult)})


def retry_cold_solve(solve_fn: Callable[[torch.Tensor], SolveResult],
                     Y_warm: torch.Tensor,
                     Y_cold: torch.Tensor) -> SolveResult:
    """Certify-or-recover: solve from ``Y_warm``; when any lane fails the
    four-part certification, solve once more with certified lanes keeping
    their solution (they re-certify at the first check) and failed lanes
    reset to ``Y_cold``, and merge per lane.  ``iters`` and costs of a
    retried lane report the attempt that produced its result."""
    res = solve_fn(Y_warm)
    if bool(res.converged.all()):
        return res
    Y0 = torch.where(res.converged[None, :], res.Y, Y_cold)
    return merge_lanes(res.converged, res, solve_fn(Y0))


def _batch_of(dual: DualQP) -> int:
    return dual.Fd.shape[1] if dual.Fd.dim() == 2 else 1


def _normalize_warm(Y0: torch.Tensor, N: int, B: int):
    """(Y0 (N, B), B): one warm start seeds the whole batch, and a batched
    warm start over a single instance widens the batch."""
    Y0 = _as2d(Y0)
    if Y0.shape[1] == 1 and B > 1:
        Y0 = Y0.expand(N, B)
    elif B == 1 and Y0.shape[1] > 1:
        B = Y0.shape[1]
    elif Y0.shape[1] != B:
        raise ValueError(
            f"warm start batch {Y0.shape[1]} != instance batch {B}")
    return Y0, B


def solve_batched(primal: PrimalQP, dual: DualQP,
                  Y0: Optional[torch.Tensor] = None,
                  cfg: SolverConfig = SolverConfig(),
                  retry_cold: bool = False) -> SolveResult:
    """Solve a batch of PQP instances sharing constraint geometry.

    ``primal.Fp`` / ``dual.Fd`` may be ``(M,)``/``(N,)`` or
    ``(M, B)``/``(N, B)``.  ``Y0`` warm-starts the solve (one column seeds
    the whole batch); the default is the reference's cold start
    ``Y = y0 * ones`` (PQP_CPU.c:710).  ``retry_cold`` (with a warm ``Y0``)
    re-solves failed lanes once from the cold start
    (:func:`retry_cold_solve`).
    """
    _shared_only(dual)
    N = dual.n_con
    B = _batch_of(dual)
    dev = dual.Qd.device
    warm = Y0 is not None
    if Y0 is None:
        Y0 = torch.full((N, B), cfg.y0, dtype=torch.float32, device=dev)
    else:
        Y0, B = _normalize_warm(Y0, N, B)
    if retry_cold and warm:
        Y_cold = torch.full((N, B), cfg.y0, dtype=torch.float32, device=dev)
        return retry_cold_solve(
            lambda y0: _solve_core(primal, dual, y0, cfg), Y0, Y_cold)
    return _solve_core(primal, dual, Y0, cfg)


def _solve_core(primal: PrimalQP, dual: DualQP, Y0: torch.Tensor,
                cfg: SolverConfig) -> SolveResult:
    """The masked-lane loop on a normalized ``Y0 (N, B)``."""
    N = dual.n_con
    B = Y0.shape[1]
    k = cfg.check_every
    dev = Y0.device

    use_kernel = cfg.use_pallas
    streamed = None
    if use_kernel:
        from pqp_for_mpc_tpu_torch.ops import kernels as _kernels
        if not _kernels.fits_resident(N):
            # past residency the update streams one Qd_hat (K3), built once
            # per solve; it never needed the materialized splits
            from pqp_for_mpc_tpu_torch.ops import tiled_kernel as _tiled
            streamed = _tiled.streamed_matrix(dual.Qd, dual.theta, "float32")
        elif dual.Qdn_theta is None:
            # the resident kernel holds the materialized splits; a
            # split-free dual rides the plain body, as in the JAX package
            use_kernel = False

    def run_mult_updates(Y, done, n):
        if streamed is not None:
            Ynew = _tiled.streamed_pqp_iterations(
                *streamed, dual.Fdn, dual.Fdp, Y, num_iters=n,
                den_eps=cfg.den_eps)
            return torch.where(done[None, :], Y, Ynew)
        if use_kernel:
            Ynew = _kernels.fused_pqp_iterations(
                dual.Qdn_theta, dual.Qdp_theta, _as2d(dual.Fdn),
                _as2d(dual.Fdp), Y, num_iters=n, den_eps=cfg.den_eps)
            return torch.where(done[None, :], Y, Ynew)
        for _ in range(n):
            Y = torch.where(done[None, :], Y,
                            pqp_update(dual, Y, den_eps=cfg.den_eps))
        return Y

    def run_updates(Y, done):
        if not cfg.accel_every:
            return run_mult_updates(Y, done, k)
        # chunks of accel_every multiplicative updates, each followed by
        # one safeguarded projected-gradient step
        for _ in range(k // cfg.accel_every):
            Y = run_mult_updates(Y, done, cfg.accel_every)
            Y = accel_step(dual, Y, done)
        return Y

    Y = Y0
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    div = torch.zeros(B, dtype=torch.bool, device=dev)
    h = 1
    # one host sync per check: the JAX package's while-loop condition
    while h <= cfg.max_iters and not bool(done.all()):
        ok = check_terminate(primal, dual, Y, cfg)[0]
        # divergence: a non-finite iterate never recovers under the
        # multiplicative update — freeze the lane, stamping the freeze h
        bad = ~torch.isfinite(Y).all(dim=0) & ~done
        newly = ok & ~done & ~bad
        iters = torch.where(newly | bad, h, iters)
        done = done | ok | bad
        div = div | bad
        Y = run_updates(Y, done)
        h += k

    # final check so exit diagnostics reflect the returned iterate
    ok, U, feas, Jp, Jd = check_terminate(primal, dual, Y, cfg)
    bad = ~torch.isfinite(Y).all(dim=0)
    newly_bad = bad & ~done
    div = div | newly_bad
    newly = ok & ~done & ~bad
    iters = torch.where(newly | newly_bad, h, iters)
    done = done | ok | bad
    iters = torch.where(done, iters, h).to(torch.int32)
    return SolveResult(U=U, Y=Y, iters=iters, converged=done & ~div,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def solve_mixed(primal: PrimalQP, dual: DualQP,
                Y0: Optional[torch.Tensor] = None,
                cfg: SolverConfig = SolverConfig(),
                floor_frac: float = 0.25,
                floor_checks: int = 2) -> SolveResult:
    """Mixed-precision solve for large N: a bfloat16 bulk phase, then
    :func:`solve_batched` refines in float32 from the bf16 iterate to the
    full certification tolerances (the JAX ``solve_mixed``).  The result is
    certified on the TRUE float32 problem; bf16 only speeds the journey.

    The rules of the JAX docstring, each kept:

    * one consistent bf16 problem: ``Qd`` (its diagonal clamped at 0 when
      the kernel runs) is rounded ONCE to bfloat16 and split exactly by
      sign; theta comes from the ROUNDED negative part's rowsums (floored
      at ``cfg.theta_floor``) and is applied as the same float32 term on
      both sides of the update.  Products take ``Y`` rounded to bf16 and sum
      in float32;
    * phase 1 freezes a lane when it certifies (:func:`check_terminate` on
      the true problem), goes non-finite, or reaches the bf16 floor: the
      gap of the bf16 problem ``g_bf = Y'(Qd_bf Y + Fd)`` below
      ``floor_frac`` times the true gap for ``floor_checks`` consecutive
      checks;
    * non-finite phase-1 lanes restart phase 2 from the cold start ``y0``;
    * ``cfg.max_iters`` caps each phase; the reported ``iters`` is the sum
      of both phases.

    With ``cfg.use_pallas`` past residency (N > 128) the bulk updates run in
    the streamed kernel's bf16 mode (K3) and phase 2 in its f32 mode; CPU
    tensors run its plain version.  Shared (2-D) geometry only.
    """
    if dual.Qd.dim() == 3:
        raise NotImplementedError(
            "solve_mixed on distinct (3-D) geometry is not ported yet "
            "(ROADMAP queue 1, item 8)")
    N = dual.n_con
    B = _batch_of(dual)
    dev = dual.Qd.device
    if Y0 is None:
        Y0 = torch.full((N, B), cfg.y0, dtype=torch.float32, device=dev)
    else:
        Y0 = _as2d(Y0)
        if Y0.shape[1] == 1 and B > 1:
            Y0 = Y0.expand(N, B)
        else:
            B = Y0.shape[1]

    use_kernel = False
    if cfg.use_pallas:
        from pqp_for_mpc_tpu_torch.ops import kernels as _kernels
        use_kernel = not _kernels.fits_resident(N)
    floor = torch.full_like(dual.theta, cfg.theta_floor)
    if use_kernel:
        # clamp the diagonal BEFORE the one rounding, exactly as the
        # kernel's bf16 stream is built: phase 1 is one perturbed problem
        # whichever engine runs a given step
        from pqp_for_mpc_tpu_torch.ops import tiled_kernel as _tiled
        Qd_bf, theta = _tiled.streamed_matrix(dual.Qd, floor, "bfloat16")
    else:
        Qd_bf = dual.Qd.to(torch.bfloat16)
        theta = torch.maximum(
            floor, torch.clamp(-Qd_bf.float(), min=0.0).sum(dim=1))
    Qbf = Qd_bf.float()                  # the rounded matrix, exactly
    if not use_kernel:
        Qdn_bf = torch.clamp(-Qbf, min=0.0)
        Qdp_bf = torch.clamp(Qbf, min=0.0)
    th = theta[:, None]
    Fdn = _as2d(dual.Fdn).expand(N, B)
    Fdp = _as2d(dual.Fdp).expand(N, B)
    Fd = _as2d(dual.Fd)

    def dot_bf(A, Y):
        # bf16 x bf16 products are exact in float32; the sum stays float32
        return A @ Y.bfloat16().float()

    def upd(Y):
        tY = th * Y
        num = dot_bf(Qdn_bf, Y) + tY + Fdn
        den = dot_bf(Qdp_bf, Y) + tY + Fdp
        if cfg.den_eps:
            den = torch.clamp(den, min=cfg.den_eps)
        return (num / den) * Y

    def accel_bf(Y, frozen):
        # accel_step on the bf16 problem (same safeguarded algebra)
        grad = dot_bf(Qbf, Y) + Fd
        p = torch.where((Y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * dot_bf(Qbf, p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        Yn = torch.clamp(Y + alpha[None, :] * p, min=0.0)
        fY = 0.5 * (Y * (grad + Fd)).sum(dim=0)
        fYn = (0.5 * (Yn * dot_bf(Qbf, Yn)).sum(dim=0)
               + (Fd * Yn).sum(dim=0))
        keep = (fYn <= fY) & ~frozen
        return torch.where(keep[None, :], Yn, Y)

    k = cfg.check_every

    def mult(n, Y, frozen):
        if use_kernel:
            Yn = _tiled.streamed_pqp_iterations(Qd_bf, theta, Fdn, Fdp, Y,
                                                num_iters=n,
                                                den_eps=cfg.den_eps)
            return torch.where(frozen[None, :], Y, Yn)
        for _ in range(n):
            Y = torch.where(frozen[None, :], Y, upd(Y))
        return Y

    def run_updates(Y, frozen):
        if not cfg.accel_every:
            return mult(k, Y, frozen)
        for _ in range(k // cfg.accel_every):
            Y = accel_bf(mult(cfg.accel_every, Y, frozen), frozen)
        return Y

    Y = Y0
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    slow = torch.zeros(B, dtype=torch.int32, device=dev)
    h = 0
    # one host sync per check, as in solve_batched
    while h <= cfg.max_iters and not bool(frozen.all()):
        ok, _, _, Jp, Jd = check_terminate(primal, dual, Y, cfg)
        g = (complementarity_gap(dual, Y) if cfg.gap_from_complementarity
             else Jp + Jd).abs()
        g_bf = (Y * (dot_bf(Qbf, Y) + Fd)).sum(dim=0).abs()
        bad = ~torch.isfinite(Y).all(dim=0) & ~frozen
        slow = torch.where(g_bf < floor_frac * g, slow + 1,
                           torch.zeros_like(slow))
        newly = (ok | bad | (slow >= floor_checks)) & ~frozen
        iters = torch.where(newly, h, iters)
        frozen = frozen | newly
        Y = run_updates(Y, frozen)
        h += k
    it1 = torch.where(frozen, iters, h).to(torch.int32)

    # a non-finite lane would poison its f32 warm start forever (NaN/Inf
    # are absorbing under the multiplicative update): restart it cold
    lane_ok = torch.isfinite(Y).all(dim=0)
    Y1 = torch.where(lane_ok[None, :], Y, torch.full_like(Y, cfg.y0))
    res = solve_batched(primal, dual, Y0=Y1, cfg=cfg)
    return dataclasses.replace(res, iters=(res.iters + it1).to(torch.int32))


def solve(primal: PrimalQP, dual: Optional[DualQP] = None,
          Y0: Optional[torch.Tensor] = None,
          cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Single-instance convenience wrapper: dualizes if needed, solves, and
    squeezes the batch axis (mirrors main(), PQP_CPU.c:994-999).  Rejects
    batched inputs — use :func:`solve_batched` for those."""
    for name, arr in (("Fp", primal.Fp), ("Kp", primal.Kp),
                      ("Y0", Y0), ("Fd", None if dual is None else dual.Fd)):
        if arr is not None and arr.dim() == 2 and arr.shape[1] > 1:
            raise ValueError(
                f"solve() is single-instance but {name} has batch "
                f"{arr.shape[1]}; use solve_batched()")
    if dual is None:
        from pqp_for_mpc_tpu_torch.dual import dualize
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
    res = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    squeeze = lambda a: a[..., 0] if a.dim() >= 1 and a.shape[-1] == 1 else a
    return SolveResult(
        U=res.U[:, 0], Y=res.Y[:, 0], iters=squeeze(res.iters),
        converged=squeeze(res.converged), feasible=squeeze(res.feasible),
        Jp=squeeze(res.Jp), Jd=squeeze(res.Jd),
        diverged=squeeze(res.diverged))
