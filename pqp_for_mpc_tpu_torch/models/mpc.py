"""Condensed-MPC problem construction and the receding-horizon loop.

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/mpc.py`` for the
condensed backend.  Given a :class:`LinearPlant`, a horizon and cost and
constraint specs, :func:`condense` produces a :class:`CondensedMPCData`
with the reference's block semantics — ``assemble(x, D)`` reproduces

    Fp = Fp1 D + Fp2 x - Fp3                          (PQP_CPU.c:373-382)
    Mp = 1/2 (x'Mp1 x + D'Mp2 x + Mp4.x
              + D'Mp3 D + Mp5.D + Mp6)                (PQP_CPU.c:395-428)

for the tracking cost
    J(U) = sum_k (y_k - r)' Qy (y_k - r) + u_k' R u_k
over the stacked prediction
    X = Sx x0 + Su U + Sd Dseq,   y_k = C x_k,
with box input bounds and slew-rate bounds contributing the reference's
``N = 4 * horizon * n_input`` constraint rows (PQP_CPU.c:941).

The build is the JAX package's float64 NumPy host build, copied; only the
final cast differs (float32 tensors on a given device).
:class:`MPCController` runs the receding-horizon loop through
:func:`~pqp_for_mpc_tpu_torch.routing.solve_auto`: ``rollout`` propagates
the plant on the host, ``rollout_jit`` keeps the whole loop on the
controller's device.  The stage-wise backend is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dual_geometry, dualize_forcing
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.problem import CondensedMPCData, resolve_device
from pqp_for_mpc_tpu_torch.routing import solve_auto


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Cost and constraint specification for condensation.

    ``plant`` may be an LTI :class:`LinearPlant` or a time-varying
    :class:`~pqp_for_mpc_tpu_torch.models.plants.LTVPlant` (stacked
    per-stage matrices, e.g. from successive linearization of a nonlinear
    plant); ``r`` may be a constant ``(ny,)``
    reference or a per-stage ``(H, ny)`` trajectory.  ``Qy``/``R`` may
    likewise be constant or per-stage stacks ``(H, ny, ny)``/``(H, nu,
    nu)``.  ``P`` adds the terminal state cost ``x_H' P x_H``.  The same
    dataclass as the JAX package's.
    """

    plant: LinearPlant
    horizon: int
    Qy: np.ndarray            # (ny, ny) or (H, ny, ny) tracking weight
    R: np.ndarray             # (nu, nu) or (H, nu, nu) input weight
    r: np.ndarray             # (ny,) or (H, ny) output reference
    u_min: np.ndarray         # (nu,) or per-stage (H, nu)
    u_max: np.ndarray         # (nu,) or per-stage (H, nu)
    du_max: np.ndarray        # (nu,) or (H, nu) slew-rate bound
    u_prev: Optional[np.ndarray] = None  # previous input for rate rows
    # Optional output (state) constraints y_min <= y_k <= y_max over the
    # horizon — beyond the reference's input-only constraint surface.
    # Their condensed bounds depend on (x, D): Kp = Kp0 + Kx x + Kd D.
    y_min: Optional[np.ndarray] = None   # (ny,)
    y_max: Optional[np.ndarray] = None   # (ny,)
    # Soften the output constraints with nonnegative slacks s and a
    # quadratic penalty rho*|s|^2: hard output constraints can make the
    # QP infeasible for reachable states; softened ones always admit a
    # solution.  None = hard constraints.
    soft_penalty: Optional[float] = None
    # Terminal state cost x_H' P x_H (P PSD, (ns, ns)); None = no
    # terminal term.  Enters Qp/Fp/Mp on the condensed path and the
    # Riccati init on the stage-wise path.
    P: Optional[np.ndarray] = None
    # Move blocking (condensed backend): hold the input constant over
    # blocks of stages, so the decision variable shrinks from H*nu to
    # n_moves*nu and the dual from 4*H*nu to 4*n_moves*nu rows — the
    # classic way to make long-horizon condensed MPC cheap (the dual
    # Hessian shrinks QUADRATICALLY in the blocking factor).  Either an
    # int (H split as evenly as possible) or an explicit tuple of
    # per-move stage counts summing to H (e.g. (1, 1, 2, 4, 8, 16) —
    # fine near now, coarse far out).  The COST still charges every
    # stage; box bounds aggregate to the tightest in each block and
    # slew rows live at block boundaries, so the blocked solution is
    # feasible for the original per-stage constraints by construction.
    # None = no blocking.  The stage-wise backend rejects it (it is
    # already O(H) and blocking would break its Riccati structure).
    moves: Optional[object] = None


def _bound_flat(v, H: int, nu: int) -> np.ndarray:
    """Flat (H*nu,) float64 bound vector from a constant ``(nu,)`` bound or
    a per-stage ``(H, nu)`` schedule."""
    a = np.asarray(v, np.float64)
    if a.ndim == 2:
        if a.shape != (H, nu):
            raise ValueError(f"per-stage bound shape {a.shape} != "
                             f"({H}, {nu})")
        return a.reshape(-1)
    return np.tile(a, H)


def _prediction_matrices_f64(plant: LinearPlant, H: int):
    """Host-side float64 prediction build for :func:`_condense`:
    ``X = Sx x0 + Su U + Sd Dseq`` for x_1..x_H.  The build runs once per
    (plant, horizon) and its accuracy bounds everything downstream
    (kappa(Qp) grows ~H^4), so it runs in float64 and only the finished
    blocks are cast to float32."""
    ltv = np.asarray(plant.A).ndim == 3
    ns, nu, nd = plant.n_state, plant.n_input, plant.n_dist
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    E = np.asarray(plant.E, np.float64)
    if ltv:
        if A.shape[0] != H:
            raise ValueError(f"LTV plant horizon {A.shape[0]} != {H}")
    else:
        A = np.broadcast_to(A, (H, ns, ns))
        B = np.broadcast_to(B, (H, ns, nu))
        E = np.broadcast_to(E, (H, ns, nd))
    Sx = np.zeros((H * ns, ns))
    Su = np.zeros((H * ns, H * nu))
    Sd = np.zeros((H * ns, H * nd))
    sx = np.eye(ns)
    su = np.zeros((H, ns, nu))
    sd = np.zeros((H, ns, nd))
    for i in range(H):
        sx = A[i] @ sx
        su = np.einsum("pk,jkq->jpq", A[i], su)
        sd = np.einsum("pk,jkq->jpq", A[i], sd)
        su[i] = B[i]
        sd[i] = E[i]
        Sx[i * ns:(i + 1) * ns] = sx
        Su[i * ns:(i + 1) * ns] = su.transpose(1, 0, 2).reshape(ns, H * nu)
        Sd[i * ns:(i + 1) * ns] = sd.transpose(1, 0, 2).reshape(ns, H * nd)
    return Sx, Su, Sd


def dare_terminal_weight(plant: LinearPlant, Qy, R,
                         max_iters: int = 10_000,
                         tol: float = 1e-12) -> np.ndarray:
    """Infinite-horizon cost-to-go ``P`` for the UNSCALED tracking cost
    ``sum |C x|^2_Qy + |u|^2_R`` — the textbook ``MPCSpec.P`` choice
    (terminal cost = what an infinite horizon would charge, turning a
    short-horizon MPC into the constrained LQR near the origin).

    Solved by value iteration on the discrete algebraic Riccati
    equation in float64 on the host (build-time, never hot).  LTI
    plants only — an LTV/linearization user should evaluate at the
    operating point.
    """
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    if A.ndim != 2:
        raise ValueError("dare_terminal_weight needs an LTI plant")
    Q = C.T @ np.asarray(Qy, np.float64) @ C
    R = np.asarray(R, np.float64)
    P = Q.copy()
    for _ in range(max_iters):
        BtP = B.T @ P
        P_next = Q + A.T @ P @ A - A.T @ P @ B @ np.linalg.solve(
            R + BtP @ B, BtP @ A)
        P_next = 0.5 * (P_next + P_next.T)
        if np.abs(P_next - P).max() <= tol * max(1.0, np.abs(P).max()):
            return P_next.astype(np.float32)
        P = P_next
    raise ValueError("DARE value iteration did not converge "
                     "(unstabilizable plant or undetectable cost?)")


def _stage_weight_diag(W, H: int, n: int, name: str) -> np.ndarray:
    """Block-diagonal stacked weight: a constant ``(n, n)`` weight
    krons across stages; a per-stage ``(H, n, n)`` stack fills the
    blocks individually (time-varying weights)."""
    W = np.asarray(W, np.float64)
    if W.ndim == 2:
        if W.shape != (n, n):
            raise ValueError(f"{name} shape {W.shape} != ({n}, {n})")
        return np.kron(np.eye(H), W)
    if W.shape != (H, n, n):
        raise ValueError(f"{name} shape {W.shape} != ({H}, {n}, {n})")
    out = np.zeros((H * n, H * n))
    for k in range(H):
        out[k * n:(k + 1) * n, k * n:(k + 1) * n] = W[k]
    return out


def move_schedule(moves, H: int) -> np.ndarray:
    """Resolve ``MPCSpec.moves`` to an array of per-move stage counts.
    An int n splits H as evenly as possible into n blocks (earlier
    blocks get the remainder stage each — finer resolution near now);
    a tuple is validated to positive ints summing to H."""
    if isinstance(moves, (int, np.integer)):
        n = int(moves)
        if not 1 <= n <= H:
            raise ValueError(f"moves={n} not in [1, {H}]")
        base, rem = divmod(H, n)
        return np.array([base + (1 if j < rem else 0) for j in range(n)])
    lengths = np.asarray(moves, dtype=int)
    if lengths.ndim != 1 or (lengths < 1).any() or lengths.sum() != H:
        raise ValueError(f"move schedule {moves!r} must be positive "
                         f"stage counts summing to horizon {H}")
    return lengths


def _blocking_matrix(lengths: np.ndarray, nu: int) -> np.ndarray:
    """U = Mb V: ``Mb (H*nu, n_moves*nu)`` repeats move j's value over
    its ``lengths[j]`` stages."""
    H = int(lengths.sum())
    n = len(lengths)
    S = np.zeros((H, n))
    k = 0
    for j, L in enumerate(lengths):
        S[k:k + L, j] = 1.0
        k += L
    return np.kron(S, np.eye(nu))


def _blocked_input_constraints_f64(spec: MPCSpec, lengths: np.ndarray):
    """Input rows on the blocked variable V: box bounds take the
    TIGHTEST per-stage bound inside each block, slew rows sit at block
    boundaries (within-block first differences are identically zero),
    so ``U = Mb V`` satisfies every original per-stage row."""
    H, nu = spec.horizon, spec.plant.n_input
    n = len(lengths)
    Mv = n * nu
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    umax = _bound_flat(spec.u_max, H, nu).reshape(H, nu)
    umin = _bound_flat(spec.u_min, H, nu).reshape(H, nu)
    dmax = _bound_flat(spec.du_max, H, nu).reshape(H, nu)
    umax_v = np.stack([umax[s:s + L].min(axis=0)
                       for s, L in zip(starts, lengths)]).reshape(-1)
    umin_v = np.stack([umin[s:s + L].max(axis=0)
                       for s, L in zip(starts, lengths)]).reshape(-1)
    dmax_v = dmax[starts].reshape(-1)          # boundary-stage slew bound
    I = np.eye(Mv)
    T = np.eye(Mv) - np.eye(Mv, k=-nu)
    Gp = np.concatenate([I, -I, T, -T], axis=0)                  # (4Mv, Mv)
    uprev = np.zeros(nu) if spec.u_prev is None else \
        np.asarray(spec.u_prev, np.float64)
    e1u = np.concatenate([uprev, np.zeros(Mv - nu)])
    Kp = np.concatenate([umax_v, -umin_v, dmax_v + e1u, dmax_v - e1u])
    return Gp, Kp


def _input_constraints_f64(spec: MPCSpec):
    """Box + slew-rate rows ``Gp U <= Kp`` (N = 4*H*nu rows), float64:
    [U <= umax; -U <= -umin; T U <= dumax + e1 uprev;
    -T U <= dumax - e1 uprev] with T the first-difference operator."""
    H, nu = spec.horizon, spec.plant.n_input
    M = H * nu
    I = np.eye(M)
    T = np.eye(M) - np.eye(M, k=-nu)
    Gp = np.concatenate([I, -I, T, -T], axis=0)                  # (4M, M)
    umax = _bound_flat(spec.u_max, H, nu)
    umin = _bound_flat(spec.u_min, H, nu)
    dmax = _bound_flat(spec.du_max, H, nu)
    uprev = np.zeros(nu) if spec.u_prev is None else \
        np.asarray(spec.u_prev, np.float64)
    e1u = np.concatenate([uprev, np.zeros(M - nu)])
    Kp = np.concatenate([umax, -umin, dmax + e1u, dmax - e1u])   # (4M,)
    return Gp, Kp



def condense(spec: MPCSpec, device=None) -> CondensedMPCData:
    """Derive the condensed blocks in the reference's exact block
    conventions (so :meth:`CondensedMPCData.assemble` reproduces the
    tracking cost; see the module docstring for the algebra).

    The build runs once per (plant, horizon) on the host in float64, and
    the finished blocks are cast to float32 tensors on ``device``: build
    accuracy bounds solver accuracy (kappa(Qp) reaches ~1e11 for stiff
    plants at modest horizons), so the float32 cast is the only error.
    ``device`` defaults to CUDA (``problem.resolve_device``).
    """
    return _condense(spec, resolve_device(device))


def _condense(spec: MPCSpec, device) -> CondensedMPCData:
    plant, H = spec.plant, spec.horizon
    ns, nu, nd, ny = (plant.n_state, plant.n_input, plant.n_dist,
                      plant.n_output)
    M = H * nu

    Sx, Su, Sd = _prediction_matrices_f64(plant, H)
    C = np.asarray(plant.C, np.float64)
    if C.ndim == 3:      # LTV: per-stage output maps, block-diagonal
        Cs = np.zeros((H * ny, H * ns))
        for k in range(H):
            Cs[k * ny:(k + 1) * ny, k * ns:(k + 1) * ns] = C[k]
    else:
        Cs = np.kron(np.eye(H), C)
    Qbar = _stage_weight_diag(spec.Qy, H, ny, "Qy")
    Rbar = _stage_weight_diag(spec.R, H, nu, "R")
    r = np.asarray(spec.r, np.float64)
    if r.ndim == 2:      # per-stage reference (H, ny)
        if r.shape != (H, ny):
            raise ValueError(f"reference shape {r.shape} != ({H}, {ny})")
        rbar = r.reshape(-1)
    else:
        rbar = np.tile(r, H)                                     # (H*ny,)

    if spec.P is not None:
        # Terminal cost x_H' P x_H as ns extra zero-reference "outputs"
        # selecting the last state block: append Sel_H = [0 .. 0 I] to
        # Cs and blkdiag P into Qbar — every cost block below then
        # carries the terminal term through unchanged algebra.  The
        # OUTPUT-CONSTRAINT geometry must not see these rows; it slices
        # the leading H*ny rows back out (``rows_u`` below).
        P = np.asarray(spec.P, np.float64)
        if P.shape != (ns, ns):
            raise ValueError(f"terminal P shape {P.shape} != ({ns},{ns})")
        sel = np.zeros((ns, H * ns))
        sel[:, (H - 1) * ns:] = np.eye(ns)
        Cs = np.concatenate([Cs, sel], axis=0)
        Qbar = np.block([
            [Qbar, np.zeros((H * ny, ns))],
            [np.zeros((ns, H * ny)), P]])
        rbar = np.concatenate([rbar, np.zeros(ns)])

    CSu = Cs @ Su        # (Hny[+ns], M)
    CSx = Cs @ Sx        # (Hny[+ns], ns)
    CSd = Cs @ Sd        # (Hny[+ns], Hnd)

    Mv = M
    if spec.moves is not None:
        # Move blocking: substitute U = Mb V everywhere.  The cost
        # still charges every stage (CSu absorbs Mb; Rbar contracts to
        # Mb' Rbar Mb), so this is the textbook blocked problem, not a
        # coarser-grid approximation.
        lengths = move_schedule(spec.moves, H)
        Mb = _blocking_matrix(lengths, nu)
        CSu = CSu @ Mb
        Rbar = Mb.T @ Rbar @ Mb
        Mv = len(lengths) * nu
    QCSu = Qbar @ CSu

    # J = (CSu U + c)'Qbar(CSu U + c) + U'Rbar U,
    # c = CSx x + CSd D - rbar  ==  1/2 U'Qp U + Fp'U + 1/2 Mp with:
    Qp = 2.0 * (CSu.T @ QCSu + Rbar)
    Fp1 = 2.0 * QCSu.T @ CSd                                     # (M, Hnd)
    Fp2 = 2.0 * QCSu.T @ CSx                                     # (M, ns)
    Fp3 = 2.0 * QCSu.T @ rbar                                    # (M,)
    # Mp blocks match computeMp's actual arithmetic (all five assembled
    # terms carry the +1/2 factor; PQP_CPU.c:403-425):
    Mp1 = 4.0 * CSx.T @ Qbar @ CSx                               # (ns, ns)
    Mp2 = 8.0 * CSd.T @ Qbar @ CSx                               # (Hnd, ns)
    Mp3 = 4.0 * CSd.T @ Qbar @ CSd                               # (Hnd, Hnd)
    Mp4 = -8.0 * CSx.T @ (Qbar @ rbar)                           # (ns,)
    Mp5 = -8.0 * CSd.T @ (Qbar @ rbar)                           # (Hnd,)
    Mp6 = 4.0 * rbar @ (Qbar @ rbar)                             # ()

    if spec.moves is None:
        Gp, Kp = _input_constraints_f64(spec)
    else:
        Gp, Kp = _blocked_input_constraints_f64(spec, lengths)
    Kx = Kd = None
    if spec.y_min is not None or spec.y_max is not None:
        # Output constraints: y = CSu U + CSx x + CSd D, so
        #   CSu U <= ymax - CSx x - CSd D     (rows with Kx = -CSx)
        #  -CSu U <= -ymin + CSx x + CSd D    (rows with Kx = +CSx)
        # Constraint bounds become state-dependent: Kp(x, D) =
        # Kp0 + Kx x + Kd D, handled by CondensedMPCData.assemble.
        big = 1e6  # one-sided bounds stay inert

        def _ybound(v, default):
            # constant (ny,) or per-stage (H, ny) schedule (e.g. tube
            # tightening, models/robust.py), flattened stage-major
            if v is None:
                return np.full(H * ny, default)
            a = np.asarray(v, np.float64)
            if a.ndim == 2:
                if a.shape != (H, ny):
                    raise ValueError(f"per-stage output bound shape "
                                     f"{a.shape} != ({H}, {ny})")
                return a.reshape(-1)
            return np.tile(a, H)

        ymax = _ybound(spec.y_max, big)
        ymin = _ybound(spec.y_min, -big)
        rows_u = CSu[:H * ny]      # output rows only (skip terminal-P)
        n_out = 2 * H * ny
        Gp = np.concatenate([Gp, rows_u, -rows_u], axis=0)
        Kp = np.concatenate([Kp, ymax, -ymin])
        Zx = np.zeros((4 * Mv, ns))
        Zd = np.zeros((4 * Mv, H * nd))
        Kx = np.concatenate([Zx, -CSx[:H * ny], CSx[:H * ny]], axis=0)
        Kd = np.concatenate([Zd, -CSd[:H * ny], CSd[:H * ny]], axis=0)

        if spec.soft_penalty is not None:
            # Slack softening: V = [U; s], s >= 0 penalized rho|s|^2.
            # Output rows become  +/-CSu U - s <= bound  and n_out extra
            # rows enforce s >= 0 (with zero state dependence).
            rho = float(spec.soft_penalty)
            Qp = np.block([
                [Qp, np.zeros((Mv, n_out))],
                [np.zeros((n_out, Mv)), 2.0 * rho * np.eye(n_out)]])
            zrow = lambda A: np.concatenate(
                [A, np.zeros((n_out, A.shape[1]))], axis=0)
            Fp1, Fp2 = zrow(Fp1), zrow(Fp2)
            Fp3 = np.concatenate([Fp3, np.zeros(n_out)])
            slack_cols = np.concatenate([
                np.zeros((4 * Mv, n_out)), -np.eye(n_out)], axis=0)
            Gp = np.concatenate([
                np.concatenate([Gp, slack_cols], axis=1),
                np.concatenate([np.zeros((n_out, Mv)), -np.eye(n_out)],
                               axis=1)], axis=0)
            Kp = np.concatenate([Kp, np.zeros(n_out)])
            Kx = np.concatenate([Kx, np.zeros((n_out, ns))], axis=0)
            Kd = np.concatenate([Kd, np.zeros((n_out, H * nd))], axis=0)

    Qp_inv = np.linalg.inv(Qp)

    f32 = lambda a: (None if a is None else torch.as_tensor(
        np.asarray(a, np.float64), dtype=torch.float32, device=device))
    return CondensedMPCData(
        Qp_inv=f32(Qp_inv), Qp=f32(Qp),
        Fp1=f32(Fp1), Fp2=f32(Fp2), Fp3=f32(Fp3),
        Mp1=f32(Mp1), Mp2=f32(Mp2), Mp3=f32(Mp3), Mp4=f32(Mp4),
        Mp5=f32(Mp5), Mp6=f32(Mp6),
        Gp=f32(Gp), Kp=f32(Kp),
        # Z is file-format parity only (unused by the solve); an LTV
        # plant has no single output map - record stage 0's.
        Z=f32(C[0] if C.ndim == 3 else C),
        ThetaOut=f32(np.zeros((ny, nd))),
        x=f32(np.zeros(ns)), D=f32(np.zeros(H * nd)),
        Kx=f32(Kx), Kd=f32(Kd))


#: auto_backend's condensed->stage-wise crossover, as the CONDENSED dual
#: dimension n_con — the JAX package's value, measured there on a TPU
#: (its models/mpc.py); not yet measured for this port (ROADMAP queue 2,
#: open cells).
_AUTO_BACKEND_NCON = 1536


def condensed_n_con(spec: MPCSpec) -> int:
    """Constraint count of the condensed dual for ``spec`` (the N whose
    square the dense path materializes): 4 input-row groups (box+slew,
    the reference's layout, PQP_CPU.c:941) over the move-blocked stage
    count, plus 2 output groups when bounds are present, plus 2
    slack-positivity groups when softened."""
    H, nu, ny = spec.horizon, spec.plant.n_input, spec.plant.n_output
    Hv = len(move_schedule(spec.moves, H)) if spec.moves is not None else H
    n = 4 * Hv * nu
    if spec.y_min is not None or spec.y_max is not None:
        n += 2 * H * ny
        if spec.soft_penalty is not None:
            n += 2 * H * ny
    return n


def auto_backend(spec: MPCSpec) -> str:
    """Pick the MPC backend for ``spec``: ``"condensed"`` (dense dual,
    the reference's formulation) while its n_con stays below the
    measured crossover, ``"stagewise"`` (matrix-free O(H)) beyond it.
    Move blocking (the one condensed-only feature) forces
    ``"condensed"`` at any horizon."""
    if spec.moves is not None:
        return "condensed"
    return ("condensed" if condensed_n_con(spec) < _AUTO_BACKEND_NCON
            else "stagewise")


# ---------------------------------------------------------------------------
# Receding-horizon closed loop
# ---------------------------------------------------------------------------


class MPCController:
    """Receding-horizon controller around the batched PQP solver
    (condensed backend).

    Warm starting carries the dual iterate Y* between consecutive solves:
    consecutive QPs differ only in (x, u_prev), so the previous multipliers
    are a near-optimal initialization.  ``device`` is where the condensed
    blocks and every solve live (default: CUDA; without a card that
    raises — pass ``device="cpu"``).
    """

    def __init__(self, spec: MPCSpec, cfg: Optional[SolverConfig] = None,
                 warm_start=True,
                 cold_start_y0: Optional[float] = None,
                 warm_start_floor: float = 1e-6,
                 backend: str = "condensed",
                 retry_cold: bool = False,
                 device=None):
        # warm_start: False | True (carry multipliers) | "shift" (carry
        # AND advance them one control stage — see _shift_multipliers)
        # retry_cold: any step that fails the four-part certification is
        # re-solved once from the cold start (solver.retry_cold_solve).
        from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
        if backend == "auto":
            backend = auto_backend(spec)
        if backend == "stagewise":
            raise NotImplementedError(
                "the stage-wise backend is not ported yet (ROADMAP queue 1, "
                "item 10)")
        if backend != "condensed":
            raise ValueError(f"unknown backend {backend!r}")
        self._n_moves = None
        if spec.moves is not None:
            self._n_moves = len(move_schedule(spec.moves, spec.horizon))
        self._Hv = self._n_moves or spec.horizon
        if cfg is None:
            # MPC_CONFIG's small cold start (y0=0.01) matters: the
            # multiplicative update grows Y fast but decays it slowly, so
            # the reference's Y0=1000 (PQP_CPU.c:710) is catastrophic on
            # a typical MPC QP
            cfg = MPC_CONFIG
        self.device = resolve_device(device)
        self.spec = spec
        self.warm_start = warm_start
        # an explicitly-passed cfg is honored verbatim; cold_start_y0
        # overrides only its y0 when given
        self.cfg = cfg if cold_start_y0 is None else \
            dataclasses.replace(cfg, y0=cold_start_y0)
        # Zero is an absorbing state of the multiplicative update, so the
        # carried multipliers are floored at a tiny positive value.
        self.warm_start_floor = warm_start_floor
        self.backend = backend
        self.retry_cold = retry_cold
        self._u_base = self._as_f32(np.zeros(spec.plant.n_input)
                                    if spec.u_prev is None else spec.u_prev)
        self.data = condense(spec, device=self.device)
        self.Qp = self.data.qp()    # exactly-built, never re-inverted
        # instance-invariant dual geometry, computed once; per-step solves
        # only rebuild the forcing
        self._geom = dual_geometry(self.data.Gp, self.data.Qp_inv,
                                   theta_floor=self.cfg.theta_floor,
                                   precision=self.cfg.precision)
        self._Y = None
        # (steps, preview?, w_seq?) -> rollout_jit's trajectory buffers
        self._rollout_fns = {}

    def reset(self):
        self._Y = None

    def _shift_multipliers(self, Y):
        """Shift each stage-structured multiplier block one control step
        forward (last stage repeated).  Row layout: four (H, nu) input
        blocks, then two (H, ny) output blocks when present (four when
        softened)."""
        spec = self.spec
        H, nu = spec.horizon, spec.plant.n_input
        ny = spec.plant.n_output
        Hi = self._Hv    # move blocking: input groups have n_moves rows
        Y2 = Y if Y.dim() == 2 else Y[:, None]

        def shift_block(block, steps, w):
            b = block.reshape(steps, w, -1)
            return torch.cat([b[1:], b[-1:]], dim=0).reshape(steps * w, -1)

        segs, off = [], 0
        for _ in range(4):
            segs.append(shift_block(Y2[off:off + Hi * nu], Hi, nu))
            off += Hi * nu
        if self.data.Kx is not None:
            n_blocks = 4 if spec.soft_penalty is not None else 2
            for _ in range(n_blocks):
                segs.append(shift_block(Y2[off:off + H * ny], H, ny))
                off += H * ny
        out = torch.cat(segs, dim=0)
        return out if Y.dim() == 2 else out[:, 0]

    def step(self, x, d_seq=None, u_prev=None):
        """Solve one MPC QP; returns (u0, SolveResult).  ``x`` may be
        batched ``(ns, B)`` for scenario fan-outs."""
        H, nu = self.spec.horizon, self.spec.plant.n_input
        nd = self.spec.plant.n_dist
        D = (torch.zeros(H * nd, dtype=torch.float32, device=self.device)
             if d_seq is None else self._as_f32(d_seq).reshape(-1))
        data = (self.data if u_prev is None
                else self._data_with_uprev(self._as_f32(u_prev)))
        primal = data.assemble(x=self._as_f32(x), D=D, Qp=self.Qp)
        dual = dualize_forcing(self._geom, primal.Fp, primal.Mp, primal.Kp,
                               precision=self.cfg.precision)
        Y0 = None
        if self.warm_start and self._Y is not None:
            B = primal.Fp.shape[1] if primal.Fp.dim() == 2 else 1
            Yw = self._Y
            if self.warm_start == "shift":
                Yw = self._shift_multipliers(Yw)
            if Yw.shape[1] == B or Yw.shape[1] == 1:
                Y0 = torch.clamp(Yw, min=self.warm_start_floor)
            # else: batch size changed since last step — cold start
        res = solve_auto(primal, dual, Y0=Y0, cfg=self.cfg,
                         retry_cold=self.retry_cold and Y0 is not None)
        if self.warm_start:
            self._Y = res.Y
        u0 = res.U[:nu]
        return u0, res

    def _data_with_uprev(self, u_prev: torch.Tensor) -> CondensedMPCData:
        """The condensed data with the slew-row bounds moved to ``u_prev``
        (a tensor on the controller's device).  ``u_prev`` enters only those
        rows, additively ([box+, box-, slew+, slew-]); ``data.Kp`` already
        carries ``spec.u_prev``, so only the delta from it is applied, and
        any output rows after the 4M input rows are kept."""
        M, nu = self._Hv * self.spec.plant.n_input, self.spec.plant.n_input
        e1u = torch.zeros(M, dtype=torch.float32, device=self.device)
        e1u[:nu] = u_prev.reshape(-1) - self._u_base
        Kp = self.data.Kp.clone()
        Kp[2 * M:3 * M] += e1u
        Kp[3 * M:4 * M] -= e1u
        return dataclasses.replace(self.data, Kp=Kp)

    def _as_f32(self, a) -> torch.Tensor:
        """``a`` (array-like or tensor) as float32 on the controller's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _check_lti_rollout(self):
        # The closed-loop propagation x+ = A x + B u0 reuses one (A, B); an
        # LTV prediction model has no single pair
        if np.asarray(self.spec.plant.A).ndim == 3:
            raise NotImplementedError(
                "closed-loop rollout needs an LTI plant; for LTV loops "
                "call step() per control step")

    def rollout_jit(self, x0, steps: int, d_forecast=None, w_seq=None):
        """The closed loop kept on the controller's device: per step the
        slew-row ``Kp`` update, ``assemble``, ``dualize_forcing``,
        ``solve_auto`` (warm, ``retry_cold`` honoured) and
        ``x+ = A x + B u0 (+ E d + w)`` in float32, the trajectories written
        into buffers preallocated on the device and brought to the host
        once at the end.  The JAX package compiles this loop into one
        ``lax.scan``; here it is a Python loop whose only host syncs are
        the solver's own per-check ``all(done)`` tests (and, with
        ``retry_cold``, its per-step "did every lane certify").  No CUDA
        graph: that loop is data-dependent.  ``self._rollout_fns`` caches
        the buffers per ``(steps, preview, w_seq)``.

        ``d_forecast`` — optional known-disturbance preview ``(steps + H,
        nd)``: step t solves with the window ``d_forecast[t:t+H]`` and the
        plant moves with ``d_forecast[t]``.  ``w_seq`` — optional
        ``(steps, ns)`` additive process disturbance on the true state
        update, never seen by the solver.

        Returns a dict of NumPy trajectories: ``x (steps, ns)``, ``u
        (steps, nu)``, ``iters (steps,)`` and ``converged (steps,)``.
        """
        self._check_lti_rollout()
        spec, cfg, dev = self.spec, self.cfg, self.device
        plant = spec.plant
        H, nu, nd, ns = (spec.horizon, plant.n_input, plant.n_dist,
                         plant.n_state)
        f32 = torch.float32
        key = (steps, d_forecast is not None, w_seq is not None)
        traj = self._rollout_fns.get(key)
        if traj is None:
            traj = self._rollout_fns[key] = dict(
                x=torch.empty((steps, ns), dtype=f32, device=dev),
                u=torch.empty((steps, nu), dtype=f32, device=dev),
                iters=torch.empty(steps, dtype=torch.int32, device=dev),
                converged=torch.empty(steps, dtype=torch.bool, device=dev))
        ws = None if w_seq is None else self._as_f32(w_seq).reshape(steps, ns)
        wins = None
        if d_forecast is not None:
            df = self._as_f32(d_forecast).reshape(-1, nd)
            if df.shape[0] < steps + H:
                raise ValueError(f"d_forecast needs {steps + H} rows "
                                 f"(steps + horizon), got {df.shape[0]}")
            # per-step preview windows (steps, H, nd), gathered on the device
            idx = (torch.arange(steps, device=dev)[:, None]
                   + torch.arange(H, device=dev)[None, :])
            wins = df[idx]
        A, Bm, Em = (self._as_f32(m) for m in (plant.A, plant.B, plant.E))
        D0 = torch.zeros(H * nd, dtype=f32, device=dev)
        Y_cold = torch.full((self.data.n_con, 1), cfg.y0, dtype=f32,
                            device=dev)
        x = self._as_f32(x0).reshape(ns)
        u_prev = torch.zeros(nu, dtype=f32, device=dev)
        Y = Y_cold
        for t in range(steps):
            win = None if wins is None else wins[t]
            primal = self._data_with_uprev(u_prev).assemble(
                x=x, D=D0 if win is None else win.reshape(-1), Qp=self.Qp)
            dual = dualize_forcing(self._geom, primal.Fp, primal.Mp,
                                   primal.Kp, precision=cfg.precision)
            res = solve_auto(primal, dual,
                             Y0=torch.clamp(Y, min=self.warm_start_floor),
                             cfg=cfg, retry_cold=self.retry_cold)
            u0 = res.U[:nu, 0]
            xn = A @ x + Bm @ u0
            if win is not None:
                xn = xn + Em @ win[0]
            if ws is not None:
                xn = xn + ws[t]
            # the next warm start honours the controller's mode
            if self.warm_start == "shift":
                Y = self._shift_multipliers(res.Y)
            elif self.warm_start:
                Y = res.Y
            else:
                Y = Y_cold
            traj["x"][t] = xn
            traj["u"][t] = u0
            traj["iters"][t] = res.iters[0]
            traj["converged"][t] = res.converged[0]
            x, u_prev = xn, u0
        return {k: v.cpu().numpy() for k, v in traj.items()}

    def rollout(self, x0, steps: int, d_fn=None, noise=None):
        """Closed-loop simulation for ``steps`` steps (the plant propagates
        in NumPy).  Returns a dict of NumPy trajectories: ``x``, ``u``,
        ``iters`` (per step, max over the batch) and ``converged`` (per
        step, all lanes certified)."""
        self._check_lti_rollout()
        plant = self.spec.plant
        x = np.asarray(x0, np.float32)
        u_prev = np.zeros(plant.n_input, np.float32)
        xs, us, iters, conv = [], [], [], []
        for t in range(steps):
            d_seq = None if d_fn is None else d_fn(t)
            u0, res = self.step(x, d_seq=d_seq, u_prev=u_prev)
            u0v = u0[:, 0] if u0.dim() == 2 else u0
            u0v = u0v.cpu().numpy()
            d_now = (None if d_fn is None else
                     np.asarray(d_fn(t), np.float32).reshape(
                         self.spec.horizon, plant.n_dist)[0])
            x = plant.step(x, u0v, d_now)
            if noise is not None:
                x = x + noise(t)
            x = np.asarray(x, np.float32)
            u_prev = u0v
            xs.append(x)
            us.append(u0v)
            iters.append(int(res.iters.max()))
            conv.append(bool(res.converged.all()))
        return dict(x=np.stack(xs), u=np.stack(us), iters=np.array(iters),
                    converged=np.array(conv))
