"""Sparse (non-condensed) stage-wise PQP for long horizons.

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/stagewise.py``, with its
names and its algebra.  The condensed formulation (:mod:`.mpc`) densifies at
O((H*nu)^2): its dual Hessian ``Qd = Gp Qp^-1 Gp'`` is a dense
(4*H*nu)^2 matrix.  This module runs the SAME PQP algorithm with O(H)
memory and O(H) work per iteration by never materializing Qp, Qp^-1 or Qd:

* ``Qp^-1 v`` is an unconstrained LQR solve: a Riccati-factored backward and
  forward recursion over stages (:func:`kkt_solve`), batched over the
  columns of ``v``;
* ``Qd Y = G Qp^-1 (G' Y)`` where G (box and slew rows, the layout of
  :func:`~pqp_for_mpc_tpu_torch.models.mpc.input_constraints`) applies as
  shifts and sign flips;
* the multiplicative update's elementwise split ``Qd = Qd^+ - Qd^-`` uses an
  elementwise bound ``D >= |Qd|``: ``P = (D + Qd)/2 + diag(theta)``,
  ``N = (D - Qd)/2 + diag(theta)``.  D is the banded-exact hybrid of
  :class:`StagewiseDual`: ``|Qd|`` exactly within ``band`` stages of the
  diagonal, the rank-1 Cauchy-Schwarz bound ``|Qd_ij| <= r_i r_j`` off the
  band.  ``theta_i = max(rowsum(N)_i, floor)`` dominates the reference's
  ``rowsum(Qd^-)`` rule (PQP_CPU.c:503-519), so the update keeps the PQP
  monotonicity guarantee.

Temporal parallelization (``pscan``): every stage recursion here is a
composition of affine maps ``x -> M_k x + c_k``, and affine composition is
associative (Sarkka & Garcia-Fernandez, IEEE TAC 2021).
:func:`_affine_cumulative` computes the inclusive composition in log2(H)
rounds of batched ``(H, n, n)`` matmuls; :func:`solve_stagewise` turns it on
at H >= 64, as the JAX package does.  Its association order differs from
``lax.associative_scan``'s, so results agree to float32 rounding, not bit
for bit.

Every function works on float32 tensors on the device of its inputs, with
full float32 products (TF32 stays off, PyTorch's default), which is what
the JAX package's ``precision="highest"`` asks for.  The solve loop
is a Python ``while`` that reads ``done.all()`` once per check, as
:func:`~pqp_for_mpc_tpu_torch.solver.solve_batched` does.  The band width
is picked on the host in NumPy (:func:`_auto_band`), the one build stage
that reads the blocks back; :func:`relinearize` reuses it and stays on the
device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import (SolveResult, certificate_slack,
                                         cold_start, lane_batch,
                                         termination_fail)
from pqp_for_mpc_tpu_torch.problem import resolve_device
from pqp_for_mpc_tpu_torch.solver import retry_cold_solve
from pqp_for_mpc_tpu_torch.utils import tracing


def _f32(v, device) -> torch.Tensor:
    """``v`` (array-like or tensor) as a float32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class StagewiseFactor:
    """Riccati factorization of the stage-wise primal Hessian Qp:
    time-varying gains such that ``Qp^-1 v`` is one backward and one forward
    recursion.  Plant matrices are stored stacked per stage ``(H, ...)`` (an
    LTI plant is broadcast at build time), convention
    ``x_{k+1} = A[k] x_k + B[k] u_k``, output slot k = ``C[k] x_{k+1}``,
    tracking target ``r[k]``."""

    A: torch.Tensor        # (H, ns, ns)
    Bm: torch.Tensor       # (H, ns, nu)
    E: torch.Tensor        # (H, ns, nd)
    C: torch.Tensor        # (H, ny, ns)
    Qy: torch.Tensor       # (H, ny, ny) per-stage tracking weights
    R: torch.Tensor        # (H, nu, nu) per-stage input weights
    P: torch.Tensor        # (ns, ns) terminal state weight (zeros = none)
    r: torch.Tensor        # (H, ny)
    K: torch.Tensor        # (H, nu, ns)   feedback gains
    Hinv: torch.Tensor     # (H, nu, nu)   (R + B'P_{k+1}B)^-1
    W: torch.Tensor        # (H, ns, nu)   P_{k+1} B Hinv_k
    H: int = 0
    ns: int = 0
    nu: int = 0
    ny: int = 0

    @functools.cached_property
    def stages(self) -> dict:
        """Per-stage views of the stacks (and their transposes) for the
        sequential recursions: one ``unbind`` per factor instead of an
        index per stage and use."""
        return {name: a.unbind(0) for name, a in dict(
            A=self.A, At=self.A.mT, Bm=self.Bm, Bt=self.Bm.mT, E=self.E,
            Ct=self.C.mT, K=self.K, Hinv=self.Hinv, W=self.W).items()}


def _zeros_first(a: torch.Tensor) -> torch.Tensor:
    """``a`` shifted one stage later along axis 0, zero at stage 0."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)


def _zeros_last(a: torch.Tensor) -> torch.Tensor:
    """``a`` shifted one stage earlier along axis 0, zero at the last."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], dim=0)


def _a_shift(f: StagewiseFactor) -> torch.Tensor:
    """``Ash[k] = A[k+1]`` (zero at k = H-1): the costate entering output
    slot k propagates through the NEXT stage's dynamics."""
    return _zeros_last(f.A)


def riccati_factor(spec, device=None) -> StagewiseFactor:
    """Backward Riccati recursion for the stage costs
    ``sum_{k=1..H} |C_k x_k - r_k|^2_Qy + sum_k |u_k|^2_R`` of ``spec``
    (an :class:`~pqp_for_mpc_tpu_torch.models.mpc.MPCSpec`).  Accepts LTI and
    LTV plants and a constant ``(ny,)`` or per-stage ``(H, ny)`` reference.
    The factor's tensors live on ``device`` (default CUDA,
    ``problem.resolve_device``)."""
    dev = resolve_device(device)
    plant, H = spec.plant, spec.horizon
    ltv = np.asarray(plant.A).ndim == 3
    if ltv and plant.A.shape[0] != H:
        raise ValueError(
            f"LTV plant horizon {plant.A.shape[0]} != spec horizon {H}")

    def stk(m):
        a = np.asarray(m, np.float32)
        if not ltv:
            a = np.broadcast_to(a, (H,) + a.shape)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    A, B, E, C = stk(plant.A), stk(plant.B), stk(plant.E), stk(plant.C)
    ny, ns, nu = C.shape[1], A.shape[1], B.shape[2]
    Qy = _f32(spec.Qy, dev)
    Qy = Qy.expand(H, ny, ny) if Qy.dim() == 2 else Qy
    if Qy.shape != (H, ny, ny):
        raise ValueError(f"Qy shape {tuple(Qy.shape)} != ({H}, {ny}, {ny})")
    R = _f32(spec.R, dev)
    R = R.expand(H, nu, nu) if R.dim() == 2 else R
    if R.shape != (H, nu, nu):
        raise ValueError(f"R shape {tuple(R.shape)} != ({H}, {nu}, {nu})")
    P = (torch.zeros((ns, ns), dtype=torch.float32, device=dev)
         if spec.P is None else _f32(spec.P, dev))
    r = _f32(spec.r, dev)
    if r.dim() == 1:
        r = r.expand(H, ny)
    elif r.shape != (H, ny):
        raise ValueError(f"reference shape {tuple(r.shape)} != ({H}, {ny})")
    return _riccati_core(A, B, E, C, Qy.contiguous(), R.contiguous(),
                         r.contiguous(), P)


def _riccati_core(A, B, E, C, Qy, R, r, P=None) -> StagewiseFactor:
    """The recursion on validated stacked ``(H, ...)`` tensors: a pure
    tensor function (no host round trip), so :func:`relinearize` can run it
    every control step.  ``Qy (H, ny, ny)``/``R (H, nu, nu)`` are per-stage
    weight stacks; ``P (ns, ns)`` the terminal state weight (None/zeros = no
    terminal term).

    The recursion runs on the DOUBLED stage weights so that :func:`kkt_solve`
    applies the reference's ``Qp^-1`` (``J = 1/2 U'Qp U + Fp'U + 1/2 Mp``
    with ``Qp = 2 (Su'Qbar Su + Rbar)``); Qy/R/P are stored unscaled.  The
    carry entering the step that emits stage k's gains is the cost-to-go
    Hessian at x_{k+1}; the terminal weight rides its initial value."""
    H, ny, ns = C.shape[0], C.shape[1], A.shape[1]
    if P is None:
        P = torch.zeros((ns, ns), dtype=torch.float32, device=A.device)
    Qt = 2.0 * (C.mT @ Qy @ C)                           # (H, ns, ns)
    R2 = 2.0 * R
    Qt_prev = _zeros_first(Qt)
    Pc = Qt[-1] + 2.0 * P
    K, Hinv, W = [None] * H, [None] * H, [None] * H
    for k in range(H - 1, -1, -1):
        Ak, Bk = A[k], B[k]
        BtP = Bk.T @ Pc
        Hk = R2[k] + BtP @ Bk
        # inv_ex: no error check, so no host sync on the card; a singular
        # Hk gives non-finite gains, as jnp.linalg.inv does
        Hinv[k] = torch.linalg.inv_ex(Hk).inverse
        K[k] = Hinv[k] @ BtP @ Ak
        W[k] = Pc @ Bk @ Hinv[k]
        P_new = Qt_prev[k] + Ak.T @ Pc @ Ak - Ak.T @ Pc @ Bk @ K[k]
        Pc = 0.5 * (P_new + P_new.T)                      # keep symmetric
    return StagewiseFactor(A=A, Bm=B, E=E, C=C, Qy=Qy, R=R, P=P, r=r,
                           K=torch.stack(K), Hinv=torch.stack(Hinv),
                           W=torch.stack(W), H=H, ns=ns, nu=B.shape[2],
                           ny=ny)


def _affine_cumulative(Ms: torch.Tensor, cs: torch.Tensor):
    """Inclusive scan of affine maps ``x -> M_i x + c_i`` along axis 0:
    position ``i`` holds the composition of steps ``0..i`` (step 0 applied
    first).  ``Ms (H, n, n)``, ``cs (H, n, B)``.

    log2(H) rounds of batched matmuls (Hillis-Steele): round d composes each
    position with the one ``d`` before it, in the JAX package's order
    (``M = Mb Ma``, ``c = Mb ca + cb``, ``a`` the earlier map)."""
    M, c = Ms, cs
    d = 1
    while d < M.shape[0]:
        Ma, ca = M[:-d], c[:-d]
        Mb, cb = M[d:], c[d:]
        M, c = (torch.cat([M[:d], Mb @ Ma]),
                torch.cat([c[:d], Mb @ ca + cb]))
        d *= 2
    return M, c


def _carry_in(ccum: torch.Tensor) -> torch.Tensor:
    """Exclusive-from-inclusive for a zero initial carry: the carry each
    step SEES is the previous step's cumulative value."""
    return _zeros_first(ccum)


def kkt_solve(f: StagewiseFactor, v: torch.Tensor,
              pscan: bool = False) -> torch.Tensor:
    """``u = Qp^-1 v`` via the Riccati factor: minimize
    ``1/2 u'Qp u - v'u`` (dynamics from x0 = 0).  v, u: (H, nu, B).

    ``pscan=True`` replaces the two depth-H recursions with log-depth scans
    of the SAME affine maps (backward: ``p_j = A_j'(I - W_j B_j') p_{j+1} +
    A_j' W_j v_j``; forward: ``x_{k+1} = (A_k - B_k K_k) x_k + B_k kff_k``):
    identical math, another float32 association order."""
    if pscan:
        eye = torch.eye(f.ns, dtype=v.dtype, device=v.device)
        Mb = f.A.mT @ (eye - f.W @ f.Bm.mT)
        cb = f.A.mT @ (f.W @ v)
        _, crev = _affine_cumulative(Mb.flip(0), cb.flip(0))
        p_in = _carry_in(crev).flip(0)                # p_{j+1} at stage j
        kff = -(f.Hinv @ (f.Bm.mT @ p_in - v))
        _, cx = _affine_cumulative(f.A - f.Bm @ f.K, f.Bm @ kff)
        return -(f.K @ _carry_in(cx)) + kff           # x_k at stage k

    s, vs = f.stages, v.unbind(0)
    p = torch.zeros((f.ns, v.shape[-1]), dtype=v.dtype, device=v.device)
    kff = [None] * f.H
    for k in range(f.H - 1, -1, -1):
        t = torch.addmm(vs[k], s["Bt"][k], p, beta=-1)    # B'p - v, (nu, B)
        kff[k] = -(s["Hinv"][k] @ t)
        p = s["At"][k] @ torch.addmm(p, s["W"][k], t, alpha=-1)
    x = torch.zeros_like(p)
    us = []
    for k in range(f.H):
        u = torch.addmm(kff[k], s["K"][k], x, alpha=-1)   # -K x + kff
        x = torch.addmm(s["A"][k] @ x, s["Bm"][k], u)     # A x + B u
        us.append(u)
    return torch.stack(us)


def rollout_states(f: StagewiseFactor, x0: torch.Tensor, u: torch.Tensor,
                   dseq: Optional[torch.Tensor] = None,
                   pscan: bool = False) -> torch.Tensor:
    """States x_1..x_H from x0 ``(ns, B)`` under inputs u (H, nu, B):
    (H, ns, B)."""
    B_ = u.shape[-1]
    if dseq is None:
        dseq = torch.zeros((f.H, f.E.shape[-1], B_), dtype=u.dtype,
                           device=u.device)
    if pscan:
        Mcum, ccum = _affine_cumulative(f.A, f.Bm @ u + f.E @ dseq)
        return Mcum @ x0 + ccum
    s, us, ds = f.stages, u.unbind(0), dseq.unbind(0)
    x, xs = x0, []
    for k in range(f.H):
        x = torch.addmm(torch.addmm(s["A"][k] @ x, s["Bm"][k], us[k]),
                        s["E"][k], ds[k])                 # A x + B u + E d
        xs.append(x)
    return torch.stack(xs)


# ---------------------------------------------------------------------------
# Constraint operators: rows [up; lo; slew+; slew-], the layout of
# models/mpc.py input_constraints (N = 4*H*nu, reference PQP_CPU.c:941).

def _g_apply(U: torch.Tensor) -> torch.Tensor:
    """G U for U (H, nu, B) -> (4, H, nu, B)."""
    TU = U - _zeros_first(U)
    return torch.stack([U, -U, TU, -TU], dim=0)


def _gt_apply(Y: torch.Tensor) -> torch.Tensor:
    """G' Y for Y (4, H, nu, B) -> (H, nu, B)."""
    up, lo, sp, sn = Y[0], Y[1], Y[2], Y[3]
    d = sp - sn
    return up - lo + (d - _zeros_last(d))


@dataclasses.dataclass(frozen=True)
class StagewiseDual:
    """Matrix-free dual-geometry bundle: everything the PQP loop needs that
    depends only on (plant, costs, horizon); the JAX ``StagewiseDual``'s
    fields, as tensors.

    ``band_abs`` holds the banded-exact hybrid split: all 16 group-blocks of
    Qd are signed copies of four base blocks ``S = Qp^-1``, ``S T'``,
    ``T S``, ``T S T'`` (T = the slew first-difference), so the split only
    needs ``|base|`` matvecs; entries within ``band`` stages of the
    diagonal are stored exactly, the off-band tail keeps the rank-1 bound
    ``|Qd_ij| <= r_i r_j``.  ``band_abs[i, j, k, o]`` = the (nu, nu) block
    ``|base^{ij}|[stage k, stage k + o - band]`` for i, j in {box, slew},
    zero outside the horizon.

    Output rows ``y_min <= C x_k <= y_max`` extend the layout with two
    (H, ny) groups after the four input groups (``band_io``/``band_oi``/
    ``band_oo`` couple them; bounds are per instance, from the free
    response).  Slack-softened outputs (``soft_rho > 0``) add two more
    groups whose Qd couplings are the closed-form ``+1/(2 rho)`` terms of
    :func:`_with_soft`.  ``y_*``/``r_out``/... are ``None`` without output
    bounds."""

    factor: StagewiseFactor
    r_vec: torch.Tensor      # (4, H, nu)  Cauchy-Schwarz radii sqrt(Qd_ii)
    theta: torch.Tensor      # (4, H, nu)
    Kp: torch.Tensor         # (4, H, nu)
    band_abs: torch.Tensor   # (2, 2, H, 2*band+1, nu, nu)
    r_out: Optional[torch.Tensor] = None       # (H, ny) y-row radii
    theta_out: Optional[torch.Tensor] = None   # (2, H, ny)
    theta_soft: Optional[torch.Tensor] = None  # (2, H, ny)
    band_io: Optional[torch.Tensor] = None     # (2, H, 2b+1, nu, ny)
    band_oi: Optional[torch.Tensor] = None     # (2, H, 2b+1, ny, nu)
    band_oo: Optional[torch.Tensor] = None     # (H, 2b+1, ny, ny)
    y_max: Optional[torch.Tensor] = None       # (H, ny) +big where unbounded
    y_min: Optional[torch.Tensor] = None       # (H, ny)
    u_prev: Optional[torch.Tensor] = None      # (nu,) stage-0 slew anchor
    n_con: int = 0
    band: int = 0
    soft_rho: float = 0.0
    theta_floor: float = 5.0   # kept so relinearize can reuse it

    @property
    def has_y(self) -> bool:
        return self.r_out is not None

    @property
    def has_soft(self) -> bool:
        return self.soft_rho > 0.0


def _flat(Y: torch.Tensor) -> torch.Tensor:
    """(G, H, width, B) -> (G*H*width, B)."""
    s = Y.shape
    return Y.reshape(s[0] * s[1] * s[2], s[3])


def _unflat(Y: torch.Tensor, H: int, nu: int) -> torch.Tensor:
    return Y.reshape(4, H, nu, Y.shape[-1])


def _g_apply_all(dual: StagewiseDual, U: torch.Tensor,
                 pscan: bool = False) -> torch.Tensor:
    """Full constraint apply ``G U`` -> flat (n_con, B): the four input
    groups plus, when present, the output groups ``+/- C x_k`` via the
    zero-state rollout."""
    rows = _flat(_g_apply(U))
    if not dual.has_y:
        return rows
    f = dual.factor
    xs = rollout_states(f, torch.zeros((f.ns, U.shape[-1]), dtype=U.dtype,
                                       device=U.device), U, None,
                        pscan=pscan)
    yv = f.C @ xs
    return torch.cat([rows, _flat(torch.stack([yv, -yv]))], dim=0)


def _gt_apply_all(dual: StagewiseDual, Yf: torch.Tensor,
                  pscan: bool = False) -> torch.Tensor:
    """u-space adjoint ``G_u' Y`` for flat Y (n_con, B) -> (H, nu, B).
    Slack rows (soft outputs) have no u-columns and are ignored."""
    f = dual.factor
    H, nu = f.H, f.nu
    M4 = 4 * H * nu
    v = _gt_apply(_unflat(Yf[:M4], H, nu))
    if dual.has_y:
        Hny = H * f.ny
        Yo = Yf[M4:M4 + 2 * Hny].reshape(2, H, f.ny, Yf.shape[-1])
        v = v + _su_adjoint(f, Yo[0] - Yo[1], pscan=pscan)
    return v


def _soft_parts(dual: StagewiseDual, Yf: torch.Tensor):
    """``(a, b) = ((Y_y+ + Y_s+)/(2 rho), (Y_y- + Y_s-)/(2 rho))``: the
    recovered slacks s+/s-, and the slack-borne rows of Qd Y."""
    f = dual.factor
    Hny = f.H * f.ny
    M4 = 4 * f.H * f.nu
    inv2rho = 1.0 / (2.0 * dual.soft_rho)
    y4 = Yf[M4:M4 + Hny]
    y5 = Yf[M4 + Hny:M4 + 2 * Hny]
    y6 = Yf[M4 + 2 * Hny:M4 + 3 * Hny]
    y7 = Yf[M4 + 3 * Hny:]
    return (y4 + y6) * inv2rho, (y5 + y7) * inv2rho


def _with_soft(dual: StagewiseDual, base: torch.Tensor, Yf: torch.Tensor):
    """Extend a Qd Y (or |Qd|-bound) apply with the exact slack-borne
    terms: ``base`` covers the u-borne rows [input; y+; y-]; the slack
    couplings add ``a``/``b`` to the y rows and ARE the s rows."""
    if not dual.has_soft:
        return base
    f = dual.factor
    Hny = f.H * f.ny
    M4 = 4 * f.H * f.nu
    a, b = _soft_parts(dual, Yf)
    return torch.cat([base[:M4], base[M4:M4 + Hny] + a, base[M4 + Hny:] + b,
                      a, b], dim=0)


def _auto_band(absK: np.ndarray, rvec2: np.ndarray, H: int,
               widths: list, slack: float = 1.25) -> int:
    """Smallest band b (in stages) such that the hybrid bound's rowsums
    exceed the exact ``|Qd|`` rowsums by at most ``slack`` (the JAX
    package's NumPy rule, copied).  ``absK``: the |base-block| super-matrix
    (one row block of width ``H*w`` per entry of ``widths``); ``rvec2``:
    radii in the same row order."""
    stage = np.concatenate([np.repeat(np.arange(H), w) for w in widths])
    dist = np.abs(stage[:, None] - stage[None, :])
    rr = rvec2[:, None] * rvec2[None, :]
    rs_exact = absK.sum(axis=1) + 1e-30
    for b in [0, 1, 2, 4, 8, 16, 32, 64, 128, 256]:
        if b >= H - 1:
            break
        inband = dist <= b
        rs_b = np.where(inband, absK, rr).sum(axis=1)
        if float((rs_b / rs_exact).max()) <= slack:
            return b
    return H - 1


def _extract_band(K: torch.Tensor, H: int, ru: int, b: int,
                  rv: int | None = None) -> torch.Tensor:
    """(H*ru, H*rv) dense base block -> (H, 2b+1, ru, rv) stage band, zero
    outside the horizon: ``out[k, o] = K[stage k, stage k+o-b]``."""
    rv = ru if rv is None else rv
    Kb = K.reshape(H, ru, H, rv).permute(0, 2, 1, 3)     # (H, H, ru, rv)
    Kp_ = F.pad(Kb, (0, 0, 0, 0, b, b))                  # (H, H+2b, ..)
    win = Kp_.unfold(1, 2 * b + 1, 1)                    # (H, H, ru, rv, w)
    rows = torch.arange(H, device=K.device)
    return win[rows, rows].permute(0, 3, 1, 2)           # (H, 2b+1, ..)


def _su_adjoint(f: StagewiseFactor, e: torch.Tensor, pscan: bool = False,
                g_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Su' C' e`` for per-stage output seeds ``e (H, ny, B)``: the adjoint
    of the zero-state rollout (slot j gets ``B_j' mu_j`` with
    ``mu_j = C_j' e_j + A_{j+1}' mu_{j+1}``), as one backward recursion or
    its log-depth scan.  ``g_last (ns, B)`` adds a state-space costate seed
    at the last stage (the terminal cost's gradient ``2 P x_H``)."""
    if pscan:
        cs = (f.C.mT @ e).flip(0)
        if g_last is not None:
            cs = torch.cat([cs[:1] + g_last, cs[1:]])  # slot 0 = stage H-1
        _, mu = _affine_cumulative(_a_shift(f).flip(0).mT, cs)
        return (f.Bm.flip(0).mT @ mu).flip(0)

    s, es = f.stages, e.unbind(0)
    out = [None] * f.H
    # the last slot has nothing downstream (Ash[H-1] = 0)
    mu = s["Ct"][-1] @ es[-1]
    if g_last is not None:
        mu = mu + g_last
    out[-1] = s["Bt"][-1] @ mu
    for k in range(f.H - 2, -1, -1):
        mu = torch.addmm(s["Ct"][k] @ es[k], s["At"][k + 1], mu)
        out[k] = s["Bt"][k] @ mu
    return torch.stack(out)                               # (H, nu, B)


def _absqd_apply(dual: StagewiseDual, m: torch.Tensor, s: torch.Tensor,
                 w: Optional[torch.Tensor] = None):
    """Hybrid ``|Qd|``-bound matvec: exact banded ``|base|`` blocks plus the
    rank-1 Cauchy-Schwarz tail off-band.  ``m = Y_up + Y_lo``,
    ``s = Y_s+ + Y_s-`` (each (H, nu, B)), ``w = Y_y+ + Y_y-`` ((H, ny, B),
    output rows only).  Returns ``(D_box, D_slew, D_y)`` (``D_y`` None
    without output rows); negated groups have identical row magnitudes."""
    b = dual.band
    wd = 2 * b + 1
    r_box, r_slew = dual.r_vec[0], dual.r_vec[2]          # (H, nu)
    r2 = torch.stack([r_box, r_slew])                     # (2, H, nu)
    X2 = torch.stack([m, s])                              # (2, H, nu, B)
    # (2, H, wd, nu, B): the stage window k-b..k+b of each stage k
    Xwin = F.pad(X2, (0, 0, 0, 0, b, b)).unfold(1, wd, 1).permute(
        0, 1, 4, 2, 3)
    bandY = torch.einsum("ijhwuv,jhwvb->ihub", dual.band_abs, Xwin)
    # rank-1 tail: per-stage weighted sums; the off-band total is the grand
    # sum minus each row's in-band window
    u = torch.einsum("jhv,jhvb->jhb", r2, X2)             # (2, H, B)
    D_y = None
    if dual.has_y:
        Wwin = F.pad(w, (0, 0, 0, 0, b, b)).unfold(0, wd, 1).permute(
            0, 3, 1, 2)                                   # (H, wd, ny, B)
        bandY = bandY + torch.einsum("ihwuv,hwvb->ihub", dual.band_io, Wwin)
        D_y = (torch.einsum("jhwuv,jhwvb->hub", dual.band_oi, Xwin)
               + torch.einsum("hwuv,hwvb->hub", dual.band_oo, Wwin))
        u_y = torch.einsum("hv,hvb->hb", dual.r_out, w)   # (H, B)
        u = torch.cat([u, u_y[None]], dim=0)              # (3, H, B)
    upad = F.pad(u, (0, 0, b, b))
    off = (u.sum(dim=(0, 1))[None]
           - upad.unfold(1, wd, 1).sum(dim=(0, 3)))       # (H, B)
    off = off[:, None, :]                                 # (H, 1, B)
    if D_y is not None:
        D_y = D_y + dual.r_out[..., None] * off
    return (bandY[0] + r_box[..., None] * off,
            bandY[1] + r_slew[..., None] * off, D_y)


def _dual_blocks(f: StagewiseFactor, has_y: bool) -> dict:
    """Radii and the dense ``|Qd|`` base blocks, on the factor's device,
    through the sequential recursions (each carries O(H) columns here).

    One batched :func:`kkt_solve` over all distinct constraint directions
    gives ``Z = Qp^-1 G'``; the radii are its diagonal inner products and
    the base blocks (``S = Qp^-1``, ``S T'``, ``T S T'``, plus the y-row
    couplings when present) are reshapes and differences of the same Z."""
    H, nu = f.H, f.nu
    M = H * nu
    dev = f.A.device
    eye = torch.eye(M, dtype=torch.float32, device=dev).reshape(H, nu, M)
    # slew ROW k's direction is e_k - e_{k-1} = T' e_k
    G_all = torch.cat([eye, eye - _zeros_last(eye)], dim=-1)   # (H, nu, 2M)
    Z = kkt_solve(f, G_all)
    flat_g = G_all.reshape(M, 2 * M)
    flat_z = Z.reshape(M, 2 * M)
    r2 = (flat_g * flat_z).sum(dim=0)                          # g'Qp^-1 g
    r_box = torch.sqrt(torch.clamp(r2[:M], min=0.0)).reshape(H, nu)
    r_slew = torch.sqrt(torch.clamp(r2[M:], min=0.0)).reshape(H, nu)
    # symmetrize against recursion-order float asymmetry so |S| is exactly
    # symmetric
    S = flat_z[:, :M]
    S = 0.5 * (S + S.T)
    ST = flat_z[:, M:]
    STr = ST.reshape(H, nu, M)
    TST = (STr - _zeros_first(STr)).reshape(M, M)
    TST = 0.5 * (TST + TST.T)
    blk = dict(r_box=r_box, r_slew=r_slew, S=S, ST=ST, TST=TST)

    if has_y:
        ny = f.ny
        Hny = H * ny
        # y-row directions g_{k,i} = Su'C'e_{k,i}: the adjoint of unit
        # output seeds, then one batched kkt_solve
        Eo = torch.eye(Hny, dtype=torch.float32, device=dev).reshape(
            H, ny, Hny)
        Go = _su_adjoint(f, Eo)                                # (H, nu, Hny)
        Zo = kkt_solve(f, Go)
        Zo_flat = Zo.reshape(M, Hny)                           # Qp^-1 Gy'
        # out x out base: Gy Qp^-1 Gy' = C * rollout(0, Zo) per stage
        xs = rollout_states(f, torch.zeros((f.ns, Hny), dtype=torch.float32,
                                           device=dev), Zo)
        OO = (f.C @ xs).reshape(Hny, Hny)
        OO = 0.5 * (OO + OO.T)
        r_out = torch.sqrt(torch.clamp(torch.diagonal(OO), min=0.0)).reshape(
            H, ny)
        Zr = Zo_flat.reshape(H, nu, Hny)
        TZo = (Zr - _zeros_first(Zr)).reshape(M, Hny)
        blk.update(Zo_flat=Zo_flat, TZo=TZo, OO=OO, r_out=r_out)
    return blk


def _dual_assemble(f: StagewiseFactor, blk: dict, band: int, has_y: bool,
                   soft_rho: float, y_min, y_max, umax, umin, dmax,
                   uprev, theta_floor: float) -> StagewiseDual:
    """Band extraction, bounds and theta from the blocks: a pure tensor
    function of them, so :func:`relinearize` stays on the device."""
    H, nu, ny = f.H, f.nu, f.ny
    M = H * nu
    dev = f.A.device
    r_box, r_slew = blk["r_box"], blk["r_slew"]
    r_vec = torch.stack([r_box, r_box, r_slew, r_slew], dim=0)
    S, ST, TST = blk["S"], blk["ST"], blk["TST"]
    band_abs = torch.stack([
        torch.stack([_extract_band(S.abs(), H, nu, band),
                     _extract_band(ST.abs(), H, nu, band)]),
        torch.stack([_extract_band(ST.T.abs(), H, nu, band),
                     _extract_band(TST.abs(), H, nu, band)])])
    # ^ (2, 2, H, 2b+1, nu, nu)

    r_out = theta_out = band_io = band_oi = band_oo = None
    if has_y:
        r_out = blk["r_out"]
        Zo_flat, TZo, OO = blk["Zo_flat"], blk["TZo"], blk["OO"]
        band_io = torch.stack(
            [_extract_band(Zo_flat.abs(), H, nu, band, ny),
             _extract_band(TZo.abs(), H, nu, band, ny)])
        band_oi = torch.stack(
            [_extract_band(Zo_flat.T.abs(), H, ny, band, nu),
             _extract_band(TZo.T.abs(), H, ny, band, nu)])
        band_oo = _extract_band(OO.abs(), H, ny, band, ny)
        big = 1e6   # one-sided bounds stay inert
        # a constant (ny,) bound broadcasts; a (H, ny) schedule (e.g.
        # robust_spec's tube tightening) passes through — bound VALUES touch
        # only the per-instance Kp_y rows in _forcing, never the geometry
        y_max = (torch.full((H, ny), big, dtype=torch.float32, device=dev)
                 if y_max is None else _f32(y_max, dev).expand(H, ny).clone())
        y_min = (torch.full((H, ny), -big, dtype=torch.float32, device=dev)
                 if y_min is None else _f32(y_min, dev).expand(H, ny).clone())
    else:
        y_max = y_min = None

    umax = _f32(umax, dev).expand(H, nu)
    umin = _f32(umin, dev).expand(H, nu)
    dmax = _f32(dmax, dev).expand(H, nu)
    uprev = (torch.zeros(nu, dtype=torch.float32, device=dev)
             if uprev is None else _f32(uprev, dev))
    e1u = torch.cat([uprev[None], torch.zeros((H - 1, nu),
                                              dtype=torch.float32,
                                              device=dev)])
    Kp = torch.stack([umax, -umin, dmax + e1u, dmax - e1u], dim=0)

    n_con = 4 * M + (2 * H * ny if has_y else 0) \
        + (2 * H * ny if soft_rho else 0)
    sd = StagewiseDual(factor=f, r_vec=r_vec,
                       theta=torch.zeros_like(r_vec), Kp=Kp,
                       band_abs=band_abs, r_out=r_out,
                       theta_out=theta_out, band_io=band_io,
                       band_oi=band_oi, band_oo=band_oo,
                       y_max=y_max, y_min=y_min, u_prev=uprev,
                       n_con=n_con, band=band, soft_rho=soft_rho,
                       theta_floor=theta_floor)

    # theta_i = max(rowsum(N)_i, floor) with N = (D - Qd)/2 the hybrid
    # split's negative part; Qd1 and D1 both carry the exact slack terms
    ones = torch.ones((n_con, 1), dtype=torch.float32, device=dev)
    qd1 = _with_soft(sd, _g_apply_all(
        sd, kkt_solve(f, _gt_apply_all(sd, ones))), ones)[:, 0]
    two_u = torch.full((H, nu, 1), 2.0, dtype=torch.float32, device=dev)
    two_y = (torch.full((H, ny, 1), 2.0, dtype=torch.float32, device=dev)
             if has_y else None)
    D1_box, D1_slew, D1_y = _absqd_apply(sd, two_u, two_u, two_y)
    D1 = _flat(torch.stack([D1_box, D1_box, D1_slew, D1_slew]))
    if has_y:
        D1 = torch.cat([D1, _flat(torch.stack([D1_y, D1_y]))])
    D1 = _with_soft(sd, D1, ones)[:, 0]
    th_all = torch.clamp(0.5 * (D1 - qd1), min=theta_floor)
    theta = th_all[:4 * M].reshape(4, H, nu)
    theta_soft = None
    if has_y:
        theta_out = th_all[4 * M:4 * M + 2 * H * ny].reshape(2, H, ny)
    if soft_rho:
        theta_soft = th_all[4 * M + 2 * H * ny:].reshape(2, H, ny)
    return dataclasses.replace(sd, theta=theta, theta_out=theta_out,
                               theta_soft=theta_soft)


def stagewise_dual(spec, theta_floor: float = 5.0,
                   band: Optional[int] = None,
                   device=None) -> StagewiseDual:
    """Build the matrix-free dual geometry of ``spec`` on ``device``
    (default CUDA; without a card that raises — pass ``device="cpu"``):
    Riccati factor, the radii ``r_i = sqrt((G Qp^-1 G')_ii)``, the
    banded-exact ``|Qd|`` blocks of the hybrid split and theta.

    ``band`` — stage half-width of the exact band; ``None`` picks the
    smallest width whose Cauchy-Schwarz tail inflates the split's rowsums
    by <= 25% (:func:`_auto_band`, on the host); ``H - 1`` makes the split
    exact.  Output bounds (constant ``(ny,)`` or per-stage ``(H, ny)``) and
    ``soft_penalty`` are supported; move blocking is not (condensed only).
    The build runs the sequential recursions: it pushes O(H) columns
    through each, so it is fed already (the JAX package measured the
    sequential form faster at H=512 on the CPU)."""
    if getattr(spec, "moves", None) is not None:
        raise NotImplementedError(
            "move blocking is condensed-only (models/mpc.py): the "
            "stage-wise path is already O(H) per iteration")
    has_y = spec.y_min is not None or spec.y_max is not None
    soft_rho = float(spec.soft_penalty or 0.0) if has_y else 0.0
    f = riccati_factor(spec, device)
    H, nu = f.H, f.nu

    blk = _dual_blocks(f, has_y)
    if band is None:
        # the width is structural: read the dense blocks back and pick it
        # on the host; relinearize reuses it
        host = {k: v.detach().cpu().numpy() for k, v in blk.items()}
        rvec2 = np.concatenate(
            [host["r_box"].reshape(-1), host["r_slew"].reshape(-1)]
            + ([host["r_out"].reshape(-1)] if has_y else []))
        S, ST, TST = host["S"], host["ST"], host["TST"]
        if has_y:
            Zo_flat, TZo, OO = host["Zo_flat"], host["TZo"], host["OO"]
            absK = np.abs(np.block([[S, ST, Zo_flat],
                                    [ST.T, TST, TZo],
                                    [Zo_flat.T, TZo.T, OO]]))
            widths = [nu, nu, f.ny]
        else:
            absK = np.abs(np.block([[S, ST], [ST.T, TST]]))
            widths = [nu, nu]
        band = _auto_band(absK, rvec2, H, widths)
    band = int(min(max(band, 0), H - 1))
    return _dual_assemble(f, blk, band, has_y, soft_rho,
                          spec.y_min, spec.y_max, spec.u_max, spec.u_min,
                          spec.du_max, spec.u_prev, theta_floor)


def relinearize(sd: StagewiseDual, A: torch.Tensor, B: torch.Tensor,
                E: Optional[torch.Tensor] = None,
                C: Optional[torch.Tensor] = None,
                r: Optional[torch.Tensor] = None,
                u_prev: Optional[torch.Tensor] = None) -> StagewiseDual:
    """Rebuild the dual geometry for NEW per-stage dynamics ``A, B
    (H, ns, .)`` under the SAME static structure (horizon, band width,
    constraint groups): a pure tensor function of its inputs, with no host
    round trip, for successive-linearization loops that refresh the
    geometry every control step.

    ``E``/``C``/``r`` default to the previous factor's; ``u_prev`` moves the
    stage-0 slew bounds.  Cost weights, bounds, theta floor and the band
    width are inherited from ``sd``."""
    f0 = sd.factor
    dev = f0.A.device
    A = _f32(A, dev)
    B = _f32(B, dev)
    E = f0.E if E is None else _f32(E, dev)
    C = f0.C if C is None else _f32(C, dev)
    r = f0.r if r is None else _f32(r, dev)
    if r.dim() == 1:
        r = r.expand(f0.H, f0.ny)
    f = _riccati_core(A, B, E, C, f0.Qy, f0.R, r, f0.P)
    blk = _dual_blocks(f, sd.has_y)
    # the bound vectors from the stacked Kp rows [umax, -umin, dmax + e1
    # uprev, dmax - e1 uprev]; u_prev from the stored field (the row
    # difference is inf - inf = NaN when du_max is +inf)
    umax, umin = sd.Kp[0], -sd.Kp[1]
    dmax = 0.5 * (sd.Kp[2] + sd.Kp[3])
    uprev = sd.u_prev if u_prev is None else _f32(u_prev, dev)
    return _dual_assemble(f, blk, sd.band, sd.has_y, sd.soft_rho,
                          sd.y_min, sd.y_max, umax, umin, dmax, uprev,
                          sd.theta_floor)


def _forcing(dual: StagewiseDual, x0, dseq, pscan: bool = False):
    """Per-instance forcing: Fp (H, nu, B), Mp (B,), Fd (N, B), Md (B,),
    QiF = Qp^-1 Fp and the flat constraint bounds kp_full (N, B).

    ``Fp_k = B' mu_{k+1}`` over the free response xbar (inputs = 0),
    ``Mp = sum_j |C xbar_j - r|^2_Qy`` (doubled weights, the reference's
    convention), ``Fd = Kp + G Qp^-1 Fp`` and ``Md = Fp'Qp^-1 Fp - Mp``
    (computeFd/computeMd, PQP_CPU.c:456-479); output rows' bounds
    ``[y_max - C xbar; C xbar - y_min]`` ride the same free response."""
    f = dual.factor
    B_ = x0.shape[-1]
    zeros_u = torch.zeros((f.H, f.nu, B_), dtype=torch.float32,
                          device=x0.device)
    xbar = rollout_states(f, x0, zeros_u, dseq, pscan=pscan)   # (H, ns, B)
    ybar = f.C @ xbar                                          # (H, ny, B)
    e = ybar - f.r[:, :, None]
    Qe = 2.0 * (f.Qy @ e)
    Mp = (e * Qe).sum(dim=(0, 1))                              # (B,)
    Pxh = 2.0 * (f.P @ xbar[-1])                               # (ns, B)
    Mp = Mp + (xbar[-1] * Pxh).sum(dim=0)

    Fp = _su_adjoint(f, Qe, pscan=pscan, g_last=Pxh)           # (H, nu, B)
    QiF = kkt_solve(f, Fp, pscan=pscan)
    Md = (Fp * QiF).sum(dim=(0, 1)) - Mp                       # (B,)
    kp_full = _flat(dual.Kp[..., None]).expand(4 * f.H * f.nu, B_)
    if dual.has_y:
        kp_y = torch.stack([dual.y_max[:, :, None] - ybar,
                            ybar - dual.y_min[:, :, None]])
        kp_full = torch.cat([kp_full, _flat(kp_y)], dim=0)
    GQiF = _g_apply_all(dual, QiF, pscan=pscan)
    if dual.has_soft:
        # slack rows: bounds 0, no u/forcing coupling
        zs = torch.zeros((2 * f.H * f.ny, B_), dtype=torch.float32,
                         device=x0.device)
        kp_full = torch.cat([kp_full, zs], dim=0)
        GQiF = torch.cat([GQiF, zs], dim=0)
    Fd = kp_full + GQiF                                        # (N, B)
    return Fp, Mp, Fd, Md, QiF, kp_full


def solve_stagewise(dual: StagewiseDual, x0: torch.Tensor,
                    dseq: Optional[torch.Tensor] = None,
                    Y0: Optional[torch.Tensor] = None,
                    cfg: SolverConfig = SolverConfig(),
                    pscan: Optional[bool] = None,
                    retry_cold: bool = False) -> SolveResult:
    """Run the PQP dual iteration matrix-free over a batch of initial
    states.  ``x0``: (ns,) or (ns, B); ``dseq``: optional (H, nd, B); both
    on the dual's device.  Returns a :class:`SolveResult` with
    ``U (H*nu, B)``, ``Y (N, B)``.

    Semantics of :func:`~pqp_for_mpc_tpu_torch.solver.solve_batched` (the
    four-part test, masked lanes, divergence freeze, warm start, and
    ``retry_cold`` through
    :func:`~pqp_for_mpc_tpu_torch.solver.retry_cold_solve`); only the linear
    algebra is implicit.  ``pscan`` selects the log-depth recursions;
    ``None`` = on for H >= 64."""
    f = dual.factor
    H, nu = f.H, f.nu
    if pscan is None:
        pscan = H >= 64
    x0 = x0 if x0.dim() == 2 else x0[:, None]
    B = x0.shape[1]
    N = dual.n_con
    dev = x0.device

    Fp, Mp, Fd, Md, QiF, kp_full = _forcing(dual, x0, dseq, pscan=pscan)
    Fdp = torch.clamp(Fd, min=0.0)
    Fdn = torch.clamp(-Fd, min=0.0)
    M4 = 4 * H * nu
    th_col = _flat(dual.theta[..., None])
    if dual.has_y:
        th_col = torch.cat([th_col, _flat(dual.theta_out[..., None])])
    if dual.has_soft:
        th_col = torch.cat([th_col, _flat(dual.theta_soft[..., None])])
    kp_slack = kp_full + certificate_slack(kp_full, cfg.erc, cfg.eac)

    def kkt_gty(Yf):
        """Z = Qp^-1 G' Y, the shared inner solve: (N, B) -> (H, nu, B)."""
        return kkt_solve(f, _gt_apply_all(dual, Yf, pscan=pscan),
                         pscan=pscan)

    def qd_apply(Yf):
        """Qd Y, flat (N, B) -> (N, B)."""
        return _with_soft(dual, _g_apply_all(dual, kkt_gty(Yf), pscan=pscan),
                          Yf)

    def update(Yf):
        """Multiplicative update under the banded-exact hybrid split:
        ``P Y = (D Y + Qd Y)/2 + theta Y``, ``N Y = (D Y - Qd Y)/2 +
        theta Y``; D Y depends on Y only through the sums of the signed
        group pairs."""
        qdY = qd_apply(Yf)
        Y4 = _unflat(Yf[:M4], H, nu)
        Yw = None
        if dual.has_y:
            Yo = Yf[M4:M4 + 2 * H * f.ny].reshape(2, H, f.ny, -1)
            Yw = Yo[0] + Yo[1]
        D_box, D_slew, D_y = _absqd_apply(dual, Y4[0] + Y4[1],
                                          Y4[2] + Y4[3], Yw)
        DY = _flat(torch.stack([D_box, D_box, D_slew, D_slew]))
        if dual.has_y:
            DY = torch.cat([DY, _flat(torch.stack([D_y, D_y]))])
        DY = _with_soft(dual, DY, Yf)
        # num >= 0 in exact arithmetic; clamp the eps-level negatives of
        # the banded float difference that would flip Y's sign
        num = torch.clamp(0.5 * (DY - qdY) + th_col * Yf + Fdn, min=0.0)
        den = 0.5 * (DY + qdY) + th_col * Yf + Fdp
        if cfg.den_eps:
            den = torch.clamp(den, min=cfg.den_eps)
        return (num / den) * Yf

    def accel(Yf, Yprev, tm, done):
        """Momentum-extrapolated projected-gradient step with exact line
        search and gradient-based adaptive restart (O'Donoghue & Candes
        2015), the JAX package's stage-wise accel."""
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tm * tm))
        beta = ((tm - 1.0) / tn)[None, :]
        Z = torch.clamp(Yf + beta * (Yf - Yprev), min=0.0)
        grad = qd_apply(Z) + Fd
        p = torch.where((Z > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * qd_apply(p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        Yn = torch.clamp(Z + alpha[None, :] * p, min=0.0)
        restart = ((Z - Yn) * (Yn - Yf)).sum(dim=0) > 0.0
        Yn = torch.where(done[None, :], Yf, Yn)
        return (Yn, torch.where(done[None, :], Yprev, Yf),
                torch.where(done, tm, torch.where(restart,
                                                  torch.ones_like(tn), tn)))

    def check(Yf):
        """The four-part test.  Recovery ``U = -(QiF + Z)`` with
        ``Z = Qp^-1 G'Y`` solved apart from the forcing, sharing QiF with
        the Fd build, so ``G U - Kp = -(Fd + Qd Y)`` telescopes and the
        forcing's float32 noise cancels from the feasibility residual; one
        inner solve Z serves the recovery and ``Qd Y``."""
        Z = kkt_gty(Yf)
        U = -(QiF + Z)
        qdY = _with_soft(dual, _g_apply_all(dual, Z, pscan=pscan), Yf)
        GU = _g_apply_all(dual, U, pscan=pscan)
        s_pen = 0.0
        if dual.has_soft:
            sa, sb = _soft_parts(dual, Yf)
            Hny = H * f.ny
            GU = torch.cat([GU[:M4], GU[M4:M4 + Hny] - sa,
                            GU[M4 + Hny:] - sb, -sa, -sb], dim=0)
            s_pen = dual.soft_rho * ((sa * sa).sum(dim=0)
                                     + (sb * sb).sum(dim=0))
        feas = (GU <= kp_slack).all(dim=0)
        Jd = (0.5 * (Yf * qdY).sum(dim=0) + (Fd * Yf).sum(dim=0) + 0.5 * Md)
        # 1/2 U'Qp U from the stage-cost rollout of U from x0 = 0
        xs = rollout_states(f, torch.zeros_like(x0), U, None, pscan=pscan)
        ysU = f.C @ xs
        quad = (ysU * (f.Qy @ ysU)).sum(dim=(0, 1))
        quad = quad + (U * (f.R @ U)).sum(dim=(0, 1))
        quad = quad + (xs[-1] * (f.P @ xs[-1])).sum(dim=0)
        Jp = quad + s_pen + (Fp * U).sum(dim=(0, 1)) + 0.5 * Mp
        gap = ((Yf * (qdY + Fd)).sum(dim=0)
               if cfg.gap_from_complementarity else None)
        return ~termination_fail(feas, Jp, Jd, cfg, gap), U, feas, Jp, Jd

    warm = Y0 is not None
    Y0, _ = lane_batch(dual, Y0, cfg, x0=x0)
    k = cfg.check_every

    def masked_updates(Y, done, n):
        for _ in range(n):
            Y = torch.where(done[None, :], Y, update(Y))
        return Y

    def run_updates(Y, Yprev, tm, done):
        if not cfg.accel_every:
            return masked_updates(Y, done, k), Yprev, tm
        for _ in range(k // cfg.accel_every):
            Y = masked_updates(Y, done, cfg.accel_every)
            Y, Yprev, tm = accel(Y, Yprev, tm, done)
        return Y, Yprev, tm

    def solve_once(Y0f):
        Y, Yprev = Y0f, Y0f
        tm = torch.ones(B, dtype=torch.float32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        div = torch.zeros(B, dtype=torch.bool, device=dev)
        h = 1
        # one host sync per check: the JAX package's while-loop condition
        while h <= cfg.max_iters and not tracing.sync(done.all(),
                                                       "stagewise"):
            ok = check(Y)[0]
            bad = ~torch.isfinite(Y).all(dim=0) & ~done
            newly = ok & ~done & ~bad
            iters = torch.where(newly | bad, h, iters)
            done = done | ok | bad
            div = div | bad
            Y, Yprev, tm = run_updates(Y, Yprev, tm, done)
            h += k

        ok, U, feas, Jp, Jd = check(Y)
        bad = ~torch.isfinite(Y).all(dim=0)
        newly_bad = bad & ~done
        div = div | newly_bad
        newly = ok & ~done & ~bad
        iters = torch.where(newly | newly_bad, h, iters)
        done = done | ok | bad
        iters = torch.where(done, iters, h).to(torch.int32)
        return SolveResult(U=U.reshape(H * nu, B), Y=Y, iters=iters,
                           converged=done & ~div, feasible=feas,
                           Jp=Jp, Jd=Jd, diverged=div)

    if retry_cold and warm:
        return retry_cold_solve(solve_once, Y0, cold_start(N, B, cfg, dev))
    return solve_once(Y0)
