# A frozen copy of reference/pqp.py as it stood when every lane shared one
# geometry; test_pb_lanes.py holds the generalised reference to it, bit for
# bit, on the shared cells.  Do not edit.
"""The plain reference of a PQP solve, in plain PyTorch at a chosen dtype.

It imports nothing of the program.  For a batch of QPs that share ``Qp``
and ``Gp`` and differ in ``Fp`` and ``Kp`` (lanes last)

    min_U 1/2 U'Qp U + Fp'U + 1/2 Mp   s.t.   Gp U <= Kp

it dualizes (``Qd = Gp Qp^-1 Gp'``, ``Fd = Gp Qp^-1 Fp + Kp``), runs the
multiplicative update ``Y <- Y ((Qd^- + theta) Y + Fd^-) / ((Qd^+ + theta) Y
+ Fd^+)`` from ``Y = y0`` with the safeguarded projected-gradient step every
``accel_every`` updates, checks every ``check_every`` updates, and recovers
``U = -Qp^-1 (Fp + Gp'Y)``.

Two uses:

* :func:`exact` (float64): the reference answer.  The iteration only finds
  the active set; at checkpoints, and once a lane passes the certificate,
  its candidate set
  ``{i : Y_i > (Qd Y + Fd)_i}``, mended by a few active-set steps, is
  solved exactly (``Qd_AA Y_A = -Fd_A``) and kept once the KKT conditions
  hold (``Y >= 0``, ``g = Qd Y + Fd >= 0``,
  which is ``Gp U <= Kp``, and ``g_A = 0``), which for a strictly convex QP
  makes ``U`` the optimum to rounding.  A lane that never verifies keeps
  its iterate and is counted as unverified.
* :func:`certified` (any dtype): the same algorithm stopped by the
  configuration's own certificate, as the program stops; at ``bfloat16``
  it is the control that the comparison has to reject.

The certificate covers the settings the configurations use: the
complementarity gap (``gap_from_complementarity``), either feasibility
form, and no strict weak-duality test.
"""

from __future__ import annotations

import numpy as np
import torch


def inverse(Qp: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``Qp^-1`` taken in float64 and rounded to ``dtype`` (PyTorch has no
    inverse below float32)."""
    return torch.linalg.inv(Qp.double()).to(dtype)


class Dual:
    """The dual of a lane batch at one dtype, with the update's splits."""

    def __init__(self, Qp, Gp, Fp, Kp, Mp, theta_floor: float, dtype):
        cast = lambda a: a.to(dtype)
        self.dtype = dtype
        self.Qp, self.Gp, self.Fp = cast(Qp), cast(Gp), cast(Fp)
        self.Kp = cast(Kp)
        self.Mp = cast(Mp)
        self.Qpi = inverse(Qp, dtype)
        GQi = self.Gp @ self.Qpi
        self.Qd = GQi @ self.Gp.T
        self.Fd = GQi @ self.Fp + self.Kp
        self.Md = (self.Fp * (self.Qpi @ self.Fp)).sum(0) - self.Mp
        neg = torch.clamp(-self.Qd, min=0.0)
        theta = torch.clamp(neg.sum(1), min=theta_floor)
        eye = torch.diag(theta)
        self.Qdn = neg + eye
        self.Qdp = torch.clamp(self.Qd, min=0.0) + eye
        self.Fdn = torch.clamp(-self.Fd, min=0.0)
        self.Fdp = torch.clamp(self.Fd, min=0.0)
        self.np = None           # (Qd, Fd, Gp) in NumPy, for the KKT finish

    def recover(self, Y):
        return -(self.Qpi @ (self.Gp.T @ Y + self.Fp))

    def update(self, Y, den_eps: float):
        den = torch.clamp(self.Qdp @ Y + self.Fdp, min=den_eps)
        return Y * ((self.Qdn @ Y + self.Fdn) / den)

    def accel(self, Y, frozen):
        """One projected steepest-descent step with exact line search on
        ``1/2 Y'Qd Y + Fd'Y`` over ``Y >= 0``, kept per lane where it does
        not raise the objective."""
        grad = self.Qd @ Y + self.Fd
        p = torch.where((Y > 0) | (grad < 0), -grad, torch.zeros_like(grad))
        pQp = (p * (self.Qd @ p)).sum(0)
        alpha = torch.where(pQp > 0, (p * p).sum(0) / torch.clamp(
            pQp, min=1e-30), torch.zeros_like(pQp))
        Yn = torch.clamp(Y + alpha * p, min=0.0)
        f = lambda Z: (0.5 * (Z * (self.Qd @ Z)).sum(0)
                       + (self.Fd * Z).sum(0))
        keep = (f(Yn) <= f(Y)) & ~frozen
        return torch.where(keep, Yn, Y)

    def certificate(self, Y, s: dict):
        """The four-part test with the configuration's tolerances: True
        where the lane passes."""
        if s["strict_weak_duality"] or not s["gap_from_complementarity"]:
            raise NotImplementedError(
                "the reference certifies with the complementarity gap and "
                "no strict weak-duality test only")
        g = self.Qd @ Y + self.Fd                  # = Kp - Gp U
        slack = torch.clamp(s["erc"] * self.Kp, min=s["eac"])
        if s["feas_from_dual_gradient"]:
            feas = (g >= -slack).all(0)
        else:
            U = self.recover(Y)
            feas = (self.Gp @ U <= self.Kp + slack).all(0)
        gap = (Y * g).sum(0)
        Jd = (0.5 * (Y * (self.Qd @ Y)).sum(0) + (self.Fd * Y).sum(0)
              + 0.5 * self.Md)
        return feas & (gap <= s["eaj"]) & (gap / Jd.abs() <= s["erj"])


def _iterate(dual: Dual, s: dict, stop):
    """The program's loop shape: at h = 1, 1 + k, 1 + 2k, ... call
    ``stop(Y, h, done)`` (returns the lanes that stop now and a ``Y`` to
    keep for them), then ``k`` updates with an acceleration step every
    ``accel_every``, stopped lanes frozen.  Returns (Y, iters, done)."""
    N, B = dual.Fd.shape
    k, a = s["check_every"], s["accel_every"]
    Y = torch.full((N, B), s["y0"], dtype=dual.dtype, device=dual.Fd.device)
    done = torch.zeros(B, dtype=torch.bool, device=Y.device)
    iters = torch.zeros(B, dtype=torch.long, device=Y.device)
    h = 1
    while h <= s["max_iters"] and not bool(done.all()):
        newly, Y = stop(Y, h, done)
        newly = newly & ~done
        iters = torch.where(newly, h, iters)
        done = done | newly
        for _ in range(k // a if a else 1):
            for _ in range(a if a else k):
                Y = torch.where(done, Y, dual.update(Y, s["den_eps"]))
            if a:
                Y = dual.accel(Y, done)
        h += k
    newly, Y = stop(Y, h, done)
    iters = torch.where(done, iters, h)
    return Y, iters, done | newly


def certified(dual: Dual, s: dict):
    """(U, iters, certified) of the configuration's algorithm and
    certificate at the dual's dtype."""
    Y, iters, done = _iterate(
        dual, s, lambda Y, h, done: (dual.certificate(Y, s), Y))
    return dual.recover(Y), iters, done


def _independent(G: np.ndarray, order) -> list:
    """The rows of ``order`` (in that order) that are linearly independent
    of the rows taken before them (Gram-Schmidt, twice)."""
    Q = np.zeros((0, G.shape[1]))
    keep = []
    for i in order:
        r = G[i] - Q.T @ (Q @ G[i])
        r = r - Q.T @ (Q @ r)
        n = np.linalg.norm(r)
        if n > 1e-9 * np.linalg.norm(G[i]):
            Q = np.vstack([Q, r / n])
            keep.append(i)
    return keep


def _kkt(dual: Dual, Y, lanes: torch.Tensor):
    """Exact solutions on the candidate active sets of ``lanes`` (bool,
    (B,)), in float64 NumPy: (Y_exact, verified), ``verified`` False
    elsewhere.  The candidate set ``{i : Y_i > g_i}`` keeps its rows in
    order of Y, largest first, while they stay independent (where a box
    and a slew bound meet, more rows are active than are independent);
    then a few active-set steps mend it: the most negative multiplier
    leaves, or else the most violated row joins (in the place of another
    where the set would turn dependent)."""
    if dual.np is None:
        dual.np = tuple(a.detach().cpu().numpy()
                        for a in (dual.Qd, dual.Fd, dual.Gp))
    Qd, Fd, Gp = dual.np
    N = Qd.shape[0]
    Yh = Y.detach().cpu().numpy()
    g = Qd @ Yh + Fd
    Yx = np.zeros_like(Yh)
    on = np.zeros(Yh.shape, dtype=bool)          # the rows solved for
    tol_g = 1e-9 * (1.0 + np.abs(Fd).max(0))
    for b in np.nonzero(lanes.cpu().numpy())[0]:
        cand = np.nonzero(Yh[:, b] > g[:, b])[0]
        if len(cand) > 2 * Gp.shape[1]:
            continue                    # far from an active set yet
        S = _independent(Gp, cand[np.argsort(-Yh[cand, b])])
        for _ in range(2 * N):
            yS = (np.linalg.solve(Qd[np.ix_(S, S)], -Fd[S, b]) if S
                  else np.zeros(0))
            gb = Qd[:, S] @ yS + Fd[:, b]
            if S and yS.min() < -1e-9 * (1.0 + np.abs(yS).max()):
                S.pop(int(np.argmin(yS)))
                continue
            worst = int(np.argmin(gb))
            if gb[worst] >= -tol_g[b] or worst in S:
                break
            # the violated row joins; where it depends on the set, it takes
            # the place of the row with the least multiplier it can replace
            swaps = [S] + [S[:j] + S[j + 1:] for j in np.argsort(yS)]
            T = next((T + [worst] for T in swaps
                      if len(_independent(Gp, T + [worst])) == len(T) + 1),
                     None)
            if T is None:
                break
            S = T
        Yx[S, b] = yS
        on[S, b] = True
    gx = Qd @ Yx + Fd
    tol_y = 1e-9 * (1.0 + np.abs(Yx).max(0))
    # KKT: Y >= 0, Gp U <= Kp (g >= 0), and g = 0 where Y > 0
    ok = (lanes.cpu().numpy() & np.isfinite(Yx).all(0)
          & (Yx >= -tol_y).all(0) & (gx >= -tol_g).all(0)
          & ((np.abs(gx) <= tol_g) | ~on).all(0))
    to = lambda a: torch.as_tensor(a, device=Y.device)
    return torch.clamp(to(Yx), min=0.0), to(ok)


def exact(dual: Dual, s: dict):
    """(U, unverified lanes) of the float64 reference: the configuration's
    update, acceleration and cadence from its ``y0``, with the exact KKT
    finish tried on every lane left at h = 33, 65, 129, ..., on a lane once
    it passes the configuration's certificate (again at twice that h while
    it fails), and on every lane left at the end (``max_iters``)."""
    B = dual.Fd.shape[1]
    nxt = torch.zeros(B, dtype=torch.long, device=dual.Fd.device)
    every = [33]

    def stop(Y, h, done):
        sweep = h >= every[0] or h > s["max_iters"]
        if h >= every[0]:
            every[0] = 2 * every[0] - 1
        tried = ~done & (sweep | (dual.certificate(Y, s) & (nxt <= h)))
        if not bool(tried.any()):
            return tried, Y
        Yx, ok = _kkt(dual, Y, tried)
        nxt.copy_(torch.where(tried & ~ok, 2 * h, nxt))
        return ok, torch.where(ok, Yx, Y)

    Y, _, done = _iterate(dual, s, stop)
    return dual.recover(Y), int((~done).sum())
