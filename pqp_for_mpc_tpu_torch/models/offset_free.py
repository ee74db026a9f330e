"""Offset-free MPC: disturbance-augmented estimation + target tracking.

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/offset_free.py``.  A
linear MPC tracking a constant reference has steady-state offset whenever
the real plant differs from the prediction model (unmeasured constant
disturbances, parameter mismatch).  The textbook fix (Pannocchia &
Rawlings, AIChE J. 2003; Maeder, Borrelli & Morari, Automatica 2009) is a
three-piece loop:

1. **Disturbance-augmented estimation** — model a fictitious constant
   disturbance ``d`` entering the state update (``Bd d``) and/or the
   output (``Cd d``), and estimate ``(x, d)`` jointly with a Kalman
   filter on the augmented plant (:func:`augment_plant` +
   :class:`~pqp_for_mpc_tpu_torch.models.estimator.KalmanFilter`);
2. **Target calculation** — per step, the steady-state pair
   ``(x_ss, u_ss)`` that holds the output at the reference GIVEN the
   current disturbance estimate (:func:`target_maps`: one
   host-precomputed linear map, so the per-step "solve" is two matvecs);
3. **Deviation MPC** — the PQP solve in deviation coordinates
   ``z = x - x_ss``, ``v = u - u_ss`` (reference zero; box bounds shifted
   by ``u_ss``, output bounds by ``y_ss``, slew rows anchored at ``v_prev``
   — first differences are shift-invariant).  Every shift is an additive
   update of the per-step bound vector, so the dual geometry (Qd, θ,
   splits / Riccati factor) is built once and reused every step.

The host builds (:func:`disturbance_channels`, :func:`augment_plant`,
:func:`check_offset_free_rank`, :func:`target_maps`) are the JAX package's
float64 NumPy code, copied.  The solve is the plain ``solve_batched``
(condensed) or ``solve_stagewise``, as in the JAX package.

Disturbance-model choice (``kind``):

* ``"output"`` — ``Bd = 0, Cd = I`` (ny disturbances on the measured
  outputs).  Always detectable when the plant has no integrating modes
  (``rank(I - A) = ns``); the classic default.
* ``"input"`` — ``Bd = B, Cd = 0`` (nu disturbances on the actuators).

Either way the augmented estimator is detectable iff ``(A, C)`` is
detectable and ``rank [[I - A, -Bd], [C, Cd]] = ns + nd`` with
``nd <= ny`` (checked at construction with a clear error).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.dual import dualize_forcing
from pqp_for_mpc_tpu_torch.lanes import cold_start
from pqp_for_mpc_tpu_torch.models.estimator import KalmanFilter
from pqp_for_mpc_tpu_torch.models.mpc import MPCController, MPCSpec
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.models.stagewise import solve_stagewise
from pqp_for_mpc_tpu_torch.solver import solve_batched


def disturbance_channels(plant: LinearPlant, kind: str = "output",
                         Bd=None, Cd=None):
    """Resolve the disturbance-model channels ``(Bd (ns, nd),
    Cd (ny, nd))`` from a named ``kind`` or explicit matrices
    (explicit ones win; missing one defaults to zeros)."""
    ns, nu, ny = plant.n_state, plant.n_input, plant.n_output
    if Bd is None and Cd is None:
        if kind == "output":
            Bd = np.zeros((ns, ny))
            Cd = np.eye(ny)
        elif kind == "input":
            Bd = np.asarray(plant.B, np.float64)
            Cd = np.zeros((ny, nu))
        else:
            raise ValueError(f"unknown disturbance kind {kind!r} "
                             "(use 'output', 'input', or pass Bd/Cd)")
    else:
        nd = (np.asarray(Bd).shape[1] if Bd is not None
              else np.asarray(Cd).shape[1])
        Bd = (np.zeros((ns, nd)) if Bd is None
              else np.asarray(Bd, np.float64))
        Cd = (np.zeros((ny, nd)) if Cd is None
              else np.asarray(Cd, np.float64))
    Bd = np.asarray(Bd, np.float64)
    Cd = np.asarray(Cd, np.float64)
    if Bd.shape[0] != ns or Cd.shape[0] != ny or Bd.shape[1] != Cd.shape[1]:
        raise ValueError(f"disturbance channel shapes Bd {Bd.shape} / "
                         f"Cd {Cd.shape} inconsistent with plant "
                         f"(ns={ns}, ny={ny})")
    return Bd, Cd


def augment_plant(plant: LinearPlant, Bd, Cd) -> LinearPlant:
    """Disturbance-augmented plant for the estimator:
    state ``[x; d]`` with ``d`` a random-walk constant —
    ``A_aug = [[A, Bd], [0, I]]``, ``C_aug = [C, Cd]``."""
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    E = np.asarray(plant.E, np.float64)
    C = np.asarray(plant.C, np.float64)
    if A.ndim != 2:
        raise ValueError("augment_plant needs an LTI plant")
    ns, nd = Bd.shape
    A_aug = np.block([[A, Bd], [np.zeros((nd, ns)), np.eye(nd)]])
    B_aug = np.vstack([B, np.zeros((nd, plant.n_input))])
    E_aug = np.vstack([E, np.zeros((nd, plant.n_dist))])
    C_aug = np.hstack([C, Cd])
    f32 = lambda m: np.asarray(m, np.float32)
    return LinearPlant(f32(A_aug), f32(B_aug), f32(E_aug), f32(C_aug),
                       name=plant.name + "_aug")


def check_offset_free_rank(plant: LinearPlant, Bd, Cd):
    """The Pannocchia-Rawlings detectability condition for the
    augmented estimator: ``nd <= ny`` and
    ``rank [[I - A, -Bd], [C, Cd]] = ns + nd``.  Raises ValueError
    with the measured rank on failure."""
    ns, ny = plant.n_state, plant.n_output
    nd = Bd.shape[1]
    if nd > ny:
        raise ValueError(f"offset-free disturbance model has nd={nd} > "
                         f"ny={ny} disturbances — at most one per "
                         "measured output is estimable")
    A = np.asarray(plant.A, np.float64)
    C = np.asarray(plant.C, np.float64)
    T = np.block([[np.eye(ns) - A, -Bd], [C, Cd]])
    rank = np.linalg.matrix_rank(T)
    if rank < ns + nd:
        raise ValueError(
            f"augmented disturbance model undetectable: "
            f"rank [[I-A, -Bd],[C, Cd]] = {rank} < ns + nd = {ns + nd} "
            "(integrating plant modes overlapping the disturbance "
            "channels? try kind='input' or fewer disturbances)")


def target_maps(plant: LinearPlant, Bd, Cd):
    """Precompute the steady-state target map (host, float64):

        [[A - I, B], [C, 0]] [x_ss; u_ss] = [-Bd d; r - Cd d]

    so per step ``[x_ss; u_ss] = Gd @ d_hat + Gr @ r``.  Square systems
    (ny == nu, invertible) solve exactly; otherwise the pseudo-inverse
    gives the least-squares target (ny > nu: closest reachable output;
    ny < nu: minimum-norm input).  Returns float32 NumPy ``(Gd, Gr)``.
    """
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    ns, nu, ny = plant.n_state, plant.n_input, plant.n_output
    T = np.block([[A - np.eye(ns), B], [C, np.zeros((ny, nu))]])
    Rd = np.vstack([-Bd, -Cd])                      # (ns+ny, nd)
    Rr = np.vstack([np.zeros((ns, ny)), np.eye(ny)])
    if ny == nu and np.linalg.cond(T) < 1e12:
        Ti = np.linalg.inv(T)
    else:
        Ti = np.linalg.pinv(T)
    return ((Ti @ Rd).astype(np.float32), (Ti @ Rr).astype(np.float32))


class OffsetFreeController:
    """Output-feedback offset-free MPC (see module docstring).

    Wraps an :class:`~pqp_for_mpc_tpu_torch.models.mpc.MPCController` built
    on the deviation problem (``spec`` with reference zero) plus the
    augmented Kalman filter and the target map, all on ``device`` (default
    CUDA; without a card that raises — pass ``device="cpu"``).  ``spec.r``
    must be a constant ``(ny,)`` reference (per-stage trajectories have no
    steady-state target).

    Eager surface (user-driven loops):

    * ``estimator.step(xa, u, y_next)`` — augmented estimate update;
    * :meth:`targets` — ``d_hat -> (x_ss, u_ss)``;
    * :meth:`control` — ``(x_hat, d_hat, u_prev) -> (u, SolveResult)``
      (warm-started like ``MPCController.step``).

    Device loop: :meth:`rollout_jit` runs the whole closed loop (truth
    simulation with a constant true disturbance through the model channels,
    measurement [+ optional noise], estimation, targets, deviation solve,
    actuation) on the controller's device.
    """

    def __init__(self, spec: MPCSpec, kind: str = "output",
                 Bd=None, Cd=None, Qw=None, Rv=None,
                 cfg=None, backend: str = "condensed",
                 warm_start="shift", warm_start_floor: float = 1e-6,
                 cold_start_y0: Optional[float] = None,
                 retry_cold: bool = False, device=None):
        r = np.asarray(spec.r, np.float64)
        if r.ndim != 1:
            raise ValueError("offset-free MPC needs a constant (ny,) "
                             "reference — a per-stage trajectory has no "
                             "steady-state target")
        plant = spec.plant
        if np.asarray(plant.A).ndim == 3:
            raise NotImplementedError("offset-free MPC needs an LTI "
                                      "plant (LTV loops relinearize per "
                                      "step — see models/rti.py)")
        Bd64, Cd64 = disturbance_channels(plant, kind, Bd, Cd)
        check_offset_free_rank(plant, Bd64, Cd64)
        nd = Bd64.shape[1]

        # Deviation problem: same plant/horizon/weights/bounds,
        # reference 0 and a zero slew anchor (v_prev supplied per step).
        dev_spec = dataclasses.replace(spec, r=np.zeros_like(r),
                                       u_prev=None)
        self._ctrl = MPCController(dev_spec, cfg=cfg,
                                   warm_start=warm_start,
                                   cold_start_y0=cold_start_y0,
                                   warm_start_floor=warm_start_floor,
                                   backend=backend,
                                   retry_cold=retry_cold, device=device)
        self.device = self._ctrl.device
        f32 = self._ctrl._as_f32
        Gd, Gr = target_maps(plant, Bd64, Cd64)
        self._Gd = f32(Gd)
        self._Gr = f32(Gr)
        self._r = f32(r)
        self._Bd = f32(Bd64)
        self._Cd = f32(Cd64)
        self._C = f32(plant.C)
        self.n_dist_model = nd

        ns, ny = plant.n_state, plant.n_output
        if Qw is None:
            # default augmented process noise: small on the physical
            # state, larger on the disturbance walk so d_hat tracks
            # step disturbances within a few filter time constants
            Qw = np.diag(np.concatenate([np.full(ns, 1e-4),
                                         np.full(nd, 1e-2)]))
        if Rv is None:
            Rv = 1e-4 * np.eye(ny)
        self.estimator = KalmanFilter(augment_plant(plant, Bd64, Cd64),
                                      Qw, Rv, device=self.device)
        self._Y = None

    # -- per-step pieces (tensors on the controller's device) ------------

    def targets(self, d_hat: torch.Tensor):
        """Steady-state target ``(x_ss, u_ss)`` for the current
        disturbance estimate (two matvecs)."""
        ns = self._ctrl.spec.plant.n_state
        t = self._Gd @ d_hat + self._Gr @ self._r
        return t[:ns], t[ns:]

    def _dev_solve(self, z, u_ss, v_prev, y_ss, Y0, D=None):
        """Deviation-coordinates PQP solve: reference-zero problem with
        box rows shifted by ``u_ss``, slew anchor at ``v_prev`` and (if
        present) output rows shifted by ``y_ss``.  All shifts are additive
        bound updates on a copy of the controller's bounds — the dual
        geometry is reused and the controller's own bounds never change.
        ``D``: optional flat ``(H * nd,)`` KNOWN-disturbance preview
        window through the plant's E channel (shift-invariant, so it
        enters the deviation problem unchanged)."""
        c = self._ctrl
        retry = c.retry_cold and Y0 is not None
        if c.backend == "stagewise":
            sd0 = c._sd
            # Kp layout (4, H, nu): [umax, -umin, dmax + e1 up, dmax - e1 up]
            Kp = sd0.Kp.clone()
            Kp[0] -= u_ss
            Kp[1] += u_ss
            Kp[2, 0] += v_prev
            Kp[3, 0] -= v_prev
            repl = dict(Kp=Kp, u_prev=v_prev)
            if sd0.has_y:
                repl["y_max"] = sd0.y_max - y_ss
                repl["y_min"] = sd0.y_min - y_ss
            sd = dataclasses.replace(sd0, **repl)
            z2 = z if z.dim() == 2 else z[:, None]
            dseq = None
            if D is not None:
                dseq = D.reshape(c.spec.horizon,
                                 c.spec.plant.n_dist)[..., None]
            return solve_stagewise(sd, z2, dseq=dseq, Y0=Y0, cfg=c.cfg,
                                   retry_cold=retry)
        data = c.data
        H, nu = c.spec.horizon, c.spec.plant.n_input
        ny = c.spec.plant.n_output
        M = c._Hv * nu       # move blocking shrinks the input groups
        tss = u_ss.repeat(c._Hv)
        Kp = data.Kp.clone()
        Kp[:M] -= tss
        Kp[M:2 * M] += tss
        Kp[2 * M:2 * M + nu] += v_prev
        Kp[3 * M:3 * M + nu] -= v_prev
        if data.Kx is not None:
            # output rows sit right after the 4M input rows; slack-
            # positivity rows (soft mode) follow and are shift-free
            ty = y_ss.repeat(H)
            b = 4 * M
            Kp[b:b + H * ny] -= ty
            Kp[b + H * ny:b + 2 * H * ny] += ty
        d2 = dataclasses.replace(data, Kp=Kp)
        D0 = (torch.zeros(H * c.spec.plant.n_dist, dtype=torch.float32,
                          device=self.device) if D is None else D)
        primal = d2.assemble(x=z, D=D0, Qp=c.Qp)
        dual = dualize_forcing(c._geom, primal.Fp, primal.Mp, primal.Kp,
                               precision=c.cfg.precision)
        return solve_batched(primal, dual, Y0=Y0, cfg=c.cfg,
                             retry_cold=retry)

    # -- eager surface ---------------------------------------------------

    def control(self, x_hat, d_hat, u_prev=None):
        """One offset-free control computation from the current
        estimates; returns ``(u, SolveResult)`` with ``u`` in ORIGINAL
        input coordinates (``v* + u_ss``)."""
        c = self._ctrl
        nu = c.spec.plant.n_input
        x_hat = c._as_f32(x_hat).reshape(-1)
        d_hat = c._as_f32(d_hat).reshape(-1)
        up = (torch.zeros(nu, dtype=torch.float32, device=self.device)
              if u_prev is None else c._as_f32(u_prev).reshape(-1))
        x_ss, u_ss = self.targets(d_hat)
        y_ss = self._C @ x_ss + self._Cd @ d_hat
        Y0 = None
        if c.warm_start and self._Y is not None:
            Yw = self._Y
            if c.warm_start == "shift":
                Yw = c._shift_multipliers(Yw)
            Y0 = torch.clamp(Yw, min=c.warm_start_floor)
        res = self._dev_solve(x_hat - x_ss, u_ss, up - u_ss, y_ss, Y0)
        if c.warm_start:
            self._Y = res.Y
        return res.U[:nu, 0] + u_ss, res

    def reset(self):
        self._Y = None
        self._ctrl.reset()

    # -- the closed loop on the device -----------------------------------

    def rollout_jit(self, x0, steps: int, d_true,
                    x_hat0=None, d_hat0=None, meas_noise=None,
                    w_seq=None, d_forecast=None):
        """The output-feedback closed loop kept on the controller's device:
        per step {targets -> deviation solve -> actuate -> simulate truth
        with the constant disturbance ``d_true`` through the model channels
        -> measure (+ ``meas_noise[t]`` if given) -> estimate}, the
        trajectories written into buffers on the device and brought to the
        host once at the end.  The JAX package compiles this loop into one
        ``lax.scan``; here it is a Python loop whose only host syncs are
        the solver's own per-check tests (and, with ``retry_cold``, its
        per-step "did every lane certify").

        Production composition hooks (the full stack {robust tightening +
        offset-free + estimator + preview} rides this one loop):

        * ``w_seq (steps, ns)`` — additive process disturbance on the
          TRUE state update (the robust tube's ``|w| <= w_box``; pair
          with a :func:`~pqp_for_mpc_tpu_torch.models.robust.robust_spec`-
          tightened spec to keep the ORIGINAL bounds under it);
        * ``d_forecast (steps + H, nd)`` — KNOWN-disturbance preview
          through the plant's E channel, windowed per step exactly like
          :meth:`MPCController.rollout_jit`; the truth propagates with
          ``E d_forecast[t]``.

        Returns NumPy trajectories: x (truth), y (measurements), u, d_hat,
        iters, converged.
        """
        c = self._ctrl
        plant = c.spec.plant
        H = c.spec.horizon
        ns, nu, ny = plant.n_state, plant.n_input, plant.n_output
        nd, dev, f32 = self.n_dist_model, self.device, torch.float32
        x = c._as_f32(x0).reshape(ns)
        xh = x if x_hat0 is None else c._as_f32(x_hat0).reshape(ns)
        dh = (torch.zeros(nd, dtype=f32, device=dev) if d_hat0 is None
              else c._as_f32(d_hat0).reshape(nd))
        xa = torch.cat([xh, dh])
        dt = c._as_f32(d_true).reshape(-1)
        nz = (torch.zeros((steps, ny), dtype=f32, device=dev)
              if meas_noise is None
              else c._as_f32(meas_noise).reshape(steps, ny))
        ws = (None if w_seq is None
              else c._as_f32(w_seq).reshape(steps, ns))
        wins = None
        if d_forecast is not None:
            df = c._as_f32(d_forecast).reshape(-1, plant.n_dist)
            if df.shape[0] < steps + H:
                raise ValueError(f"d_forecast needs {steps + H} rows "
                                 f"(steps + horizon), got {df.shape[0]}")
            idx = (torch.arange(steps, device=dev)[:, None]
                   + torch.arange(H, device=dev)[None, :])
            wins = df[idx]
        A, Bm, Em = (c._as_f32(m) for m in (plant.A, plant.B, plant.E))
        C, Bd, Cd = self._C, self._Bd, self._Cd
        kf = self.estimator
        Y_cold = cold_start(c.n_con, 1, c.cfg, dev)
        traj = dict(x=torch.empty((steps, ns), dtype=f32, device=dev),
                    y=torch.empty((steps, ny), dtype=f32, device=dev),
                    u=torch.empty((steps, nu), dtype=f32, device=dev),
                    d_hat=torch.empty((steps, nd), dtype=f32, device=dev),
                    iters=torch.empty(steps, dtype=torch.int32, device=dev),
                    converged=torch.empty(steps, dtype=torch.bool,
                                          device=dev))
        u_prev = torch.zeros(nu, dtype=f32, device=dev)
        Y = Y_cold
        for t in range(steps):
            x_hat, d_hat = xa[:ns], xa[ns:]
            x_ss, u_ss = self.targets(d_hat)
            y_ss = C @ x_ss + Cd @ d_hat
            win = None if wins is None else wins[t]
            res = self._dev_solve(
                x_hat - x_ss, u_ss, u_prev - u_ss, y_ss,
                torch.clamp(Y, min=c.warm_start_floor),
                D=None if win is None else win.reshape(-1))
            u0 = res.U[:nu, 0] + u_ss
            xn = A @ x + Bm @ u0 + Bd @ dt
            if ws is not None:
                xn = xn + ws[t]
            if win is not None:
                xn = xn + Em @ win[0]
            yn = C @ xn + Cd @ dt + nz[t]
            # the estimator sees the previewed disturbance as a known
            # input through the AUGMENTED plant's E channel
            xa = kf.step(xa, u0, yn, d=None if win is None else win[0])
            if c.warm_start == "shift":
                Y = c._shift_multipliers(res.Y)
            elif c.warm_start:
                Y = res.Y
            else:
                Y = Y_cold
            traj["x"][t] = xn
            traj["y"][t] = yn
            traj["u"][t] = u0
            traj["d_hat"][t] = xa[ns:]
            traj["iters"][t] = res.iters[0]
            traj["converged"][t] = res.converged[0]
            x, u_prev = xn, u0
        return {k: v.cpu().numpy() for k, v in traj.items()}
