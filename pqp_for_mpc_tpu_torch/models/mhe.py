"""Constrained moving-horizon estimation (MHE) through the PQP solver.

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/mhe.py``.  MHE is the
estimation dual of MPC: over a sliding window of the last ``N``
measurements, find the process-noise sequence (and thereby the state
trajectory) that best explains the data, subject to KNOWN bounds on the
noise / states that a Kalman filter cannot express:

    min_w  sum_k w_k' Qw^-1 w_k + sum_k (y_k - C x_k)' Rv^-1 (y_k - C x_k)
    s.t.   x_{k+1} = A x_k + B u_k + w_k,     x_{t-N} = x_bar (arrival),
           w_min <= w_k <= w_max,   y_min <= C x_k <= y_max.

This IS the package's MPC problem under the identification {noise w ->
"input", measurements y -> per-stage reference, known inputs u ->
disturbance channel}:

    estimation plant   x+ = A x + I w + B u,   y = C x
    weights            Qy = Rv^-1,  R = Qw^-1
    reference          r_k = y_k        (changes EVERY step)

so the whole geometry (Qp, Gp, dual Hessian, theta, splits) comes from
:func:`~pqp_for_mpc_tpu_torch.models.mpc.condense` built once at r = 0, and
only the measurement-dependent forcing is assembled per window: the
reference enters the condensed blocks LINEARLY (Fp3 = L3 r, Mp4 = L4 r,
Mp5 = L5 r, Mp6 = r' Q4 r), so each window solve is the standard per-step
pattern {assemble forcing -> dualize_forcing -> solve_batched}.

Arrival handling: the window start is the previous window's smoothed
estimate PLUS a weighted arrival correction — stage 0's "noise" rides free
of the w bounds and is weighted by the inverse of the steady-state
one-step prediction covariance ``P0`` (the filter-DARE solution, or a
user-supplied prior), through the per-stage weight/bound stacks
(``MPCSpec.R``/``u_min`` as ``(H, ...)`` schedules).  The recursion
x_bar <- xs[0] advances it one step per slide.

:class:`NonlinearMHE` does the same for nonlinear dynamics by successive
linearization on the stage-wise backend (``relinearize`` +
``solve_stagewise``), with the Jacobians from ``torch.func``.  The JAX
package compiles each record run into one ``lax.scan``; here ``run`` is a
loop on the estimator's device whose only host syncs are the solver's
per-check tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.dual import dual_geometry, dualize_forcing
from pqp_for_mpc_tpu_torch.lanes import cold_start
from pqp_for_mpc_tpu_torch.models.estimator import filter_dare
from pqp_for_mpc_tpu_torch.models.mpc import (MPCSpec,
                                              _prediction_matrices_f64,
                                              _stage_weight_diag, condense)
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant, LTVPlant
from pqp_for_mpc_tpu_torch.models.stagewise import (_f32, relinearize,
                                                    solve_stagewise,
                                                    stagewise_dual)
from pqp_for_mpc_tpu_torch.problem import resolve_device
from pqp_for_mpc_tpu_torch.solver import solve_batched

#: inert bound for unconstrained noise components
_BIG = 1e4


def _estimation_weights(ns, N, Qw, Rv, P0, w_min, w_max):
    """The window's per-stage weight and bound stacks (host float64):
    stage 0 carries the arrival correction (weight ``P0^-1``, free bounds),
    stages 1..N-1 the noise weight ``Qw^-1`` and bounds.  Returns
    ``(scale * Rv^-1, scale * R_stack, wmin_stack, wmax_stack)``, scaled so
    the largest weight entry is 1: the estimate is invariant to a uniform
    scaling of (Qy, R), but the gap certification is not — inverse
    covariances put the raw objective at O(1/Rv) (~1e4 for percent-level
    sensors), which drives the absolute gap tolerance below the float32
    floor and stalls the solve at 50k iterations."""
    wmax = (np.full(ns, _BIG) if w_max is None
            else np.asarray(w_max, np.float64))
    wmin = (np.full(ns, -_BIG) if w_min is None
            else np.asarray(w_min, np.float64))
    R_stack = np.concatenate(
        [np.linalg.inv(P0)[None],
         np.broadcast_to(np.linalg.inv(Qw), (N - 1, ns, ns))])
    wmax_stack = np.concatenate(
        [np.full((1, ns), _BIG), np.broadcast_to(wmax, (N - 1, ns))])
    wmin_stack = np.concatenate(
        [np.full((1, ns), -_BIG), np.broadcast_to(wmin, (N - 1, ns))])
    Qy64 = np.linalg.inv(Rv)
    scale = 1.0 / max(np.abs(Qy64).max(), np.abs(R_stack).max())
    return scale * Qy64, scale * R_stack, wmin_stack, wmax_stack


def _estimation_spec(eplant, N, ny, ns, Qy, R, wmin, wmax, y_min, y_max):
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return MPCSpec(plant=eplant, horizon=N, Qy=Qy, R=R,
                   r=np.zeros(ny, np.float32),
                   u_min=f32(wmin), u_max=f32(wmax),
                   # noise has no slew physics — keep the rows inert
                   du_max=np.full(ns, 4 * _BIG, np.float32),
                   y_min=f32(y_min), y_max=f32(y_max))


def _check_record(u_seq, y_seq, N):
    T = y_seq.shape[0]
    if u_seq.shape[0] != T or T < N:
        raise ValueError(f"need matching records with T >= {N}, got "
                         f"u {u_seq.shape[0]} / y {T}")
    return T - N + 1


class MovingHorizonEstimator:
    """Sliding-window constrained state estimator (see module docstring),
    on ``device`` (default CUDA; without a card that raises — pass
    ``device="cpu"``).

    * :meth:`step` — solve ONE window ``(x_bar, u_win, y_win) ->
      (x_hat, xs, SolveResult)``; warm-started.
    * :meth:`run` — slide the window over a whole input/measurement
      record on the device (window solves, arrival recursion and
      warm-start carry).
    """

    def __init__(self, plant: LinearPlant, window: int, Qw, Rv,
                 w_min=None, w_max=None, y_min=None, y_max=None,
                 P0=None, cfg=None, warm_start: bool = True,
                 warm_start_floor: float = 1e-6, device=None):
        if np.asarray(plant.A).ndim == 3:
            raise NotImplementedError(
                "this condensed MHE needs an LTI plant; for LTV or "
                "nonlinear dynamics use NonlinearMHE (stage-wise window "
                "geometry rebuilt per window)")
        ns, ny = plant.n_state, plant.n_output
        self.plant = plant
        self.window = N = int(window)
        if N < 2:
            raise ValueError("window must be >= 2 (stage 0 carries the "
                             "arrival correction)")
        self.device = resolve_device(device)
        Qw = np.asarray(Qw, np.float64)
        Rv = np.asarray(Rv, np.float64)
        if P0 is None:
            # steady-state one-step prediction covariance (the shared
            # filter-DARE solver; raises on undetectable (A, C))
            P0 = filter_dare(plant.A, plant.C, Qw, Rv)
        Qy, R, wmin, wmax = _estimation_weights(
            ns, N, Qw, Rv, np.asarray(P0, np.float64), w_min, w_max)
        # estimation plant: noise is the input, the KNOWN plant input
        # rides the disturbance channel
        f32 = lambda a: np.asarray(a, np.float32)
        eplant = LinearPlant(A=f32(plant.A), B=f32(np.eye(ns)),
                             E=f32(plant.B), C=f32(plant.C),
                             name=plant.name + "_mhe")
        spec = _estimation_spec(eplant, N, ny, ns, Qy, R, wmin, wmax,
                                y_min, y_max)
        self.cfg = MPC_CONFIG if cfg is None else cfg
        self.spec = spec
        self.data = condense(spec, device=self.device)  # r = 0
        self.Qp = self.data.qp()
        self._geom = dual_geometry(self.data.Gp, self.data.Qp_inv,
                                   theta_floor=self.cfg.theta_floor,
                                   precision=self.cfg.precision)

        # measurement-dependent forcing maps (host f64 build, f32 on the
        # device) — the rbar-linear terms of mpc._condense's algebra
        Sx, Su, Sd = _prediction_matrices_f64(eplant, N)
        Cs = np.kron(np.eye(N), np.asarray(plant.C, np.float64))
        Qbar = _stage_weight_diag(Qy, N, ny, "Qy")
        CSu, CSx, CSd = Cs @ Su, Cs @ Sx, Cs @ Sd
        dev = self.device
        self._L3 = _f32(2.0 * CSu.T @ Qbar, dev)      # Fp3  = L3 @ rbar
        self._L4 = _f32(-8.0 * CSx.T @ Qbar, dev)     # Mp4  = L4 @ rbar
        self._L5 = _f32(-8.0 * CSd.T @ Qbar, dev)     # Mp5  = L5 @ rbar
        self._Q4 = _f32(4.0 * Qbar, dev)              # Mp6  = r' Q4 r
        self._A = _f32(plant.A, dev)
        self._B = _f32(plant.B, dev)
        self.warm_start = warm_start
        self.warm_start_floor = warm_start_floor
        self._Y = None

    # -- one window ------------------------------------------------------

    def _solve_window(self, x_bar, D, rbar, Y0):
        """Assemble the r-dependent forcing on top of the r=0 condensed
        blocks and solve; all inputs flat/unbatched tensors."""
        primal0 = self.data.assemble(x=x_bar, D=D, Qp=self.Qp)
        dFp = self._L3 @ rbar                       # enters as -Fp3
        dMp = 0.5 * ((self._L4 @ rbar) @ x_bar + (self._L5 @ rbar) @ D
                     + rbar @ (self._Q4 @ rbar))
        primal = dataclasses.replace(
            primal0,
            Fp=primal0.Fp - (dFp[:, None] if primal0.Fp.dim() == 2
                             else dFp),
            Mp=primal0.Mp + dMp)
        dual = dualize_forcing(self._geom, primal.Fp, primal.Mp,
                               primal.Kp, precision=self.cfg.precision)
        return solve_batched(primal, dual, Y0=Y0, cfg=self.cfg)

    def _roll(self, x_bar, W, u_win):
        """State trajectory from the arrival state, the solved noise
        sequence ``W (N, ns)`` and the known inputs ``u_win (N, nu)``;
        returns ``xs (N, ns)`` = x_{t-N+1} .. x_t."""
        Bu = u_win @ self._B.T                      # (N, ns)
        xs, x = [], x_bar
        for k in range(self.window):
            x = self._A @ x + W[k] + Bu[k]
            xs.append(x)
        return torch.stack(xs)

    def _window(self, x_bar, u_win, y_win, Y0):
        res = self._solve_window(x_bar, u_win.reshape(-1),
                                 y_win.reshape(-1), Y0)
        W = res.U[:, 0].reshape(self.window, self.plant.n_state)
        return self._roll(x_bar, W, u_win), res

    def step(self, x_bar, u_win, y_win):
        """Solve one window.  ``x_bar (ns,)`` arrival state,
        ``u_win (N, nu)`` known inputs, ``y_win (N, ny)`` measurements
        (slot k holds u/y of window stage k).  Returns
        ``(x_hat, xs, SolveResult)`` with ``x_hat = xs[-1]`` the current
        state estimate."""
        N = self.window
        x_bar = _f32(x_bar, self.device).reshape(-1)
        u_win = _f32(u_win, self.device).reshape(N, -1)
        y_win = _f32(y_win, self.device).reshape(N, -1)
        Y0 = None
        if self.warm_start and self._Y is not None:
            Y0 = torch.clamp(self._Y, min=self.warm_start_floor)
        xs, res = self._window(x_bar, u_win, y_win, Y0)
        if self.warm_start:
            self._Y = res.Y
        return xs[-1], xs, res

    def reset(self):
        self._Y = None

    # -- sliding-window record run on the device ---------------------------

    def run(self, x_bar0, u_seq, y_seq):
        """Estimate over a whole record: ``u_seq (T, nu)``, ``y_seq (T,
        ny)`` with ``T >= window``.  Window k covers samples
        ``k .. k+N-1``; the arrival recursion advances ``x_bar`` by the
        first smoothed state each slide and the dual warm start carries
        between windows.  The estimator's own :meth:`step` state is left
        as it is.

        Returns NumPy: ``x_hat (T-N+1, ns)`` (estimate of the state at
        each window end), iters, converged.
        """
        N = self.window
        u_seq = _f32(u_seq, self.device)
        y_seq = _f32(y_seq, self.device)
        steps = _check_record(u_seq, y_seq, N)
        out = _RecordBuffers(steps, self.plant.n_state, self.device)
        x_bar = _f32(x_bar0, self.device).reshape(-1)
        Y = cold_start(self.data.n_con, 1, self.cfg, self.device)
        for k in range(steps):
            xs, res = self._window(x_bar, u_seq[k:k + N], y_seq[k:k + N],
                                   torch.clamp(Y, min=self.warm_start_floor))
            if self.warm_start:
                Y = res.Y
            # arrival advances to the first smoothed state of the window
            x_bar = xs[0]
            out.put(k, xs[-1], res)
        return out.numpy()


class _RecordBuffers:
    """Per-window outputs of a record run, kept on the device until the
    end: ``x_hat (steps, ns)``, ``iters`` and ``converged``."""

    def __init__(self, steps: int, ns: int, device):
        self.x_hat = torch.empty((steps, ns), dtype=torch.float32,
                                 device=device)
        self.iters = torch.empty(steps, dtype=torch.int32, device=device)
        self.converged = torch.empty(steps, dtype=torch.bool, device=device)

    def put(self, k, x_hat, res):
        self.x_hat[k] = x_hat
        self.iters[k] = res.iters[0]
        self.converged[k] = res.converged[0]

    def numpy(self) -> dict:
        return dict(x_hat=self.x_hat.cpu().numpy(),
                    iters=self.iters.cpu().numpy(),
                    converged=self.converged.cpu().numpy())


class NonlinearMHE:
    """Moving-horizon estimation for NONLINEAR (or LTV) dynamics by
    successive linearization — the estimation mirror of
    :class:`~pqp_for_mpc_tpu_torch.models.rti.RTIController`.

    Dynamics ``x_{k+1} = f(x_k, u_k) + w_k`` with additive process noise
    and a linear measurement ``y = C x``.  Each window solve linearizes
    ``f`` along the nominal trajectory implied by the current noise
    estimate (``torch.func.jacrev`` vmapped over the stages), maps the
    window onto the stage-wise MPC machinery under the MHE identification
    {noise w -> input (B = I), known input + affine remainder
    ``f(xbar, u) - A xbar`` -> disturbance channel (E = I), measurement
    y_k -> per-stage reference r_k}, rebuilds the geometry with
    :func:`~pqp_for_mpc_tpu_torch.models.stagewise.relinearize` and solves
    the constrained QP matrix-free.

    Arrival handling mirrors :class:`MovingHorizonEstimator`: stage 0's
    noise rides free of the bounds, weighted by ``P0^-1`` (one-step
    prediction covariance of the INITIAL linearization by default), and the
    recursion advances the arrival state by each window's first smoothed
    state.

    ``f_disc``: a torch callable ``(x (ns,), u (nu,)) -> x_next (ns,)``
    that ``torch.func`` can differentiate and vmap.  ``sqp_iters``:
    linearize+solve passes per window (1 = classic RTI pacing; 2 helps when
    the trajectory bends fast within a window).  ``device``: default CUDA;
    without a card that raises — pass ``device="cpu"``.
    """

    def __init__(self, f_disc, C, window: int, Qw, Rv,
                 w_min=None, w_max=None, y_min=None, y_max=None,
                 P0=None, cfg=None,
                 sqp_iters: int = 1, band: Optional[int] = None,
                 x_lin=None, u_lin=None,
                 warm_start: bool = True, warm_start_floor: float = 1e-6,
                 device=None):
        C = np.asarray(C, np.float64)
        ny, ns = C.shape
        N = int(window)
        if N < 2:
            raise ValueError("window must be >= 2 (stage 0 carries the "
                             "arrival correction)")
        self.f_disc = f_disc
        self.window = N
        self.sqp_iters = int(sqp_iters)
        self.warm_start = warm_start
        self.warm_start_floor = warm_start_floor
        self.device = dev = resolve_device(device)

        # initial linearization point (defaults to the origin)
        x0 = _f32(np.zeros(ns) if x_lin is None else x_lin, dev)
        if u_lin is None:
            raise ValueError("pass u_lin (a representative known-input "
                             "vector, e.g. np.zeros(nu)) — the input "
                             "dimension cannot be inferred from f_disc")
        u0 = _f32(u_lin, dev)
        A0 = torch.func.jacrev(f_disc, argnums=0)(x0, u0) \
            .detach().cpu().numpy().astype(np.float64)

        Qw = np.asarray(Qw, np.float64)
        Rv = np.asarray(Rv, np.float64)
        if P0 is None:
            # arrival prior from the INITIAL linearization's filter DARE
            # (the shared solver; raises on undetectable (A0, C))
            P0 = filter_dare(A0, C, Qw, Rv)
        Qy, R, wmin, wmax = _estimation_weights(
            ns, N, Qw, Rv, np.asarray(P0, np.float64), w_min, w_max)
        f32 = lambda a: np.asarray(a, np.float32)
        eye = np.broadcast_to(np.eye(ns), (N, ns, ns))
        eplant = LTVPlant(A=f32(np.broadcast_to(A0, (N, ns, ns))),
                          B=f32(eye), E=f32(eye),
                          C=f32(np.broadcast_to(C, (N, ny, ns))),
                          name="nonlinear_mhe")
        # y_min/y_max: hard bounds on the MEASURED OUTPUT of the estimated
        # trajectory (physically-known sensor/state ranges a Gaussian
        # filter cannot express), taken matrix-free by the stage-wise path
        spec = _estimation_spec(eplant, N, ny, ns, Qy, R, wmin, wmax,
                                y_min, y_max)
        self.cfg = MPC_CONFIG if cfg is None else cfg
        self.spec = spec
        self._sd0 = stagewise_dual(spec, theta_floor=self.cfg.theta_floor,
                                   band=band, device=dev)
        self._B_eye = _f32(eye, dev)
        self._C = _f32(C, dev)
        self._ns, self._ny = ns, ny
        self._jac_x = torch.func.vmap(torch.func.jacrev(f_disc, argnums=0))
        self._f_stages = torch.func.vmap(f_disc)
        self._Y = None
        self._W = None

    @property
    def band(self) -> int:
        return self._sd0.band

    def reset(self):
        self._Y = None
        self._W = None

    def _cold(self):
        """The record's first noise and dual warm starts."""
        return (torch.zeros((self.window, self._ns), dtype=torch.float32,
                            device=self.device),
                cold_start(self._sd0.n_con, 1, self.cfg, self.device))

    def _roll(self, x_bar, u_win, W):
        """States entering each stage ``(N, ns)`` and the states each stage
        produces ``(N, ns)`` under ``x+ = f(x, u) + w`` from ``x_bar``."""
        entering, produced, x = [], [], x_bar
        for k in range(self.window):
            entering.append(x)
            x = self.f_disc(x, u_win[k]) + W[k]
            produced.append(x)
        return torch.stack(entering), torch.stack(produced)

    # -- one window ------------------------------------------------------

    def _window_core(self, x_bar, u_win, y_win, W, Y):
        """One window solve with ``sqp_iters`` relinearization passes.
        Tensors: ``x_bar (ns,)``, ``u_win (N, nu)``, ``y_win (N, ny)``,
        ``W (N, ns)`` noise warm start, ``Y (n_con, 1)`` dual warm start.
        Returns ``(xs, W, Y, res)``."""
        N, ns = self.window, self._ns
        res = None
        for _ in range(self.sqp_iters):
            # nominal trajectory ENTERING each stage under the current
            # noise estimate: xbar_0 = x_bar
            xbars = self._roll(x_bar, u_win, W)[0]
            A = self._jac_x(xbars, u_win)                  # (N, ns, ns)
            # known forcing: f(xbar, u) - A xbar rides the disturbance
            # channel (E = I) — includes B u and the affine remainder
            d = (self._f_stages(xbars, u_win)
                 - torch.einsum("kij,kj->ki", A, xbars))   # (N, ns)
            sd = relinearize(self._sd0, A, self._B_eye, r=y_win)
            Y0 = (torch.clamp(Y, min=self.warm_start_floor)
                  if self.warm_start else None)
            res = solve_stagewise(sd, x_bar[:, None], dseq=d[:, :, None],
                                  Y0=Y0, cfg=self.cfg)
            W = res.U[:, 0].reshape(N, ns)
            Y = res.Y
        # smoothed states from the NONLINEAR roll with the solved noise
        xs = self._roll(x_bar, u_win, W)[1]                # x_1..x_N
        return xs, W, Y, res

    def step(self, x_bar, u_win, y_win):
        """Solve one window eagerly.  Returns ``(x_hat, xs,
        SolveResult)``; carries noise/dual warm starts."""
        N = self.window
        x_bar = _f32(x_bar, self.device).reshape(-1)
        u_win = _f32(u_win, self.device).reshape(N, -1)
        y_win = _f32(y_win, self.device).reshape(N, -1)
        W0, Y0 = self._cold()
        W = W0 if self._W is None else self._W
        Y = Y0 if self._Y is None else self._Y
        xs, W, Y, res = self._window_core(x_bar, u_win, y_win, W, Y)
        if self.warm_start:
            # shift the noise plan one slide forward for the next window
            self._W = torch.cat([W[1:], W[-1:]])
            self._Y = Y
        return xs[-1], xs, res

    # -- sliding-window record run on the device ---------------------------

    def run(self, x_bar0, u_seq, y_seq):
        """Estimate over a whole record on the device (same contract as
        :meth:`MovingHorizonEstimator.run`)."""
        N = self.window
        u_seq = _f32(u_seq, self.device)
        y_seq = _f32(y_seq, self.device)
        steps = _check_record(u_seq, y_seq, N)
        out = _RecordBuffers(steps, self._ns, self.device)
        x_bar = _f32(x_bar0, self.device).reshape(-1)
        W, Y = self._cold()
        for k in range(steps):
            xs, Wn, Yn, res = self._window_core(
                x_bar, u_seq[k:k + N], y_seq[k:k + N], W, Y)
            if self.warm_start:
                W, Y = torch.cat([Wn[1:], Wn[-1:]]), Yn
            x_bar = xs[0]
            out.put(k, xs[-1], res)
        return out.numpy()
