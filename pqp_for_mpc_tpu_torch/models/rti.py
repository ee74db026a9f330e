"""Nonlinear MPC by real-time iteration (RTI).

The PyTorch counterpart of ``pqp_for_mpc_tpu/models/rti.py``: the classic
successive-linearization controller for NONLINEAR plants on the stage-wise
backend.  One control step is

    Jacobians of the user dynamics along the shifted nominal plan
    (``torch.func.jacrev``, vmapped over the stages)
      → time-varying Riccati factorization and dual geometry
        (:func:`~pqp_for_mpc_tpu_torch.models.stagewise.relinearize`)
      → matrix-free PQP solve (warm-started)
      → first input applied.

The JAX package compiles the step into one XLA graph and the closed loop
into one ``lax.scan``; here both run eagerly on the controller's device,
with the same plan shift, ``sqp_iters`` passes and warm start, and the
solver's per-check tests as the only host syncs.

The linearization error rides the disturbance channel: with
``x+ ~ A x + B u + c``, ``c = f(xbar, ubar) - A xbar - B ubar``, the
affine remainder ``c`` is exactly a known per-stage disturbance under
``E = I`` — so the controller requires ``spec.plant.E`` to be identity
stacks and feeds ``dseq = c``.  Output maps stay linear (``y = C x``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig, stagewise_mpc_config
from pqp_for_mpc_tpu_torch.models.mpc import MPCSpec
from pqp_for_mpc_tpu_torch.models.stagewise import (_f32, relinearize,
                                                    solve_stagewise,
                                                    stagewise_dual)
from pqp_for_mpc_tpu_torch.problem import resolve_device


class RTIController:
    """Receding-horizon controller for a nonlinear plant via
    relinearize-and-solve (one or more SQP passes per step).

    ``f_disc``: torch discrete dynamics ``(x (ns,), u (nu,)) -> x_next
    (ns,)`` (e.g. an RK4 step of a continuous model) that ``torch.func``
    can differentiate and vmap.

    ``spec``: the QP shape — horizon, weights, bounds, and a plant whose
    matrices give the dimensions and the FIRST linearization.
    ``spec.plant.E`` must be the identity (the remainder channel, see
    module docstring); ``spec.plant.C`` is the fixed linear output map.

    ``sqp_iters``: relinearize+solve passes per control step.  1 is the
    classic real-time iteration (warm-started by the shifted previous
    plan); 2-3 tighten the plan when the trajectory moves fast relative to
    the horizon.  The structural choices (band width, theta floor) are
    made ONCE here by :func:`stagewise_dual` on the initial linearization
    and reused by every step through :func:`relinearize`.  ``device``:
    default CUDA; without a card that raises — pass ``device="cpu"``.
    """

    def __init__(self, f_disc: Callable, spec: MPCSpec,
                 cfg: Optional[SolverConfig] = None,
                 sqp_iters: int = 1,
                 band: Optional[int] = None,
                 warm_start: bool = True,
                 warm_start_floor: float = 0.01,
                 device=None):
        plant = spec.plant
        H, ns, nu = spec.horizon, plant.n_state, plant.n_input
        E = np.broadcast_to(np.asarray(plant.E, np.float32),
                            (H, ns, plant.n_dist))
        if plant.n_dist != ns or not np.allclose(
                E, np.broadcast_to(np.eye(ns, dtype=np.float32),
                                   (H, ns, ns))):
            raise ValueError(
                "RTIController needs spec.plant.E = identity stacks "
                "(the linearization remainder rides the disturbance "
                "channel, see models/rti.py docstring)")
        self.f_disc = f_disc
        self.spec = spec
        self.cfg = cfg if cfg is not None else stagewise_mpc_config(H)
        self.sqp_iters = int(sqp_iters)
        self.warm_start = warm_start
        self.warm_start_floor = float(warm_start_floor)
        self.device = resolve_device(device)
        self._sd0 = stagewise_dual(spec, theta_floor=self.cfg.theta_floor,
                                   band=band, device=self.device)
        self._H, self._ns, self._nu = H, ns, nu
        self._jacs = torch.func.vmap(
            torch.func.jacrev(f_disc, argnums=(0, 1)))
        self._f_stages = torch.func.vmap(f_disc)
        self.reset()

    @property
    def band(self) -> int:
        return self._sd0.band

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def reset(self):
        self._useq = self._zeros(self._H, self._nu)
        self._u_prev = self._zeros(self._nu)
        self._Y = self._zeros(self._sd0.n_con, 1)

    def _nominal(self, x, useq):
        """States entering each stage under the plan ``useq (H, nu)``."""
        xs = []
        for k in range(self._H):
            xs.append(x)
            x = self.f_disc(x, useq[k])
        return torch.stack(xs)

    def _step(self, x, useq, u_prev, Y):
        """One control step from state ``x`` with the previous plan, input
        and multipliers; returns ``(u0, useq, Y, SolveResult)``."""
        H, nu = self._H, self._nu
        # shift the previous plan one stage (receding horizon)
        useq = torch.cat([useq[1:], useq[-1:]])
        res = None
        for _ in range(self.sqp_iters):
            xbar = self._nominal(x, useq)
            A, B = self._jacs(xbar, useq)
            c = (self._f_stages(xbar, useq)
                 - torch.einsum("kij,kj->ki", A, xbar)
                 - torch.einsum("kij,kj->ki", B, useq))
            sd = relinearize(self._sd0, A, B, u_prev=u_prev)
            Y0 = (torch.clamp(Y, min=self.warm_start_floor)
                  if self.warm_start else None)
            res = solve_stagewise(sd, x[:, None], dseq=c[:, :, None], Y0=Y0,
                                  cfg=self.cfg)
            useq = res.U.reshape(H, nu)
            Y = res.Y
        return useq[0], useq, Y, res

    def step(self, x):
        """One control step: returns ``(u0 (nu,), SolveResult)`` and
        advances the internal plan/warm-start state."""
        u0, self._useq, self._Y, res = self._step(
            _f32(x, self.device), self._useq, self._u_prev, self._Y)
        self._u_prev = u0
        return u0, res

    def rollout(self, x0, steps: int):
        """The nonlinear closed loop on the controller's device:
        relinearization, the PQP solve and the true nonlinear plant
        propagation (``f_disc``) per control step, from a fresh plan and
        warm start (the controller's :meth:`step` state is left as it is).
        Returns NumPy trajectories (x, u, iters, converged)."""
        H, nu = self._H, self._nu
        x = _f32(x0, self.device)
        xs = self._zeros(steps, self._ns)
        us = self._zeros(steps, nu)
        iters = torch.empty(steps, dtype=torch.int32, device=self.device)
        conv = torch.empty(steps, dtype=torch.bool, device=self.device)
        useq, u_prev = self._zeros(H, nu), self._zeros(nu)
        Y = self._zeros(self._sd0.n_con, 1)
        for t in range(steps):
            u_prev, useq, Y, res = self._step(x, useq, u_prev, Y)
            x = self.f_disc(x, u_prev)
            xs[t], us[t] = x, u_prev
            iters[t], conv[t] = res.iters[0], res.converged[0]
        return dict(x=xs.cpu().numpy(), u=us.cpu().numpy(),
                    iters=iters.cpu().numpy(), converged=conv.cpu().numpy())


def output_feedback_rollout(rti: RTIController, mhe, x_true0, steps: int,
                            w_seq=None, v_seq=None, u_warmup=None):
    """Output-feedback NONLINEAR MPC on the device: moving-horizon
    estimation -> relinearize -> PQP solve -> apply, per step.

    The controller (:class:`RTIController`) and the estimator
    (:class:`~pqp_for_mpc_tpu_torch.models.mhe.NonlinearMHE`) share the
    same discrete dynamics ``f_disc`` and the same relinearization
    machinery, so the whole closed loop — window estimate from the last
    ``N`` measurements, RTI control step from the estimate, true nonlinear
    propagation under process noise, noisy measurement — runs on the
    controller's device.

    ``w_seq (steps + N, ns)`` / ``v_seq (steps + N, ny)``: process /
    measurement noise realizations (zeros when ``None``).  The first ``N``
    steps run open loop (``u_warmup``, default zeros) to fill the
    estimation window; control starts at step ``N``.

    Returns NumPy trajectories over the ``steps`` controlled steps: ``x``
    (true), ``x_hat`` (estimate the controller acted on), ``u``,
    ``iters_mhe``, ``iters_rti``, ``conv_mhe``, ``conv_rti``.
    """
    f_disc = rti.f_disc
    if mhe.f_disc is not f_disc:
        raise ValueError("controller and estimator must share f_disc "
                         "(same discrete dynamics)")
    N, ns, ny = mhe.window, mhe._ns, mhe._ny
    H, nu = rti._H, rti._nu
    C = mhe._C
    f32 = lambda a: _f32(a, rti.device)
    x = f32(x_true0)
    w_seq = (rti._zeros(steps + N, ns) if w_seq is None else f32(w_seq))
    v_seq = (rti._zeros(steps + N, ny) if v_seq is None else f32(v_seq))
    u_buf = (rti._zeros(N, nu) if u_warmup is None
             else f32(u_warmup).reshape(N, nu))
    # ---- warmup: fill the measurement window open loop
    ys = []
    for k in range(N):
        x = f_disc(x, u_buf[k]) + w_seq[k]
        ys.append(C @ x + v_seq[k])
    y_buf = torch.stack(ys)
    # arrival prior = zero state (deliberately wrong: the arrival
    # correction must absorb it); callers wanting a better prior pass
    # longer records through NonlinearMHE.run directly.
    x_bar = rti._zeros(ns)
    W, Ym = mhe._cold()
    useq, u_prev = rti._zeros(H, nu), rti._zeros(nu)
    Yr = rti._zeros(rti._sd0.n_con, 1)
    out = dict(x=rti._zeros(steps, ns), x_hat=rti._zeros(steps, ns),
               u=rti._zeros(steps, nu))
    out.update({k: torch.empty(steps, dtype=torch.int32, device=rti.device)
                for k in ("iters_mhe", "iters_rti")})
    out.update({k: torch.empty(steps, dtype=torch.bool, device=rti.device)
                for k in ("conv_mhe", "conv_rti")})
    for t in range(steps):
        xs, Wn, Ym, res_m = mhe._window_core(x_bar, u_buf, y_buf, W, Ym)
        x_hat = xs[-1]
        u_prev, useq, Yr, res_r = rti._step(x_hat, useq, u_prev, Yr)
        x = f_disc(x, u_prev) + w_seq[N + t]
        yn = C @ x + v_seq[N + t]
        u_buf = torch.cat([u_buf[1:], u_prev[None]])
        y_buf = torch.cat([y_buf[1:], yn[None]])
        W = torch.cat([Wn[1:], Wn[-1:]])
        x_bar = xs[0]
        out["x"][t], out["x_hat"][t], out["u"][t] = x, x_hat, u_prev
        out["iters_mhe"][t], out["iters_rti"][t] = (res_m.iters[0],
                                                    res_r.iters[0])
        out["conv_mhe"][t], out["conv_rti"][t] = (res_m.converged[0],
                                                  res_r.converged[0])
    return {k: v.cpu().numpy() for k, v in out.items()}
