"""Nonlinear MPC by real-time iteration (successive linearization).

A NONLINEAR plant controlled by relinearizing along a nominal trajectory
every control step.  The default mode runs
:class:`~pqp_for_mpc_tpu_torch.models.rti.RTIController` ``.rollout`` —
per-stage Jacobians (``torch.func``), the time-varying Riccati
refactorization (``relinearize``), the matrix-free PQP solve and the true
nonlinear plant propagation, the closed loop kept on the device.
``--eager`` runs the same algorithm spelled out by hand with a
``stagewise_dual`` rebuild per pass: readable, and slower.

Plant: torque-limited pendulum measured from the UPRIGHT equilibrium
(gravity destabilizing), swung from 2.5 rad to balance.

    python -m pqp_for_mpc_tpu_torch.examples.nonlinear_mpc [steps]
        [--eager] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from pqp_for_mpc_tpu_torch import SolverConfig
from pqp_for_mpc_tpu_torch.models import (LTVPlant, MPCSpec, RTIController,
                                          solve_stagewise, stagewise_dual)

DT = 0.05
G_OVER_L = 10.0
DAMPING = 0.1

H, NS, NU = 20, 2, 1


def f_cont(x, u):
    """Pendulum about the upright: theta'' = (g/l) sin(theta) - b w + u."""
    th, w = x[0], x[1]
    return torch.stack([w, G_OVER_L * torch.sin(th) - DAMPING * w + u[0]])


def f_disc(x, u):
    """One RK4 step of the continuous dynamics."""
    k1 = f_cont(x, u)
    k2 = f_cont(x + 0.5 * DT * k1, u)
    k3 = f_cont(x + 0.5 * DT * k2, u)
    k4 = f_cont(x + DT * k3, u)
    return x + (DT / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def make_spec(x_lin, u_lin):
    """The QP shape; the plant matrices carry the FIRST linearization
    (at ``(x_lin, u_lin)``), later steps relinearize on the device."""
    A, B = (j.numpy() for j in torch.func.jacrev(f_disc, (0, 1))(
        x_lin, u_lin))
    C = np.tile(np.array([[[1.0, 0.0]]], np.float32), (H, 1, 1))
    E = np.tile(np.eye(NS, dtype=np.float32)[None], (H, 1, 1))
    plant = LTVPlant(A=np.tile(A[None], (H, 1, 1)),
                     B=np.tile(B[None], (H, 1, 1)),
                     E=E, C=C, name="pendulum_ltv")
    return MPCSpec(
        plant=plant, horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.02 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-12.0], np.float32),
        u_max=np.array([12.0], np.float32),
        du_max=np.array([6.0], np.float32))


def solver_config():
    return SolverConfig(max_iters=20_000, check_every=8, accel_every=4,
                        y0=0.01, eaj=1e-3, erj=1e-4, erc=1e-4, eac=1e-4,
                        strict_weak_duality=False)


def run_device_loop(x0, steps, device):
    """RTIController.rollout: the whole closed loop (Jacobians +
    relinearize + solve + plant) on the controller's device."""
    ctrl = RTIController(f_disc, make_spec(torch.zeros(NS), torch.zeros(NU)),
                         cfg=solver_config(), sqp_iters=2, device=device)
    t0 = time.perf_counter()
    out = ctrl.rollout(x0, steps)
    dt = time.perf_counter() - t0
    traj = np.concatenate([np.asarray(x0)[None], out["x"]])
    return traj, out["u"][:, 0], out["iters"], dt


def run_eager(x0, steps, device):
    """The same algorithm spelled out eagerly (didactic; slow path)."""
    cfg = solver_config()
    x = torch.as_tensor(x0, device=device)
    u_prev = np.zeros(NU, np.float32)
    useq = torch.zeros((H, NU), device=device)   # running plan (shifted)
    traj, inputs, iters = [x.cpu().numpy()], [], []

    def nominal(x, useq):
        xs = []                                  # xbar_k = state ENTERING k
        for k in range(H):
            xs.append(x)
            x = f_disc(x, useq[k])
        return torch.stack(xs)

    def linearize(xbar, ubar):
        A, B = torch.func.vmap(torch.func.jacrev(f_disc, (0, 1)))(xbar, ubar)
        c = (torch.func.vmap(f_disc)(xbar, ubar)
             - torch.einsum("kij,kj->ki", A, xbar)
             - torch.einsum("kij,kj->ki", B, ubar))
        return A, B, c

    base = make_spec(torch.zeros(NS), torch.zeros(NU))
    t0 = time.perf_counter()
    for t in range(steps):
        # warm-start the SQP from the previous plan shifted one stage; two
        # relinearizations while the plan is far from the trajectory it
        # predicts, then the classic real-time-iteration single pass
        sqp_iters = 2 if t < 3 else 1
        useq = torch.cat([useq[1:], useq[-1:]])
        for _ in range(sqp_iters):
            xbar = nominal(x, useq)
            A, B, c = linearize(xbar, useq)
            plant = LTVPlant(A=A.cpu().numpy(), B=B.cpu().numpy(),
                             E=base.plant.E, C=base.plant.C,
                             name="pendulum_ltv")
            spec = MPCSpec(
                plant=plant, horizon=H, Qy=base.Qy, R=base.R, r=base.r,
                u_min=base.u_min, u_max=base.u_max, du_max=base.du_max,
                u_prev=u_prev)
            sd = stagewise_dual(spec, theta_floor=cfg.theta_floor,
                                device=device)
            res = solve_stagewise(sd, x[:, None], dseq=c[:, :, None],
                                  cfg=cfg)
            useq = res.U.reshape(H, NU)
        u0 = useq[0]
        x = f_disc(x, u0)                        # TRUE nonlinear plant
        u_prev = u0.cpu().numpy()
        traj.append(x.cpu().numpy())
        inputs.append(float(u0[0]))
        iters.append(int(res.iters.max()))
    dt = time.perf_counter() - t0
    return np.stack(traj), np.asarray(inputs), np.asarray(iters), dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=60)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps

    x0 = np.array([2.5, 0.0], np.float32)        # 143 degrees from upright
    run = run_eager if args.eager else run_device_loop
    traj, inputs, iters, dt = run(x0, steps, args.device)

    mode = "eager" if args.eager else "device loop (RTIController.rollout)"
    print(f"{steps} steps in {dt:.2f} s ({steps/dt:.1f} steps/s) [{mode}]")
    print(f"theta: start {traj[0, 0]:+.3f} rad -> final "
          f"{traj[-1, 0]:+.5f} rad  (|u| max {np.abs(inputs).max():.2f}, "
          f"solver iters mean {np.mean(iters):.0f})")
    if steps >= 30:
        assert abs(traj[-1, 0]) < 0.5, "pendulum not swinging up"
    if steps >= 60:
        assert abs(traj[-1, 0]) < 0.01 and abs(traj[-1, 1]) < 0.02, \
            "pendulum not stabilized"
        print("stabilized upright: OK")


if __name__ == "__main__":
    main()
