"""Output-feedback nonlinear MPC: NonlinearMHE + RTI.

A torque-limited UPRIGHT pendulum (unstable) is stabilized from noisy
ANGLE-ONLY measurements.  Per control step: a moving-horizon estimate
from the last N measurements (the estimation window relinearized along
the estimated trajectory, the constrained noise QP solved matrix-free),
then a real-time-iteration control step from the estimate, the true
nonlinear propagation under process noise and a noisy measurement into
the window; :func:`~pqp_for_mpc_tpu_torch.models.rti.
output_feedback_rollout` keeps the whole loop on the device.

    python -m pqp_for_mpc_tpu_torch.examples.output_feedback_nonlinear_mpc
        [steps] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.models import (LTVPlant, MPCSpec, NonlinearMHE,
                                          RTIController,
                                          output_feedback_rollout)

DT, G, B_DAMP = 0.05, 9.81, 0.2
NS, NU, NY = 2, 1, 1


def f_cont(x, u):
    th, om = x[0], x[1]
    return torch.stack([om, G * torch.sin(th) - B_DAMP * om + u[0]])


def f_disc(x, u):
    k1 = f_cont(x, u)
    k2 = f_cont(x + 0.5 * DT * k1, u)
    k3 = f_cont(x + 0.5 * DT * k2, u)
    k4 = f_cont(x + DT * k3, u)
    return x + DT / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps
    H, N = 24, 8
    A0, B0 = (j.numpy() for j in torch.func.jacrev(f_disc, (0, 1))(
        torch.zeros(NS), torch.zeros(NU)))
    C = np.array([[1.0, 0.0]], np.float32)      # measure the angle only
    plant = LTVPlant(
        A=np.broadcast_to(A0, (H, NS, NS)).astype(np.float32),
        B=np.broadcast_to(B0, (H, NS, NU)).astype(np.float32),
        E=np.broadcast_to(np.eye(NS), (H, NS, NS)).astype(np.float32),
        C=np.broadcast_to(C, (H, NY, NS)).astype(np.float32))
    spec = MPCSpec(plant=plant, horizon=H,
                   Qy=np.eye(NY, dtype=np.float32),
                   R=0.05 * np.eye(NU, dtype=np.float32),
                   r=np.zeros(NY, np.float32),
                   u_min=np.array([-12.0], np.float32),
                   u_max=np.array([12.0], np.float32),
                   du_max=np.array([10.0], np.float32))
    rti = RTIController(f_disc, spec, sqp_iters=1, device=args.device)

    w_sd = np.array([0.001, 0.005])
    v_sd = 0.01
    mhe = NonlinearMHE(f_disc, C, window=N, Qw=np.diag(w_sd ** 2),
                       Rv=np.array([[v_sd ** 2]]), u_lin=np.zeros(NU),
                       w_min=-5 * w_sd, w_max=5 * w_sd, device=args.device)

    rng = np.random.default_rng(1)
    w_seq = rng.normal(0, w_sd, (steps + N, NS)).astype(np.float32)
    v_seq = rng.normal(0, v_sd, (steps + N, NY)).astype(np.float32)
    x0 = np.array([0.15, 0.0], np.float32)

    t0 = time.perf_counter()
    out = output_feedback_rollout(rti, mhe, x0, steps, w_seq, v_seq)
    wall = time.perf_counter() - t0

    tail = np.abs(out["x"][-5:])
    err = np.sqrt(((out["x_hat"][steps // 3:]
                    - out["x"][steps // 3:]) ** 2).mean(0))
    ok = tail[:, 0].max() < 0.05 and out["conv_mhe"].all() \
        and out["conv_rti"].all()
    print(f"{steps} output-feedback steps in {wall:.1f}s (one closed loop "
          f"on the device)")
    print(f"certified: mhe {out['conv_mhe'].mean():.0%} / "
          f"rti {out['conv_rti'].mean():.0%}; iters/step "
          f"mhe {out['iters_mhe'].mean():.0f} / "
          f"rti {out['iters_rti'].mean():.0f}")
    print(f"estimation RMSE (post-transient): theta {err[0]:.4f}, "
          f"omega {err[1]:.4f}")
    print(f"final |x| = {tail.max(axis=0).round(4)}")
    print("stabilized upright from angle-only measurements:",
          "OK" if ok else "FAILED")


if __name__ == "__main__":
    main()
