"""Offset-free output-feedback MPC under an unmeasured disturbance.

A constant unmodeled input disturbance pushes a nominal MPC loop off its
setpoint.  The offset-free loop estimates the disturbance jointly with
the state, recomputes the steady-state target each step and solves the
QP in deviation coordinates, the whole closed loop (estimate -> targets
-> solve -> actuate -> measure) kept on the device
(``OffsetFreeController.rollout_jit``).

    python -m pqp_for_mpc_tpu_torch.examples.offset_free_mpc [steps]
        [--device cuda]
"""

import argparse
import time

import numpy as np

from pqp_for_mpc_tpu_torch.models import (MPCSpec, OffsetFreeController,
                                          double_integrator)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps
    spec = MPCSpec(
        plant=double_integrator(), horizon=20,
        Qy=np.eye(1, dtype=np.float32),
        R=0.1 * np.eye(1, dtype=np.float32),
        r=np.array([1.0], np.float32),        # track position 1.0
        u_min=np.array([-2.0], np.float32),
        u_max=np.array([2.0], np.float32),
        du_max=np.array([1.0], np.float32))
    d_true = np.array([0.3], np.float32)      # unmeasured actuator bias

    ofc = OffsetFreeController(spec, kind="input", device=args.device)
    ofc.rollout_jit(np.zeros(2, np.float32), steps, d_true)    # warm-up
    t0 = time.perf_counter()
    out = ofc.rollout_jit(np.zeros(2, np.float32), steps, d_true)
    dt = time.perf_counter() - t0

    y_err = abs(float(out["y"][-1, 0]) - 1.0)
    print(f"{steps} output-feedback steps in {dt:.3f} s "
          f"({steps/dt:,.0f} steps/s)")
    print(f"final |y - r| = {y_err:.2e} (offset-free) ; "
          f"d_hat = {float(out['d_hat'][-1, 0]):+.4f} "
          f"(true {float(d_true[0]):+.4f})")
    print(f"solver iters mean {out['iters'].mean():.0f} "
          f"max {out['iters'].max()}; all converged: "
          f"{bool(out['converged'].all())}")


if __name__ == "__main__":
    main()
