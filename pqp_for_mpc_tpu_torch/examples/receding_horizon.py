"""Receding-horizon MPC closed loop on the device (``rollout_jit``): the
plant, the constraint rebuild and the warm-started PQP solve for every
step, kept on the controller's device.

    python -m pqp_for_mpc_tpu_torch.examples.receding_horizon [steps]
        [--device cuda]
"""

import argparse
import time

import numpy as np

from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                          double_integrator)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps
    spec = MPCSpec(
        plant=double_integrator(), horizon=16,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    ctrl = MPCController(spec, device=args.device)

    x0 = np.array([2.0, 0.0], np.float32)
    ctrl.rollout_jit(x0, steps=steps)                    # warm-up
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(x0, steps=steps)
    dt = time.perf_counter() - t0
    print(f"{steps} steps in {dt:.3f} s ({steps/dt:,.0f} steps/s); "
          f"final x = {out['x'][-1].round(4)}; "
          f"solver iters mean {out['iters'].mean():.0f} "
          f"max {out['iters'].max()}; all converged: "
          f"{bool(out['converged'].all())}")


if __name__ == "__main__":
    main()
