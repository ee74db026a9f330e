"""Output-constrained MPC through the matrix-free stage-wise backend.

Hard OUTPUT bounds ``|y_k| <= y_max`` over the whole horizon, run
matrix-free at a long horizon.  The setpoint sits ABOVE the bound, so the
optimal trajectory must ride the constraint instead of settling at the
reference.

    python -m pqp_for_mpc_tpu_torch.examples.constrained_outputs_mpc
        [horizon] [steps] [--device cuda]
"""

import argparse
import time

import numpy as np

from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                          double_integrator)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("horizon", nargs="?", type=int, default=128)
    ap.add_argument("steps", nargs="?", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    H, steps = args.horizon, args.steps
    y_max = 1.9

    spec = MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.full(1, 2.5, np.float32),          # setpoint ABOVE the bound
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32),
        y_min=np.array([-y_max], np.float32),
        y_max=np.array([y_max], np.float32))
    ctrl = MPCController(spec, backend="stagewise", warm_start="shift",
                         retry_cold=True, device=args.device)
    assert ctrl.data is None          # the condensed blocks never exist

    x0 = np.array([0.0, 0.0], np.float32)
    ctrl.rollout_jit(x0, steps=steps)                    # warm-up
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(x0, steps=steps)
    dt = time.perf_counter() - t0

    y = out["x"][:, 0]
    print(f"H={H}, |y| <= {y_max}, setpoint 2.5: {steps} steps in "
          f"{dt:.3f}s ({steps / dt:.1f} steps/s), "
          f"certified {100 * out['converged'].mean():.0f}%, "
          f"y peak {y.max():.4f} (bound honored: {y.max() <= y_max + 1e-3}), "
          f"y final {y[-1]:.3f} (riding the active bound)")


if __name__ == "__main__":
    main()
