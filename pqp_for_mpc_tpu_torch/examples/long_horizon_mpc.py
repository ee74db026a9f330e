"""Long-horizon MPC with the matrix-free stage-wise backend.

A horizon-H receding-horizon loop through
``MPCController(backend="stagewise")`` — O(H) memory, tolerances set to
the horizon's float32 certification floor (``config.stagewise_mpc_config``)
and certify-or-recover cold retries for any step whose warm start fails
certification.

    python -m pqp_for_mpc_tpu_torch.examples.long_horizon_mpc [horizon]
        [steps] [--device cuda]
"""

import argparse
import time

import numpy as np

from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                          double_integrator)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("horizon", nargs="?", type=int, default=128)
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    H, steps = args.horizon, args.steps

    spec = MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    ctrl = MPCController(spec, backend="stagewise", warm_start="shift",
                         retry_cold=True, device=args.device)
    assert ctrl.data is None          # the condensed blocks never exist

    x0 = np.array([2.0, 0.0], np.float32)
    ctrl.rollout_jit(x0, steps=steps)                    # warm-up
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(x0, steps=steps)
    dt = time.perf_counter() - t0

    print(f"H={H}: {steps} steps in {dt:.3f}s "
          f"({steps / dt:.1f} steps/s), "
          f"certified {100 * out['converged'].mean():.0f}%, "
          f"mean {out['iters'].mean():.0f} iters/step, "
          f"|x_final| = {np.linalg.norm(out['x'][-1]):.3f}")


if __name__ == "__main__":
    main()
