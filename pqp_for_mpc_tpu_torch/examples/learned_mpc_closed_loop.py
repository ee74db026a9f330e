"""End-to-end differentiable MPC: tune the controller's input weight by
gradient descent through a FULL closed-loop rollout (a loop over steps,
the implicit-differentiation QP solve inside every step).

The gradient flows: closed-loop cost <- rollout <- U*(QP) <- implicit KKT
differentiation <- cost weight.  One backward pass per iteration gives
both the cost and its gradient.

    python -m pqp_for_mpc_tpu_torch.examples.learned_mpc_closed_loop
        [--device cuda]
"""

import argparse

import numpy as np
import torch

from pqp_for_mpc_tpu_torch import SolverConfig, solve_qp_implicit
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, double_integrator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plant = double_integrator()
    H, steps = 8, 25
    spec = MPCSpec(
        plant=plant, horizon=H,
        Qy=np.eye(1, dtype=np.float32), R=np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=-np.ones(1, np.float32), u_max=np.ones(1, np.float32),
        du_max=np.ones(1, np.float32))
    data = condense(spec, device=args.device)
    dev = data.Qp_inv.device
    Qp0 = data.qp()
    A = torch.as_tensor(plant.A, device=dev)
    Bm = torch.as_tensor(plant.B, device=dev)
    cfg = SolverConfig(max_iters=50_000, check_every=4, accel_every=4,
                       y0=0.1, strict_weak_duality=False,
                       eaj=1e-5, erj=1e-6)

    def closed_loop_cost(log_r):
        Qp = Qp0 + 2.0 * (torch.exp(log_r) - 1.0) * torch.eye(H, device=dev)
        x = torch.tensor([1.5, 0.0], device=dev)
        total = 0.0
        for _ in range(steps):
            primal = data.assemble(x=x, D=torch.zeros(H, device=dev), Qp=Qp)
            U = solve_qp_implicit(Qp, primal.Fp, primal.Gp, primal.Kp, cfg)
            u0 = U[:1]
            x = A @ x + Bm @ u0
            # true plant cost: position error + ACTUAL actuation price
            total = total + x[0] ** 2 + 0.4 * u0[0] ** 2
        return total

    log_r = torch.log(torch.tensor(0.05, device=dev))  # far from the truth
    hist = []
    for _ in range(40):
        log_r = log_r.detach().requires_grad_()
        val = closed_loop_cost(log_r)
        val.backward()
        hist.append(float(val.detach()))
        # clipped step: the landscape has sharp curvature near R=1
        log_r = log_r - 0.2 * torch.clamp(log_r.grad, -2.0, 2.0)
    log_r = log_r.detach()
    with torch.no_grad():
        final = float(closed_loop_cost(log_r))
    print(f"closed-loop cost {hist[0]:.4f} -> {final:.4f} "
          f"(tuned R = {float(torch.exp(log_r)):.3f}; the true actuation "
          f"price in the rollout cost is 0.4)")
    assert final < hist[0] - 0.5


if __name__ == "__main__":
    main()
