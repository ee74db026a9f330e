"""Learning-based MPC: tune the input weight R by gradient descent
THROUGH the QP solver (implicit differentiation of the KKT system,
``solve_qp_implicit``).  A scalar input weight is tuned so that the
one-step optimal input matches a target input.

    python -m pqp_for_mpc_tpu_torch.examples.differentiable_mpc
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
    H = 8
    cfg = SolverConfig(max_iters=100_000, check_every=4, accel_every=4,
                       y0=0.1, strict_weak_duality=False,
                       eaj=1e-5, erj=1e-6)
    u_target = -0.6

    spec = MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=np.eye(1, dtype=np.float32),   # placeholder, replaced below
        r=np.zeros(1, np.float32),
        u_min=-np.ones(1, np.float32), u_max=np.ones(1, np.float32),
        du_max=np.ones(1, np.float32))
    data = condense(spec, device=args.device)    # independent of log_r
    dev = data.Qp_inv.device
    Qp0 = data.qp()
    x0 = torch.tensor([1.5, 0.0], device=dev)

    def first_input(log_r):
        # Qp = 2(S'QS + R I): adjust the R part differentiably
        Qp = Qp0 + 2.0 * (torch.exp(log_r) - 1.0) * torch.eye(H, device=dev)
        primal = data.assemble(x=x0, D=torch.zeros(H, device=dev), Qp=Qp)
        U = solve_qp_implicit(Qp, primal.Fp, primal.Gp, primal.Kp, cfg)
        return U[0]

    log_r = torch.zeros((), device=dev)
    for _ in range(30):
        log_r = log_r.detach().requires_grad_()
        ((first_input(log_r) - u_target) ** 2).backward()
        log_r = log_r - 0.5 * log_r.grad
    log_r = log_r.detach()
    with torch.no_grad():
        u = float(first_input(log_r))
    print(f"tuned R = {float(torch.exp(log_r)):.4f}; "
          f"first input {u:+.4f} (target {u_target:+.1f})")
    assert abs(u - u_target) < 0.05


if __name__ == "__main__":
    main()
