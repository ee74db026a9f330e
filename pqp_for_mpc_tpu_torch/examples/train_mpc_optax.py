"""Batched learning-based MPC: Adam training through the QP solver.

Scales ``learned_mpc_closed_loop`` to a SCENARIO BATCH: the loss is the
mean closed-loop cost over a batch of initial states; every step of the
rollout solves the whole batch at once (``torch.func.vmap`` of
``solve_qp_implicit``: one batched solve, one batched KKT backward).  The
JAX example's ``optax.chain(clip_by_global_norm(5.0), adam(0.1))`` is
``clip_grad_norm_(params, 5.0)`` then ``torch.optim.Adam(lr=0.1)`` here.

Learned parameters: the log actuation weight AND a per-stage log
tracking-weight profile — 1 + H parameters, trained jointly.  The plant's
"true" actuation price differs from the controller's initial guess, so
the optimum moves both.

    python -m pqp_for_mpc_tpu_torch.examples.train_mpc_optax [batch]
        [steps] [--device cuda]
"""

import argparse

import numpy as np
import torch

from pqp_for_mpc_tpu_torch import SolverConfig, solve_qp_implicit
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, double_integrator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("steps", nargs="?", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batch, train_steps = args.batch, args.steps
    plant = double_integrator()
    H, rollout_len = 8, 15
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

    rng = np.random.default_rng(0)
    X0 = torch.as_tensor(np.stack([rng.uniform(0.8, 2.0, batch),
                                   rng.uniform(-0.5, 0.5, batch)]),
                         dtype=torch.float32, device=dev)   # (2, batch)

    def loss(log_r, log_stage):
        # controller Hessian: the condensed Qp's R-contribution is the +2I
        # diagonal block; swapping it for learned per-stage weights
        # 2*r_w*stage_i keeps Qp PD for ANY positive weights
        Qp = Qp0 + torch.diag(2.0 * (torch.exp(log_r)
                                     * torch.exp(log_stage) - 1.0))
        x, total = X0, 0.0
        for _ in range(rollout_len):
            primal = data.assemble(x=x, D=torch.zeros(H, batch, device=dev),
                                   Qp=Qp)
            U = torch.func.vmap(lambda fp: solve_qp_implicit(
                Qp, fp, primal.Gp, primal.Kp, cfg))(primal.Fp.T)  # (B, H)
            u0 = U[:, :1].T                                      # (1, B)
            x = A @ x + Bm @ u0
            # TRUE plant economics: position error + actual actuation price
            total = total + x[0] ** 2 + 0.4 * u0[0] ** 2
        return total.mean()

    params = [torch.log(torch.tensor(0.05, device=dev)).requires_grad_(),
              torch.zeros(H, device=dev, requires_grad=True)]
    opt = torch.optim.Adam(params, lr=0.1)
    hist = []
    for it in range(train_steps):
        opt.zero_grad()
        val = loss(*params)
        val.backward()
        torch.nn.utils.clip_grad_norm_(params, 5.0)
        opt.step()
        hist.append(float(val.detach()))
        if it % 5 == 0:
            print(f"step {it:3d}  loss {hist[-1]:.5f}  "
                  f"R={float(torch.exp(params[0].detach())):.3f}")
    print(f"loss {hist[0]:.5f} -> {hist[-1]:.5f} over {batch} scenarios "
          f"({train_steps} adam steps)")
    assert hist[-1] < hist[0], "training loss must decrease"
    return hist


if __name__ == "__main__":
    main()
