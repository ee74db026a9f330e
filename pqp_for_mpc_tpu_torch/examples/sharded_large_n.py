"""Tensor-parallel solve of a long-horizon condensed MPC problem.

Row-shards the N x N dual Hessian across the ``model`` mesh axis and the
scenario batch across ``data``, one process per device, started by
``torchrun`` (``initialize()`` reads its environment):

    python -m torch.distributed.run --standalone --nproc_per_node=1 \
        -m pqp_for_mpc_tpu_torch.examples.sharded_large_n [--device cuda]

``--nproc_per_node=8 ... --device cpu`` tries it on a gloo ring of CPU
processes.  Rank 0 prints the statistics of the whole batch.
"""

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as tdist

from pqp_for_mpc_tpu_torch import SolverConfig, dualize
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, random_stable
from pqp_for_mpc_tpu_torch.parallel import solve_row_sharded
from pqp_for_mpc_tpu_torch.parallel.distributed import (global_mesh,
                                                        initialize)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = initialize(device=args.device)
    try:
        n_dev = tdist.get_world_size()
        model = 4 if n_dev >= 8 else (2 if n_dev >= 2 else 1)
        mesh = global_mesh(model=model)
        dp = mesh.size(0)
        if tdist.get_rank() == 0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

        plant = random_stable(12, 4, seed=7)
        spec = MPCSpec(
            plant=plant, horizon=50,        # -> M=200 vars, N=800 constraints
            Qy=np.eye(plant.n_output, dtype=np.float32),
            R=0.1 * np.eye(4, dtype=np.float32),
            r=np.zeros(plant.n_output, np.float32),
            u_min=-2 * np.ones(4, np.float32),
            u_max=2 * np.ones(4, np.float32),
            du_max=np.ones(4, np.float32))
        data = condense(spec, device=device)

        B = 8 * dp
        rng = np.random.default_rng(0)      # the same batch on every rank
        x = torch.as_tensor(rng.uniform(-0.5, 0.5, (12, B)).astype(
            np.float32), device=device)
        primal = data.assemble(
            x=x, D=(torch.zeros(50, device=device) if plant.n_dist == 1
                    else None), Qp=data.qp())
        cfg = SolverConfig(erc=1e-4, eac=1e-4, eaj=1e-3, erj=1e-3, y0=0.01,
                           check_every=8, accel_every=4,
                           strict_weak_duality=False, max_iters=50_000)
        dual = dualize(primal, theta_floor=cfg.theta_floor)
        res = solve_row_sharded(primal, dual, cfg=cfg, mesh=mesh)

        # the whole batch's per-lane vectors: the lanes of the model
        # coordinate 0 ranks, in data order
        def whole(v):
            parts = [torch.empty_like(v) for _ in range(n_dev)]
            tdist.all_gather(parts, v.contiguous())
            return torch.cat(parts[::mesh.size(1)])

        res = dataclasses.replace(res, **{
            f: whole(getattr(res, f))
            for f in ("iters", "converged", "feasible", "Jp", "Jd")})
        if tdist.get_rank() == 0:
            print(res.stats())
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
