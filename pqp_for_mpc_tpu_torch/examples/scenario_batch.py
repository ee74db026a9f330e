"""Monte-Carlo scenario fan-out: solve the MPC QP for thousands of initial
states at once.

The workload is the repository's example benchmark
(``pqp_for_mpc_tpu_torch.bench.example_workload``: the double integrator
condensed at horizon 7, M = 7 inputs, N = 28 dual constraints, x0 ~
N(0, 0.5^2) from seed 0) under its configuration ``EXAMPLE_CFG``, solved
on the card by ``solve_fused`` (the whole-solve kernel) and on the CPU by
the plain ``solve_batched``.

    python -m pqp_for_mpc_tpu_torch.examples.scenario_batch [batch]
        [--device cuda]
"""

import argparse
import time

import torch

from pqp_for_mpc_tpu_torch.bench import EXAMPLE_CFG, example_workload
from pqp_for_mpc_tpu_torch.problem import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    B = args.batch
    device = resolve_device(args.device)
    primal, dual = example_workload(B, device)
    if device.type == "cuda":
        from pqp_for_mpc_tpu_torch.ops.solve_kernel import \
            solve_fused as solve_b
    else:
        from pqp_for_mpc_tpu_torch.solver import solve_batched as solve_b

    res = solve_b(primal, dual, cfg=EXAMPLE_CFG)         # warm-up (build)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = solve_b(primal, dual, cfg=EXAMPLE_CFG)
    res.U.sum().item()                                   # the fence
    dt = time.perf_counter() - t0
    print(res.stats())
    print(f"{B} scenarios in {dt*1e3:.1f} ms -> {B/dt:,.0f} solves/s")


if __name__ == "__main__":
    main()
