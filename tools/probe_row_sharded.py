#!/usr/bin/env python3
"""Split the cost of ``solve_row_sharded``'s float32 and bf16 phases on
one GPU.

    python3 tools/probe_row_sharded.py

On the streamed workload (N=4096, M=1024, B=128, seed 0,
``chip_smoke.streamed_workload``), on a 1 x 1 mesh of a one-rank NCCL
group:

* the update's (N, N) @ (N, B) product on the dual's own split, on ``Qd``
  and on the bf16-rounded ``Qd`` kept in float32, with a float32 and a
  bf16-rounded ``Y`` (CUDA events, mean of 50): whether a product's time
  depends on its values;
* ten checks of each phase (``max_iters`` = 160, nothing certifies):
  milliseconds of the whole call (CUDA events) and, under
  ``torch.profiler``, the host's CPU time and the card's time by operator,
  so the time per update splits into host and device.

Needs a CUDA device; builds no kernel.  Prints the times and one profiler
table per phase.
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
from pqp_for_mpc_tpu_torch.parallel import (make_mesh,  # noqa: E402
                                            solve_row_sharded)
from pqp_for_mpc_tpu_torch.parallel.distributed import initialize  # noqa


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_row_sharded: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    lp, ld = cs.streamed_workload(dev)
    Y = torch.rand(cs.N_BIG, cs.B_BIG, device=dev) + 0.5
    Qbf = ld.Qd.to(torch.bfloat16).float()
    Qn = torch.clamp(-Qbf, min=0.0)
    Ybf = Y.bfloat16().float()
    for name, fn in (("Qdn_theta @ Y", lambda: ld.Qdn_theta @ Y),
                     ("Qd @ Y", lambda: ld.Qd @ Y),
                     ("Qn_bf(f32) @ Y", lambda: Qn @ Y),
                     ("Qn_bf(f32) @ Ybf(f32)", lambda: Qn @ Ybf),
                     ("Qdn_theta @ Ybf(f32)", lambda: ld.Qdn_theta @ Ybf),
                     ("Qbf(f32) @ Y", lambda: Qbf @ Y)):
        print(name, "ms", cs.cuda_ms(fn, 50), flush=True)
    cfg = pqp.SolverConfig(max_iters=160, check_every=16, accel_every=16,
                           strict_weak_duality=False,
                           gap_from_complementarity=True, eaj=-1.0)
    with tempfile.TemporaryDirectory() as tmp:
        initialize(init_method=f"file://{tmp}/store", num_processes=1,
                   process_id=0, device=dev)
        try:
            mesh = make_mesh(data=1, model=1)
            for mixed in (False, True):
                run = lambda: solve_row_sharded(lp, ld, cfg=cfg, mesh=mesh,
                                                mixed=mixed)
                ms = cs.cuda_ms(run, 1)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                print("mixed" if mixed else "float32", "ms", ms, flush=True)
                print(prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=14), flush=True)
        finally:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
