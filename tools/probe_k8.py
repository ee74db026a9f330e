#!/usr/bin/env python3
"""Probe the H=16 closed loop and K8's accelerated states on one GPU.

    python3 tools/probe_k8.py

1. Times the H=16 closed loop (``bench.example_spec(16, 0.0)``, 200
   steps) through ``rollout_jit`` and ``rollout`` in turns, then profiles
   50 steps of each with ``torch.profiler``: kernel launches, device time,
   host syncs.
2. Counts, for the accelerated H=16 workload (MPC_CONFIG without the
   dual-gradient certificate), the lanes where K8 and its plain version
   (and K1 and its plain version) end in different states.

K8 launches K1's lane-tile engine; ``tools/probe_k1.py`` times both
kernels.  Needs a CUDA device and ``nvcc``; prints one line per
measurement.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pqp_for_mpc_tpu_torch.bench import example_spec, example_workload  # noqa: E402
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG  # noqa: E402
from pqp_for_mpc_tpu_torch.models import MPCController  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import packed_kernel as pk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import solve_kernel as sk  # noqa: E402

def closed_loop(dev) -> None:
    from torch.profiler import ProfilerActivity, profile
    for rnd in range(2):
        for name in (("rollout_jit", "rollout") if rnd == 0
                     else ("rollout", "rollout_jit")):
            ctrl = MPCController(example_spec(16, 0.0), device=dev)
            getattr(ctrl, name)([2.0, 0.0], 5)
            ctrl.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(ctrl, name)([2.0, 0.0], cs.LOOP_STEPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print("loop", name, "steps/s", cs.LOOP_STEPS / dt, "iters mean",
                  float(out["iters"].mean()), flush=True)
    steps = 50
    for name in ("rollout_jit", "rollout"):
        ctrl = MPCController(example_spec(16, 0.0), device=dev)
        getattr(ctrl, name)([2.0, 0.0], 5)
        ctrl.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            getattr(ctrl, name)([2.0, 0.0], steps)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ka = prof.key_averages()
        launches = sum(e.count for e in ka if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        syncs = sum(e.count for e in ka if "Synchronize" in e.key)
        # the table's own total of kernel time (summing the averages would
        # count each kernel under its operator too)
        device_ms = float(re.search(r"Self CUDA time total: ([0-9.]+)ms",
                                    ka.table(row_limit=1)).group(1))
        print("profile", name, "steps", steps, "launches per step",
              launches / steps, "device ms per step", device_ms / steps,
              "wall ms per step (profiled)", 1e3 * wall / steps,
              "host syncs", syncs, flush=True)


def accel_states(dev) -> None:
    cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False)
    for B, r in ((2048, 2.5), (4096, 2.5), (4096, 0.0)):
        primal, dual = example_workload(B, dev, horizon=16, r=r)
        a, k = sk.fused_inputs(primal, dual, None, cfg)
        o8 = pk.fused_full_solve_packed(*a, **k)
        p8 = pk.fused_full_solve_packed_reference(*a, **k)
        o1 = sk.fused_full_solve(*a, **k)
        p1 = sk.fused_full_solve_reference(*a, **k)
        lanes = torch.nonzero(o8[3] != p8[3]).flatten().tolist()
        print("accel H=16 B", B, "r", r, "K8 vs plain: lanes", lanes,
              "(kernel state, plain state)",
              [(int(o8[3][i]), int(p8[3][i])) for i in lanes],
              "| K1 vs plain:", int((o1[3] != p1[3]).sum()),
              "| K8 vs K1:", int((o8[3] != o1[3]).sum()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k8: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    closed_loop(dev)
    accel_states(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
