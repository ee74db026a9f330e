#!/usr/bin/env python3
"""Time kernel K3's bf16 tile plans against each other on one GPU.

    python3 tools/probe_k3.py

On the streamed workload (N=4096, M=1024, B=128, seed 0,
``chip_smoke.streamed_workload``) runs 16 bf16-mode updates of
``streamed_pqp_iterations`` with each (tile rows, tile lanes) forced, in
turns (forward, then reversed), and checks that every plan gives the
shipped plan's bits (each output entry's tensor-core sums run in the
same order whatever the tiling).  Needs a CUDA device and ``nvcc``; prints
one JSON line per plan.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import tiled_kernel as tk  # noqa: E402

PLANS = [(64, 64), (32, 64), (16, 64)]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k3: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _, dual = cs.streamed_workload(dev)
    Y = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 2.0, (cs.N_BIG, cs.B_BIG)).astype(np.float32), device=dev)
    Q, th = tk.streamed_matrix(dual.Qd, dual.theta, "bfloat16")
    args = (Q, th, dual.Fdn, dual.Fdp, Y)
    kw = dict(num_iters=16, den_eps=1e-30)
    base = tk.streamed_pqp_iterations(*args, **kw)
    print(json.dumps({"probe": "k3_plan",
                      "plan": tk.k3_bf16_plan(cs.N_BIG, cs.B_BIG),
                      "nvidia_smi": smi}), flush=True)
    real_plan = tk.k3_bf16_plan
    times = {p: [] for p in PLANS}
    same = {}
    try:
        for order in (PLANS, PLANS[::-1]):
            for rows, lanes in order:
                tk.k3_bf16_plan = lambda n, B, _r=rows, _l=lanes: dict(
                    tile_rows=_r, tile_lanes=_l)
                times[(rows, lanes)].append(cs.cuda_ms(
                    lambda: tk.streamed_pqp_iterations(*args, **kw), 5))
                same[(rows, lanes)] = bool(
                    (tk.streamed_pqp_iterations(*args, **kw) == base).all())
    finally:
        tk.k3_bf16_plan = real_plan
    for p in PLANS:
        print(json.dumps({"probe": "k3_tile", "tile_rows": p[0],
                          "tile_lanes": p[1],
                          "ms_per_16_updates": times[p],
                          "bits_equal_shipped": same[p],
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
