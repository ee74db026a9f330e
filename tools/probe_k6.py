#!/usr/bin/env python3
"""Time kernel K6's register budgets against each other on one GPU.

    python3 tools/probe_k6.py [--parent DIR]

On the streamed distinct workload (B=8, N=2048, M=512, gaussian Gp, seed 0,
``chip_smoke.distinct_workload``; ``bench_mixed.py --distinct --accel``'s
configuration) launches ``fused_full_solve_distinct_tiled`` from builds of
``csrc/full_solve_distinct_tiled.cu`` with its registers capped for 1 and 2
blocks per SM (``-DPQP_K6_MIN_BLOCKS``) and, with ``--parent``, from the
same source in DIR (another commit's ``csrc/``, e.g. unpacked with ``git
archive``), beside the shipped build: three launches each, in turns
(forward, then reversed).  Prints ptxas's registers and spills and whether
each build gives the shipped build's bits.  Needs a CUDA device and
``nvcc``; prints one JSON line per build.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import distinct_tiled_kernel as dtk  # noqa: E402
from probe_k5 import build_variants, smi_line  # noqa: E402

ENTRY = "full_solve_distinct_tiled_f32"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k6: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    cfg = pqp.SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                           strict_weak_duality=False,
                           gap_from_complementarity=True, erc=1e-6, eac=1e-6,
                           eaj=1e-6, erj=1e-6)
    primal = cs.distinct_workload(cs.B_DS, cs.M_DS, cs.N_DS, dev,
                                  gaussian_gp=True)
    dual = dataclasses.replace(
        pqp.dualize_distinct(primal, theta_floor=cfg.theta_floor),
        Qdp_theta=None, Qdn_theta=None)
    args, kw = dtk.distinct_tiled_inputs(primal, dual, None, cfg)
    base = dtk.fused_full_solve_distinct_tiled(*args, **kw)
    src = build.CSRC / "full_solve_distinct_tiled.cu"
    libs = build_variants(
        [(f"k6_min_blocks_{mb}", src, [f"-DPQP_K6_MIN_BLOCKS={mb}"])
         for mb in (1, 2)], (ENTRY,))
    if opts.parent:
        parent = Path(opts.parent).resolve()
        libs.update(build_variants(
            [("k6_parent", parent / "full_solve_distinct_tiled.cu", [])],
            (ENTRY,), csrc=parent))
    libs["shipped"] = (build.load_library(), None)
    names = ["shipped"] + sorted(k for k in libs if k != "shipped")
    real_load = build.load_library
    times = {name: [] for name in names}
    same = {}
    try:
        for order in (names, names[::-1]):
            for name in order:
                build.load_library = lambda _l=libs[name][0]: _l
                times[name].append(cs.cuda_ms(
                    lambda: dtk.fused_full_solve_distinct_tiled(*args, **kw),
                    3))
                out = dtk.fused_full_solve_distinct_tiled(*args, **kw)
                same[name] = all(bool((a == b).all())
                                 for a, b in zip(out, base))
    finally:
        build.load_library = real_load
    for name in names:
        print(json.dumps({"probe": "k6_build", "build": name,
                          "ptxas": libs[name][1], "ms": times[name],
                          "bits_equal_shipped": same[name],
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
