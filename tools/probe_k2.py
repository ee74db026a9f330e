#!/usr/bin/env python3
"""Time kernel K2 against another build of it on one GPU.

    python3 tools/probe_k2.py [--parent DIR]

On the main path's batch (M=7/N=28 at B=2^22, seed 0, ``chip_smoke.
workload``) runs 8 updates of ``fused_pqp_iterations`` (per-lane forcing
panels, as the K2 route hands them) from the shipped build and, with
``--parent``, from ``pqp_iterations.cu`` in DIR (another commit's
``csrc/``, e.g. unpacked with ``git archive``, or an edited copy of this
one's: the thread tile is the constants ``R`` and ``L``): ten launches
each, in turns (forward, then reversed).  Prints ptxas's registers and
spills and whether each build gives the shipped build's bits.  Needs a CUDA device and ``nvcc``; prints one JSON
line per build.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pqp_for_mpc_tpu_torch.bench import example_workload  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build, kernels  # noqa: E402
from probe_k5 import build_variants, ptxas_lines, smi_line  # noqa: E402

ENTRY = "pqp_iterations_f32"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    _, dual = example_workload(cs.B_MAIN, dev)
    Y = torch.as_tensor(np.random.default_rng(3).uniform(
        0.01, 10.0, (dual.n_con, cs.B_MAIN)).astype(np.float32), device=dev)
    args = (dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Y)
    kw = dict(num_iters=8, den_eps=1e-30)
    print(json.dumps({"probe": "k2_plan", "plan": kernels.k2_plan(
        dual.n_con, cs.B_MAIN), "nvidia_smi": smi}), flush=True)
    select = lambda log: ptxas_lines(log, "pqp_iterations_kernel")
    libs = {"shipped": (build.load_library(), select(
        Path(str(build.library_path()) + ".log").read_text()))}
    if opts.parent:
        parent = Path(opts.parent).resolve()
        libs.update(build_variants(
            [("k2_parent", parent / "pqp_iterations.cu", [])], (ENTRY,),
            csrc=parent, select=select))
    names = list(libs)
    base = kernels.fused_pqp_iterations(*args, **kw)
    real_load = build.load_library
    times = {name: [] for name in names}
    same = {}
    try:
        for order in (names, names[::-1]):
            for name in order:
                build.load_library = lambda _l=libs[name][0]: _l
                times[name].append(cs.cuda_ms(
                    lambda: kernels.fused_pqp_iterations(*args, **kw), 10))
                same[name] = bool((kernels.fused_pqp_iterations(*args, **kw)
                                   == base).all())
    finally:
        build.load_library = real_load
    for name in names:
        print(json.dumps({"probe": "k2_build", "build": name,
                          "ptxas": libs[name][1], "ms": times[name],
                          "bits_equal_shipped": same[name],
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
