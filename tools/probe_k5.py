#!/usr/bin/env python3
"""Time kernel K5's layouts against each other on one GPU.

    python3 tools/probe_k5.py

On the resident distinct workload (B=1024, N=400, M=100, seed 0,
``chip_smoke.distinct_workload``; ``bench_distinct.py``'s configuration)
launches ``fused_full_solve_distinct`` with each layout forced: the Qd rows
resident in shared memory at 16, 8 and 4 blocks per instance, and streamed
from global memory at 16.  Each forced size is a build of its own
(``csrc/full_solve_distinct.cu`` with ``-DPQP_K5_SIZES=<C>``); the streamed
layout also hands the launcher a plan that says so.  Then builds K5 with its
registers capped for 2 and 3 blocks per SM (``-DPQP_K5_MIN_BLOCKS``; the
shipped build caps them for 4) and prints ptxas's registers and spills.
Every build is timed over two launches in turns (forward, then reversed)
beside the shipped one, with the card's active clusters, and checked for the
shipped build's lane states.  Needs a CUDA device and ``nvcc``; prints one
JSON line per build.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import distinct_kernel as dk  # noqa: E402

#: (name, resident, -D flags) of each build beside the shipped one
BUILDS = [("resident_16", True, ["-DPQP_K5_SIZES=16"]),
          ("resident_8", True, ["-DPQP_K5_SIZES=8"]),
          ("resident_4", True, ["-DPQP_K5_SIZES=4"]),
          ("streamed_16", False, ["-DPQP_K5_SIZES=16"]),
          ("min_blocks_2", True, ["-DPQP_K5_MIN_BLOCKS=2"]),
          ("min_blocks_3", True, ["-DPQP_K5_MIN_BLOCKS=3"])]


def build_variants(variants, entry_points, csrc=build.CSRC, select=None):
    """Build each ``(name, source, flags)`` of ``variants`` with
    ``csrc/pqp_iterations.cu`` (it carries ``pqp_error_string``, which
    ``build.check`` reads) into its own library, all ``nvcc`` started
    together: ``{name: (library, ptxas's register and spill lines)}`` —
    the first two such lines, or ``select(log)`` when given.  A source that
    is ``csrc/pqp_iterations.cu`` itself is built alone."""
    out = os.path.join(ROOT, ".build", "probes")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name, source, flags in variants:
        lib = os.path.join(out, f"{name}.so")
        srcs = {str(source), str(csrc / "pqp_iterations.cu")}
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", *flags, "-o",
               lib, *sorted(srcs)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(lib)
        for entry in entry_points:
            getattr(cdll, entry).argtypes = build.SIGNATURES[entry]
            getattr(cdll, entry).restype = ctypes.c_int
        cdll.pqp_error_string.argtypes = [ctypes.c_int]
        cdll.pqp_error_string.restype = ctypes.c_char_p
        libs[name] = (cdll, select(log) if select else
                      [ln.strip() for ln in log.splitlines()
                       if re.search(r"registers|spill", ln)][:2])
    return libs


def ptxas_lines(log: str, pattern: str) -> list:
    """ptxas's register, stack and spill lines for the functions whose
    mangled name matches ``pattern``, each prefixed with that name."""
    out, name = [], ""
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      ln)
        if m:
            name = m.group(1)
        elif re.search(r"registers|spill", ln) and re.search(pattern, name):
            out.append(f"{name}: {ln.strip()}")
    return out


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k5: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    cfg = pqp.SolverConfig(max_iters=20000, check_every=8, y0=1.0, erc=1e-4,
                           eac=1e-4, eaj=1e-3, erj=1e-4,
                           strict_weak_duality=False)
    primal = cs.distinct_workload(cs.B_DR, cs.M_DR, cs.N_DR, dev)
    dual = pqp.dualize_distinct(primal, theta_floor=cfg.theta_floor)
    args, kw = dk.distinct_inputs(primal, dual, None, cfg)
    plan = dk.k5_plan(cs.N_DR, cs.M_DR)
    base = dk.fused_full_solve_distinct(*args, **kw)
    print(json.dumps({"probe": "k5_plan", "plan": plan,
                      "card_pick": dk.card_cluster(cs.N_DR, cs.M_DR, cs.B_DR,
                                                   plan["resident"]),
                      "nvidia_smi": smi}), flush=True)
    src = build.CSRC / "full_solve_distinct.cu"
    libs = build_variants(
        [(name, src, flags) for name, _, flags in BUILDS],
        ("full_solve_distinct_f32", "full_solve_distinct_cluster"))
    libs["shipped"] = (build.load_library(), None)
    resident = {name: res for name, res, _ in BUILDS}
    resident["shipped"] = plan["resident"]
    names = ["shipped"] + [name for name, _, _ in BUILDS]
    real_load, real_plan = build.load_library, dk.k5_plan
    times = {name: [] for name in names}
    states, cards = {}, {}
    try:
        for order in (names, names[::-1]):
            for name in order:
                build.load_library = lambda _l=libs[name][0]: _l
                dk.k5_plan = lambda n, m, _r=resident[name]: dict(
                    real_plan(n, m), resident=_r)
                cards[name] = dk.card_cluster(cs.N_DR, cs.M_DR, cs.B_DR,
                                              resident[name])
                out, ms = cs.timed_once(
                    lambda: dk.fused_full_solve_distinct(*args, **kw))
                times[name].append(ms)
                states[name] = bool((out[3] == base[3]).all())
    finally:
        build.load_library, dk.k5_plan = real_load, real_plan
    for name in names:
        print(json.dumps({"probe": "k5_build", "build": name,
                          "resident": resident[name], "card": cards[name],
                          "ptxas": libs[name][1], "ms": times[name],
                          "states_equal_shipped": states[name],
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
