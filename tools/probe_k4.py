#!/usr/bin/env python3
"""Time kernel K4 (the streamed whole solve) against another build of it on
one GPU, and hold each build to the plain version.

    python3 tools/probe_k4.py [--parent DIR] [--rounds R]

On the streamed workload (N=4096, M=1024, B=128, seed 0,
``chip_smoke.streamed_workload``; ``bench_tiled_solve.py --accel``'s
configuration) launches ``fused_full_solve_tiled`` from the shipped build
and, with ``--parent``, from a build of ``full_solve_tiled.cu`` in DIR
(another commit's ``csrc/``, e.g. unpacked with ``git archive``, or an
edited copy of this one's: a tile size is a constant of
``fma_tile.cuh``): one launch each per turn, R rounds (default 2)
alternating the order, so both builds meet the same card state.  Splits
each build's time into phases from three solves cut at max_iters = 320 (no
lane certifies that early): checks every 16 and every 2 updates without
acceleration, and every 16 with it — an update U, a check with its stall
test C and an accel step A from 320 U + 20 C, 320 U + 160 C and
320 U + 20 (C + A).  Holds each build to the shipped build's Y, U,
iterations and states on the streamed workload, bit for bit
(``bits_equal_shipped``), and to the plain version on that
workload and on the four cases of ``tests/test_torch_cuda.py::
test_k4_kernel_matches_plain``: lanes whose state differs (lane, state,
plain state, iterations, plain iterations), the largest iteration
difference, the share of lanes within the iteration bar and the largest U
error.  Prints ptxas's registers, stack and spills of the K4 functions.
Needs a CUDA device and ``nvcc``; prints one JSON line per build.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
import test_torch_cuda as card  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import tiled_solve_kernel as tsk  # noqa: E402
from probe_k5 import build_variants, ptxas_lines, smi_line  # noqa: E402

ENTRY = "full_solve_tiled_f32"
#: the K4 functions of any build (kernel and tile functions)
K4_FUNCTIONS = r"tiled_full_solve|update_tile|product_tile"


def card_cases(dev):
    """(args, kwargs, plain result, check_every) of each case of
    test_k4_kernel_matches_plain."""
    out = {}
    for case, (cfg, N, M, B, fp_scale) in sorted(card.K4_CASES.items()):
        primal, dual = card._random_problem(dev, N, M, B, fp_scale=fp_scale)
        args, kw = tsk.tiled_inputs(primal, dual, None, cfg)
        out[case] = (args, kw, tsk.fused_full_solve_tiled_reference(
            *args, **kw), cfg.check_every)
    return out


def against_plain(got, want, check_every) -> dict:
    st, st_p = got[3], want[3]
    it, it_p = got[2].long(), want[2].long()
    differ = torch.nonzero(st != st_p).flatten().tolist()
    in_bar = (it - it_p).abs() <= card._bar(it_p, check_every)
    return dict(
        states_differ=[[b, int(st[b]), int(st_p[b]), int(it[b]),
                        int(it_p[b])] for b in differ],
        max_iters_diff=int((it - it_p).abs().max()),
        in_bar=float(in_bar.float().mean()),
        u_err=float((got[1] - want[1]).abs().max()),
        u_tol=5e-3 * max(1.0, float(want[1].abs().max())))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k4: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    cfg = pqp.SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                           strict_weak_duality=False,
                           gap_from_complementarity=True)
    primal, dual = cs.streamed_workload(dev)
    args, kw = tsk.tiled_inputs(primal, dual, None, cfg)
    print(json.dumps({"probe": "k4_plan", "plan": tsk.k4_plan(
        cs.N_BIG, cs.M_BIG, cs.B_BIG), "nvidia_smi": smi}), flush=True)
    plain = tsk.fused_full_solve_tiled_reference(*args, **kw)
    cases = card_cases(dev)
    select = lambda log: ptxas_lines(log, K4_FUNCTIONS)
    libs = {"shipped": (build.load_library(), select(
        Path(str(build.library_path()) + ".log").read_text()))}
    if opts.parent:
        parent = Path(opts.parent).resolve()
        libs.update(build_variants(
            [("k4_parent", parent / "full_solve_tiled.cu", [])], (ENTRY,),
            csrc=parent, select=select))
    names = list(libs)
    # the phase solves: (check_every, accel) cut at max_iters = 320
    cut = {key: dict(kw, max_iters=320, check_every=key[0], accel=key[1])
           for key in ((16, False), (2, False), (16, True))}
    real_load = build.load_library
    times = {name: [] for name in names}
    cut_ms = {name: {key: [] for key in cut} for name in names}
    outs, held = {}, {}
    try:
        for r in range(opts.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                build.load_library = lambda _l=libs[name][0]: _l
                outs[name], ms = cs.timed_once(
                    lambda: tsk.fused_full_solve_tiled(*args, **kw))
                times[name].append(ms)
                for key, ckw in cut.items():
                    cut_ms[name][key].append(cs.timed_once(
                        lambda: tsk.fused_full_solve_tiled(*args, **ckw))[1])
        for name in names:
            build.load_library = lambda _l=libs[name][0]: _l
            held[name] = {case: against_plain(
                tsk.fused_full_solve_tiled(*a, **k), want, ce)
                for case, (a, k, want, ce) in cases.items()}
    finally:
        build.load_library = real_load
    for name in names:
        t16, t2, ta = (min(cut_ms[name][key]) for key in cut)
        check = (t2 - t16) / 140
        phases = dict(update_ms=(t16 - 20 * check) / 320, check_ms=check,
                      accel_ms=(ta - t16) / 20, cut_solves_ms=[t16, t2, ta])
        _, _, it, st = outs[name]
        print(json.dumps({
            "probe": "k4_build", "build": name, "ptxas": libs[name][1],
            "ms": times[name], "phases": phases,
            "bits_equal_shipped": cs.bits_equal(outs[name], outs["shipped"]),
            "iters_mean": float(it.float().mean()),
            "certified": int((st == 1).sum()),
            "n4096_vs_plain": against_plain(outs[name], plain, 16),
            "card_cases_vs_plain": held[name],
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
