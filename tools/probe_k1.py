#!/usr/bin/env python3
"""Time kernels K1 and K8 (the lane-tile engine) against another build of
them on one GPU, and hold this build to that one's bits.

    python3 tools/probe_k1.py --parent DIR [--variant DIR2 ...]
                              [--batches 16,20,22]

DIR is a ``csrc/`` directory whose ``full_solve.cu`` and
``full_solve_packed.cu`` keep the C entry points of the one-thread-per-lane
design (the matrices passed one by one, no lane queue): e.g. the commit
before the engine, unpacked with ``git archive``.  On the main path's
workload (M=7/N=28, seed 0, ``bench.example_workload``, SMOKE_CFG) at
B = 2^16, 2^20 and 2^22 it times each kernel of both builds, one launch
per turn in the order shipped K1, parent K1, shipped K8, parent K8 and
then reversed, two turns each way, and gives the time per lane (the drain
at the end of the queue shows in it); at B = 2^22 it times the two routes
(``solve_auto`` and ``solve_fused_packed`` against the same wrapping
around the parent's kernels) in turns too.  It requires the parent K1's
bits (Y, U, iters and state) on every lane of the B = 2^22 batch and of
the six cases of ``tests/test_torch_cuda.py::K1_CASES``, and K8's bits
equal to K1's.  It prints ``k1_plan`` beside the card's plan, ptxas's
registers and spills of the engine, and the parent's warp tail: the mean
over 32 consecutive lanes of their largest iteration count, over the mean
count; at B = 2^22 it splits each build's K1 time into updates, checks
and a fixed cost per lane (``phase_split``).  Each ``--variant`` (an
edited copy of this build's ``csrc/``) is built beside the parent, timed
in the same turns and held to this build's bits.  Needs a CUDA device and
``nvcc``; prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pqp_for_mpc_tpu_torch.bench import example_workload  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
import test_torch_cuda as card  # noqa: E402
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build, packed_kernel  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import solve_kernel as sk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops.kernels import _matrix, _panel  # noqa: E402
from probe_k5 import ptxas_lines, smi_line  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent's whole-solve entry points: qdn, qdp, qd, gp, qp, qpi, then
#: the panels and the scalars of full_solve_f32 without the lane queue
PARENT_SIGNATURE = ([_P] * 6 + [_P, _I] * 8 + [_P] * 4 + [_I] * 6
                    + [_F, _F, _I, _F, _I, _P])
PARENT_ENTRIES = ("full_solve_f32", "full_solve_packed_f32")


def build_other(csrc: Path, name: str, signatures: dict):
    """K1 and K8 of another ``csrc/`` (and its pqp_iterations.cu, which
    carries pqp_error_string) in one library under .build/probes/, each
    entry point with its argument types: ``(library, ptxas's register and
    spill lines of the whole-solve kernel)``."""
    out = os.path.join(ROOT, ".build", "probes")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"{name}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
           *(str(csrc / f) for f in ("full_solve.cu", "full_solve_packed.cu",
                                     "pqp_iterations.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n" + proc.stdout
                           + proc.stderr)
    cdll = ctypes.CDLL(lib)
    for entry, argtypes in signatures.items():
        getattr(cdll, entry).argtypes = argtypes
        getattr(cdll, entry).restype = ctypes.c_int
    cdll.pqp_error_string.argtypes = [ctypes.c_int]
    cdll.pqp_error_string.restype = ctypes.c_char_p
    return cdll, ptxas_lines(proc.stdout + proc.stderr,
                             "full_solve|lane_tile")


def through(lib, fn):
    """``fn()`` with the wrappers loading ``lib`` instead of this build."""
    real = build.load_library
    build.load_library = lambda: lib
    try:
        return fn()
    finally:
        build.load_library = real


def parent_solve(lib, entry, args, kw):
    """The parent's wrapper: ``(Y, U, iters, lane_state)`` of its kernel
    ``entry`` on ``fused_inputs``' arguments."""
    (qdn, qdp, qd, gp, qp, qpi, Fp, Fd, Fdp, Fdn, Kps, Mp, Md, Y0) = args
    N, B = Y0.shape
    M = gp.shape[1]
    dev = Y0.device
    mats = [_matrix(t, shape, "matrix", dev) for t, shape in
            ((qdn, (N, N)), (qdp, (N, N)), (qd, (N, N)), (gp, (N, M)),
             (qp, (M, M)), (qpi, (M, M)))]
    panels = [_panel(Fp, M, B, "Fp", dev), _panel(Fd, N, B, "Fd", dev),
              _panel(Fdp, N, B, "Fdp", dev), _panel(Fdn, N, B, "Fdn", dev),
              _panel(Kps, N, B, "Kp_slack", dev),
              _panel(Mp.reshape(1, -1), 1, B, "Mp", dev),
              _panel(Md.reshape(1, -1), 1, B, "Md", dev),
              _panel(Y0, N, B, "Y0", dev)]
    out = (torch.empty((N, B), device=dev), torch.empty((M, B), device=dev),
           torch.empty(B, dtype=torch.int32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))
    flat = [t.data_ptr() for t in mats]
    for t, lane in panels:
        flat += [t.data_ptr(), lane]
    code = getattr(lib, entry)(
        *flat, *(t.data_ptr() for t in out), N, M, B,
        int(kw["max_iters"]), int(kw["check_every"]), int(kw["accel_every"]),
        float(kw["eaj"]), float(kw["erj"]), int(bool(kw["strict"])),
        float(kw["den_eps"]), int(bool(kw["gap_comp"])),
        build.stream_handle(dev))
    if code:
        raise RuntimeError(f"parent {entry}: CUDA error {code} "
                           f"({lib.pqp_error_string(code).decode()})")
    return out


def in_turns(fns: dict, reps: int, turns: int = 2) -> dict:
    """Milliseconds per call of each of ``fns``, in turns (forward, then
    reversed), ``turns`` times each way; each entry's list of turns."""
    names = list(fns)
    times = {name: [] for name in names}
    for _ in range(turns):
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cs.cuda_ms(fns[name], reps))
    return times


def phase_split(solve, args, kw) -> dict:
    """Where a lane's time goes, from three solves whose checks all fail
    (eaj = -inf), so that every lane runs to max_iters: max_iters 96 with
    a check every 8 and every 4 updates, and 192 every 8 — 96 U + 13 C +
    F, 96 U + 25 C + F and 192 U + 25 C + F for an update U, a check C
    (with its refill share) and a fixed cost F per lane (its first check,
    loads and outputs).  Milliseconds for the whole batch, per update and
    per check of every lane, and the lanes' states (all 0 when no lane
    stalled)."""
    t, states = {}, set()
    for ce, mi in ((8, 96), (4, 96), (8, 192)):
        kwp = dict(kw, check_every=ce, max_iters=mi, eaj=float("-inf"),
                   accel_every=0)
        states |= set(solve(*args, **kwp)[3].unique().tolist())
        t[(ce, mi)] = cs.cuda_ms(lambda: solve(*args, **kwp), 2)
    check = (t[(4, 96)] - t[(8, 96)]) / 12
    update = (t[(8, 192)] - t[(4, 96)]) / 96
    return dict(update_ms=update, check_ms=check,
                fixed_ms=t[(8, 96)] - 96 * update - 13 * check,
                solves_ms={f"ce{ce}_max{mi}": v for (ce, mi), v in t.items()},
                states=sorted(states))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a csrc/ directory of the one-thread-per-lane K1")
    ap.add_argument("--variant", action="append", default=[],
                    help="an edited copy of this build's csrc/, timed "
                         "beside it (repeatable)")
    ap.add_argument("--batches", default="16,20,22",
                    help="log2 of the batches to time")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    emit = lambda **kw: print(json.dumps({**kw, "nvidia_smi": smi}),
                              flush=True)
    cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                              accel_every=0, max_iters=5000)
    log = Path(str(build.library_path()) + ".log")
    build.load_library()
    engine_entries = {e: build.SIGNATURES[e] for e in (
        "full_solve_f32", "full_solve_packed_f32", "full_solve_plan")}
    jobs = {"parent": (opts.parent, {e: PARENT_SIGNATURE
                                     for e in PARENT_ENTRIES})}
    jobs.update({f"v{i}": (d, engine_entries)
                 for i, d in enumerate(opts.variant)})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build_other(Path(kv[1][0]).resolve(), "k1_" + kv[0],
                                   kv[1][1]), jobs.items())))
    parent = built.pop("parent")[0]
    variants = built
    emit(probe="k1_build", ptxas=ptxas_lines(log.read_text(),
                                             "lane_tile_solve"),
         variants={k: dict(source=jobs[k][0], ptxas=v[1])
                   for k, v in variants.items()})
    k1, k8 = sk.fused_full_solve, packed_kernel.fused_full_solve_packed

    # bits: the six card cases, then the main path's batch
    bits = {}
    for case in sorted(card.K1_CASES):
        ccfg, H, per_lane_kp = card.K1_CASES[case]
        primal, dual = card._workload(dev, H, 1000, per_lane_kp)
        args, kw = sk.fused_inputs(primal, dual, None, ccfg)
        bits[case] = card._bits_equal(k1(*args, **kw), parent_solve(
            parent, "full_solve_f32", args, kw))
    emit(probe="k1_card_cases_bits_equal_parent", **bits)

    for log2 in sorted(int(x) for x in opts.batches.split(",")):
        B = 1 << log2
        primal, dual = example_workload(B, dev)
        args, kw = sk.fused_inputs(primal, dual, None, cfg)
        out = k1(*args, **kw)
        old = parent_solve(parent, "full_solve_f32", args, kw)
        same = card._bits_equal(out, old)
        same8 = card._bits_equal(k8(*args, **kw), out)
        it = old[2].float()
        tail = float(it[:B // 32 * 32].reshape(-1, 32).max(dim=1).values
                     .mean() / it.mean()) if B >= 32 else None
        if log2 == 22:
            bits["main_path"] = same
        emit(probe="k1_plan", batch=B, plan=sk.k1_plan(dual.n_con,
                                                      primal.n_var, B),
             card=sk.card_plan(dual.n_con, primal.n_var, B))
        reps = 2 if B >= 1 << 20 else 10
        fns = {
            "k1": lambda: k1(*args, **kw),
            "k1_parent": lambda: parent_solve(parent, "full_solve_f32",
                                              args, kw),
            "k8": lambda: k8(*args, **kw),
            "k8_parent": lambda: parent_solve(
                parent, "full_solve_packed_f32", args, kw)}
        variant_bits = {}
        for name, (vlib, _) in variants.items():
            fns["k1_" + name] = (lambda _l=vlib: through(
                _l, lambda: k1(*args, **kw)))
            variant_bits[name] = card._bits_equal(fns["k1_" + name](), out)
        times = in_turns(fns, reps)
        best = {k: min(v) for k, v in times.items()}
        emit(probe="k1_times", batch=B, ms=times,
             ns_per_lane={k: v * 1e6 / B for k, v in best.items()},
             bits_equal_parent=same, k8_bits_equal_k1=same8,
             variants_bits_equal_shipped=variant_bits,
             iters_mean=float(out[2].float().mean()),
             iters_max=int(out[2].max()),
             parent_warp_tail=tail)
        if log2 == 22:
            emit(probe="k1_phases", batch=B,
                 shipped=phase_split(k1, args, kw),
                 parent=phase_split(lambda *a, **k: parent_solve(
                     parent, "full_solve_f32", a, k), args, kw))
            route = lambda entry: sk.fused_result(
                primal, dual, cfg, *parent_solve(
                    parent, entry, *sk.fused_inputs(primal, dual, None,
                                                    cfg)))
            rt = in_turns({
                "k1_route": lambda: pqp.solve_auto(primal, dual, cfg=cfg),
                "k1_route_parent": lambda: route("full_solve_f32"),
                "k8_route": lambda: pqp.solve_fused_packed(primal, dual,
                                                           cfg=cfg),
                "k8_route_parent": lambda: route("full_solve_packed_f32"),
            }, 1)
            emit(probe="k1_route_times", batch=B, ms=rt)
        del primal, dual, args, out, old
        torch.cuda.empty_cache()
    ok = all(bits.values())
    emit(probe="k1_bits", all_equal_parent=ok, **bits)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
