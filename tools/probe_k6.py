#!/usr/bin/env python3
"""Time kernel K6 against another build of it on one GPU.

    python3 tools/probe_k6.py [--parent DIR] [--variant DIR2] [--slots]

On the streamed distinct workload (B=8, N=2048, M=512, gaussian Gp, seed 0,
``chip_smoke.distinct_workload``; ``bench_mixed.py --distinct --accel``'s
configuration) launches ``fused_full_solve_distinct_tiled`` from the shipped
build and, with ``--parent``, from ``DIR/full_solve_distinct_tiled.cu``
(another commit's ``csrc/``, e.g. unpacked with ``git archive``; its C entry
point is the cluster design's, called with that design's arguments), and
with ``--variant`` from an edited copy of this ``csrc/``: three launches
each, in turns (forward, then reversed).  Holds each build's Y, U, iters
and state to the shipped build's bits, per instance, and prints each
instance's iterations.  Splits each build's time per instance into the
load of its rows and one check (``max_iters = 0``), a check, an accel step
and an update, from 144 updates run as nine rounds of 16, as one round of
144 and as nine rounds without the accel step (no instance certifies that
early), and ms per round of 16; and times
the shipped slot barrier (``Part::barrier`` of the kernel's own source, in
a loop, at the plan's blocks per instance) for its share of a round (7
barriers: 3 in the check, 4 in the accel step; the updates exchange
without one).  With
``--parent`` it also launches K5 (``fused_full_solve_distinct``, whose
wrapper and C entry point did not change) from the parent's
``full_solve_distinct.cu`` beside the shipped one on K5's resident workload
(B=1024, N=400, M=100), in turns, for bits and time.  With ``--slots`` it
times the shipped build with the plan's layout replaced by 1, 2, 3 and 4
instances side by side (each over 132 / slots blocks, as many rows
resident as fit), two launches each, and holds each to the plan's bits.
Needs a CUDA device
and ``nvcc``; prints one JSON line per build.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import distinct_kernel as dk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import distinct_tiled_kernel as dtk  # noqa: E402
from probe_k5 import build_variants, smi_line  # noqa: E402

ENTRY = "full_solve_distinct_tiled_f32"
SOURCE = "full_solve_distinct_tiled.cu"
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
#: the cluster design's C arguments (no scratch, no plan)
PARENT_ARGTYPES = [_P] * 3 + [_L] + [_P] * 2 + [_L] + [_P] * 12 + [_I] * 6 \
    + [_F, _F, _I, _F, _I, _P]
#: barriers of one round: 3 in the check, 4 in the accel step
BARRIERS_PER_ROUND = 3 + 4

BARRIER_SOURCE = r'''
#include "full_solve_distinct_tiled.cu"

__global__ void __launch_bounds__(512, 1)
k6_barrier_kernel(unsigned* arrive, int per_inst, int reps) {
  pqp::k6::Part S;
  S.P = per_inst;
  S.gen = 0;
  S.arrive = arrive + blockIdx.x / per_inst;
  for (int r = 0; r < reps; ++r) S.barrier();
}

extern "C" int k6_barrier_loop(unsigned* arrive, int blocks, int per_inst,
                               int reps, void* stream) {
  void* params[] = {&arrive, &per_inst, &reps};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)k6_barrier_kernel, dim3(blocks), dim3(512), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
'''


class ParentK6:
    """The parent library under the shipped wrapper: drops the new
    arguments (scratch and plan) and calls the cluster design's entry."""

    def __init__(self, lib):
        self.lib = lib

    def full_solve_distinct_tiled_f32(self, *args):
        # 19 pointers, xch, arrive, 11 scalars, the 6 plan ints, stream
        return self.lib.full_solve_distinct_tiled_f32(
            *args[:19], *args[21:-7], args[-1])

    def pqp_error_string(self, code):
        return self.lib.pqp_error_string(code)


def barrier_us(blocks: int, per_inst: int, smi: str) -> float:
    """Microseconds of one slot barrier of the shipped kernel's source."""
    out = os.path.join(ROOT, ".build", "probes")
    os.makedirs(out, exist_ok=True)
    src, lib_path = (os.path.join(out, "k6_barrier" + ext)
                     for ext in (".cu", ".so"))
    Path(src).write_text(BARRIER_SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                    str(build.CSRC), "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.k6_barrier_loop.argtypes = [_P, _I, _I, _I, _P]
    dev = torch.device("cuda", 0)
    arrive = torch.zeros(blocks // per_inst, dtype=torch.int32, device=dev)

    def run(reps):
        arrive.zero_()
        code = lib.k6_barrier_loop(arrive.data_ptr(), blocks, per_inst, reps,
                                   build.stream_handle(dev))
        if code:
            raise RuntimeError(f"k6_barrier_loop: CUDA error {code}")
    reps = 2000
    return (cs.cuda_ms(lambda: run(reps), 5)
            - cs.cuda_ms(lambda: run(0), 5)) / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    ap.add_argument("--variant", help="an edited copy of this csrc/")
    ap.add_argument("--slots", action="store_true",
                    help="time 1-4 instances side by side")
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dtk.k6_plan(cs.N_DS, cs.M_DS, cs.B_DS, sms)
    print(json.dumps({"probe": "k6_plan", "plan": plan, "nvidia_smi": smi}),
          flush=True)
    libs = {"shipped": build.load_library()}
    parent = Path(opts.parent).resolve() if opts.parent else None
    if parent:
        lib = build_variants([("k6_parent", parent / SOURCE, [])], (),
                             csrc=parent)["k6_parent"][0]
        lib.full_solve_distinct_tiled_f32.argtypes = PARENT_ARGTYPES
        lib.full_solve_distinct_tiled_f32.restype = ctypes.c_int
        libs["parent"] = ParentK6(lib)
    if opts.variant:
        variant = Path(opts.variant).resolve()
        libs["variant"] = build_variants(
            [("k6_variant", variant / SOURCE, [])], (ENTRY,),
            csrc=variant)["k6_variant"][0]
    names = list(libs)
    real_load = build.load_library

    def run(name, **over):
        build.load_library = lambda _l=libs[name]: _l
        try:
            return dtk.fused_full_solve_distinct_tiled(*args,
                                                       **{**kw, **over})
        finally:
            build.load_library = real_load

    base = run("shipped")
    times = {name: [] for name in names}
    split = {name: {} for name in names}
    same, iters = {}, {}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(cs.cuda_ms(lambda: run(name), 3))
            out = run(name)
            same[name] = [bool(all(torch.equal(
                t[..., b].view(torch.int32), s[..., b].view(torch.int32))
                for t, s in zip(out, base))) for b in range(cs.B_DS)]
            iters[name] = out[2].tolist()
    for name in names:
        # per instance: t0 the load and one check; t16 nine rounds of 16
        # updates (9 checks and accel steps, then the final check); t144
        # one round of 144; tn t16 without the accel step
        us = lambda **o: cs.cuda_ms(lambda: run(name, **o), 3) * 1e3 \
            / cs.B_DS
        t0, t16, t144 = us(max_iters=0), us(max_iters=144), \
            us(max_iters=144, check_every=144, accel=True)
        tn = us(max_iters=144, accel=False)
        check_accel = (t16 - t144) / 8
        accel = (t16 - tn) / 9
        split[name] = dict(
            load_and_check_us=t0, check_us=check_accel - accel,
            accel_us=accel,
            update_us=(t144 - t0 - check_accel) / 144,
            ms_per_instance_round=(t16 - t0) / 9e3)
    bar = barrier_us(plan["blocks"], plan["blocks_per_instance"], smi)
    for name in names:
        row = split[name]
        if name != "parent":
            row["barrier_share_of_round"] = BARRIERS_PER_ROUND * bar / (
                1e3 * row["ms_per_instance_round"])
        print(json.dumps({"probe": "k6_build", "build": name,
                          "ms": times[name], "iters": iters[name],
                          "bits_equal_shipped_per_instance": same[name],
                          **row, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"probe": "k6_barrier", "us": bar,
                      "blocks": plan["blocks"],
                      "blocks_per_instance": plan["blocks_per_instance"],
                      "nvidia_smi": smi}), flush=True)
    if opts.slots:
        probe_slots(args, kw, base, smi)
    if parent:
        probe_k5_parent(parent, smi)
    return 0


def probe_slots(args, kw, base, smi: str) -> None:
    """The shipped K6 with 1-4 instances side by side in place of the
    plan's layout: ms of two launches each and bits against the plan's."""
    n, m, B = cs.N_DS, cs.M_DS, cs.B_DS
    real = dtk.k6_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for slots in (1, 2, 3, 4):
            per_inst = sms // slots
            resident = -(-n // per_inst)
            while dtk.k6_smem_bytes(n, m, per_inst, resident,
                                    True) > dtk.SMEM_LIMIT_BYTES:
                resident -= 1
            plan = dict(real(n, m, B, sms), slots=slots,
                        blocks_per_instance=per_inst,
                        resident_rows=resident, staged=True)
            dtk.k6_plan = lambda *_a, _p=plan: _p
            out = dtk.fused_full_solve_distinct_tiled(*args, **kw)
            print(json.dumps({
                "probe": "k6_slots", "slots": slots,
                "blocks_per_instance": per_inst, "resident_rows": resident,
                "rows_per_block": -(-n // per_inst),
                "streamed_bytes_per_pass": slots * 4 * n * (
                    n - dtk._resident_total(n, per_inst, resident)),
                "ms": [cs.cuda_ms(lambda: dtk.fused_full_solve_distinct_tiled(
                    *args, **kw), 1) for _ in range(2)],
                "bits_equal_plan": cs.bits_equal(out, base),
                "nvidia_smi": smi}), flush=True)
    finally:
        dtk.k6_plan = real


def probe_k5_parent(parent: Path, smi: str) -> None:
    """K5 from the parent's source beside the shipped one: bits and time."""
    dev = torch.device("cuda", 0)
    cfg = pqp.SolverConfig(max_iters=20000, check_every=8, y0=1.0, erc=1e-4,
                           eac=1e-4, eaj=1e-3, erj=1e-4,
                           strict_weak_duality=False)
    primal = cs.distinct_workload(cs.B_DR, cs.M_DR, cs.N_DR, dev)
    dual = pqp.dualize_distinct(primal, theta_floor=cfg.theta_floor)
    args, kw = dk.distinct_inputs(primal, dual, None, cfg)
    libs = {"shipped": build.load_library(), "parent": build_variants(
        [("k5_parent", parent / "full_solve_distinct.cu", [])],
        ("full_solve_distinct_f32", "full_solve_distinct_cluster"),
        csrc=parent)["k5_parent"][0]}
    real_load = build.load_library
    times, outs = {k: [] for k in libs}, {}
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                build.load_library = lambda _l=libs[name]: _l
                times[name].append(cs.cuda_ms(
                    lambda: dk.fused_full_solve_distinct(*args, **kw), 1))
                outs[name] = dk.fused_full_solve_distinct(*args, **kw)
    finally:
        build.load_library = real_load
    print(json.dumps({"probe": "k5_against_parent", "ms": times,
                      "bits_equal": cs.bits_equal(outs["shipped"],
                                                  outs["parent"]),
                      "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
