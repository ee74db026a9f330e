#!/usr/bin/env python3
"""Time kernel K7 against another build of it on one GPU.

    python3 tools/probe_k7.py [--parent DIR] [--variant DIR2]

On the streamed distinct workload (B=8, N=2048, seed 0, gaussian Gp,
``chip_smoke.distinct_workload``; the iterate of ``chip_smoke``'s K7 phase)
launches ``distinct_streamed_iterations`` in both stream types from the
shipped build and, with ``--parent``, from ``DIR/pqp_iterations_distinct_
tiled.cu`` (another commit's ``csrc/``, e.g. unpacked with ``git archive``;
its C entry point is the one-launch-per-update design's, called with that
design's arguments), and with ``--variant`` from an edited copy of this
``csrc/`` (same entry point as the shipped one).  Each build runs 16 updates
and one update, in turns (forward, then reversed): the first update reads
the matrices from device memory, the other fifteen are the resident ones
(``(t16 - t1) / 15``), by CUDA events around the calls and by the
profiler's device time of the kernels alone.  Every entry of each build's 16-update result is held
to the shipped build's bits.  Prints ``k7_plan``.  Needs a CUDA device and ``nvcc``;
prints one JSON line per build and mode.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import distinct_tiled_kernel as dtk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops.distinct_kernel import instance_rows  # noqa: E402
from probe_k5 import build_variants, smi_line  # noqa: E402

ENTRY = "pqp_iterations_distinct_tiled"
SOURCE = "pqp_iterations_distinct_tiled.cu"
#: the previous design's C arguments: q, q_bf16, theta, fdn, fdp, y, y_out,
#: y_tmp, n, B, num_iters, den_eps, stream
PARENT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def parent_call(lib, Q, th, fdn, fdp, Y, num_iters, den_eps):
    """The previous design's launches on the wrapper's operands: Y (N, B)
    in, (N, B) out."""
    N, B = Y.shape
    y = Y.T.contiguous()
    out, tmp = torch.empty_like(y), torch.empty_like(y)
    code = lib.pqp_iterations_distinct_tiled(
        Q.data_ptr(), int(Q.dtype == torch.bfloat16), th.data_ptr(),
        fdn.data_ptr(), fdp.data_ptr(), y.data_ptr(), out.data_ptr(),
        tmp.data_ptr(), N, B, num_iters, den_eps,
        build.stream_handle(Y.device))
    build.check(code, "parent K7")
    return out.T


def device_us(fn, reps: int = 10) -> float:
    """Device microseconds per call of ``fn`` spent in K7's kernels (either
    design's: their names start with ``distinct_update``), from the
    profiler's trace; 0.0 when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if "distinct_update" in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    ap.add_argument("--variant", help="an edited copy of this csrc/")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k7: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    primal = cs.distinct_workload(cs.B_DS, cs.M_DS, cs.N_DS, dev,
                                  gaussian_gp=True)
    dual = pqp.dualize_distinct(primal, materialize_splits=False)
    Y = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 2.0, (cs.N_DS, cs.B_DS)).astype(np.float32), device=dev)
    # the previous design's operands: (B, N) instance-major copies
    fdn, fdp = (instance_rows(t, cs.N_DS, cs.B_DS, name, dev)
                for t, name in ((dual.Fdn, "Fdn"), (dual.Fdp, "Fdp")))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "k7_plan", "nvidia_smi": smi, "plans": [
                          dtk.k7_plan(cs.N_DS, cs.B_DS, d, sms)
                          for d in ("bfloat16", "float32")]}), flush=True)
    libs = {"shipped": build.load_library()}
    if opts.parent:
        parent = Path(opts.parent).resolve()
        libs["parent"] = build_variants(
            [("k7_parent", parent / SOURCE, [])], (), csrc=parent)[
                "k7_parent"][0]
        libs["parent"].pqp_iterations_distinct_tiled.argtypes = \
            PARENT_ARGTYPES
        libs["parent"].pqp_iterations_distinct_tiled.restype = ctypes.c_int
    if opts.variant:
        variant = Path(opts.variant).resolve()
        libs["variant"] = build_variants(
            [("k7_variant", variant / SOURCE, [])], (ENTRY,),
            csrc=variant)["k7_variant"][0]
    real_load = build.load_library
    names = list(libs)
    for mode in ("bfloat16", "float32"):
        Q, th = dtk.distinct_streamed_matrix(dual.Qd, dual.theta, mode)

        def run(name, iters):
            if name == "parent":
                return parent_call(libs[name], Q, th, fdn, fdp, Y, iters,
                                   1e-30)
            build.load_library = lambda _l=libs[name]: _l
            try:
                return dtk.distinct_streamed_iterations(
                    Q, th, dual.Fdn, dual.Fdp, Y, iters, den_eps=1e-30)
            finally:
                build.load_library = real_load

        base = run("shipped", 16)
        times = {name: {"16": [], "1": []} for name in names}
        same = {}
        for order in (names, names[::-1]):
            for name in order:
                for iters in (16, 1):
                    times[name][str(iters)].append(cs.cuda_ms(
                        lambda: run(name, iters), 20))
                out = run(name, 16)
                same[name] = bool(torch.equal(out.view(torch.int32),
                                              base.view(torch.int32)))
        for name in names:
            t16 = float(np.mean(times[name]["16"]))
            t1 = float(np.mean(times[name]["1"]))
            dev16, dev1 = (device_us(lambda: run(name, i)) for i in (16, 1))
            print(json.dumps({
                "probe": "k7_build", "build": name, "mode": mode,
                "ms_16_updates": times[name]["16"],
                "ms_1_update": times[name]["1"],
                "first_update_ms": t1, "later_update_ms": (t16 - t1) / 15,
                "device_us_16_updates": dev16, "device_us_1_update": dev1,
                "device_later_update_us": (dev16 - dev1) / 15,
                "bits_equal_shipped": same[name], "nvidia_smi": smi}),
                flush=True)
        del Q, th
    return 0


if __name__ == "__main__":
    sys.exit(main())
