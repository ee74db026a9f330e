#!/usr/bin/env python3
"""Time kernel K3's tile plans, and its float32 mode against another build
of it, on one GPU.

    python3 tools/probe_k3.py [--parent DIR] [--variant DIR2]

On the streamed workload (N=4096, M=1024, B=128, seed 0,
``chip_smoke.streamed_workload``; the iterate of ``chip_smoke``'s K3 phase)
runs 16 updates of ``streamed_pqp_iterations``:

* float32 mode: the shipped build, ``--parent`` (another commit's
  ``csrc/``, e.g. unpacked with ``git archive``) and ``--variant`` (an
  edited copy of this ``csrc/``), each built from its own
  ``pqp_iterations_tiled.cu`` (same C entry point), the FMA-tile builds at
  each lane width of ``k3_f32_plan`` (32, 64 and 128 forced), all in turns
  (forward, then reversed), also on a random problem at N=1024/B=128;
  each one's y_out is held to the shipped build's (at its own plan) bit
  for bit at N=4096/B=128 and on random problems at 1024/128, 200/72 and
  203/5 (every entry's sum is one FMA chain in ascending k whatever the
  tiling); the device time of its update kernels per update (profiler
  trace) beside the 0.128 ms that the update's 4 N^2 B flop take at the
  67 TFLOP/s float32 peak;
* the route that rides the float32 mode, ``solve_batched(use_pallas=True)``
  on the streamed workload under ``bench_tiled_solve.py --accel``'s
  configuration, with each build in turns: seconds per batch, mean
  iterations, converged share and K3 float32 launches;
* bf16 mode, each (tile rows, tile lanes) of ``k3_bf16_plan`` forced, in
  turns, each held to the shipped plan's bits.

Needs a CUDA device and ``nvcc``; prints one JSON line per plan and build.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pqp_for_mpc_tpu_torch as pqp  # noqa: E402
import test_torch_cuda as card  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import tiled_kernel as tk  # noqa: E402
from probe_k5 import build_variants, ptxas_lines, smi_line  # noqa: E402

ENTRY = "pqp_iterations_tiled"
SOURCE = "pqp_iterations_tiled.cu"
BF16_PLANS = [(64, 64), (32, 64), (16, 64)]
F32_LANES = [128, 64, 32]
#: the random problems of the bit comparison between builds: (N, B)
BIT_SHAPES = [(1024, 128), (200, 72), (203, 5)]
#: the shapes timed: the streamed workload and the card tests' N = 1024
TIMED_SHAPES = [(4096, 128), (1024, 128)]
#: the float32 mode's update kernels in any build (the parent's SIMT tile
#: and the FMA tile)
F32_KERNELS = ("tiled_update_kernel", "f32_update_kernel")
KW = dict(num_iters=16, den_eps=1e-30)


def forced(plan_name, plan):
    """A context in which ``tk.<plan_name>`` is ``plan(n, B)``."""
    class _Force:
        def __enter__(self):
            self.real = getattr(tk, plan_name)
            setattr(tk, plan_name, plan)

        def __exit__(self, *exc):
            setattr(tk, plan_name, self.real)
    return _Force()


def device_us_per_update(fn, reps: int = 5) -> float:
    """Device microseconds per update of ``fn`` (16 updates a call) spent
    in the float32 update kernels, from the profiler's trace; 0.0 when the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if any(k in evt.key for k in F32_KERNELS):
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / (reps * KW["num_iters"])


def bits(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another commit's csrc/ directory")
    ap.add_argument("--variant", help="an edited copy of this csrc/")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k3: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda", 0)
    primal, dual = cs.streamed_workload(dev)
    Y = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 2.0, (cs.N_BIG, cs.B_BIG)).astype(np.float32), device=dev)
    streams = {mode: tk.streamed_matrix(dual.Qd, dual.theta, mode)
               for mode in ("float32", "bfloat16")}
    args = {mode: (Q, th, dual.Fdn, dual.Fdp, Y)
            for mode, (Q, th) in streams.items()}
    run = lambda mode: tk.streamed_pqp_iterations(*args[mode], **KW)
    select = lambda log: ptxas_lines(log, "|".join(F32_KERNELS))
    libs = {"shipped": build.load_library()}
    print(json.dumps({"probe": "k3_plan", "nvidia_smi": smi,
                      "float32": tk.k3_f32_plan(cs.N_BIG, cs.B_BIG),
                      "bfloat16": tk.k3_bf16_plan(cs.N_BIG, cs.B_BIG),
                      "ptxas": select(Path(str(build.library_path())
                                           + ".log").read_text())}),
          flush=True)

    # float32 mode: the shipped build against the parent's and a variant's,
    # each FMA-tile build at every lane width
    builds = [(name, Path(d).resolve()) for name, d in
              (("parent", opts.parent), ("variant", opts.variant)) if d]
    logs = {"shipped": None}
    if builds:
        made = build_variants([(f"k3_{name}", d / SOURCE, [])
                               for name, d in builds], (ENTRY,),
                              csrc=build.CSRC, select=select)
        for name, _ in builds:
            libs[name], logs[name] = made[f"k3_{name}"]
    problems = {(cs.N_BIG, cs.B_BIG): args["float32"]}
    for n, b in BIT_SHAPES:
        _, d = card._random_problem(dev, n, n // 4, b)
        y = torch.as_tensor(np.random.default_rng(1).uniform(
            0.5, 2.0, (n, b)).astype(np.float32), device=dev)
        problems[(n, b)] = (*tk.streamed_matrix(d.Qd, d.theta, "float32"),
                            d.Fdn, d.Fdp, y)
    # (build, lanes): the parent's SIMT tile takes no lane width
    runs = [(name, w) for name in libs
            for w in ((None,) if name == "parent" else F32_LANES)]
    real_load = build.load_library
    ms = {(r, shape): [] for r in runs for shape in TIMED_SHAPES}
    outs, dev_us = {}, {}

    shipped_plan = tk.k3_f32_plan

    def use(name, w):
        build.load_library = lambda _l=libs[name]: _l
        return forced("k3_f32_plan", lambda n, b, _w=w: dict(
            shipped_plan(n, b), **({} if _w is None else
                                   {"tile_lanes": _w})))

    try:
        for order in (runs, runs[::-1]):
            for name, w in order:
                with use(name, w):
                    for shape in TIMED_SHAPES:
                        a = problems[shape]
                        ms[((name, w), shape)].append(cs.cuda_ms(
                            lambda: tk.streamed_pqp_iterations(*a, **KW),
                            10))
        for name, w in runs:
            with use(name, w):
                outs[(name, w)] = {
                    shape: tk.streamed_pqp_iterations(*a, **KW)
                    for shape, a in problems.items()}
                dev_us[(name, w)] = device_us_per_update(
                    lambda: run("float32"))
    finally:
        build.load_library = real_load
    ref = outs[("shipped", tk.k3_f32_plan(cs.N_BIG, cs.B_BIG)["tile_lanes"])]
    fma_bound_ms = 4.0 * cs.N_BIG ** 2 * cs.B_BIG / cs.F32_FLOPS * 1e3
    for name, w in runs:
        print(json.dumps({
            "probe": "k3_f32_build", "build": name, "tile_lanes": w,
            "ms_per_16_updates": {f"{n}x{b}": ms[((name, w), (n, b))]
                                  for n, b in TIMED_SHAPES},
            "device_us_per_update": dev_us[(name, w)],
            "fma_bound_us_per_update": fma_bound_ms * 1e3,
            "bits_equal_shipped": {f"{n}x{b}": bits(o, ref[(n, b)])
                                   for (n, b), o in outs[(name, w)].items()},
            "ptxas": logs[name], "nvidia_smi": smi}), flush=True)

    # the route that rides the float32 mode: solve_batched(use_pallas=True)
    # (one launch per check) under bench_tiled_solve.py --accel's
    # configuration, with each build, in turns
    cfg = pqp.SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                           strict_weak_duality=False,
                           gap_from_complementarity=True, use_pallas=True)
    route_s = {name: [] for name in libs}
    route_out = {}
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                build.load_library = lambda _l=libs[name]: _l
                counts = tk.streamed_pqp_iterations.launches
                counts["float32"] = 0
                res, ms_ = cs.timed_once(
                    lambda: pqp.solve_batched(primal, dual, cfg=cfg))
                route_s[name].append(ms_ / 1e3)
                route_out[name] = (float(res.iters.float().mean()),
                                   float(res.converged.float().mean()),
                                   counts["float32"])
    finally:
        build.load_library = real_load
    for name in libs:
        it, conv, launches = route_out[name]
        print(json.dumps({"probe": "k3_f32_route", "build": name,
                          "route": "solve_batched(use_pallas=True)",
                          "seconds_per_batch": route_s[name],
                          "iters_mean": it, "converged_frac": conv,
                          "k3_float32_launches": launches,
                          "nvidia_smi": smi}), flush=True)

    # bf16 mode: the tile plans of the tensor-core kernel
    base = run("bfloat16")
    times, same = {p: [] for p in BF16_PLANS}, {}
    for order in (BF16_PLANS, BF16_PLANS[::-1]):
        for rows, lanes in order:
            with forced("k3_bf16_plan", lambda n, b, _r=rows, _l=lanes:
                        dict(tile_rows=_r, tile_lanes=_l)):
                times[(rows, lanes)].append(cs.cuda_ms(
                    lambda: run("bfloat16"), 5))
                same[(rows, lanes)] = bits(run("bfloat16"), base)
    for p in BF16_PLANS:
        print(json.dumps({"probe": "k3_tile", "tile_rows": p[0],
                          "tile_lanes": p[1],
                          "ms_per_16_updates": times[p],
                          "bits_equal_shipped": same[p],
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
