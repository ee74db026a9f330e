#!/usr/bin/env python3
"""Probe what bounds kernel K8 and the H=16 closed loop on one GPU.

    python3 tools/probe_k8.py

1. Builds ``csrc/full_solve_packed.cu`` in variants (the column loop of the
   update unrolled 2x; registers capped for 3 or 4 blocks of 8 warps per
   SM, ``__launch_bounds__(256, 3|4)``), prints ptxas's registers and
   spills, and times each against the shipped build on the main path's
   batch (M=7/N=28, B=2^22, SMOKE_CFG; ``chip_smoke.workload``), in turns
   (shipped first, then reversed), with K1 on the same batch; every variant
   must give the shipped build's bits.
2. Times the H=16 closed loop (``chip_smoke.mpc_spec(16, 0.0)``, 200
   steps) through ``rollout_jit`` and ``rollout`` in turns, then profiles
   50 steps of each with ``torch.profiler``: kernel launches, device time,
   host syncs.
3. Counts, for the accelerated H=16 workload (MPC_CONFIG without the
   dual-gradient certificate), the lanes where K8 and its plain version
   (and K1 and its plain version) end in different states.

Needs a CUDA device and ``nvcc``; prints one line per measurement.
"""

from __future__ import annotations

import ctypes
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
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG  # noqa: E402
from pqp_for_mpc_tpu_torch.models import MPCController  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import build  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import packed_kernel as pk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops import solve_kernel as sk  # noqa: E402
from pqp_for_mpc_tpu_torch.ops.kernels import _panel  # noqa: E402

SMOKE = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                            accel_every=0, max_iters=5000)
UNROLL = "#pragma unroll 4\n    for (int j = 0; j < n; ++j) {"
BOUNDS = "__launch_bounds__(kPackedWarps * 32)"


def variants(src: str) -> dict:
    cap = lambda s, k: s.replace(BOUNDS, BOUNDS[:-1] + f", {k})")
    out = {"unroll2": src.replace(UNROLL, UNROLL.replace("4", "2", 1)),
           "cap3": cap(src, 3), "cap4": cap(src, 4)}
    for name, text in out.items():
        if text == src:
            raise RuntimeError(f"variant {name} did not change the source")
    return out


def build_variant(name: str, text: str):
    d = os.path.join(ROOT, ".build", "probe_k8")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, name + ".cu"), os.path.join(d, name + ".so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-shared", "-o", so, cu],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    print(name, "registers", re.findall(r"Used (\d+) registers", log),
          "spill stores", re.findall(r"(\d+) bytes spill stores", log),
          flush=True)
    if r.returncode:
        raise RuntimeError(log[-3000:])
    lib = ctypes.CDLL(so)
    fn = lib.full_solve_packed_f32
    fn.argtypes = build.SIGNATURES["full_solve_packed_f32"]
    fn.restype = ctypes.c_int
    return lib


def kernel_variants(dev) -> None:
    src = open(build.CSRC / "full_solve_packed.cu").read()
    libs = {"shipped": build.load_library()}
    libs.update({k: build_variant(k, v) for k, v in variants(src).items()})
    primal, dual = cs.workload(cs.B_MAIN, dev)
    args, kw = sk.fused_inputs(primal, dual, None, SMOKE)
    N, M, B = dual.n_con, primal.n_var, cs.B_MAIN
    mats = [t.contiguous() for t in args[:6]]
    rows = (M, N, N, N, N, 1, 1, N)
    panels = [_panel(t.reshape(1, -1) if r == 1 else t, r, B, "panel", dev)
              for t, r in zip(args[6:], rows)]

    def run(lib):
        y = torch.empty((N, B), device=dev)
        u = torch.empty((M, B), device=dev)
        it = torch.empty(B, dtype=torch.int32, device=dev)
        st = torch.empty(B, dtype=torch.int32, device=dev)
        a = [t.data_ptr() for t in mats]
        for t, lane in panels:
            a += [t.data_ptr(), lane]
        code = lib.full_solve_packed_f32(
            *a, y.data_ptr(), u.data_ptr(), it.data_ptr(), st.data_ptr(), N,
            M, B, kw["max_iters"], kw["check_every"], kw["accel_every"],
            kw["eaj"], kw["erj"], int(kw["strict"]), kw["den_eps"],
            int(kw["gap_comp"]), build.stream_handle(dev))
        build.check(code, "full_solve_packed_f32")
        return y, u, it, st

    ref = pk.fused_full_solve_packed(*args, **kw)
    order = list(libs)
    for rnd in range(2):
        for name in (order if rnd == 0 else order[::-1]):
            out, ms = cs.timed_once(lambda: run(libs[name]))
            same = all(bool((a == b).all()) for a, b in zip(out, ref))
            print("k8", name, "ms", ms, "same bits as shipped", same,
                  flush=True)
            if not same:
                raise AssertionError(f"variant {name} changed the result")
    print("k1 ms", cs.cuda_ms(lambda: sk.fused_full_solve(*args, **kw), 2),
          flush=True)


def closed_loop(dev) -> None:
    from torch.profiler import ProfilerActivity, profile
    for rnd in range(2):
        for name in (("rollout_jit", "rollout") if rnd == 0
                     else ("rollout", "rollout_jit")):
            ctrl = MPCController(cs.mpc_spec(16, 0.0), device=dev)
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
        ctrl = MPCController(cs.mpc_spec(16, 0.0), device=dev)
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
        primal, dual = cs.workload(B, dev, horizon=16, r=r)
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
    kernel_variants(dev)
    torch.cuda.empty_cache()
    closed_loop(dev)
    accel_states(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
