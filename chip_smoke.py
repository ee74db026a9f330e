#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pqp_for_mpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``pqp_for_mpc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the two paths
at full size and times them:

* the small-N path (kernels K1, K2): the batched condensed-MPC solve
  through ``solve_auto`` and ``solve_batched``, and the receding-horizon
  controller.  The workload is the reference example's shape built in the
  repo: the double integrator condensed at horizon 7 (M = 7 inputs, N = 28
  dual constraints), 2^22 initial states x0 ~ N(0, 0.5^2) from a NumPy seed;
* the streamed large-N path (kernels K3, K4): ``solve_auto`` routing to
  ``solve_mixed`` (K3 bf16 bulk phase, K3 f32 refine), ``solve_fused_tiled``
  (K4) and the plain ``solve_batched``, on the JAX package's streamed
  workload (N = 4096, M = 1024, B = 128, built from seed 0 as
  ``benchmarks/bench_tiled_solve.py`` builds it) under its ``--accel``
  configuration; and the H = 64 closed loop (N = 256, warm B = 1), which
  the router also sends to ``"mixed"``, timed against the plain route;
* the distinct-geometry paths (kernels K5, K6, K7), one geometry per
  instance built from seed 0 as ``benchmarks/bench_distinct.py:
  make_instances`` builds it: the resident path at B = 1024, N = 400,
  M = 100 (``solve_auto`` -> ``"fused_distinct"`` -> K5, and the plain
  ``solve_batched``) and the streamed path at B = 8, N = 2048, M = 512
  (``solve_auto`` -> ``"mixed"`` -> K7 bf16 then the plain f32 refine,
  ``solve_fused_distinct_tiled`` -> K6 on the split-free dual, and the plain
  ``solve_batched``), each under its JAX benchmark's configuration;
* the packed whole solve (kernel K8): ``solve_fused_packed`` on the main
  path's batch, timed beside K1 on the same call, with K1's verdicts;
* the H = 16 closed loop through ``MPCController.rollout_jit`` (the loop
  kept on the card, 200 steps) timed against ``rollout``;
* the command line, as subprocesses of ``python -m pqp_for_mpc_tpu_torch``:
  ``generate``, ``solve-file`` (engines auto, fused and mixed; the auto
  line held against the same command on the CPU), ``bench`` (riding K2),
  ``rollout --jit`` and ``serve``.

Each kernel is held against its plain version at the shapes its path gives
it.  The ``launches`` of the kernel table are those of each path's own
drive, counted from 0.  K7's row is its bf16 mode, the one its path runs;
its float32 mode is held and timed too, and sits in the row as
``float32_mode``.  The resident distinct route is held to the share of
lanes its benchmark configuration certifies in both packages
(:data:`DISTINCT_RESIDENT_CERTIFIED`) and to the plain solve's verdicts,
and prints the lanes it leaves uncertified.  Each kernel's ``bound_ms`` is
the least time an
H100 SXM could take for that call — the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations
(counted from this run's iterations) over 67 TFLOP/s in float32 or
989 TFLOP/s in bf16 — and ``bound_by`` names the term.  Where a kernel's
matrices exceed the 50 MB L2, the time its design takes to re-read them on
every pass (its stream floor, not a bound of the function) is printed on
the ``stream_floors`` line.  No single PyTorch call computes any of these
functions, so ``library_ms`` is null.  Every phase prints one JSON line and
raises on failure.  The last two lines are the kernel table
(``{"kernels": [...]}``) and the result line (``{"ok": true, "device":
{...}}``).  Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

#: the main path's batch (2^22 initial states)
B_MAIN = 1 << 22
#: the batch of the kernel-vs-plain comparisons
B_CMP = 1 << 16
#: the streamed workload (benchmarks/bench_tiled_solve.py's defaults)
N_BIG, M_BIG, B_BIG = 4096, 1024, 128
#: mean iterations the JAX package recorded on that workload under the
#: --accel configuration (benchmarks/MIXED_BENCH_r5.json, row 4): an
#: algorithmic cross-check only, not a gate and not a time
JAX_ITERS = {"f32": 4737.0, "mixed": 5714.4}
#: the distinct workloads: bench_distinct.py's defaults (resident) and
#: bench_mixed.py --distinct's (streamed)
B_DR, N_DR, M_DR = 1024, 400, 100
B_DS, N_DS, M_DS = 8, 2048, 512
#: mean iterations the JAX package recorded on the streamed distinct
#: workload (benchmarks/MIXED_BENCH_r5.json rows 1 and 5): a cross-check
JAX_DISTINCT_ITERS = {"f32": 5301.0, "mixed": "8229-8233"}
#: the share of the resident distinct workload that bench_distinct.py's
#: configuration certifies: the other lanes are still infeasible at
#: max_iters = 20,000 in both packages (the port certifies 966 of 1,024 on
#: an H100, kernel and plain alike; tests/test_torch_distinct.py solves 18
#: lanes of this draw in the JAX package — nine of the card's uncertified
#: lanes, spread over the batch, and nine it certified: the JAX package
#: leaves the first nine infeasible at max_iters and certifies the others
#: in as many iterations as the card), so this route is held to that share
#: and to the plain solve's verdicts, not to 99%
DISTINCT_RESIDENT_CERTIFIED = 0.93

#: the H=16 closed loop's batch for the K8 comparisons (N=64, G=2), and the
#: length of the rollout_jit drive
B_N64, LOOP_STEPS = 4096, 200
#: the solve-file flags of tests/test_torch_cli.py (tests/test_cli.py's
#: with erc = eac = 1e-4) and the generator seed whose 12 x 30 instance
#: certifies in both packages under them
CLI_FLAGS = ["--y0", "0.01", "--accel-every", "4", "--check-every", "8",
             "--no-strict", "--max-iters", "50000", "--eaj", "1e-3",
             "--erj", "1e-4", "--erc", "1e-4", "--eac", "1e-4"]
CLI_SEED = 3

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32 on the
#: CUDA cores and bf16 on the tensor cores, FLOP/s; and the L2 size
HBM_BPS, F32_FLOPS, BF16_FLOPS, L2_BYTES = 3.35e12, 67e12, 989e12, 50e6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def mpc_spec(horizon: int = 7, r: float = 2.5):
    """The double integrator at ``horizon`` (M = horizon, N = 4 horizon),
    |u| <= 1, |du| <= 0.5, reference ``r``: horizon 7 with r = 2.5 is the
    main path's M=7/N=28 workload, horizon 16 with r = 0 the closed loop."""
    from pqp_for_mpc_tpu_torch.models import MPCSpec, double_integrator
    return MPCSpec(double_integrator(), horizon=horizon, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([r]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))


def workload(B: int, device, seed: int = 0, horizon: int = 7,
             r: float = 2.5):
    """A batch of ``mpc_spec(horizon, r)`` from x0 ~ N(0, 0.5^2) drawn
    with NumPy: (primal, dual)."""
    from pqp_for_mpc_tpu_torch import dualize
    from pqp_for_mpc_tpu_torch.models import condense
    import torch
    data = condense(mpc_spec(horizon, r), device=device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0.0, 0.5, (2, B)).astype(np.float32),
                        device=device)
    primal = data.assemble(x=x, Qp=data.qp())
    return primal, dualize(primal)


def streamed_workload(device, seed: int = 0):
    """The N=4096/M=1024/B=128 random QP of the JAX package's streamed
    benchmarks, built from ``seed`` with NumPy exactly as
    ``benchmarks/bench_tiled_solve.py:build`` builds it: (primal, dual)."""
    import torch
    from pqp_for_mpc_tpu_torch import PrimalQP, dualize
    N, M, B = N_BIG, M_BIG, B_BIG
    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    Gp = rng.normal(0, 1, (N, M)).astype(np.float32)
    Fp = rng.normal(0, 3, (M, B)).astype(np.float32)
    Kp = rng.uniform(1, 10, (N,)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    primal = PrimalQP(Qp=t(Qp), Qp_inv=t(np.linalg.inv(Qp)), Fp=t(Fp),
                      Mp=torch.zeros(B, device=device), Gp=t(Gp), Kp=t(Kp))
    return primal, dualize(primal)


def distinct_workload(B: int, M: int, N: int, device, seed: int = 0,
                      gaussian_gp: bool = False):
    """B distinct random QPs drawn from ``seed`` with NumPy exactly as
    ``benchmarks/bench_distinct.py:make_instances`` draws them: a dense SPD
    Qp per instance and {-1, 0, 1} Gp, or (``gaussian_gp``) gaussian Gp with
    ``(M - 2) I`` added to Qp.  Returns the port's PrimalQP."""
    import torch
    from pqp_for_mpc_tpu_torch import PrimalQP
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, M, M)).astype(np.float32) / np.sqrt(M)
    Qp = np.einsum("bij,bkj->bik", L, L) + 2.0 * np.eye(M, dtype=np.float32)
    if gaussian_gp:
        Qp = Qp + (M - 2.0) * np.eye(M, dtype=np.float32)
        Qp_inv = np.linalg.inv(Qp).astype(np.float32)
        Gp = rng.standard_normal((B, N, M)).astype(np.float32)
        Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
        Mp = np.zeros(B, np.float32)
        Kp = rng.uniform(1.0, 10.0, (N, B)).astype(np.float32)
    else:
        Qp_inv = np.linalg.inv(Qp).astype(np.float32)
        Gp = rng.integers(-1, 2, (B, N, M)).astype(np.float32)
        Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
        Mp = rng.standard_normal(B).astype(np.float32)
        Kp = rng.uniform(1.0, 8.0, (N, B)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return PrimalQP(Qp=t(Qp), Qp_inv=t(Qp_inv), Fp=t(Fp), Mp=t(Mp),
                    Gp=t(Gp), Kp=t(Kp))


def stored_bytes(*tensors) -> int:
    """Bytes of the distinct storages behind ``tensors`` (a stride-0 view
    counts as the storage it reads)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def bound(in_bytes: float, out_bytes: float, flops: float,
          peak: float) -> dict:
    """The least time the card could take: bytes (inputs once, outputs
    once) over HBM against operations over ``peak``."""
    t_bytes = (in_bytes + out_bytes) / HBM_BPS * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def stream_floor_ms(stream_bytes: float) -> float:
    """The floor of a design that re-reads ``stream_bytes`` from HBM (its
    matrices exceed the L2): milliseconds at 3.35 TB/s."""
    return stream_bytes / HBM_BPS * 1e3


def solve_work(n: int, m: int, iters, check_every: int, accel_every: int,
               update_bytes: float, check_bytes: float,
               accel_bytes: float):
    """(flops, streamed bytes) of whole solves whose lanes exited at
    ``iters``: per lane ``iters - 1`` updates (two n x n products), one
    check per ``check_every`` updates plus the final one (Gp'Y, Qp^-1 t,
    Gp U, Qd Y, Qp U), one accel step (three Qd products) per
    ``accel_every`` updates; ``*_bytes`` are the matrix bytes one such pass
    re-reads for one lane (0 where they stay on chip)."""
    import torch
    upd = (iters.long() - 1).clamp(min=0).double()
    checks = torch.div(upd, check_every, rounding_mode="floor") + 2
    acc = (torch.div(upd, accel_every, rounding_mode="floor")
           if accel_every else upd * 0)
    flops = (upd * 4 * n * n + checks * (4 * n * m + 2 * n * n + 4 * m * m)
             + acc * 6 * n * n)
    streamed = upd * update_bytes + checks * check_bytes + acc * accel_bytes
    return float(flops.sum()), float(streamed.sum())


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (after one warm-up
    unless ``warmup`` is False), timed with CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k2_parity(got, want) -> dict:
    """K2 against its plain version: rtol = atol = 1e-5 (the bar of
    tests/test_kernels.py)."""
    err = (got - want).abs()
    return dict(max_abs_err=float(err.max()), rtol=1e-5, atol=1e-5,
                ok=bool((err <= 1e-5 + 1e-5 * want.abs()).all()))


def k1_parity(primal, dual, cfg, out_kernel, out_plain) -> dict:
    """K1 against its plain version, both wrapped as ``solve_fused`` wraps
    them: converged flags equal on >= 99.9% of lanes, iterations within
    max(5, iters // 5), U within 5e-3 * max(1, |U|max)."""
    import torch
    from pqp_for_mpc_tpu_torch.ops.solve_kernel import fused_result
    res_k = fused_result(primal, dual, cfg, *out_kernel)
    res_p = fused_result(primal, dual, cfg, *out_plain)
    conv_agree = float((res_k.converged == res_p.converged).float().mean())
    it_k, it_p = res_k.iters.long(), res_p.iters.long()
    iters_ok = bool(((it_k - it_p).abs()
                     <= torch.clamp(it_p // 5, min=5)).all())
    tol = 5e-3 * max(1.0, float(res_p.U.abs().max()))
    err = float((res_k.U - res_p.U).abs().max())
    return dict(converged_agree=conv_agree, iters_within_bar=iters_ok,
                iters_mean_kernel=float(it_k.float().mean()),
                iters_mean_plain=float(it_p.float().mean()),
                max_abs_err=err, tol_U=tol,
                ok=conv_agree >= 0.999 and iters_ok and err <= tol)


def k3_parity(got, want, rtol: float) -> dict:
    """K3 against its plain version: |err| <= 1e-5 + rtol * |want|.  rtol
    1e-5 in float32 mode (the bar of tests/test_tiled_kernel.py); 1e-3 in
    bf16 mode, a quarter of one bf16 step: a one-ulp float32 difference in
    a sum can flip the bf16 rounding of an entry of y in the next update."""
    err = (got - want).abs()
    return dict(max_abs_err=float(err.max()), rtol=rtol, atol=1e-5,
                ok=bool((err <= 1e-5 + rtol * want.abs()).all()))


def solve_parity(out_kernel, out_plain, check_every: int,
                 accel: bool = False) -> dict:
    """A whole-solve kernel (K4, K5, K6, K8) against its plain version: lane
    states equal, iterations within max(5, iters // 5) rounded up to whole
    checks, U within 5e-3 * max(1, |U|max) (k1_parity's bar).  With
    ``accel`` the iteration bar holds on 99% of lanes, as in K1's card
    tests: the accel step is kept when f(Y_new) <= f(Y), two float32 values
    equal to rounding near the optimum."""
    import torch
    _, u_k, it_k, st_k = out_kernel
    _, u_p, it_p, st_p = out_plain
    states_equal = bool((st_k == st_p).all())
    bar = torch.clamp(it_p.long() // 5, min=5)
    bar = -(-bar // check_every) * check_every
    in_bar = float(((it_k.long() - it_p.long()).abs() <= bar).float().mean())
    tol = 5e-3 * max(1.0, float(u_p.abs().max()))
    err = float((u_k - u_p).abs().max())
    return dict(states_equal=states_equal, iters_in_bar=in_bar,
                iters_mean_kernel=float(it_k.float().mean()),
                iters_mean_plain=float(it_p.float().mean()),
                certified_kernel=int((st_k == 1).sum()),
                max_abs_err=err, tol_U=tol,
                ok=(states_equal and err <= tol
                    and in_bar >= (0.99 if accel else 1.0)))


def razor_edge_audit(primal, dual, cfg, Y, lanes) -> list:
    """The float64 audit of ROADMAP's razor-edge rule
    (``benchmarks/conformance.py:f64_gap_audit``, extended to every part
    of the test): for each lane, each tested quantity of the four-part
    test recomputed in float64 from the float32 iterate ``Y``, its
    distance to its threshold and the float32 noise floor there (eps32
    times the largest term entering it).  A lane is razor-edge when one of
    its tests sits within its floor."""
    import torch
    f64 = lambda t: t.double()
    out = []
    for b in lanes:
        col = lambda t: f64(t if t.dim() == 1 else t[:, b])
        y = f64(Y[:, b])
        Kp, Fp, Fd = col(primal.Kp), col(primal.Fp), col(dual.Fd)
        u = -f64(primal.Qp_inv) @ (Fp + f64(primal.Gp).T @ y)
        gu = f64(primal.Gp) @ u
        slack = Kp + torch.clamp(cfg.erc * Kp, min=cfg.eac)
        feas = float((gu - slack).max())
        feas_floor = 2.0 ** -23 * float(gu.abs().max())
        qy, fy = float(y @ (f64(dual.Qd) @ y)), float(Fd @ y)
        md = float(f64(dual.Md.reshape(-1))[b if dual.Md.dim() else 0])
        mp = float(f64(primal.Mp.reshape(-1))[b if primal.Mp.dim() else 0])
        uq = float(u @ (f64(primal.qp()) @ u))
        fu = float(Fp @ u)
        jd = 0.5 * qy + fy + 0.5 * md
        if cfg.gap_from_complementarity:
            gap, terms = qy + fy, [qy, fy]
        else:
            gap = 0.5 * uq + fu + 0.5 * mp + jd
            terms = [uq, fu, mp, qy, fy, md]
        gap_floor = 2.0 ** -23 * max(abs(v) for v in terms)
        margins = {"feas": (feas, feas_floor),
                   "gap_abs": (gap - cfg.eaj, gap_floor),
                   "gap_rel": (gap / abs(jd) - cfg.erj, gap_floor / abs(jd))}
        out.append(dict(lane=int(b), **{k: [m, f] for k, (m, f) in
                                        margins.items()},
                        razor=any(abs(m) <= f for m, f in margins.values())))
    return out


def timed_once(fn):
    """(result, milliseconds) of one call of ``fn``, CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run_cli(*argv, stdin=None, timeout=300):
    """``python -m pqp_for_mpc_tpu_torch *argv`` from the checkout's root:
    (exit code, stdout, stderr)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "pqp_for_mpc_tpu_torch", *map(str, argv)],
        input=stdin, capture_output=True, text=True, cwd=root, env=env,
        timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def cli_fields(line: str) -> dict:
    return dict(kv.split("=", 1) for kv in line.split() if "=" in kv)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pqp_for_mpc_tpu_torch as pqp
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
    from pqp_for_mpc_tpu_torch.models import MPCController
    from pqp_for_mpc_tpu_torch.ops import (build, kernels, packed_kernel,
                                           solve_kernel, tiled_kernel,
                                           tiled_solve_kernel)
    require("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", 0)
    # the slice's configuration: MPC_CONFIG's tolerances with the
    # reference's forcing-scale feasibility test (which the whole-solve
    # kernel certifies in-kernel) and no acceleration
    smoke_cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                                    accel_every=0, max_iters=5000)

    # -- phase 1: device and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    emit("device_and_build", device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=build_s, library=str(build.library_path()))
    # the plain versions' products must be full float32 (no TF32)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    emit("plain_precision", allow_tf32=tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    require(not tf32, "torch.backends.cuda.matmul.allow_tf32 is on")

    # -- phase 2: K2 against its plain version ---------------------------
    primal, dual = workload(B_CMP, dev)
    N = dual.n_con
    rng = np.random.default_rng(1)
    Y = torch.as_tensor(rng.uniform(0.01, 10.0, (N, B_CMP))
                        .astype(np.float32), device=dev)
    k2_args = (dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Y)
    before = kernels.fused_pqp_iterations.launches
    got = kernels.fused_pqp_iterations(*k2_args, num_iters=8,
                                       den_eps=smoke_cfg.den_eps)
    want = kernels.fused_pqp_iterations_reference(
        *k2_args, num_iters=8, den_eps=smoke_cfg.den_eps)
    torch.cuda.synchronize()
    require(kernels.fused_pqp_iterations.launches == before + 1,
            "K2 launch counter did not move")
    k2_cmp = k2_parity(got, want)
    emit("k2_vs_plain", batch=B_CMP, num_iters=8, **k2_cmp)
    require(k2_cmp["ok"], f"K2 disagrees with its plain version: {k2_cmp}")

    # -- phase 3: K1 (solve_fused) against its plain version -------------
    args, kw = solve_kernel.fused_inputs(primal, dual, None, smoke_cfg)
    before = solve_kernel.fused_full_solve.launches
    out_k = solve_kernel.fused_full_solve(*args, **kw)
    out_p = solve_kernel.fused_full_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    require(solve_kernel.fused_full_solve.launches == before + 1,
            "K1 launch counter did not move")
    k1_cmp = k1_parity(primal, dual, smoke_cfg, out_k, out_p)
    emit("k1_vs_plain", batch=B_CMP, **k1_cmp)
    require(k1_cmp["ok"], f"K1 disagrees with its plain version: {k1_cmp}")
    errs = {"k1": [k1_cmp["max_abs_err"]], "k2": [k2_cmp["max_abs_err"]]}
    del primal, dual, Y, got, want, out_k, out_p, args
    torch.cuda.empty_cache()

    # -- phase 3b: K8 (packed whole solve) against its plain version, at
    #    N=28 (G=4) on B_CMP lanes and N=64 (G=2) on the H=16 workload --
    k8 = packed_kernel.fused_full_solve_packed
    k8_plain = packed_kernel.fused_full_solve_packed_reference
    accel_cfg = dataclasses.replace(smoke_cfg, check_every=4, accel_every=4)
    mpc_cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False)
    k8_cases = [
        ("n28", lambda: workload(B_CMP, dev), smoke_cfg, False),
        ("n28_accel", lambda: workload(B_CMP, dev), accel_cfg, False),
        ("n28_per_lane_kp", lambda: workload(B_CMP, dev), dataclasses.replace(
            smoke_cfg, gap_from_complementarity=False), True),
        ("n64", lambda: workload(B_N64, dev, horizon=16, r=0.0), smoke_cfg,
         False),
        ("n64_accel", lambda: workload(B_N64, dev, horizon=16, r=0.0),
         mpc_cfg, False),
    ]
    errs["k8"] = []
    for name, make, cfg, per_lane_kp in k8_cases:
        primal, dual = make()
        if per_lane_kp:
            kp = torch.as_tensor(np.random.default_rng(6).uniform(
                0.0, 2.0, (dual.n_con, primal.Fp.shape[1])).astype(
                    np.float32), device=dev)
            primal = dataclasses.replace(primal, Kp=primal.Kp[:, None] + kp)
            dual = pqp.dualize(primal)
        args, kw = solve_kernel.fused_inputs(primal, dual, None, cfg)
        before = k8.launches
        out_k = k8(*args, **kw)
        out_p = k8_plain(*args, **kw)
        again = k8(*args, **kw)
        torch.cuda.synchronize()
        require(k8.launches == before + 2, "K8 launch counter did not move")
        cmp = solve_parity(out_k, out_p, cfg.check_every,
                           bool(cfg.accel_every))
        repeat = all(bool((a == b).all()) for a, b in zip(out_k, again))
        emit("k8_vs_plain", case=name, n=dual.n_con, m=primal.n_var,
             batch=primal.Fp.shape[1], pack=packed_kernel.pack_factor(
                 dual.n_con), repeats_bits=repeat, **cmp)
        require(cmp["ok"], f"K8 ({name}) disagrees with its plain version: "
                           f"{cmp}")
        require(repeat, f"K8 ({name}) did not repeat its bits")
        errs["k8"].append(cmp["max_abs_err"])
        del primal, dual, args, out_k, out_p, again
    torch.cuda.empty_cache()

    # -- phase 4: the main path at full size -----------------------------
    primal, dual = workload(B_MAIN, dev)
    kernels.fused_pqp_iterations.launches = 0
    solve_kernel.fused_full_solve.launches = 0
    route = pqp.route_solve(dual.n_con, B_MAIN, False, smoke_cfg,
                            m_dim=primal.n_var, platform="cuda")
    require(route == "fused", f"cold B=2^22 routed to {route!r}")
    k2_cfg = dataclasses.replace(smoke_cfg, use_pallas=True)
    runs = {
        "k1_route": lambda: pqp.solve_auto(primal, dual, cfg=smoke_cfg),
        "k2_route": lambda: pqp.solve_batched(primal, dual, cfg=k2_cfg),
        "plain": lambda: pqp.solve_batched(primal, dual, cfg=smoke_cfg),
    }
    main_rows = {}
    for name, fn in runs.items():
        res = fn()
        torch.cuda.synchronize()
        conv = float(res.converged.float().mean())
        ms = cuda_ms(fn, reps=2)
        main_rows[name] = dict(
            converged_frac=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()), seconds_per_batch=ms / 1e3,
            solves_per_s=B_MAIN / (ms / 1e3))
        emit("main_path", engine=name, batch=B_MAIN, **main_rows[name])
        require(conv >= 0.99, f"{name}: only {conv:.4f} converged")
        del res
    # the main path's launches, read before any later phase launches more
    launches = {"k1": solve_kernel.fused_full_solve.launches,
                "k2": kernels.fused_pqp_iterations.launches}
    emit("main_path_launches", **launches)
    require(launches["k1"] > 0, "solve_auto did not launch K1")
    require(launches["k2"] > 0,
            "solve_batched(use_pallas=True) did not launch K2")

    # -- phase 4b: the K8 path at full size: solve_fused_packed on the main
    #    workload, beside K1 (solve_auto's route) on the same batch -------
    k8.launches = 0
    res8 = pqp.solve_fused_packed(primal, dual, cfg=smoke_cfg)
    torch.cuda.synchronize()
    launches["k8"] = k8.launches
    res1 = pqp.solve_auto(primal, dual, cfg=smoke_cfg)
    conv8 = float(res8.converged.float().mean())
    differ = torch.nonzero(res8.converged != res1.converged).flatten()
    audit = razor_edge_audit(
        primal, dual, smoke_cfg,
        torch.where(res8.converged[None, :], res8.Y, res1.Y),
        differ.tolist()) if len(differ) else []
    k8_route_ms = cuda_ms(
        lambda: pqp.solve_fused_packed(primal, dual, cfg=smoke_cfg), reps=2)
    k1_route_ms = cuda_ms(
        lambda: pqp.solve_auto(primal, dual, cfg=smoke_cfg), reps=2)
    emit("k8_path", batch=B_MAIN, converged_frac=conv8,
         iters_mean=float(res8.iters.float().mean()),
         iters_max=int(res8.iters.max()),
         verdicts_differ_from_k1=len(differ), razor_edge_lanes=audit,
         k8_route_seconds_per_batch=k8_route_ms / 1e3,
         k1_route_seconds_per_batch=k1_route_ms / 1e3,
         k8_route_solves_per_s=B_MAIN / (k8_route_ms / 1e3),
         launches=launches["k8"], nvidia_smi=smi)
    require(conv8 >= 0.99, f"solve_fused_packed: only {conv8:.4f} converged")
    require(all(a["razor"] for a in audit),
            "K8 and K1 verdicts differ on a lane outside the float32 "
            f"noise floor: {[a for a in audit if not a['razor']]}")
    require(launches["k8"] > 0, "solve_fused_packed did not launch K8")
    del res8, res1

    # -- phase 5: the closed loop ----------------------------------------
    spec = mpc_spec(16, 0.0)
    ctrl = MPCController(spec, device=dev)
    out = ctrl.rollout([2.0, 0.0], 20)
    loop_ok = (bool(out["converged"].all()) and int(out["iters"].max()) < 2000
               and bool(np.isfinite(out["x"]).all()))
    emit("closed_loop", steps=20, certified=int(out["converged"].sum()),
         iters_max=int(out["iters"].max()),
         x_final=out["x"][-1].tolist(), ok=loop_ok)
    require(loop_ok, "closed loop failed to certify every step")
    k2_before = kernels.fused_pqp_iterations.launches
    fan = MPCController(spec, cfg=dataclasses.replace(MPC_CONFIG,
                                                      use_pallas=True),
                        device=dev)
    xs = np.random.default_rng(2).normal(0.0, 0.5, (2, 4096))
    _, res = fan.step(xs.astype(np.float32))
    torch.cuda.synchronize()
    fan_conv = float(res.converged.float().mean())
    emit("scenario_fan_out", batch=4096, converged_frac=fan_conv,
         iters_max=int(res.iters.max()),
         k2_launches=kernels.fused_pqp_iterations.launches - k2_before)
    require(kernels.fused_pqp_iterations.launches > k2_before,
            "the fan-out step did not launch K2")

    # -- phase 5b: the H=16 closed loop kept on the card (rollout_jit),
    #    timed against the host loop (rollout) on the same spec ---------
    loop = {}
    for name in ("rollout_jit", "rollout"):
        ctrl = MPCController(mpc_spec(16, 0.0), device=dev)
        getattr(ctrl, name)([2.0, 0.0], 5)            # warm-up
        ctrl.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop[name] = getattr(ctrl, name)([2.0, 0.0], LOOP_STEPS)
        torch.cuda.synchronize()
        loop[name]["seconds"] = time.perf_counter() - t0
    lj, lh = loop["rollout_jit"], loop["rollout"]
    tol_u = 5e-3 * max(1.0, float(np.abs(lh["u"]).max()))
    bar = np.maximum(5, lh["iters"] // 5)
    bar = -(-bar // MPC_CONFIG.check_every) * MPC_CONFIG.check_every
    in_bar = float((np.abs(lj["iters"] - lh["iters"]) <= bar).mean())
    du = float(np.abs(lj["u"] - lh["u"]).max())
    emit("closed_loop_h16_rollout_jit", steps=LOOP_STEPS, nvidia_smi=smi,
         steps_per_s_rollout_jit=LOOP_STEPS / lj["seconds"],
         steps_per_s_rollout=LOOP_STEPS / lh["seconds"],
         certified_rollout_jit=int(lj["converged"].sum()),
         certified_rollout=int(lh["converged"].sum()),
         iters_mean_rollout_jit=float(lj["iters"].mean()),
         iters_mean_rollout=float(lh["iters"].mean()),
         iters_in_bar=in_bar, max_abs_err_u=du, tol_u=tol_u,
         max_abs_err_x=float(np.abs(lj["x"] - lh["x"]).max()))
    require(bool(lj["converged"].all()),
            "rollout_jit left a step of the H=16 loop uncertified")
    require(bool(lh["converged"].all()),
            "rollout left a step of the H=16 loop uncertified")
    # the bars of tests/test_torch_rollout.py: u within the U bar, the
    # iteration bar on 26 of 30 steps' share, mean iterations within 10%
    require(du <= tol_u and in_bar >= 26 / 30
            and abs(lj["iters"].mean() - lh["iters"].mean())
            <= 0.1 * lh["iters"].mean(),
            "rollout_jit and rollout disagree on the H=16 loop")

    # -- each kernel against its plain version at the main path's shapes,
    #    then both timed ------------------------------------------------
    args, kw = solve_kernel.fused_inputs(primal, dual, None, smoke_cfg)
    out_k1 = solve_kernel.fused_full_solve(*args, **kw)
    k1_cmp = k1_parity(primal, dual, smoke_cfg, out_k1,
                       solve_kernel.fused_full_solve_reference(*args, **kw))
    emit("k1_vs_plain", batch=B_MAIN, **k1_cmp)
    require(k1_cmp["ok"], f"K1 disagrees with its plain version at the "
                          f"main path's batch: {k1_cmp}")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    Yb = 0.01 + 9.99 * torch.rand((dual.n_con, B_MAIN), generator=g,
                                  device=dev)
    k2_args = (dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Yb)
    k2_kw = dict(num_iters=smoke_cfg.check_every, den_eps=smoke_cfg.den_eps)
    k2_cmp = k2_parity(
        kernels.fused_pqp_iterations(*k2_args, **k2_kw),
        kernels.fused_pqp_iterations_reference(*k2_args, **k2_kw))
    emit("k2_vs_plain", batch=B_MAIN, num_iters=smoke_cfg.check_every,
         **k2_cmp)
    require(k2_cmp["ok"], f"K2 disagrees with its plain version at the "
                          f"main path's batch: {k2_cmp}")
    errs["k1"].append(k1_cmp["max_abs_err"])
    errs["k2"].append(k2_cmp["max_abs_err"])
    out_k8 = k8(*args, **kw)
    out_p8, k8_plain_ms = timed_once(lambda: k8_plain(*args, **kw))
    k8_cmp = solve_parity(out_k8, out_p8, smoke_cfg.check_every, False)
    emit("k8_vs_plain", case="main_path", n=dual.n_con, m=primal.n_var,
         batch=B_MAIN, pack=packed_kernel.pack_factor(dual.n_con), **k8_cmp)
    require(k8_cmp["ok"], f"K8 disagrees with its plain version at the "
                          f"main path's batch: {k8_cmp}")
    errs["k8"].append(k8_cmp["max_abs_err"])
    del out_p8

    k1_ms = cuda_ms(lambda: solve_kernel.fused_full_solve(*args, **kw), 2)
    k1_plain_ms = cuda_ms(
        lambda: solve_kernel.fused_full_solve_reference(*args, **kw), 1)
    k8_ms = cuda_ms(lambda: k8(*args, **kw), 2)
    k2_ms = cuda_ms(lambda: kernels.fused_pqp_iterations(*k2_args, **k2_kw),
                    10)
    k2_plain_ms = cuda_ms(
        lambda: kernels.fused_pqp_iterations_reference(*k2_args, **k2_kw), 10)
    emit("kernel_times", batch=B_MAIN, nvidia_smi=smi, k1_ms=k1_ms,
         k1_plain_ms=k1_plain_ms, k8_ms=k8_ms, k8_plain_ms=k8_plain_ms,
         k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
         k2_num_iters=smoke_cfg.check_every)
    n28, m7 = dual.n_con, primal.n_var
    k1_flops, _ = solve_work(n28, m7, out_k1[2], smoke_cfg.check_every,
                             smoke_cfg.accel_every, 0, 0, 0)
    bounds = {
        "k1": bound(stored_bytes(*args), sum(
            t.numel() * t.element_size() for t in out_k1), k1_flops,
            F32_FLOPS),
        "k2": bound(stored_bytes(*k2_args), 4 * Yb.numel(),
                    k2_kw["num_iters"] * 4.0 * n28 * n28 * B_MAIN,
                    F32_FLOPS),
    }
    # K8 computes K1's function: the bound counts N^2 per product per
    # instance (the function's work), not the kronned (G n_pad)^2
    k8_flops, _ = solve_work(n28, m7, out_k8[2], smoke_cfg.check_every,
                             smoke_cfg.accel_every, 0, 0, 0)
    bounds["k8"] = bound(stored_bytes(*args), sum(
        t.numel() * t.element_size() for t in out_k8), k8_flops, F32_FLOPS)
    del out_k1, out_k8
    del primal, dual, Yb, k2_args, args, kw
    torch.cuda.empty_cache()

    # -- phase 6: the streamed kernels against their plain versions ------
    big_cfg = pqp.SolverConfig(max_iters=30000, check_every=16,
                               accel_every=16, strict_weak_duality=False,
                               gap_from_complementarity=True)
    lp, ld = streamed_workload(dev)
    Y3 = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 2.0, (N_BIG, B_BIG)).astype(np.float32), device=dev)
    streams = {mode: tiled_kernel.streamed_matrix(ld.Qd, ld.theta, mode)
               for mode in ("float32", "bfloat16")}
    k3_kw = dict(num_iters=big_cfg.check_every, den_eps=big_cfg.den_eps)
    for mode, (Q, th) in streams.items():
        k3_args = (Q, th, ld.Fdn, ld.Fdp, Y3)
        cmp = k3_parity(
            tiled_kernel.streamed_pqp_iterations(*k3_args, **k3_kw),
            tiled_kernel.streamed_pqp_iterations_reference(*k3_args, **k3_kw),
            rtol=1e-5 if mode == "float32" else 1e-3)
        emit("k3_vs_plain", mode=mode, n=N_BIG, batch=B_BIG,
             num_iters=big_cfg.check_every, **cmp)
        require(cmp["ok"], f"K3 ({mode}) disagrees with its plain version: "
                           f"{cmp}")
        errs["k3_" + mode] = [cmp["max_abs_err"]]
    t_args, t_kw = tiled_solve_kernel.tiled_inputs(lp, ld, None, big_cfg)
    k4_plain_t0 = time.perf_counter()
    out_p = tiled_solve_kernel.fused_full_solve_tiled_reference(*t_args,
                                                                **t_kw)
    torch.cuda.synchronize()
    k4_plain_first_s = time.perf_counter() - k4_plain_t0
    out_k4 = tiled_solve_kernel.fused_full_solve_tiled(*t_args, **t_kw)
    k4_cmp = solve_parity(out_k4, out_p, big_cfg.check_every)
    emit("k4_vs_plain", n=N_BIG, m=M_BIG, batch=B_BIG, **k4_cmp)
    require(k4_cmp["ok"], f"K4 disagrees with its plain version: {k4_cmp}")
    errs["k4"] = [k4_cmp["max_abs_err"]]
    del out_p

    # -- phase 7: the streamed large-N path at full size ------------------
    route = pqp.route_solve(N_BIG, B_BIG, False, big_cfg, m_dim=M_BIG,
                            platform="cuda")
    require(route == "mixed", f"N={N_BIG} routed to {route!r}")
    k3_counts = tiled_kernel.streamed_pqp_iterations.launches
    k3_counts["float32"] = k3_counts["bfloat16"] = 0
    tiled_solve_kernel.fused_full_solve_tiled.launches = 0
    big_runs = {
        "mixed_route": (lambda: pqp.solve_auto(lp, ld, cfg=big_cfg),
                        "mixed"),
        "k4_route": (lambda: tiled_solve_kernel.solve_fused_tiled(
            lp, ld, cfg=big_cfg), "f32"),
        "plain": (lambda: pqp.solve_batched(lp, ld, cfg=big_cfg), "f32"),
    }
    big_rows = {}
    for name, (fn, record) in big_runs.items():
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        conv = float(res.converged.float().mean())
        big_rows[name] = dict(
            converged_frac=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()),
            jax_record_iters_mean=JAX_ITERS[record],
            seconds_first_run=time.perf_counter() - t0)
        require(conv >= 0.99, f"{name}: only {conv:.4f} converged")
        del res
    big_launches = {"k3_float32": k3_counts["float32"],
                    "k3_bfloat16": k3_counts["bfloat16"],
                    "k4": tiled_solve_kernel.fused_full_solve_tiled.launches}
    emit("large_n_launches", **big_launches)
    require(big_launches["k3_bfloat16"] > 0,
            "solve_auto (mixed) did not launch K3 in bf16 mode")
    require(big_launches["k3_float32"] > 0,
            "solve_auto (mixed) did not launch K3 in f32 mode")
    require(big_launches["k4"] > 0, "solve_fused_tiled did not launch K4")
    for name, (fn, _) in big_runs.items():
        ms = cuda_ms(fn, reps=1, warmup=False)
        emit("large_n_path", engine=name, n=N_BIG, m=M_BIG, batch=B_BIG,
             seconds_per_batch=ms / 1e3, nvidia_smi=smi, **big_rows[name])

    # -- phase 8: the streamed kernels timed beside their plain versions --
    big_times = {}
    for mode, (Q, th) in streams.items():
        k3_args = (Q, th, ld.Fdn, ld.Fdp, Y3)
        big_times["k3_" + mode] = (
            cuda_ms(lambda: tiled_kernel.streamed_pqp_iterations(
                *k3_args, **k3_kw), 5),
            cuda_ms(lambda: tiled_kernel.streamed_pqp_iterations_reference(
                *k3_args, **k3_kw), 5))
    big_times["k4"] = (
        cuda_ms(lambda: tiled_solve_kernel.fused_full_solve_tiled(
            *t_args, **t_kw), 1, warmup=False),
        cuda_ms(lambda: tiled_solve_kernel.fused_full_solve_tiled_reference(
            *t_args, **t_kw), 1, warmup=False))
    floors = {}
    for mode, (Q, th) in streams.items():
        q_bytes = Q.numel() * Q.element_size()
        bounds["k3_" + mode] = bound(
            stored_bytes(Q, th, ld.Fdn, ld.Fdp, Y3), 4 * Y3.numel(),
            k3_kw["num_iters"] * 4.0 * N_BIG * N_BIG * B_BIG,
            F32_FLOPS if mode == "float32" else BF16_FLOPS)
        if q_bytes > L2_BYTES:
            floors["k3_" + mode] = stream_floor_ms(k3_kw["num_iters"]
                                                   * q_bytes)
    # K4 streams its matrices once per pass for every lane together:
    # rounds of check_every updates, a check (Qd_hat, Gp twice, Qp,
    # Qp^-1) and the accel step (three Qd_hat passes)
    k4_flops, _ = solve_work(N_BIG, M_BIG, out_k4[2], big_cfg.check_every,
                             big_cfg.accel_every, 0, 0, 0)
    rounds = (int(out_k4[2].max()) - 1) // big_cfg.check_every + 2
    qh_b, gp_b, qp_b = 4 * N_BIG ** 2, 4 * N_BIG * M_BIG, 4 * M_BIG ** 2
    bounds["k4"] = bound(
        stored_bytes(*t_args), sum(t.numel() * t.element_size()
                                   for t in out_k4), k4_flops, F32_FLOPS)
    floors["k4"] = stream_floor_ms(
        rounds * ((big_cfg.check_every + 1 + (3 if big_cfg.accel_every
                                              else 0)) * qh_b
                  + 2 * gp_b + 2 * qp_b))
    del out_k4
    emit("streamed_kernel_times", n=N_BIG, m=M_BIG, batch=B_BIG,
         nvidia_smi=smi, k3_num_iters=big_cfg.check_every,
         k4_plain_first_run_s=k4_plain_first_s,
         **{f"{k}_ms": v[0] for k, v in big_times.items()},
         **{f"{k}_plain_ms": v[1] for k, v in big_times.items()})
    del lp, ld, streams, Y3, t_args
    torch.cuda.empty_cache()

    # -- phase 9: the H=64 closed loop past residency ---------------------
    # N = 256 > 128: the router sends the warm single-lane steps to "mixed";
    # the same loop through the plain route, for the comparison
    import pqp_for_mpc_tpu_torch.models.mpc as mpc_module
    spec64 = mpc_spec(64, 0.0)
    route64 = pqp.route_solve(256, 1, False, MPC_CONFIG, m_dim=64,
                              platform="cuda", warm=True)
    require(route64 == "mixed", f"H=64 warm step routed to {route64!r}")
    auto = mpc_module.solve_auto
    loop_rows = {}
    for engine in ("mixed", "xla"):
        mpc_module.solve_auto = (
            lambda *a, _e=engine, **k: auto(*a, engine=_e, **k))
        try:
            ctrl64 = MPCController(spec64, device=dev)
            t0 = time.perf_counter()
            out64 = ctrl64.rollout([2.0, 0.0], 20)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            mpc_module.solve_auto = auto
        loop_rows[engine] = secs
        emit("closed_loop_h64", engine=engine, steps=20,
             certified=int(out64["converged"].sum()),
             iters=out64["iters"].tolist(), seconds=secs,
             seconds_per_step=secs / 20, nvidia_smi=smi)
        require(bool(out64["converged"].all()),
                f"H=64 loop through {engine!r} left a step uncertified")
    emit("closed_loop_h64_route", routed="mixed",
         faster=min(loop_rows, key=loop_rows.get),
         ratio_mixed_over_xla=loop_rows["mixed"] / loop_rows["xla"])

    # -- phase 10: the distinct resident path (K5) -------------------------
    from pqp_for_mpc_tpu_torch.ops import (distinct_kernel,
                                           distinct_tiled_kernel)
    # bench_distinct.py's configuration (its lines 83-85)
    dr_cfg = pqp.SolverConfig(max_iters=20000, check_every=8, y0=1.0,
                              erc=1e-4, eac=1e-4, eaj=1e-3, erj=1e-4,
                              strict_weak_duality=False)
    dp = distinct_workload(B_DR, M_DR, N_DR, dev)
    dd = pqp.dualize_distinct(dp, theta_floor=dr_cfg.theta_floor)
    d_args, d_kw = distinct_kernel.distinct_inputs(dp, dd, None, dr_cfg)
    out_k5 = distinct_kernel.fused_full_solve_distinct(*d_args, **d_kw)
    out_p = distinct_kernel.fused_full_solve_distinct_reference(*d_args,
                                                                **d_kw)
    torch.cuda.synchronize()
    k5_cmp = solve_parity(out_k5, out_p, dr_cfg.check_every)
    emit("k5_vs_plain", n=N_DR, m=M_DR, batch=B_DR, **k5_cmp)
    require(k5_cmp["ok"], f"K5 disagrees with its plain version: {k5_cmp}")
    errs["k5"] = [k5_cmp["max_abs_err"]]
    del out_p
    route = pqp.route_solve(N_DR, B_DR, True, dr_cfg, m_dim=M_DR,
                            platform="cuda")
    require(route == "fused_distinct",
            f"distinct N={N_DR} routed to {route!r}")
    distinct_kernel.fused_full_solve_distinct.launches = 0
    dr_runs = {
        "k5_route": lambda: pqp.solve_auto(dp, dd, cfg=dr_cfg),
        "plain": lambda: pqp.solve_batched(dp, dd, cfg=dr_cfg),
    }
    dr_rows, dr_conv, dr_iters = {}, {}, {}
    for name, fn in dr_runs.items():
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        conv = float(res.converged.float().mean())
        dr_rows[name] = dict(
            converged_frac=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()),
            infeasible_uncertified=int((~res.feasible & ~res.converged).sum()),
            seconds_first_run=time.perf_counter() - t0)
        require(conv >= DISTINCT_RESIDENT_CERTIFIED,
                f"distinct {name}: only {conv:.4f} converged")
        dr_conv[name] = res.converged
        dr_iters[name] = res.iters
        del res
    agree = float((dr_conv["k5_route"] == dr_conv["plain"]).float().mean())
    # the lanes left uncertified and the first 16 lanes' iterations, for
    # the CPU comparison with the JAX package on the same draw
    # (tests/test_torch_distinct.py::test_bench_distinct_*_fail_alike)
    emit("distinct_resident_verdicts", converged_agree=agree,
         uncertified_lanes=torch.nonzero(~dr_conv["k5_route"]).flatten()
         .tolist(),
         iters_lanes_0_15={k: v[:16].tolist() for k, v in dr_iters.items()})
    require(agree >= 0.999, f"K5 route and plain verdicts agree on only "
                            f"{agree:.4f} of the lanes")
    del dr_conv, dr_iters
    launches["k5"] = distinct_kernel.fused_full_solve_distinct.launches
    emit("distinct_resident_launches", k5=launches["k5"])
    require(launches["k5"] > 0, "solve_auto did not launch K5")
    for name, fn in dr_runs.items():
        ms = cuda_ms(fn, reps=1, warmup=False)
        emit("distinct_resident_path", engine=name, n=N_DR, m=M_DR,
             batch=B_DR, seconds_per_batch=ms / 1e3, nvidia_smi=smi,
             **dr_rows[name])
    times = {"k5": (
        cuda_ms(lambda: distinct_kernel.fused_full_solve_distinct(
            *d_args, **d_kw), 1, warmup=False),
        cuda_ms(lambda: distinct_kernel.fused_full_solve_distinct_reference(
            *d_args, **d_kw), 1, warmup=False))}
    k5_flops, k5_stream = solve_work(
        N_DR, M_DR, out_k5[2], dr_cfg.check_every, dr_cfg.accel_every,
        8.0 * N_DR ** 2, 4.0 * (N_DR ** 2 + 2 * N_DR * M_DR + 2 * M_DR ** 2),
        12.0 * N_DR ** 2)
    bounds["k5"] = bound(stored_bytes(*d_args), sum(
        t.numel() * t.element_size() for t in out_k5), k5_flops, F32_FLOPS)
    floors["k5"] = stream_floor_ms(k5_stream)
    del dp, dd, d_args, out_k5
    torch.cuda.empty_cache()

    # -- phase 11: the distinct streamed path (K7, K6) --------------------
    # bench_mixed.py --distinct --accel's configuration (its lines 78-83)
    ds_cfg = pqp.SolverConfig(max_iters=30000, check_every=16,
                              accel_every=16, strict_weak_duality=False,
                              gap_from_complementarity=True, erc=1e-6,
                              eac=1e-6, eaj=1e-6, erj=1e-6)
    sp = distinct_workload(B_DS, M_DS, N_DS, dev, gaussian_gp=True)
    sd = pqp.dualize_distinct(sp, theta_floor=ds_cfg.theta_floor)
    sd_free = dataclasses.replace(sd, Qdp_theta=None, Qdn_theta=None)
    Y7 = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 2.0, (N_DS, B_DS)).astype(np.float32), device=dev)
    k7_kw = dict(num_iters=ds_cfg.check_every, den_eps=ds_cfg.den_eps)
    k7_streams = {mode: distinct_tiled_kernel.distinct_streamed_matrix(
        sd.Qd, sd.theta, mode) for mode in ("float32", "bfloat16")}
    k7 = distinct_tiled_kernel.distinct_streamed_iterations
    k7_plain = distinct_tiled_kernel.distinct_streamed_iterations_reference
    for mode, (Q, th) in k7_streams.items():
        k7_args = (Q, th, sd.Fdn, sd.Fdp, Y7)
        got, want = k7(*k7_args, **k7_kw), k7_plain(*k7_args, **k7_kw)
        cmp = k3_parity(got, want, rtol=1e-5 if mode == "float32" else 1e-3)
        emit("k7_vs_plain", mode=mode, n=N_DS, batch=B_DS,
             num_iters=ds_cfg.check_every, **cmp)
        require(cmp["ok"], f"K7 ({mode}) disagrees with its plain version: "
                           f"{cmp}")
        errs["k7_" + mode] = [cmp["max_abs_err"]]
        require(bool((k7(*k7_args, **k7_kw) == got).all()),
                f"K7 ({mode}) did not repeat its bits")
    s_args, s_kw = distinct_tiled_kernel.distinct_tiled_inputs(sp, sd_free,
                                                               None, ds_cfg)
    k6 = distinct_tiled_kernel.fused_full_solve_distinct_tiled
    k6_plain = distinct_tiled_kernel.fused_full_solve_distinct_tiled_reference
    out_k6 = k6(*s_args, **s_kw)
    out_p = k6_plain(*s_args, **s_kw)
    torch.cuda.synchronize()
    k6_cmp = solve_parity(out_k6, out_p, ds_cfg.check_every)
    emit("k6_vs_plain", n=N_DS, m=M_DS, batch=B_DS, **k6_cmp)
    require(k6_cmp["ok"], f"K6 disagrees with its plain version: {k6_cmp}")
    errs["k6"] = [k6_cmp["max_abs_err"]]
    del out_p
    route = pqp.route_solve(N_DS, B_DS, True, ds_cfg, m_dim=M_DS,
                            platform="cuda")
    require(route == "mixed", f"distinct N={N_DS} routed to {route!r}")
    k7.launches["float32"] = k7.launches["bfloat16"] = 0
    k6.launches = 0
    ds_runs = {
        "mixed_route": (lambda: pqp.solve_auto(sp, sd, cfg=ds_cfg),
                        "mixed"),
        "k6_route": (lambda: pqp.solve_fused_distinct_tiled(
            sp, sd_free, cfg=ds_cfg), "f32"),
        "plain": (lambda: pqp.solve_batched(sp, sd, cfg=ds_cfg), "f32"),
    }
    ds_rows = {}
    for name, (fn, record) in ds_runs.items():
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        conv = int(res.converged.sum())
        ds_rows[name] = dict(
            converged=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()),
            jax_record_iters_mean=JAX_DISTINCT_ITERS[record],
            seconds_first_run=time.perf_counter() - t0)
        require(conv == B_DS, f"distinct {name}: {conv} of {B_DS} converged")
        del res
    launches.update(k7_float32=k7.launches["float32"],
                    k7_bfloat16=k7.launches["bfloat16"], k6=k6.launches)
    emit("distinct_streamed_launches", k7_float32=launches["k7_float32"],
         k7_bfloat16=launches["k7_bfloat16"], k6=launches["k6"])
    require(launches["k7_bfloat16"] > 0,
            "solve_auto (mixed) did not launch K7 in bf16 mode")
    require(launches["k6"] > 0, "solve_fused_distinct_tiled did not launch K6")
    for name, (fn, _) in ds_runs.items():
        ms = cuda_ms(fn, reps=1, warmup=False)
        emit("distinct_streamed_path", engine=name, n=N_DS, m=M_DS,
             batch=B_DS, seconds_per_batch=ms / 1e3, nvidia_smi=smi,
             **ds_rows[name])
    for mode, (Q, th) in k7_streams.items():
        k7_args = (Q, th, sd.Fdn, sd.Fdp, Y7)
        times["k7_" + mode] = (cuda_ms(lambda: k7(*k7_args, **k7_kw), 5),
                               cuda_ms(lambda: k7_plain(*k7_args, **k7_kw),
                                       5))
        q_bytes = Q.numel() * Q.element_size()
        bounds["k7_" + mode] = bound(
            stored_bytes(Q, th, sd.Fdn, sd.Fdp, Y7), 4 * Y7.numel(),
            k7_kw["num_iters"] * 4.0 * N_DS * N_DS * B_DS,
            F32_FLOPS if mode == "float32" else BF16_FLOPS)
        if q_bytes > L2_BYTES:
            floors["k7_" + mode] = stream_floor_ms(k7_kw["num_iters"]
                                                   * q_bytes)
    times["k6"] = (cuda_ms(lambda: k6(*s_args, **s_kw), 1, warmup=False),
                   cuda_ms(lambda: k6_plain(*s_args, **s_kw), 1,
                           warmup=False))
    k6_flops, k6_stream = solve_work(
        N_DS, M_DS, out_k6[2], ds_cfg.check_every, ds_cfg.accel_every,
        4.0 * N_DS ** 2, 4.0 * (N_DS ** 2 + 2 * N_DS * M_DS + 2 * M_DS ** 2),
        12.0 * N_DS ** 2)
    bounds["k6"] = bound(stored_bytes(*s_args), sum(
        t.numel() * t.element_size() for t in out_k6), k6_flops, F32_FLOPS)
    floors["k6"] = stream_floor_ms(k6_stream)
    emit("distinct_kernel_times", nvidia_smi=smi,
         k7_num_iters=ds_cfg.check_every,
         **{f"{k}_ms": v[0] for k, v in times.items()},
         **{f"{k}_plain_ms": v[1] for k, v in times.items()})
    # the floors of the designs that re-read matrices past the L2 each pass
    # (K5 both materialized splits per update, the others one matrix), at
    # this run's iterations; the kernel table's bound_ms is the function's
    emit("stream_floors", **{f"{k}_ms": v for k, v in floors.items()})
    del sp, sd, sd_free, k7_streams, Y7, s_args, out_k6
    torch.cuda.empty_cache()

    # -- phase 12: the command line on the card, as subprocesses ---------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        inst = os.path.join(tmp, "inst.txt")
        rc, out, err = run_cli("generate", 12, 30, "--seed", CLI_SEED,
                               "-o", inst)
        require(rc == 0 and "M=12 N=30" in out, f"cli generate: {rc} {err}")
        lines = {}
        for engine in ("auto", "fused", "mixed"):
            rc, out, err = run_cli("solve-file", inst, "--engine", engine,
                                   *CLI_FLAGS)
            lines[engine] = out.strip()
            # auto is held to exit 0 and to the CPU's line below; fused (K1
            # on one lane) and mixed print their line and may exit 2
            require(rc in ((0,) if engine == "auto" else (0, 2))
                    and out.startswith("M=12 N=30 "),
                    f"cli solve-file --engine {engine}: {rc} {out} {err}")
        rc, out, err = run_cli("solve-file", inst, *CLI_FLAGS,
                               "--device", "cpu")
        require(rc == 0, f"cli solve-file --device cpu: {rc} {out} {err}")
        card, cpu = cli_fields(lines["auto"]), cli_fields(out.strip())
        it_c, it_g = int(cpu["iters"]), int(card["iters"])
        bar = -(-max(5, it_c // 5) // 8) * 8
        agree = (card["converged"] == cpu["converged"] == "True"
                 and abs(it_g - it_c) <= bar
                 and all(abs(float(card[k]) - float(cpu[k]))
                         <= 1e-3 * max(1.0, abs(float(cpu[k])))
                         for k in ("Jp", "Jd")))
        rc, out_b, err = run_cli("bench", "--M", 7, "--N", 28, "--batch",
                                 1 << 16, "--iters", 8)
        bench = json.loads(out_b.strip().splitlines()[-1]) if rc == 0 else {}
        require(bench.get("kernel") == "cuda"
                and bench.get("platform") == "cuda",
                f"cli bench did not ride K2: {rc} {out_b} {err}")
        rc, out_r, err = run_cli("rollout", "--jit", "--steps", LOOP_STEPS)
        roll = json.loads(out_r.strip().splitlines()[-1]) if rc == 0 else {}
        require(rc == 0 and roll.get("steps") == LOOP_STEPS,
                f"cli rollout --jit: {rc} {out_r} {err}")
        requests = [{"generator_file": inst},
                    {"spec": {"plant": "double_integrator", "horizon": 16},
                     "x": [2.0, 0.0]},
                    {"cmd": "quit"}]
        rc, out_s, err = run_cli(
            "serve", *CLI_FLAGS,
            stdin="".join(json.dumps(r) + "\n" for r in requests))
        replies = [json.loads(x) for x in out_s.strip().splitlines()]
        require(rc == 0 and len(replies) == 2
                and not any("error" in r for r in replies)
                and all(r["converged"] == r["batch"] for r in replies)
                and len(replies[1]["u0"]) == 1,
                f"cli serve: {rc} {out_s} {err}")
        emit("cli", solve_file=lines, solve_file_cpu=out.strip(),
             card_agrees_with_cpu=agree, bench=bench, rollout_jit=roll,
             serve=[{k: r[k] for k in ("batch", "converged", "iters_max")}
                    for r in replies], nvidia_smi=smi)
        require(agree, "cli solve-file on the card disagrees with the CPU")

    rows = [
        ("k1", "K1 fused_full_solve", "full_solve.cu",
         "solve_kernel.py:295", launches["k1"], errs["k1"], k1_ms,
         k1_plain_ms),
        ("k2", "K2 fused_pqp_iterations", "pqp_iterations.cu",
         "kernels.py:104", launches["k2"], errs["k2"], k2_ms, k2_plain_ms),
        *[("k3_" + mode, f"K3 fused_pqp_iterations_tiled ({mode})",
           "pqp_iterations_tiled.cu", "tiled_kernel.py:177",
           big_launches["k3_" + mode], errs["k3_" + mode],
           *big_times["k3_" + mode]) for mode in ("float32", "bfloat16")],
        ("k4", "K4 fused_full_solve_tiled", "full_solve_tiled.cu",
         "tiled_solve_kernel.py:324", big_launches["k4"], errs["k4"],
         *big_times["k4"]),
        ("k5", "K5 fused_full_solve_distinct", "full_solve_distinct.cu",
         "distinct_kernel.py:200", launches["k5"], errs["k5"], *times["k5"]),
        ("k6", "K6 fused_full_solve_distinct_tiled",
         "full_solve_distinct_tiled.cu", "distinct_tiled_kernel.py:253",
         launches["k6"], errs["k6"], *times["k6"]),
        ("k7_bfloat16", "K7 fused_pqp_iterations_distinct_tiled (bfloat16)",
         "pqp_iterations_distinct_tiled.cu", "distinct_tiled_kernel.py:480",
         launches["k7_bfloat16"], errs["k7_bfloat16"], *times["k7_bfloat16"]),
        ("k8", "K8 fused_full_solve_packed", "full_solve_packed.cu",
         "packed_kernel.py:276", launches["k8"], errs["k8"], k8_ms,
         k8_plain_ms),
    ]
    table = [{"name": name, "route": "cuda",
              "source": "pqp_for_mpc_tpu_torch/csrc/" + src,
              "replaces": "pqp_for_mpc_tpu/ops/" + tpu, "launches": n,
              "max_abs_err": max(err), "ms": ms, "plain_ms": plain_ms,
              **bounds[key]}
             for key, name, src, tpu, n, err, ms, plain_ms in rows]
    # K7's float32 mode (same source, same wrapper) is not on the path:
    # solve_mixed's float32 phase on 3-D Qd is the plain solve, as in the
    # JAX package.  Its numbers from this run sit beside the bf16 row.
    table[-2]["float32_mode"] = {
        "launches": launches["k7_float32"],
        "max_abs_err": errs["k7_float32"][0], "ms": times["k7_float32"][0],
        "plain_ms": times["k7_float32"][1], **bounds["k7_float32"]}
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
