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
  the router also sends to ``"mixed"``, timed against the plain route.

Each kernel is held against its plain version at the shapes its path gives
it.  The ``launches`` of the kernel table are those of each path's own
drive, counted from 0.  Every phase prints one JSON line and raises on
failure.  The last two lines are the kernel table (``{"kernels": [...]}``)
and the result line (``{"ok": true, "device": {...}}``).  Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def workload(B: int, device, seed: int = 0):
    """The M=7/N=28 condensed double-integrator batch: (primal, dual)."""
    from pqp_for_mpc_tpu_torch import dualize
    from pqp_for_mpc_tpu_torch.models import (MPCSpec, condense,
                                              double_integrator)
    import torch
    spec = MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]),
                   u_min=-np.ones(1), u_max=np.ones(1),
                   du_max=0.5 * np.ones(1))
    data = condense(spec, device=device)
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


def k4_parity(out_kernel, out_plain, check_every: int) -> dict:
    """K4 against its plain version: lane states equal, iterations within
    max(5, iters // 5) rounded up to whole checks, U within
    5e-3 * max(1, |U|max) (k1_parity's bar)."""
    import torch
    _, u_k, it_k, st_k = out_kernel
    _, u_p, it_p, st_p = out_plain
    states_equal = bool((st_k == st_p).all())
    bar = torch.clamp(it_p.long() // 5, min=5)
    bar = -(-bar // check_every) * check_every
    iters_ok = bool(((it_k.long() - it_p.long()).abs() <= bar).all())
    tol = 5e-3 * max(1.0, float(u_p.abs().max()))
    err = float((u_k - u_p).abs().max())
    return dict(states_equal=states_equal, iters_within_bar=iters_ok,
                iters_mean_kernel=float(it_k.float().mean()),
                iters_mean_plain=float(it_p.float().mean()),
                certified_kernel=int((st_k == 1).sum()),
                max_abs_err=err, tol_U=tol,
                ok=states_equal and iters_ok and err <= tol)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pqp_for_mpc_tpu_torch as pqp
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
    from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                              double_integrator)
    from pqp_for_mpc_tpu_torch.ops import (build, kernels, solve_kernel,
                                           tiled_kernel, tiled_solve_kernel)
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

    # -- phase 5: the closed loop ----------------------------------------
    spec = MPCSpec(double_integrator(), horizon=16, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
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

    # -- each kernel against its plain version at the main path's shapes,
    #    then both timed ------------------------------------------------
    args, kw = solve_kernel.fused_inputs(primal, dual, None, smoke_cfg)
    k1_cmp = k1_parity(primal, dual, smoke_cfg,
                       solve_kernel.fused_full_solve(*args, **kw),
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

    k1_ms = cuda_ms(lambda: solve_kernel.fused_full_solve(*args, **kw), 2)
    k1_plain_ms = cuda_ms(
        lambda: solve_kernel.fused_full_solve_reference(*args, **kw), 1)
    k2_ms = cuda_ms(lambda: kernels.fused_pqp_iterations(*k2_args, **k2_kw),
                    10)
    k2_plain_ms = cuda_ms(
        lambda: kernels.fused_pqp_iterations_reference(*k2_args, **k2_kw), 10)
    emit("kernel_times", batch=B_MAIN, nvidia_smi=smi, k1_ms=k1_ms,
         k1_plain_ms=k1_plain_ms, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
         k2_num_iters=smoke_cfg.check_every)
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
    k4_cmp = k4_parity(
        tiled_solve_kernel.fused_full_solve_tiled(*t_args, **t_kw), out_p,
        big_cfg.check_every)
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
    spec64 = MPCSpec(double_integrator(), horizon=64, Qy=np.eye(1),
                     R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                     u_max=np.ones(1), du_max=0.5 * np.ones(1))
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

    print(json.dumps({"kernels": [
        {"name": "K1 fused_full_solve", "route": "cuda",
         "source": "pqp_for_mpc_tpu_torch/csrc/full_solve.cu",
         "replaces": "pqp_for_mpc_tpu/ops/solve_kernel.py:295",
         "launches": launches["k1"], "max_abs_err": max(errs["k1"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 fused_pqp_iterations", "route": "cuda",
         "source": "pqp_for_mpc_tpu_torch/csrc/pqp_iterations.cu",
         "replaces": "pqp_for_mpc_tpu/ops/kernels.py:104",
         "launches": launches["k2"], "max_abs_err": max(errs["k2"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        *[{"name": f"K3 fused_pqp_iterations_tiled ({mode})",
           "route": "cuda",
           "source": "pqp_for_mpc_tpu_torch/csrc/pqp_iterations_tiled.cu",
           "replaces": "pqp_for_mpc_tpu/ops/tiled_kernel.py:177",
           "launches": big_launches["k3_" + mode],
           "max_abs_err": max(errs["k3_" + mode]),
           "ms": big_times["k3_" + mode][0],
           "plain_ms": big_times["k3_" + mode][1]}
          for mode in ("float32", "bfloat16")],
        {"name": "K4 fused_full_solve_tiled", "route": "cuda",
         "source": "pqp_for_mpc_tpu_torch/csrc/full_solve_tiled.cu",
         "replaces": "pqp_for_mpc_tpu/ops/tiled_solve_kernel.py:324",
         "launches": big_launches["k4"], "max_abs_err": max(errs["k4"]),
         "ms": big_times["k4"][0], "plain_ms": big_times["k4"][1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
