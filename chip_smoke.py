#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pqp_for_mpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``pqp_for_mpc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main path
(the batched condensed-MPC solve through ``solve_auto`` and
``solve_batched``, and the receding-horizon controller) at full size, holds
each kernel against its plain version again at the main path's batch, and
times both.  The ``launches`` of the kernel table are those of the
main-path phase alone.  Every phase prints one JSON
line and raises on failure.  The last two lines are the kernel table
(``{"kernels": [...]}``) and the result line
(``{"ok": true, "device": {...}}``).  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.

The workload is the reference example's shape built in the repo: the
double integrator condensed at horizon 7 (M = 7 inputs, N = 28 dual
constraints), a batch of initial states x0 ~ N(0, 0.5^2) from a NumPy seed.
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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    import torch
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pqp_for_mpc_tpu_torch as pqp
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
    from pqp_for_mpc_tpu_torch.models import (MPCController, MPCSpec,
                                              double_integrator)
    from pqp_for_mpc_tpu_torch.ops import build, kernels, solve_kernel
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
