#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pqp_for_mpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``pqp_for_mpc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the two paths
at full size and times them:

* the small-N path (kernels K1, K2): the batched condensed-MPC solve
  through ``solve_auto`` and ``solve_batched``, and the receding-horizon
  controller.  The workload is the example benchmark's
  (``pqp_for_mpc_tpu_torch.bench.example_workload``: the reference
  example's shape built in the repo, the double integrator condensed at
  horizon 7, M = 7 inputs, N = 28 dual constraints), 2^22 initial states
  x0 ~ N(0, 0.5^2) from a NumPy seed, under its ``EXAMPLE_CFG``;
* the streamed large-N path (kernels K3, K4): ``solve_auto`` routing to
  ``solve_mixed`` (K3 bf16 bulk phase, K3 f32 refine), ``solve_fused_tiled``
  (K4), ``solve_batched(use_pallas=True)`` (its updates on K3 f32, one
  launch per check) and the plain ``solve_batched``, on the JAX package's
  streamed
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
  ``solve_batched``), each under its JAX benchmark's configuration; K6 and
  K7 are cooperative launches that keep each instance's matrix in shared
  memory (their plans, ``k6_plan`` and ``k7_plan``, are printed);
* the packed whole solve (kernel K8): ``solve_fused_packed`` on the main
  path's batch, timed beside K1 on the same call, with K1's verdicts and
  bits (K1 and K8 launch one engine, ``csrc/lane_tile_solve.cuh``: a
  register tile over 4 rows x 4 lanes for every product and a persistent
  grid that refills a lane slot from a global queue as its lane retires);
* K1's dual-gradient instantiation (``MPC_CONFIG``, the controller's
  route) against its plain version on the warm loop's shape (N = 28,
  M = 7: cold and warm at 2^16 lanes, warm at one lane) and the H = 16
  shape (N = 64: cold at 4,096 lanes, warm at one);
* the H = 16 closed loop through ``MPCController.rollout_jit`` (the loop
  kept on the card, 200 steps, each step one K1 launch under
  ``MPC_CONFIG``'s dual-gradient certificate) timed against ``rollout`` on
  the plain engine, and the controller's fan-out step of 4,096 states,
  one K1 launch too;
* the stage-wise long-horizon backend (no hand-written kernel lies on it:
  every kernel counter is read before and after its phases and must not
  move): ``examples/long_horizon_mpc.py 512 30``'s closed loop through
  ``MPCController(backend="auto")`` (the double integrator at H = 512,
  n_con = 2,048; every step certified; launches per update, check and
  accel step counted by ``torch.profiler``), a fan-out of 1,024 states at
  H = 512 audited in float64, and the output-bounded spec at H = 256; the
  condensed/stage-wise crossover behind ``auto_backend`` (the same spec
  and cfg through both backends at H = 64-384, u held to the parity bar
  against the condensed plain route, ms per step of each); and
  ``solve_qp_implicit`` on ``examples/differentiable_mpc.py``'s problem
  (the card's gradient against the CPU's, the example's tuning loop, a
  ``torch.func.vmap`` batch of 256 against one at a time);
* state estimation and offset-free control (no hand-written kernel lies
  on these paths either, as in the JAX package: every kernel counter is
  read before and after the group and must not move), each at its JAX
  example's or test's settings: the production stack of
  ``examples/production_mpc.py`` (robust tightening, offset-free estimation
  and targets, a disturbance preview, ``retry_cold``; 80 steps, every step
  certified, the original bound y <= 1 held, the offset within
  ``tests/test_composition.py``'s tolerance), offset-free control on the
  stage-wise backend at H = 512 (30 steps), the moving-horizon estimator on
  the CLI's one-sided quadruple-tank record (400 steps, windows 10 and 40,
  every window certified, every state's RMSE below the Kalman filter's,
  the JAX package's CPU readings beside), the relinearizing MHE on the
  hanging pendulum (window 8, against the origin-linearized filter), RTI
  on ``examples/nonlinear_mpc.py``'s pendulum (H = 20, 60 steps, swung up
  and stabilized) and ``examples/output_feedback_nonlinear_mpc.py`` (H =
  24, N = 8, 60 steps), each with ms per step, iterations and peak device
  memory;
* data- and tensor-parallel solves (``parallel/``; no hand-written kernel
  lies on them either, as in the JAX package: every kernel counter is read
  before and after and must not move), on a 1 x 1 mesh of a one-rank NCCL
  group (one card measures no scaling): ``solve_row_sharded`` on the
  streamed workload in float32 (plain's verdicts on every lane, U and
  iterations within the parity bar) and ``mixed`` (>= 99% certified, U
  within 2e-3 of float32's), each with its seconds beside plain's and its
  collectives counted; ``shard_batch`` + ``solve_batched`` on the main
  path's batch, bit for bit plain's; the ``sharded_large_n`` twin under
  ``torchrun`` (``'converged': 8``); and, four processes at once, the
  twins of ``examples/`` whose settings no other phase drives
  (``pqp_for_mpc_tpu_torch.examples``: ``scenario_batch``,
  ``large_n_mixed``, ``receding_horizon``, ``constrained_outputs_mpc``,
  ``learned_mpc_closed_loop``, ``train_mpc_optax``, ``offset_free_mpc``),
  each at its JAX test's arguments and held to that test's line
  (``scenario_batch`` solves through K1, ``solve_fused``, as the JAX
  example does on its accelerator; its launches are its own process's
  and move no counter of this one);
* the command line, as subprocesses of ``python -m pqp_for_mpc_tpu_torch``:
  ``generate``, ``solve-file`` (engines auto, fused and mixed; the auto
  line held against the same command on the CPU), ``bench`` (riding K2),
  ``bench-example`` (the North-star line, held to the K1 route's rate
  within 10%), ``rollout --jit``, ``rollout --backend stagewise`` at
  H = 512, ``rollout --robust-w`` on both backends and ``serve`` (an
  H = 512 spec request among them); and, all four at once, ``estimate
  --kind kf``, ``estimate --kind mhe --simulate 400 --one-sided`` and
  ``rollout --offset-free`` input and output.

Each kernel is held against its plain version at the shapes its path gives
it.  The ``launches`` of the kernel table are those of ONE call of each
path's route, counted from 0.  K5's cluster plan (``k5_plan`` and the
card's pick), K3's tile plans in both modes, K4's tile plan
(``k4_plan``), K2's launch plan (``k2_plan``) and the K1/K8 engine's
(``k1_plan`` beside the card's ``card_plan``) are printed; K3 is held at
the streamed workload's shape and at the H=64 loop's single lane in both
modes, its float32 mode also at N = 203, B = 5 and at the streamed shape
with its other lane width (64 or 128, the same bits), K5 with its rows
resident (N = 400) and streamed (N = 1,024), K1, K2 and K8 at both of
their batches and K4 at the streamed workload, each also against its own
relaunch, bit for bit; K8 also gives K1's bits on each of its cases,
and on the accelerated H=16 case, since it sums in K1's order, it is held
to its card test's bars (``accel_h16_parity``).  The times of the kernels
redesigned for Hopper (all of them) under their previous designs are
printed on a line of their own (``earlier_times``), quoted from PERF.md,
not measured here.  K3 float32's row carries, beside the mixed route's
launches, those of ``solve_batched(use_pallas=True)``
(``use_pallas_launches``).  K7's row is its bf16 mode, the one its
path runs, timed in two windows in turns
with its plain version (``ms_windows``); its float32 mode is held and
timed too, and sits in the row as ``float32_mode``.  The resident
distinct route is held to the share of lanes its benchmark configuration
certifies in both packages (:data:`DISTINCT_RESIDENT_CERTIFIED`) and to the
plain solve's verdicts, and prints the lanes it leaves uncertified.  Each
kernel's ``bound_ms`` is
the least time an
H100 SXM could take for that call — the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations
(counted from this run's iterations) over 67 TFLOP/s in float32 or
989 TFLOP/s in bf16 — and ``bound_by`` names the term.  The floors of the
designs (not bounds of the function) are printed on the ``stream_floors``
line: for K4 the time to re-read its matrix past the 50 MB L2 on every
pass; for K3 the time to read Q once per update at the HBM rate; for K5
its inputs once from HBM and its resident rows' reads at the aggregate
shared-memory rate; for K6 and K7 each term by name (``*_terms_ms``): the
matrices once from HBM, the resident rows at the shared-memory rate and
the rows past shared memory again from HBM on every pass.  No single PyTorch call computes any of these
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

#: the long-horizon drive (examples/long_horizon_mpc.py 512 30): the double
#: integrator at H = 512 (n_con = 2,048), the stage-wise backend
H_LONG, LONG_STEPS = 512, 30
#: the stage-wise fan-out's batch (x0 ~ U(-2, 2) from seed 0) and the
#: horizons of the condensed/stage-wise crossover reading
B_FAN, CROSS_H, CROSS_STEPS = 1024, (64, 128, 256, 384), 10
#: the crossover's limit on U per horizon: each backend's first QP against
#: its float64 optimum, and the two backends' first QPs against each other
#: (twice this for their closed loops, where a step's input moves the next
#: step's state).  Both backends stop on the same relative gap, and the
#: long, nearly cost-free tail of U lets a certified answer drift further
#: from the optimum as H grows: the limits are about twice the card's
#: readings (PERF.md), the JAX package's 2e-3 bar between its backends
#: (tests/test_stagewise.py, H=12) up to H=128
CROSS_TOL = {64: 2e-3, 128: 2e-3, 256: 5e-3, 384: 1e-2}
#: the estimation group's drives, each at its JAX example's or test's
#: settings: the production stack (examples/production_mpc.py: 80 steps),
#: offset-free on the stage-wise backend at H = 512 (30 steps), the MHE
#: record (the CLI's `estimate --plant quadruple_tank --simulate 400
#: --one-sided`, windows 10 and 40), the relinearizing MHE on the pendulum
#: (window 8), RTI (examples/nonlinear_mpc.py: H = 20, 60 steps) and output
#: feedback (examples/output_feedback_nonlinear_mpc.py: H = 24, N = 8, 60
#: steps)
PROD_STEPS, OF_H, OF_STEPS = 80, 512, 30
MHE_T, MHE_WINDOWS, NMHE_WINDOW, NMHE_T = 400, (10, 40), 8, 80
RTI_H, RTI_STEPS, OFB_H, OFB_N, OFB_STEPS = 20, 60, 24, 8, 60
#: the JAX package's readings of that MHE record on the CPU (its CLI, the
#: same command): converged share, mean iterations and RMSE per state —
#: an algorithmic cross-check, not a gate and not a time
JAX_MHE = {10: (1.0, 16.9, [0.0080, 0.0080, 0.0290, 0.0637]),
           40: (1.0, 24.4, [0.0097, 0.0095, 0.0675, 0.0579]),
           "kf": [0.0103, 0.0105, 0.0846, 0.0954]}

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32 on the
#: CUDA cores and bf16 on the tensor cores, FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
#: aggregate shared-memory bandwidth of an H100 SXM: 132 SMs x 128 bytes
#: per clock at the 1.98 GHz boost clock (the K5, K6 and K7 designs' read
#: floor)
SMEM_BPS = 132 * 128 * 1.98e9
#: the redesigned kernels' times under their previous designs, quoted
#: from PERF.md section 6 (each from the last chip run before its
#: redesign, on an H100 80GB HBM3, 700 W): printed on a line of their own,
#: never in the kernel table
EARLIER_MS = {"k5": 4589.51, "k3_bfloat16": 6.925, "k4": 2088.37,
              "k2": 7.762, "k1": 602.13, "k8": 478.80, "k6": 347.38,
              "k7_bfloat16": 0.5052, "k3_float32": 6.015}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def bits_equal(a, b) -> bool:
    """Every output of two whole-solve launches equal bit for bit (NaN
    included)."""
    import torch
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


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


def accel_h16_parity(out_kernel, out_plain, check_every: int) -> dict:
    """A whole-solve kernel in K1's summation order against K8's plain
    version (kronned matrices, segment sums) on the accelerated H=16 loop,
    with the bars of tests/test_torch_cuda.py::test_k8_kernel_matches_plain
    for that case: lane states equal on >= 99.5% of lanes and every lane
    that differs stalled (code 2) on one side — the accel step's
    projection can make an absorbing zero in one summation order and not
    the other — the iteration bar on 90% of the lanes that end alike, and
    U within 5e-3 * max(1, |U|max) on them."""
    import torch
    _, u_k, it_k, st_k = out_kernel
    _, u_p, it_p, st_p = out_plain
    same = st_k == st_p
    stall = bool(((st_k == 2) | (st_p == 2))[~same].all())
    bar = (it_p.long() // 5).clamp(min=5)
    bar = -(-bar // check_every) * check_every
    in_bar = float(((it_k.long() - it_p.long()).abs() <= bar)[same]
                   .float().mean())
    tol = 5e-3 * max(1.0, float(u_p.abs().max()))
    err = float((u_k - u_p)[:, same].abs().max())
    share = float(same.float().mean())
    return dict(states_equal_share=share, differing_lanes_stalled=stall,
                differing=[(int(b), int(st_k[b]), int(st_p[b]), int(it_k[b]),
                            int(it_p[b])) for b in
                           torch.nonzero(~same).flatten().tolist()[:20]],
                iters_in_bar=in_bar, max_abs_err=err, tol_U=tol,
                ok=share >= 0.995 and stall and in_bar >= 0.90
                and err <= tol)


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


def long_horizon_spec(H: int, **extra):
    """examples/long_horizon_mpc.py's spec at horizon H: the double
    integrator, Qy = I, R = 0.05 I, r = 0, |u| <= 1, |du| <= 0.5."""
    from pqp_for_mpc_tpu_torch.models import MPCSpec, double_integrator
    kw = dict(Qy=np.eye(1), R=0.05 * np.eye(1), r=np.zeros(1),
              u_min=-np.ones(1), u_max=np.ones(1), du_max=0.5 * np.ones(1))
    kw.update(extra)
    return MPCSpec(double_integrator(), horizon=H, **kw)


def kernel_counts() -> dict:
    """Every hand-written kernel's launch counter, by kernel."""
    from pqp_for_mpc_tpu_torch.ops import (distinct_kernel,
                                           distinct_tiled_kernel, kernels,
                                           packed_kernel, solve_kernel,
                                           tiled_kernel, tiled_solve_kernel)
    k3 = tiled_kernel.streamed_pqp_iterations.launches
    k7 = distinct_tiled_kernel.distinct_streamed_iterations.launches
    return {"k1": solve_kernel.fused_full_solve.launches,
            "k2": kernels.fused_pqp_iterations.launches,
            "k3": k3["float32"] + k3["bfloat16"],
            "k4": tiled_solve_kernel.fused_full_solve_tiled.launches,
            "k5": distinct_kernel.fused_full_solve_distinct.launches,
            "k6": distinct_tiled_kernel.fused_full_solve_distinct_tiled
            .launches,
            "k7": k7["float32"] + k7["bfloat16"],
            "k8": packed_kernel.fused_full_solve_packed.launches}


def profiled_launches(fn) -> dict:
    """Kernels the card ran during one call of ``fn`` (``torch.profiler``'s
    device events, memory copies and sets apart) and the kernel launches
    the host issued (its CUDA runtime events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    return dict(
        device=sum(1 for e in events if e.device_type == cuda
                   and not e.name.startswith(("Memcpy", "Memset"))),
        host=sum(1 for e in events
                 if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))))


def stagewise_launches(sd, x0, cfg) -> dict:
    """Launches per update, per check and per accel step of
    ``solve_stagewise`` on this dual, from profiled solves that never
    certify (eaj < 0) and stop at max_iters: L(k, n, a) checks every k
    updates, accelerates every a, runs n*k updates and n + 1 checks, so
    L(16, 1, 0) - L(8, 1, 0) = 8 updates, L(8, 2, 0) - L(8, 1, 0) = one
    check and 8 updates, L(8, 1, 4) - L(8, 1, 0) = 2 accel steps."""
    from pqp_for_mpc_tpu_torch.models import solve_stagewise

    def L(k, n, a):
        c = dataclasses.replace(cfg, check_every=k, accel_every=a,
                                max_iters=k * n, eaj=-1.0)
        return profiled_launches(lambda: solve_stagewise(sd, x0, cfg=c))

    L(8, 1, 0)                                  # warm-up
    base, two, long_, acc = L(8, 1, 0), L(8, 2, 0), L(16, 1, 0), L(8, 1, 4)
    out = {}
    for key in ("device", "host"):
        upd = (long_[key] - base[key]) / 8
        out[f"{key}_per_update"] = upd
        out[f"{key}_per_check"] = two[key] - base[key] - 8 * upd
        out[f"{key}_per_accel"] = (acc[key] - base[key]) / 2
    return out


def f64_box_slew_violation(U, Kp) -> float:
    """max(G U - Kp) in float64 over the box and slew rows of a single-input
    stage-wise problem: ``U (H, B)``, ``Kp (4, H)`` = [umax, -umin,
    dmax + e1 uprev, dmax - e1 uprev]."""
    U = np.asarray(U, np.float64)
    Kp = np.asarray(Kp, np.float64)[:, :, None]
    TU = U - np.concatenate([np.zeros_like(U[:1]), U[:-1]])
    return float(np.stack([U - Kp[0], -U - Kp[1], TU - Kp[2],
                           -TU - Kp[3]]).max())


def f64_optimum(spec, x0, y) -> np.ndarray:
    """The optimum U of ``spec``'s QP (tracking r = 0) from state ``x0``,
    in float64, by a primal active-set refinement started from the rows
    where the float32 multipliers ``y`` exceed 1e-3 of their largest: each
    round solves the KKT system on the working rows, drops the row of the
    most negative multiplier or adds the most violated row, and stops when
    every row holds to 1e-9 and every multiplier is >= -1e-9 (the float64
    optimality conditions); raises past 4 rounds per row."""
    from pqp_for_mpc_tpu_torch.models.mpc import (_input_constraints_f64,
                                                  _prediction_matrices_f64)
    H = spec.horizon
    Sx, Su, _ = _prediction_matrices_f64(spec.plant, H)
    Cs = np.kron(np.eye(H), np.asarray(spec.plant.C, np.float64))
    Qbar = np.kron(np.eye(H), np.asarray(spec.Qy, np.float64))
    Qp = 2.0 * (Su.T @ Cs.T @ Qbar @ Cs @ Su
                + np.kron(np.eye(H), np.asarray(spec.R, np.float64)))
    Fp = 2.0 * Su.T @ Cs.T @ Qbar @ Cs @ Sx @ np.asarray(x0, np.float64)
    G, K = _input_constraints_f64(spec)
    M = Qp.shape[0]
    work = list(np.flatnonzero(y > 1e-3 * y.max()))
    for _ in range(4 * len(G)):
        GA = G[work]
        kkt = np.block([[Qp, GA.T], [GA, np.zeros((len(work),) * 2)]])
        sol = np.linalg.lstsq(kkt, np.concatenate([-Fp, K[work]]),
                              rcond=None)[0]
        U, lam = sol[:M], sol[M:]
        viol = G @ U - K
        if len(work) and lam.min() < -1e-9:
            work.pop(int(np.argmin(lam)))
        elif viol.max() > 1e-9:
            work.append(int(np.argmax(viol)))
        else:
            return U
    raise AssertionError("the float64 active-set refinement did not end")


def stagewise_paths(dev, smi: str) -> float:
    """The stage-wise long-horizon backend on the card (no hand-written
    kernel lies on it: every kernel counter stays at 0 over its phases),
    the condensed/stage-wise crossover and ``solve_qp_implicit``.  Returns
    the H=512 closed loop's ms per step."""
    import torch
    from pqp_for_mpc_tpu_torch import SolverConfig, solve_qp_implicit
    from pqp_for_mpc_tpu_torch.config import stagewise_mpc_config
    from pqp_for_mpc_tpu_torch.models import (MPCController, condense,
                                              solve_stagewise,
                                              stagewise_dual)
    from pqp_for_mpc_tpu_torch.models.stagewise import rollout_states
    require(not torch.backends.cuda.matmul.allow_tf32,
            "torch.backends.cuda.matmul.allow_tf32 is on")
    zero = {k: 0 for k in kernel_counts()}
    before = kernel_counts()
    x2 = np.array([2.0, 0.0], np.float32)

    # -- the H=512 closed loop: backend="auto" past the n_con line -------
    spec = long_horizon_spec(H_LONG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctrl = MPCController(spec, backend="auto", warm_start="shift",
                         retry_cold=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    require(ctrl.backend == "stagewise" and ctrl.data is None,
            f"H=512 auto built {ctrl.backend!r}")
    ctrl.rollout_jit(x2, LONG_STEPS)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = ctrl.rollout_jit(x2, LONG_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    loop_peak = torch.cuda.max_memory_allocated()
    cert = int(out["converged"].sum())
    sd1 = stagewise_dual(spec, theta_floor=ctrl.cfg.theta_floor, device=dev)
    launches = stagewise_launches(
        sd1, torch.tensor([[2.0], [0.0]], device=dev), ctrl.cfg)
    emit("stagewise_h512_closed_loop", horizon=H_LONG, n_con=ctrl.n_con,
         band=sd1.band, steps=LONG_STEPS, certified=cert,
         certified_share=cert / LONG_STEPS,
         iters_mean=float(out["iters"].mean()),
         iters_max=int(out["iters"].max()), iters=out["iters"].tolist(),
         ms_per_step=secs / LONG_STEPS * 1e3, steps_per_s=LONG_STEPS / secs,
         final_state_norm=float(np.linalg.norm(out["x"][-1])),
         build_seconds=build_s, build_peak_bytes=build_peak,
         peak_memory_bytes=loop_peak, launches=launches, nvidia_smi=smi)
    require(cert == LONG_STEPS,
            f"H=512 loop certified {cert} of {LONG_STEPS} steps")
    h512_ms = secs / LONG_STEPS * 1e3

    # -- the fan-out: B=1024 states at H=512 (tests/test_stagewise.py's
    #    cfg), with the float64 audit of every certified lane ------------
    cfg_fan = SolverConfig(max_iters=2000, check_every=16, accel_every=8,
                           y0=0.01, eaj=1e-2, erj=1e-3, erc=1e-4, eac=1e-4,
                           strict_weak_duality=False,
                           gap_from_complementarity=True)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.0, (2, B_FAN)).astype(np.float32), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, ms = timed_once(lambda: solve_stagewise(sd1, x0, cfg=cfg_fan))
    fan_peak = torch.cuda.max_memory_allocated()
    conv = res.converged.cpu().numpy()
    U = res.U.cpu().numpy()[:, conv]
    viol = f64_box_slew_violation(U, sd1.Kp.cpu().numpy()[:, :, 0])
    u_abs = float(np.abs(U).max())
    emit("stagewise_fan_out", horizon=H_LONG, batch=B_FAN,
         certified_share=float(conv.mean()),
         iters_mean=float(res.iters.float().mean()),
         iters_max=int(res.iters.max()), ms=ms,
         f64_max_violation=viol, u_abs_max=u_abs, peak_memory_bytes=fan_peak,
         nvidia_smi=smi)
    require(conv.mean() >= 0.99, f"fan-out certified {conv.mean():.4f}")
    require(viol <= 5e-4, f"fan-out float64 violation {viol}")
    require(u_abs <= 1.0 + 5e-4, f"fan-out |U| {u_abs}")
    del res, U, x0
    torch.cuda.empty_cache()

    # -- output bounds at H=256: y <= 1.9 below a reference of 2.5 -------
    spec_y = long_horizon_spec(256, r=np.full(1, 2.5), y_min=np.full(1, -1.9),
                               y_max=np.full(1, 1.9))
    cfg_y = SolverConfig(max_iters=5000, check_every=16, accel_every=8,
                         y0=0.01, eaj=1e-2, erj=1e-3, erc=5e-4, eac=5e-4,
                         strict_weak_duality=False,
                         gap_from_complementarity=True)
    sd_y = stagewise_dual(spec_y, theta_floor=cfg_y.theta_floor, device=dev)
    xy = torch.tensor([[1.0], [0.2]], device=dev)
    res, ms_y = timed_once(lambda: solve_stagewise(sd_y, xy, cfg=cfg_y))
    y = rollout_states(sd_y.factor, xy, res.U.reshape(256, 1, 1))[
        :, 0, 0].cpu().numpy()
    ctrl_y = MPCController(spec_y, backend="stagewise", warm_start="shift",
                           retry_cold=True, device=dev)
    loop_y = ctrl_y.rollout_jit([1.0, 0.2], 10)
    emit("stagewise_outputs_h256", n_con=sd_y.n_con, band=sd_y.band,
         converged=bool(res.converged.all()), iters=int(res.iters.max()),
         ms=ms_y, y_max=float(y.max()), y_last=float(y[-1]),
         u_abs_max=float(res.U.abs().max()),
         loop_certified=int(loop_y["converged"].sum()),
         loop_y_max=float(loop_y["x"][:, 0].max()),
         loop_iters=loop_y["iters"].tolist(), nvidia_smi=smi)
    require(bool(res.converged.all()) and y.max() <= 1.9 + 2e-3
            and y[-1] > 1.7 and float(res.U.abs().max()) <= 1.0 + 1e-3,
            "H=256 output-bounded solve")
    require(bool(loop_y["converged"].all())
            and loop_y["x"][:, 0].max() <= 1.9 + 2e-3,
            "H=256 output-bounded loop")
    after = kernel_counts()
    used = {k: after[k] - before[k] for k in after}
    emit("stagewise_path_kernel_launches", **used)
    require(used == zero, f"a kernel launched on the stage-wise path: {used}")

    # -- the condensed/stage-wise crossover (auto_backend's n_con line):
    #    one spec through both backends under one cfg.  The first QP
    #    (x0 = [2, 0], cold) is held, on each backend, to its float64
    #    optimum and to the other backend; then 10 warm steps of each
    #    backend's closed loop, the condensed one through its router's pick
    #    and the plain solve, each held to the stage-wise loop's inputs ----
    import pqp_for_mpc_tpu_torch.models.mpc as mpc_module
    from pqp_for_mpc_tpu_torch import dualize, solve_batched
    auto = mpc_module.solve_auto
    x2t = torch.tensor([[2.0], [0.0]], device=dev)
    cross = []
    for H in CROSS_H:
        spec_h = long_horizon_spec(H)
        cfg = stagewise_mpc_config(H)
        tol = CROSS_TOL[H]
        row = dict(horizon=H, n_con=4 * H, u_tol=tol, loop_u_tol=2 * tol)
        data = condense(spec_h, device=dev)
        primal = data.assemble(x=x2t, Qp=data.qp())
        first = {"stagewise": solve_stagewise(
                     stagewise_dual(spec_h, device=dev), x2t, cfg=cfg),
                 "condensed": solve_batched(primal, dualize(primal),
                                            cfg=cfg)}
        U64 = f64_optimum(spec_h, [2.0, 0.0],
                          first["condensed"].Y[:, 0].cpu().numpy())
        for name, r in first.items():
            require(bool(r.converged.all()), f"H={H}: first {name} QP")
            row[f"{name}_first_qp_iters"] = int(r.iters[0])
            row[f"{name}_first_qp_err_f64"] = float(np.abs(
                r.U[:, 0].double().cpu().numpy() - U64).max())
        row["first_qp_backends_max_du"] = float(
            (first["stagewise"].U - first["condensed"].U).abs().max())
        runs = {}
        for name in ("stagewise", "condensed_xla", "condensed_routed"):
            if name == "condensed_xla":
                mpc_module.solve_auto = (
                    lambda *a, **k: auto(*a, engine="xla", **k))
            try:
                c = MPCController(spec_h, cfg=cfg,
                                  backend=name.split("_")[0],
                                  warm_start="shift", retry_cold=True,
                                  device=dev)
                c.rollout_jit(x2, 2)                       # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name] = c.rollout_jit(x2, CROSS_STEPS)
                torch.cuda.synchronize()
                row[f"{name}_ms_per_step"] = (
                    (time.perf_counter() - t0) / CROSS_STEPS * 1e3)
            finally:
                mpc_module.solve_auto = auto
            row[f"{name}_certified"] = int(runs[name]["converged"].sum())
            row[f"{name}_iters_mean"] = float(runs[name]["iters"].mean())
            if name != "stagewise":
                row[f"{name}_loop_max_du"] = float(np.abs(
                    runs[name]["u"] - runs["stagewise"]["u"]).max())
        emit("stagewise_vs_condensed", nvidia_smi=smi, **row)
        cross.append(row)
        require(row["stagewise_certified"] == CROSS_STEPS
                and row["condensed_xla_certified"] == CROSS_STEPS,
                f"H={H}: a step left uncertified: {row}")
        require(max(row["stagewise_first_qp_err_f64"],
                    row["condensed_first_qp_err_f64"]) <= tol,
                f"H={H}: a backend's U is off its float64 optimum: {row}")
        require(row["first_qp_backends_max_du"] <= tol,
                f"H={H}: the backends' first U disagree: {row}")
        require(max(row["condensed_xla_loop_max_du"],
                    row["condensed_routed_loop_max_du"]) <= 2 * tol,
                f"H={H}: the backends' closed loops disagree: {row}")
    # -- solve_qp_implicit: examples/differentiable_mpc.py's problem ------
    H = 8
    spec_d = long_horizon_spec(H, R=np.eye(1), du_max=np.ones(1))
    cfg_d = SolverConfig(max_iters=100_000, check_every=4, accel_every=4,
                         y0=0.1, strict_weak_duality=False, eaj=1e-5,
                         erj=1e-6)
    datas = {d: condense(spec_d, device=d) for d in (dev, "cpu")}

    def first_input(lr, d):
        data = datas[d]
        Qp = data.qp() + 2.0 * (torch.exp(lr) - 1.0) * torch.eye(
            H, device=lr.device)
        p = data.assemble(x=torch.tensor([1.5, 0.0], device=lr.device),
                          D=torch.zeros(H, device=lr.device), Qp=Qp)
        return solve_qp_implicit(Qp, p.Fp, p.Gp, p.Kp, cfg_d)[0]

    grads = {}
    for d in (dev, "cpu"):
        lr = torch.zeros((), device=d, requires_grad=True)
        u = first_input(lr, d)
        u.backward()
        require(u.device.type == torch.device(d).type,
                f"the implicit solve left {d}")
        grads[str(d)] = float(lr.grad)
    g_card, g_cpu = grads[str(dev)], grads["cpu"]
    # the example's tuning loop, on the card
    lr = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    for _ in range(30):
        lr = lr.detach().requires_grad_()
        ((first_input(lr, dev) + 0.6) ** 2).backward()
        lr = lr - 0.5 * lr.grad
    tune_s = time.perf_counter() - t0
    u_tuned = float(first_input(lr.detach(), dev))
    # a vmap batch of 256 Fp's on the card (one batched solve and one
    # batched KKT solve) against one instance at a time: every lane on the
    # CPU, the first 8 on the card (a single-lane solve is launch-bound
    # there, ~0.3 s)
    Fps = torch.as_tensor(np.random.default_rng(0).normal(
        0.0, 2.0, (256, H)).astype(np.float32))
    gsum = lambda fn: torch.func.grad(lambda a: (fn(a) ** 2).sum())
    per_lane = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        data = datas[d]
        Qp = data.qp()
        p = data.assemble(x=torch.tensor([1.5, 0.0], device=d), Qp=Qp)
        fp = p.Fp[None] + Fps.to(d)
        f = (lambda a, Qp=Qp, p=p:
             solve_qp_implicit(Qp, a, p.Gp, p.Kp, cfg_d))
        if where == "card":
            gv, vmap_ms = timed_once(lambda: gsum(torch.func.vmap(f))(fp))
        lanes = range(8) if where == "card" else range(256)
        per_lane[where] = torch.stack([gsum(f)(fp[b]) for b in lanes])
    vmap_tol = 1e-4 * max(1.0, float(per_lane["cpu"].abs().max()))
    vmap_err = float((gv.cpu() - per_lane["cpu"]).abs().max())
    card_lane_err = float((gv[:8] - per_lane["card"]).abs().max())
    emit("diff", grad_card=g_card, grad_cpu=g_cpu,
         rel_err=abs(g_card - g_cpu) / max(abs(g_cpu), 1e-30),
         tuned_first_input=u_tuned, tuning_seconds=tune_s,
         vmap_batch=256, vmap_grad_ms=vmap_ms,
         vmap_vs_cpu_lanes_max_abs_err=vmap_err,
         vmap_vs_card_lanes_max_abs_err=card_lane_err, vmap_tol=vmap_tol,
         grad_device=gv.device.type, nvidia_smi=smi)
    require(abs(g_card - g_cpu) <= 1e-3 * abs(g_cpu),
            f"card gradient {g_card} against the CPU's {g_cpu}")
    require(abs(u_tuned + 0.6) < 0.05, f"tuned first input {u_tuned}")
    require(gv.device.type == "cuda" and vmap_err <= vmap_tol
            and card_lane_err <= vmap_tol,
            f"vmap gradients disagree: {vmap_err}, {card_lane_err}")
    return h512_ms


def production_spec():
    """examples/production_mpc.py's spec: the double integrator with a real
    disturbance channel (E = [0.005, 0.1]'), H = 20, r = 0.92, |u| <= 3,
    |du| <= 3, y <= 1, tightened by ``robust_spec`` for 1.3x the box
    |w| <= [0.003, 0.012]."""
    from pqp_for_mpc_tpu_torch.models import (LinearPlant, MPCSpec,
                                              robust_spec)
    dt = 0.1
    plant = LinearPlant(A=np.array([[1, dt], [0, 1]], np.float32),
                        B=np.array([[0.5 * dt * dt], [dt]], np.float32),
                        E=np.array([[0.005], [0.1]], np.float32),
                        C=np.array([[1.0, 0.0]], np.float32), name="di_e")
    spec = MPCSpec(plant=plant, horizon=20, Qy=np.eye(1), R=0.05 * np.eye(1),
                   r=np.array([0.92]), u_min=-3 * np.ones(1),
                   u_max=3 * np.ones(1), du_max=3 * np.ones(1),
                   y_max=np.ones(1))
    return robust_spec(spec, 1.3 * np.array([0.003, 0.012]))


def pendulum(g: float, damping: float, upright: bool):
    """The examples' pendulum as a torch RK4 step (dt = 0.05): theta'' =
    +-g sin(theta) - damping omega + u (+ about the upright)."""
    import torch
    sign = 1.0 if upright else -1.0

    def f_cont(x, u):
        return torch.stack([x[1], sign * g * torch.sin(x[0])
                            - damping * x[1] + u[0]])

    def f_disc(x, u):
        k1 = f_cont(x, u)
        k2 = f_cont(x + 0.025 * k1, u)
        k3 = f_cont(x + 0.025 * k2, u)
        k4 = f_cont(x + 0.05 * k3, u)
        return x + (0.05 / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return f_disc


def pendulum_spec(f_disc, H: int, R: float, du_max: float, dev):
    """The examples' RTI spec: the first linearization at the origin
    (torch.func Jacobians), E = I, the angle measured, |u| <= 12."""
    import torch
    from pqp_for_mpc_tpu_torch.models import LTVPlant, MPCSpec
    A, B = (j.cpu().numpy() for j in torch.func.jacrev(f_disc, (0, 1))(
        torch.zeros(2, device=dev), torch.zeros(1, device=dev)))
    plant = LTVPlant(A=np.tile(A[None], (H, 1, 1)),
                     B=np.tile(B[None], (H, 1, 1)),
                     E=np.tile(np.eye(2, dtype=np.float32)[None], (H, 1, 1)),
                     C=np.tile(np.array([[[1.0, 0.0]]], np.float32),
                               (H, 1, 1)), name="pendulum")
    return MPCSpec(plant=plant, horizon=H, Qy=np.eye(1), R=R * np.eye(1),
                   r=np.zeros(1), u_min=-12 * np.ones(1),
                   u_max=12 * np.ones(1), du_max=du_max * np.ones(1))


def timed_phase(fn):
    """(result, seconds, peak device bytes) of one call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def run_modules(argvs, timeout: float = 600):
    """``python -m <module> *args`` for each ``(module, *args)`` of
    ``argvs`` from the checkout's root, four at a time: [(exit code,
    stdout, stderr, seconds)] in order.  A process past ``timeout`` is
    killed (exit code None)."""
    from concurrent.futures import ThreadPoolExecutor
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def one(argv):
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "-m", *map(str, argv)],
                               capture_output=True, text=True, cwd=root,
                               env=env, timeout=timeout)
            return p.returncode, p.stdout, p.stderr, \
                time.perf_counter() - t0
        except subprocess.TimeoutExpired as e:
            return None, str(e.stdout), str(e.stderr), timeout
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(one, argvs))


def estimation_paths(dev, smi: str, mpc_h512_ms=None) -> None:
    """State estimation and offset-free control on the card (no
    hand-written kernel lies on these paths, as in the JAX package: the
    plain ``solve_batched`` and the stage-wise solve; every kernel counter
    stays at 0 over the group): the production stack, offset-free control
    on the stage-wise backend at H = 512, the linear and the relinearizing
    MHE, RTI, output feedback, and the command line's ``estimate`` and
    ``rollout --offset-free``.  Each phase prints ms per step (or window),
    its iterations and its peak device memory beside the card's name and
    power limit."""
    import torch
    from pqp_for_mpc_tpu_torch.cli import kf_estimates, simulated_record
    from pqp_for_mpc_tpu_torch.models import (KalmanFilter, LinearPlant,
                                              MovingHorizonEstimator,
                                              NonlinearMHE,
                                              OffsetFreeController,
                                              RTIController,
                                              output_feedback_rollout,
                                              quadruple_tank, relinearize)
    t_group = time.perf_counter()
    zero = {k: 0 for k in kernel_counts()}
    before = kernel_counts()

    # -- the production stack (examples/production_mpc.py) ---------------
    steps = PROD_STEPS
    t = np.arange(steps)
    w_seq = (np.where((t // 8) % 2 == 0, 1.0, -1.0)[:, None]
             * np.array([0.003, 0.012])[None, :]).astype(np.float32)
    d_fc = (0.5 * np.sin(0.15 * np.arange(steps + 20)))[:, None].astype(
        np.float32)
    ctrl = OffsetFreeController(production_spec(), kind="input",
                                retry_cold=True, device=dev)
    out, secs, peak = timed_phase(lambda: ctrl.rollout_jit(
        np.zeros(2, np.float32), steps, np.array([0.4], np.float32),
        w_seq=w_seq, d_forecast=d_fc))
    y = out["x"][:, 0]
    row = dict(steps=steps, backend=ctrl._ctrl.backend,
               n_con=ctrl._ctrl.n_con,
               certified=int(out["converged"].sum()),
               iters_mean=float(out["iters"].mean()),
               iters_max=int(out["iters"].max()), y_max=float(y.max()),
               y_mean_last_42=float(y[-42:].mean()),
               d_hat_mean_last_16=float(out["d_hat"][-16:].mean()),
               ms_per_step=secs / steps * 1e3, peak_memory_bytes=peak,
               launches_one_control=profiled_launches(lambda: ctrl.control(
                   np.array([0.5, 0.0]), np.array([0.4]))))
    emit("production_stack", nvidia_smi=smi, **row)
    # tests/test_composition.py::test_production_stack_holds_all_guarantees
    require(row["certified"] == steps and row["y_max"] <= 1.0 + 1e-4
            and abs(row["y_mean_last_42"] - 0.92) < 0.02
            and abs(row["d_hat_mean_last_16"] - 0.4) <= 0.02,
            f"production stack: {row}")

    # -- offset-free on the stage-wise backend at H = 512 ----------------
    spec = long_horizon_spec(OF_H, r=np.array([0.5]))
    (ctrl, build_s, _) = timed_phase(lambda: OffsetFreeController(
        spec, kind="input", backend="stagewise", device=dev))
    out, secs, peak = timed_phase(lambda: ctrl.rollout_jit(
        np.zeros(2, np.float32), OF_STEPS, np.array([0.2], np.float32)))
    row = dict(horizon=OF_H, n_con=ctrl._ctrl.n_con, steps=OF_STEPS,
               certified=int(out["converged"].sum()),
               iters_mean=float(out["iters"].mean()),
               iters_max=int(out["iters"].max()),
               iters=out["iters"].tolist(), y_last=float(out["y"][-1, 0]),
               d_hat_last=float(out["d_hat"][-1, 0]), build_seconds=build_s,
               ms_per_step=secs / OF_STEPS * 1e3,
               mpc_h512_loop_ms_per_step_this_run=mpc_h512_ms,
               peak_memory_bytes=peak)
    emit("offset_free_stagewise_h512", nvidia_smi=smi, **row)
    require(row["certified"] == OF_STEPS,
            f"offset-free H=512: {row['certified']} of {OF_STEPS} certified")

    # -- the linear MHE on the CLI's one-sided quadruple-tank record -----
    plant = quadruple_tank()
    x0, U, Y, X = simulated_record(plant, MHE_T, 1e-4, 1e-4, True, 0)
    qw, rv = 1e-4 * np.eye(4), 1e-4 * np.eye(2)
    kf_est, kf_s, _ = timed_phase(lambda: kf_estimates(
        KalmanFilter(plant, qw, rv, device=dev), x0, U, Y))
    kf_rmse = np.sqrt(((kf_est - X) ** 2).mean(axis=0))
    rows = {}
    for N in MHE_WINDOWS:
        mhe = MovingHorizonEstimator(plant, N, qw, rv,
                                     w_min=np.zeros(4, np.float32),
                                     device=dev)
        out, secs, peak = timed_phase(lambda: mhe.run(x0, U, Y))
        rmse = np.sqrt(((out["x_hat"] - X[N - 1:]) ** 2).mean(axis=0))
        windows = out["x_hat"].shape[0]
        rows[N] = dict(window=N, windows=windows, n_con=mhe.data.n_con,
                       converged_frac=float(out["converged"].mean()),
                       iters_mean=float(out["iters"].mean()),
                       iters_max=int(out["iters"].max()),
                       rmse=rmse.tolist(), ms_per_window=secs / windows * 1e3,
                       peak_memory_bytes=peak,
                       jax_cpu_reading=dict(zip(
                           ("converged_frac", "iters_mean", "rmse"),
                           JAX_MHE[N])))
        emit("mhe_quadruple_tank", nvidia_smi=smi, kf_rmse=kf_rmse.tolist(),
             kf_ms_per_step=kf_s / MHE_T * 1e3, jax_kf_rmse=JAX_MHE["kf"],
             **rows[N])
        require(rows[N]["converged_frac"] == 1.0
                and (rmse < kf_rmse).all(),
                f"MHE window {N}: {rows[N]} against the KF's {kf_rmse}")

    # -- the relinearizing MHE: the hanging pendulum, angle measured -----
    f_hang = pendulum(9.81, 0.15, upright=False)
    rng = np.random.default_rng(0)
    w_sd, v_sd = np.array([0.002, 0.01]), 0.02
    x = torch.tensor([2.4, 0.0])
    xs, us, ys = [], [], []
    for k in range(NMHE_T):
        u = np.array([0.3 * np.sin(0.25 * k)], np.float32)
        x = f_hang(x, torch.from_numpy(u)) + torch.from_numpy(
            rng.normal(0, w_sd).astype(np.float32))
        xs.append(x.numpy())
        us.append(u)
        ys.append((x.numpy()[:1] + rng.normal(0, v_sd, 1)).astype(
            np.float32))
    xs, us, ys = np.stack(xs), np.stack(us), np.stack(ys)
    Qw, Rv = np.diag(w_sd ** 2), np.array([[v_sd ** 2]])
    x0_hat = xs[0] + np.array([0.1, -0.2], np.float32)
    A0, B0 = (j.cpu().numpy() for j in torch.func.jacrev(f_hang, (0, 1))(
        torch.zeros(2, device=dev), torch.zeros(1, device=dev)))
    kf = KalmanFilter(LinearPlant(A=A0, B=B0, E=np.zeros((2, 1), np.float32),
                                  C=np.array([[1.0, 0.0]], np.float32)),
                      Qw, Rv, device=dev)
    kf_est = kf_estimates(kf, x0_hat, us[1:], ys[1:])
    nmhe = NonlinearMHE(f_hang, np.array([[1.0, 0.0]]), window=NMHE_WINDOW,
                        Qw=Qw, Rv=Rv, u_lin=np.zeros(1), w_min=-5 * w_sd,
                        w_max=5 * w_sd, sqp_iters=2, device=dev)
    out, secs, peak = timed_phase(lambda: nmhe.run(x0_hat, us, ys))
    truth = xs[NMHE_WINDOW - 1:]
    e_mhe = np.sqrt(((out["x_hat"] - truth) ** 2).mean(axis=0))
    e_kf = np.sqrt(((kf_est[NMHE_WINDOW - 2:] - truth) ** 2).mean(axis=0))
    windows = out["x_hat"].shape[0]
    row = dict(window=NMHE_WINDOW, windows=windows, sqp_iters=2,
               converged_frac=float(out["converged"].mean()),
               iters_mean=float(out["iters"].mean()),
               iters_max=int(out["iters"].max()), rmse=e_mhe.tolist(),
               kf_rmse=e_kf.tolist(), ms_per_window=secs / windows * 1e3,
               peak_memory_bytes=peak,
               launches_one_window=profiled_launches(lambda: nmhe.step(
                   x0_hat, us[:NMHE_WINDOW], ys[:NMHE_WINDOW])))
    emit("nonlinear_mhe_pendulum", nvidia_smi=smi, **row)
    require(row["converged_frac"] == 1.0 and (e_mhe < e_kf).all(),
            f"nonlinear MHE: {row}")

    # -- RTI: examples/nonlinear_mpc.py (H = 20, two passes, 60 steps) ---
    f_up = pendulum(10.0, 0.1, upright=True)
    from pqp_for_mpc_tpu_torch import SolverConfig
    rti_cfg = SolverConfig(max_iters=20_000, check_every=8, accel_every=4,
                           y0=0.01, eaj=1e-3, erj=1e-4, erc=1e-4, eac=1e-4,
                           strict_weak_duality=False)
    rti = RTIController(f_up, pendulum_spec(f_up, RTI_H, 0.02, 6.0, dev),
                        cfg=rti_cfg, sqp_iters=2, device=dev)
    out, secs, peak = timed_phase(lambda: rti.rollout(
        np.array([2.5, 0.0], np.float32), RTI_STEPS))
    row = dict(horizon=RTI_H, steps=RTI_STEPS, sqp_iters=2,
               certified=int(out["converged"].sum()),
               iters_mean=float(out["iters"].mean()),
               iters_max=int(out["iters"].max()),
               x_last=out["x"][-1].tolist(),
               u_abs_max=float(np.abs(out["u"]).max()),
               ms_per_step=secs / RTI_STEPS * 1e3, peak_memory_bytes=peak)
    # one pass split (profiling a whole step costs seconds of host time):
    # the nominal roll, the Jacobians, relinearize, and the solve's
    # launches per update, check and accel step
    x = torch.tensor([2.5, 0.0], device=dev)
    useq = torch.zeros((RTI_H, 1), device=dev)
    xbar = rti._nominal(x, useq)
    A, B = rti._jacs(xbar, useq)
    row["launches_one_pass"] = dict(
        nominal=profiled_launches(lambda: rti._nominal(x, useq)),
        jacobians=profiled_launches(lambda: rti._jacs(xbar, useq)),
        relinearize=profiled_launches(lambda: relinearize(rti._sd0, A, B)),
        solve=stagewise_launches(relinearize(rti._sd0, A, B), x[:, None],
                                 rti.cfg))
    emit("rti_pendulum", nvidia_smi=smi, **row)
    # tests/test_rti.py's swing bars and the example's "stabilized upright"
    require(row["certified"] == RTI_STEPS
            and abs(out["x"][-1, 0]) < 0.01 and abs(out["x"][-1, 1]) < 0.02
            and abs(out["x"][-1, 0]) < abs(out["x"][4, 0])
            and row["u_abs_max"] <= 12.0 + 1.5e-3, f"RTI: {row}")

    # -- output feedback (examples/output_feedback_nonlinear_mpc.py) -----
    f_of = pendulum(9.81, 0.2, upright=True)
    rti = RTIController(f_of, pendulum_spec(f_of, OFB_H, 0.05, 10.0, dev),
                        sqp_iters=1, device=dev)
    w_sd, v_sd = np.array([0.001, 0.005]), 0.01
    mhe = NonlinearMHE(f_of, np.array([[1.0, 0.0]], np.float32),
                       window=OFB_N, Qw=np.diag(w_sd ** 2),
                       Rv=np.array([[v_sd ** 2]]), u_lin=np.zeros(1),
                       w_min=-5 * w_sd, w_max=5 * w_sd, device=dev)
    rng = np.random.default_rng(1)
    w_seq = rng.normal(0, w_sd, (OFB_STEPS + OFB_N, 2)).astype(np.float32)
    v_seq = rng.normal(0, v_sd, (OFB_STEPS + OFB_N, 1)).astype(np.float32)
    out, secs, peak = timed_phase(lambda: output_feedback_rollout(
        rti, mhe, np.array([0.15, 0.0], np.float32), OFB_STEPS, w_seq,
        v_seq))
    tail = np.abs(out["x"][-5:])
    err = np.sqrt(((out["x_hat"][OFB_STEPS // 3:]
                    - out["x"][OFB_STEPS // 3:]) ** 2).mean(axis=0))
    row = dict(horizon=OFB_H, window=OFB_N, steps=OFB_STEPS,
               certified_mhe=int(out["conv_mhe"].sum()),
               certified_rti=int(out["conv_rti"].sum()),
               iters_mhe_mean=float(out["iters_mhe"].mean()),
               iters_rti_mean=float(out["iters_rti"].mean()),
               tail_abs_max=tail.max(axis=0).tolist(),
               estimate_rmse=err.tolist(),
               ms_per_step=secs / OFB_STEPS * 1e3, peak_memory_bytes=peak)
    emit("output_feedback_pendulum", nvidia_smi=smi, **row)
    # the example's "stabilized upright from angle-only measurements" and
    # tests/test_mhe.py's bars on the capstone
    require(row["certified_mhe"] == row["certified_rti"] == OFB_STEPS
            and tail[:, 0].max() < 0.05 and tail[:, 1].max() < 0.15
            and err[0] < 0.03 and err[1] < 0.1, f"output feedback: {row}")
    after = kernel_counts()
    used = {k: after[k] - before[k] for k in after}
    emit("estimation_path_kernel_launches", **used)
    require(used == zero, f"a kernel launched on the estimation path: {used}")

    # -- the command line, as subprocesses, all at once ------------------
    argvs = {"estimate_kf": ("estimate", "--kind", "kf"),
             "estimate_mhe": ("estimate", "--kind", "mhe", "--simulate",
                              MHE_T, "--one-sided"),
             "rollout_offset_free_input": ("rollout", "--offset-free",
                                           "input", "--steps", 30),
             "rollout_offset_free_output": ("rollout", "--offset-free",
                                            "output", "--plant",
                                            "quadruple_tank", "--steps",
                                            30)}
    t_cli = time.perf_counter()
    results = dict(zip(argvs, run_modules(
        [("pqp_for_mpc_tpu_torch", *argv) for argv in argvs.values()],
        timeout=300)))
    cli_s = time.perf_counter() - t_cli
    lines = {}
    for name, (rc, out_l, err, _) in results.items():
        lines[name] = json.loads(out_l.strip().splitlines()[-1]) \
            if rc == 0 else {}
        require(rc == 0 and lines[name], f"cli {name}: {rc} {out_l} {err}")
    emit("cli_estimation", nvidia_smi=smi, seconds=cli_s, **lines)
    require(lines["estimate_mhe"]["converged_frac"] == 1.0
            and lines["rollout_offset_free_input"]["offset_free"] == "input"
            and lines["rollout_offset_free_output"]["offset_free"]
            == "output", f"cli estimation lines: {lines}")
    emit("estimation_group", seconds=time.perf_counter() - t_group,
         nvidia_smi=smi)


def parallel_paths(dev, smi: str, main_plain: dict, big_plain: dict,
                   big_cfg) -> None:
    """Data- and tensor-parallel solves (``parallel/``) on the card.  No
    hand-written kernel lies on these paths, as in the JAX package, whose
    sharded products are plain matmuls inside ``shard_map``: every kernel
    counter stays at 0 over the group.  One card is a 1 x 1 mesh of a
    one-rank NCCL group, so every collective runs, over one rank, and no
    scaling is measured.  ``main_plain`` and ``big_plain`` hold the plain
    ``solve_batched`` results (U, iters, converged; the large-N run's
    seconds per batch too) of the main path's and the streamed workload's
    phases.  Phases:

    * ``row_sharded_streamed``: ``solve_row_sharded`` on the streamed
      workload under the large-N configuration, float32 and ``mixed``:
      float32 gives plain's verdict on every lane, U within the parity bar
      and iterations within max(5, iters/5) rounded up to whole checks;
      mixed certifies >= 99% with U within 2e-3 of float32's; each run's
      collectives counted (all-gathers by dtype with their bytes,
      all-reduces);
    * ``data_parallel_main``: ``shard_batch`` + ``solve_batched`` on the
      main path's batch, U, iterations and verdicts bit for bit plain's;
    * ``sharded_large_n_torchrun``: the ``sharded_large_n`` twin under
      ``torchrun`` (one process; the env-driven ``initialize`` on NCCL):
      ``'converged': 8``;
    * ``example_twins``: the twins whose settings the script does not
      already drive, four processes at once, at their JAX tests' arguments
      (the default where the JAX package has no test), each held to its
      JAX test's line.  ``long_horizon_mpc``, ``production_mpc``,
      ``nonlinear_mpc``, ``output_feedback_nonlinear_mpc`` and
      ``differentiable_mpc`` are driven at their settings by
      ``stagewise_paths`` and ``estimation_paths``."""
    import tempfile

    import torch
    import torch.distributed as tdist
    import pqp_for_mpc_tpu_torch as pqp
    from pqp_for_mpc_tpu_torch.bench import EXAMPLE_CFG, example_workload
    from pqp_for_mpc_tpu_torch.parallel import (make_mesh, shard_batch,
                                                solve_row_sharded)
    from pqp_for_mpc_tpu_torch.parallel.distributed import initialize
    t_group = time.perf_counter()
    zero = {k: 0 for k in kernel_counts()}
    before = kernel_counts()
    tally = {}
    real = {"all_gather_into_tensor": tdist.all_gather_into_tensor,
            "all_reduce": tdist.all_reduce}

    def counted(name):
        def call(*args, **kw):
            key = name
            if name == "all_gather_into_tensor":
                key = f"all_gather_{args[1].dtype}".replace("torch.", "")
                tally[key + "_bytes"] = (tally.get(key + "_bytes", 0)
                                         + args[0].numel()
                                         * args[0].element_size())
            tally[key] = tally.get(key, 0) + 1
            return real[name](*args, **kw)
        return call

    with tempfile.TemporaryDirectory() as tmp:
        initialize(init_method=f"file://{tmp}/store", num_processes=1,
                   process_id=0, device=dev)
        try:
            mesh = make_mesh(data=1, model=1, device_type=dev.type)
            # -- row-sharded on the streamed workload, f32 and mixed -----
            lp, ld = streamed_workload(dev)
            runs = {}
            for name, mixed in (("float32", False), ("mixed", True)):
                tally.clear()
                for k in real:
                    setattr(tdist, k, counted(k))
                try:
                    res, secs, peak = timed_phase(lambda: solve_row_sharded(
                        lp, ld, cfg=big_cfg, mesh=mesh, mixed=mixed))
                finally:
                    for k, fn in real.items():
                        setattr(tdist, k, fn)
                runs[name] = res
                emit("row_sharded_streamed", mode=name, mesh=[1, 1],
                     n=N_BIG, m=M_BIG, batch=B_BIG,
                     converged_frac=float(res.converged.float().mean()),
                     iters_mean=float(res.iters.float().mean()),
                     iters_max=int(res.iters.max()),
                     seconds_per_batch=secs, peak_memory_bytes=peak,
                     plain_seconds_per_batch=big_plain["seconds_per_batch"],
                     collectives=dict(tally), nvidia_smi=smi)
            r32, rmx = runs["float32"], runs["mixed"]
            it_p = big_plain["iters"].long()
            k = big_cfg.check_every
            bar = torch.div(torch.clamp(it_p // 5, min=5) + k - 1, k,
                            rounding_mode="floor") * k
            U_p = big_plain["U"]
            cmp = dict(
                verdicts_equal_plain=int((r32.converged
                                          == big_plain["converged"]).sum()),
                u_max_abs_err=float((r32.U - U_p).abs().max()),
                u_tol=5e-3 * max(1.0, float(U_p.abs().max())),
                iters_max_abs_diff=int((r32.iters.long() - it_p).abs().max()),
                iters_within_bar=int(((r32.iters.long() - it_p).abs()
                                      <= bar).sum()),
                mixed_converged_frac=float(rmx.converged.float().mean()),
                mixed_u_max_abs_err=float((rmx.U - r32.U).abs().max()),
                mixed_u_within_2e3=bool(torch.allclose(
                    rmx.U, r32.U, rtol=2e-3, atol=2e-3)),
                all_gather_bytes_received_per_rank_per_update=dict(
                    float32=f"(mp-1)/mp * {N_BIG * B_BIG * 4}",
                    bfloat16=f"(mp-1)/mp * {N_BIG * B_BIG * 2}"))
            emit("row_sharded_streamed_parity", batch=B_BIG, **cmp)
            require(cmp["verdicts_equal_plain"] == B_BIG
                    and cmp["u_max_abs_err"] <= cmp["u_tol"]
                    and cmp["iters_within_bar"] == B_BIG,
                    f"row-sharded float32 against plain: {cmp}")
            require(cmp["mixed_converged_frac"] >= 0.99
                    and cmp["mixed_u_within_2e3"],
                    f"row-sharded mixed: {cmp}")
            del lp, ld, runs, r32, rmx
            torch.cuda.empty_cache()

            # -- data parallel on the main path's batch -----------------
            primal, dual = example_workload(B_MAIN, dev)
            pl, dl = shard_batch(primal, dual, mesh)
            res, secs, peak = timed_phase(
                lambda: pqp.solve_batched(pl, dl, cfg=EXAMPLE_CFG))
            bits = dict(
                u=bits_equal([res.U], [main_plain["U"]]),
                iters=bool(torch.equal(res.iters, main_plain["iters"])),
                verdicts=bool(torch.equal(res.converged,
                                          main_plain["converged"])))
            emit("data_parallel_main", mesh=[1, 1], batch=B_MAIN,
                 converged_frac=float(res.converged.float().mean()),
                 iters_mean=float(res.iters.float().mean()),
                 seconds_per_batch=secs, peak_memory_bytes=peak,
                 bits_equal_plain=bits, nvidia_smi=smi)
            require(all(bits.values()),
                    f"data-parallel solve differs from plain: {bits}")
            del primal, dual, pl, dl, res
        finally:
            tdist.destroy_process_group()
    torch.cuda.empty_cache()
    after = kernel_counts()
    used = {k: after[k] - before[k] for k in after}
    emit("parallel_path_kernel_launches", **used)
    require(used == zero, f"a kernel launched on the parallel path: {used}")

    # -- the sharded_large_n twin under torchrun (env:// on NCCL) --------
    ((rc, out, err, secs),) = run_modules(
        [("torch.distributed.run", "--standalone", "--nproc_per_node=1",
          "-m", "pqp_for_mpc_tpu_torch.examples.sharded_large_n",
          "--device", dev.type)], timeout=300)
    emit("sharded_large_n_torchrun", seconds=secs, stdout=out.strip(),
         nvidia_smi=smi)
    require(rc == 0 and "'converged': 8" in out,
            f"sharded_large_n under torchrun: {rc} {out} {err[-3000:]}")

    # -- the twins, four at once ------------------------------------------
    twins = {"scenario_batch": (["64"], ["solves/s"]),
             "large_n_mixed": ([], ["certified 8/8", "max |dU|"]),
             "receding_horizon": (["30"], ["steps in"]),
             "constrained_outputs_mpc": (["48", "20"],
                                         ["certified 100%",
                                          "bound honored: True"]),
             "learned_mpc_closed_loop": ([], ["closed-loop cost"]),
             "train_mpc_optax": (["4", "6"], ["->", "scenarios"]),
             "offset_free_mpc": (["60"], ["offset-free",
                                          "all converged: True"])}
    t_twins = time.perf_counter()
    results = run_modules([(f"pqp_for_mpc_tpu_torch.examples.{name}", *argv,
                            "--device", dev.type)
                           for name, (argv, _) in twins.items()])
    rows = {}
    for (name, (argv, lines)), (rc, out, err, secs) in zip(twins.items(),
                                                           results):
        rows[name] = dict(argv=argv, rc=rc, seconds=secs,
                          lines_found=all(x in out for x in lines),
                          last_line=(out.strip().splitlines() or [""])[-1],
                          stderr_tail=err[-1500:] if rc else "")
    emit("example_twins", seconds=time.perf_counter() - t_twins,
         nvidia_smi=smi, **rows)
    require(all(r["rc"] == 0 and r["lines_found"] for r in rows.values()),
            f"example twins: {rows}")
    emit("parallel_group", seconds=time.perf_counter() - t_group,
         nvidia_smi=smi)


#: K1's dual-gradient instantiation against its plain version: (name,
#: horizon, reference r, batch, warm) -- the warm loop's shape (N = 28,
#: M = 7) at one lane and at B_CMP, and the H = 16 shape (N = 64, M = 16)
#: of the controller's fan-out step and its closed loop
K1_DUAL_CASES = [("n28_cold", 7, 2.5, B_CMP, False),
                 ("n28_warm", 7, 2.5, B_CMP, True),
                 ("n28_warm_b1", 7, 2.5, 1, True),
                 ("n64_cold", 16, 0.0, B_N64, False),
                 ("n64_warm_b1", 16, 0.0, 1, True)]


def k1_dual_gradient_paths(dev, smi: str) -> list:
    """K1 under ``MPC_CONFIG`` (the dual-gradient certificate, with
    acceleration) against its plain version, on each of
    :data:`K1_DUAL_CASES`; a warm start is the plain solve's multipliers on
    the next draw of states (seed 1), floored at 1e-6.  Held to
    :func:`solve_parity`'s bars with acceleration (lane states equal,
    the iteration bar on 99% of lanes, U within 5e-3 * max(1, |U|max));
    at N = 64 to :func:`accel_h16_parity`'s, the bars of the accelerated
    H = 16 loop (K8's ``n64_accel`` case: on an H100 one lane of the
    4,096 cold ones ends in another state, as there); to
    :func:`k1_parity`'s verdicts through the rescue on >= 99.9% of
    lanes; and the launch repeated to the bit.  Returns the U errors."""
    import torch
    from pqp_for_mpc_tpu_torch import solve_batched
    from pqp_for_mpc_tpu_torch.bench import example_workload
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
    from pqp_for_mpc_tpu_torch.ops import solve_kernel
    cfg, errs = MPC_CONFIG, []
    for name, H, r, B, warm in K1_DUAL_CASES:
        primal, dual = example_workload(B, dev, seed=0, horizon=H, r=r)
        Y0 = None
        if warm:
            prev = solve_batched(*example_workload(B, dev, seed=1,
                                                   horizon=H, r=r), cfg=cfg)
            Y0 = torch.clamp(prev.Y, min=1e-6)
        args, kw = solve_kernel.fused_inputs(primal, dual, Y0, cfg)
        require(kw.get("feas_dual") is True,
                f"K1 ({name}): fused_inputs did not ask for the "
                f"dual-gradient test")
        before = solve_kernel.fused_full_solve.launches
        out_k = solve_kernel.fused_full_solve(*args, **kw)
        out_p = solve_kernel.fused_full_solve_reference(*args, **kw)
        again = solve_kernel.fused_full_solve(*args, **kw)
        torch.cuda.synchronize()
        require(solve_kernel.fused_full_solve.launches == before + 2,
                "K1 launch counter did not move")
        if dual.n_con == 64:
            cmp = accel_h16_parity(out_k, out_p, cfg.check_every)
        else:
            cmp = solve_parity(out_k, out_p, cfg.check_every, accel=True)
        verdicts = k1_parity(primal, dual, cfg, out_k, out_p)
        cmp["converged_agree"] = verdicts["converged_agree"]
        cmp["repeats_bits"] = bits_equal(out_k, again)
        emit("k1_dual_gradient_vs_plain", case=name, n=dual.n_con,
             m=primal.n_var, batch=B, warm=warm, nvidia_smi=smi, **cmp)
        require(cmp["ok"] and cmp["converged_agree"] >= 0.999,
                f"K1's dual-gradient test ({name}) disagrees with its "
                f"plain version: {cmp}")
        require(cmp["repeats_bits"], f"K1 ({name}) did not repeat its bits")
        errs.append(cmp["max_abs_err"])
        del primal, dual, Y0, args, out_k, out_p, again
    torch.cuda.empty_cache()
    return errs


def closed_loop_h16(dev, smi: str) -> None:
    """The H = 16 closed loop kept on the card (``rollout_jit``, routed:
    each step one K1 launch under ``MPC_CONFIG``'s dual-gradient
    certificate) against the host loop (``rollout``) on the plain engine
    (``engine="xla"``), each certified at every step, u within the U bar,
    the iteration bar on 26 of 30 steps' share and mean iterations within
    10% (the bars of tests/test_torch_rollout.py); both timed."""
    import torch
    import pqp_for_mpc_tpu_torch.models.mpc as mpc_module
    from pqp_for_mpc_tpu_torch.bench import example_spec
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
    from pqp_for_mpc_tpu_torch.models import MPCController
    from pqp_for_mpc_tpu_torch.ops import solve_kernel
    auto = mpc_module.solve_auto
    loop, k1 = {}, {}
    for name in ("rollout_jit", "rollout"):
        if name == "rollout":
            mpc_module.solve_auto = (
                lambda *a, **k: auto(*a, engine="xla", **k))
        try:
            ctrl = MPCController(example_spec(16, 0.0), device=dev)
            getattr(ctrl, name)([2.0, 0.0], 5)            # warm-up
            ctrl.reset()
            torch.cuda.synchronize()
            before = solve_kernel.fused_full_solve.launches
            t0 = time.perf_counter()
            loop[name] = getattr(ctrl, name)([2.0, 0.0], LOOP_STEPS)
            torch.cuda.synchronize()
            loop[name]["seconds"] = time.perf_counter() - t0
            k1[name] = solve_kernel.fused_full_solve.launches - before
        finally:
            mpc_module.solve_auto = auto
    lj, lh = loop["rollout_jit"], loop["rollout"]
    tol_u = 5e-3 * max(1.0, float(np.abs(lh["u"]).max()))
    bar = np.maximum(5, lh["iters"] // 5)
    bar = -(-bar // MPC_CONFIG.check_every) * MPC_CONFIG.check_every
    in_bar = float((np.abs(lj["iters"] - lh["iters"]) <= bar).mean())
    du = float(np.abs(lj["u"] - lh["u"]).max())
    emit("closed_loop_h16_rollout_jit", steps=LOOP_STEPS, nvidia_smi=smi,
         steps_per_s_rollout_jit=LOOP_STEPS / lj["seconds"],
         steps_per_s_rollout=LOOP_STEPS / lh["seconds"],
         k1_launches_rollout_jit=k1["rollout_jit"],
         k1_launches_rollout=k1["rollout"],
         certified_rollout_jit=int(lj["converged"].sum()),
         certified_rollout=int(lh["converged"].sum()),
         iters_mean_rollout_jit=float(lj["iters"].mean()),
         iters_mean_rollout=float(lh["iters"].mean()),
         iters_in_bar=in_bar, max_abs_err_u=du, tol_u=tol_u,
         max_abs_err_x=float(np.abs(lj["x"] - lh["x"]).max()))
    require(k1["rollout_jit"] == LOOP_STEPS and k1["rollout"] == 0,
            f"the H=16 loops' K1 launches: {k1}")
    require(bool(lj["converged"].all()),
            "rollout_jit left a step of the H=16 loop uncertified")
    require(bool(lh["converged"].all()),
            "rollout left a step of the H=16 loop uncertified")
    require(du <= tol_u and in_bar >= 26 / 30
            and abs(lj["iters"].mean() - lh["iters"].mean())
            <= 0.1 * lh["iters"].mean(),
            "rollout_jit on K1 and rollout on the plain engine disagree on "
            "the H=16 loop")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pqp_for_mpc_tpu_torch as pqp
    from pqp_for_mpc_tpu_torch.bench import (EXAMPLE_CFG, example_spec,
                                             example_workload)
    from pqp_for_mpc_tpu_torch.config import MPC_CONFIG, stagewise_mpc_config
    from pqp_for_mpc_tpu_torch.models import MPCController
    from pqp_for_mpc_tpu_torch.ops import (build, kernels, packed_kernel,
                                           solve_kernel, tiled_kernel,
                                           tiled_solve_kernel)
    require("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", 0)
    # the main path's configuration (the example benchmark's): MPC_CONFIG's
    # tolerances with the reference's forcing-scale feasibility test (which
    # the whole-solve kernel certifies in-kernel) and no acceleration
    smoke_cfg = EXAMPLE_CFG

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
    primal, dual = example_workload(B_CMP, dev)
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
    k2_cmp["repeats_bits"] = bool((kernels.fused_pqp_iterations(
        *k2_args, num_iters=8, den_eps=smoke_cfg.den_eps) == got).all())
    emit("k2_plan", main_path=kernels.k2_plan(N, B_MAIN),
         comparison=kernels.k2_plan(N, B_CMP))
    emit("k2_vs_plain", batch=B_CMP, num_iters=8, **k2_cmp)
    require(k2_cmp["ok"], f"K2 disagrees with its plain version: {k2_cmp}")
    require(k2_cmp["repeats_bits"], "K2 did not repeat its bits")

    # -- phase 3: K1 (solve_fused) against its plain version -------------
    args, kw = solve_kernel.fused_inputs(primal, dual, None, smoke_cfg)
    before = solve_kernel.fused_full_solve.launches
    out_k = solve_kernel.fused_full_solve(*args, **kw)
    out_p = solve_kernel.fused_full_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    require(solve_kernel.fused_full_solve.launches == before + 1,
            "K1 launch counter did not move")
    k1_cmp = k1_parity(primal, dual, smoke_cfg, out_k, out_p)
    k1_cmp["repeats_bits"] = bits_equal(
        out_k, solve_kernel.fused_full_solve(*args, **kw))
    emit("k1_plan", main_path=solve_kernel.k1_plan(N, primal.n_var, B_MAIN),
         card=solve_kernel.card_plan(N, primal.n_var, B_MAIN),
         comparison=solve_kernel.k1_plan(N, primal.n_var, B_CMP))
    emit("k1_vs_plain", batch=B_CMP, **k1_cmp)
    require(k1_cmp["ok"], f"K1 disagrees with its plain version: {k1_cmp}")
    require(k1_cmp["repeats_bits"], "K1 did not repeat its bits")
    errs = {"k1": [k1_cmp["max_abs_err"]], "k2": [k2_cmp["max_abs_err"]]}
    del primal, dual, Y, got, want, out_k, out_p, args
    torch.cuda.empty_cache()

    # -- phase 3c: K1's dual-gradient instantiation (MPC_CONFIG, the
    #    controller's route) against its plain version ------------------
    errs["k1"] += k1_dual_gradient_paths(dev, smi)

    # -- phase 3b: K8 (packed whole solve) against its plain version, at
    #    N=28 (G=4) on B_CMP lanes and N=64 (G=2) on the H=16 workload --
    k8 = packed_kernel.fused_full_solve_packed
    k8_plain = packed_kernel.fused_full_solve_packed_reference
    accel_cfg = dataclasses.replace(smoke_cfg, check_every=4, accel_every=4)
    mpc_cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False)
    k8_cases = [
        ("n28", lambda: example_workload(B_CMP, dev), smoke_cfg, False),
        ("n28_accel", lambda: example_workload(B_CMP, dev), accel_cfg,
         False),
        ("n28_per_lane_kp", lambda: example_workload(B_CMP, dev),
         dataclasses.replace(smoke_cfg, gap_from_complementarity=False),
         True),
        ("n64", lambda: example_workload(B_N64, dev, horizon=16, r=0.0),
         smoke_cfg, False),
        ("n64_accel", lambda: example_workload(B_N64, dev, horizon=16,
                                               r=0.0), mpc_cfg, False),
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
        if name == "n64_accel":
            cmp = accel_h16_parity(out_k, out_p, cfg.check_every)
        else:
            cmp = solve_parity(out_k, out_p, cfg.check_every,
                               bool(cfg.accel_every))
        repeat = all(bool((a == b).all()) for a, b in zip(out_k, again))
        cmp["bits_equal_k1"] = bits_equal(
            out_k, solve_kernel.fused_full_solve(*args, **kw))
        require(cmp["bits_equal_k1"], f"K8 ({name}) did not give K1's bits")
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
    primal, dual = example_workload(B_MAIN, dev)
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
    # the main path's launches over ONE call of each route: every count set
    # to 0 just before the route's first call and read just after it
    launches = {}
    for name, fn in runs.items():
        kernels.fused_pqp_iterations.launches = 0
        solve_kernel.fused_full_solve.launches = 0
        res = fn()
        torch.cuda.synchronize()
        if name == "k1_route":
            launches["k1"] = solve_kernel.fused_full_solve.launches
        elif name == "k2_route":
            launches["k2"] = kernels.fused_pqp_iterations.launches
        conv = float(res.converged.float().mean())
        if name == "plain":     # parallel_paths holds its solve to these
            main_plain = dict(U=res.U, iters=res.iters,
                              converged=res.converged)
        ms = cuda_ms(fn, reps=2)
        main_rows[name] = dict(
            converged_frac=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()), seconds_per_batch=ms / 1e3,
            solves_per_s=B_MAIN / (ms / 1e3))
        emit("main_path", engine=name, batch=B_MAIN, **main_rows[name])
        require(conv >= 0.99, f"{name}: only {conv:.4f} converged")
        del res
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
    spec = example_spec(16, 0.0)
    ctrl = MPCController(spec, device=dev)
    out = ctrl.rollout([2.0, 0.0], 20)
    loop_ok = (bool(out["converged"].all()) and int(out["iters"].max()) < 2000
               and bool(np.isfinite(out["x"]).all()))
    emit("closed_loop", steps=20, certified=int(out["converged"].sum()),
         iters_max=int(out["iters"].max()),
         x_final=out["x"][-1].tolist(), ok=loop_ok)
    require(loop_ok, "closed loop failed to certify every step")
    # the controller's fan-out step at N = 64 routes to K1 under
    # MPC_CONFIG's dual-gradient certificate: one launch, no K2
    k1_before = solve_kernel.fused_full_solve.launches
    k2_before = kernels.fused_pqp_iterations.launches
    fan = MPCController(spec, device=dev)
    xs = np.random.default_rng(2).normal(0.0, 0.5, (2, 4096))
    _, res = fan.step(xs.astype(np.float32))
    torch.cuda.synchronize()
    fan_conv = float(res.converged.float().mean())
    emit("scenario_fan_out", batch=4096, converged_frac=fan_conv,
         iters_max=int(res.iters.max()),
         k1_launches=solve_kernel.fused_full_solve.launches - k1_before,
         k2_launches=kernels.fused_pqp_iterations.launches - k2_before)
    require(solve_kernel.fused_full_solve.launches == k1_before + 1
            and kernels.fused_pqp_iterations.launches == k2_before,
            "the fan-out step did not run as one K1 launch")

    # -- phase 5b: the H=16 closed loop kept on the card (rollout_jit, on
    #    K1), timed against the host loop (rollout) on the plain engine --
    closed_loop_h16(dev, smi)

    # -- each kernel against its plain version at the main path's shapes,
    #    then both timed ------------------------------------------------
    args, kw = solve_kernel.fused_inputs(primal, dual, None, smoke_cfg)
    out_k1 = solve_kernel.fused_full_solve(*args, **kw)
    k1_cmp = k1_parity(primal, dual, smoke_cfg, out_k1,
                       solve_kernel.fused_full_solve_reference(*args, **kw))
    k1_cmp["repeats_bits"] = bits_equal(
        out_k1, solve_kernel.fused_full_solve(*args, **kw))
    emit("k1_vs_plain", batch=B_MAIN, **k1_cmp)
    require(k1_cmp["ok"], f"K1 disagrees with its plain version at the "
                          f"main path's batch: {k1_cmp}")
    require(k1_cmp["repeats_bits"], "K1 did not repeat its bits at the "
                                    "main path's batch")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    Yb = 0.01 + 9.99 * torch.rand((dual.n_con, B_MAIN), generator=g,
                                  device=dev)
    k2_args = (dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Yb)
    k2_kw = dict(num_iters=smoke_cfg.check_every, den_eps=smoke_cfg.den_eps)
    got = kernels.fused_pqp_iterations(*k2_args, **k2_kw)
    k2_cmp = k2_parity(
        got, kernels.fused_pqp_iterations_reference(*k2_args, **k2_kw))
    k2_cmp["repeats_bits"] = bool(
        (kernels.fused_pqp_iterations(*k2_args, **k2_kw) == got).all())
    del got
    emit("k2_vs_plain", batch=B_MAIN, num_iters=smoke_cfg.check_every,
         **k2_cmp)
    require(k2_cmp["ok"], f"K2 disagrees with its plain version at the "
                          f"main path's batch: {k2_cmp}")
    require(k2_cmp["repeats_bits"], "K2 did not repeat its bits at the main "
                                    "path's batch")
    errs["k1"].append(k1_cmp["max_abs_err"])
    errs["k2"].append(k2_cmp["max_abs_err"])
    out_k8 = k8(*args, **kw)
    out_p8, k8_plain_ms = timed_once(lambda: k8_plain(*args, **kw))
    k8_cmp = solve_parity(out_k8, out_p8, smoke_cfg.check_every, False)
    k8_cmp["repeats_bits"] = bits_equal(out_k8, k8(*args, **kw))
    k8_cmp["bits_equal_k1"] = bits_equal(out_k8, out_k1)
    emit("k8_vs_plain", case="main_path", n=dual.n_con, m=primal.n_var,
         batch=B_MAIN, pack=packed_kernel.pack_factor(dual.n_con), **k8_cmp)
    require(k8_cmp["ok"], f"K8 disagrees with its plain version at the "
                          f"main path's batch: {k8_cmp}")
    require(k8_cmp["repeats_bits"] and k8_cmp["bits_equal_k1"],
            f"K8 did not repeat its bits or K1's: {k8_cmp}")
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
    # the tile plans: the streamed workload and the H=64 loop (f32 also a
    # ragged shape)
    emit("k3_bf16_plan", streamed=tiled_kernel.k3_bf16_plan(N_BIG, B_BIG),
         h64_loop=tiled_kernel.k3_bf16_plan(256, 1))
    emit("k3_f32_plan", streamed=tiled_kernel.k3_f32_plan(N_BIG, B_BIG),
         h64_loop=tiled_kernel.k3_f32_plan(256, 1),
         ragged=tiled_kernel.k3_f32_plan(203, 5))
    k3 = tiled_kernel.streamed_pqp_iterations
    k3_plain = tiled_kernel.streamed_pqp_iterations_reference
    # the H=64 loop's geometry (N = 256) at its single lane (both modes'
    # small tiles, staged entry by entry), a ragged corner of the streamed
    # workload (N = 203, B = 5) in f32, and the streamed workload's shape in
    # f32 also at the other of 64 and 128 lanes
    _, d64 = example_workload(1, dev, horizon=64, r=0.0)
    Y64 = torch.as_tensor(np.random.default_rng(6).uniform(
        0.5, 2.0, (d64.n_con, 1)).astype(np.float32), device=dev)
    k3_cases = [(mode, N_BIG, B_BIG, None, (Q, th, ld.Fdn, ld.Fdp, Y3))
                for mode, (Q, th) in streams.items()]
    shipped_lanes = tiled_kernel.k3_f32_plan(N_BIG, B_BIG)["tile_lanes"]
    other = 64 if shipped_lanes == 128 else 128
    k3_cases.append(("float32", N_BIG, B_BIG, other,
                     (*streams["float32"], ld.Fdn, ld.Fdp, Y3)))
    for mode in ("float32", "bfloat16"):
        k3_cases.append((mode, d64.n_con, 1, None, (
            *tiled_kernel.streamed_matrix(d64.Qd, d64.theta, mode),
            d64.Fdn, d64.Fdp, Y64)))
    k3_cases.append(("float32", 203, 5, None, (
        *tiled_kernel.streamed_matrix(ld.Qd[:203, :203].contiguous(),
                                      ld.theta[:203], "float32"),
        ld.Fdn[:203, :5].contiguous(), ld.Fdp[:203, :5].contiguous(),
        Y3[:203, :5].contiguous())))
    shipped_plan = tiled_kernel.k3_f32_plan
    k3_f32_big = {}
    for mode, n, batch, lanes, k3_args in k3_cases:
        if lanes:
            tiled_kernel.k3_f32_plan = lambda n_, b_, _l=lanes: dict(
                shipped_plan(n_, b_), tile_lanes=_l)
        try:
            plan = (tiled_kernel.k3_f32_plan(n, batch)["tile_lanes"]
                    if mode == "float32" else None)
            got = k3(*k3_args, **k3_kw)
            again = k3(*k3_args, **k3_kw)
        finally:
            tiled_kernel.k3_f32_plan = shipped_plan
        cmp = k3_parity(got, k3_plain(*k3_args, **k3_kw),
                        rtol=1e-5 if mode == "float32" else 1e-3)
        cmp["repeats_bits"] = bits_equal([again], [got])
        if mode == "float32" and n == N_BIG:
            k3_f32_big[plan] = got
        emit("k3_vs_plain", mode=mode, n=n, batch=batch, tile_lanes=plan,
             num_iters=big_cfg.check_every, **cmp)
        require(cmp["ok"], f"K3 ({mode}) disagrees with its plain version "
                           f"at N={n}, B={batch}: {cmp}")
        require(cmp["repeats_bits"],
                f"K3 ({mode}) at N={n}, B={batch} did not repeat its bits")
        errs.setdefault("k3_" + mode, []).append(cmp["max_abs_err"])
    # every entry is one FMA chain in ascending k at any lane width
    require(bits_equal(*([t] for t in k3_f32_big.values())),
            "K3 (float32) at 64 and 128 lanes gave different bits")
    del d64, Y64, k3_cases, k3_f32_big
    t_args, t_kw = tiled_solve_kernel.tiled_inputs(lp, ld, None, big_cfg)
    k4_plain_t0 = time.perf_counter()
    out_p = tiled_solve_kernel.fused_full_solve_tiled_reference(*t_args,
                                                                **t_kw)
    torch.cuda.synchronize()
    k4_plain_first_s = time.perf_counter() - k4_plain_t0
    emit("k4_plan", streamed=tiled_solve_kernel.k4_plan(N_BIG, M_BIG, B_BIG))
    out_k4 = tiled_solve_kernel.fused_full_solve_tiled(*t_args, **t_kw)
    k4_cmp = solve_parity(out_k4, out_p, big_cfg.check_every)
    k4_cmp["repeats_bits"] = all(bool((a == b).all()) for a, b in zip(
        tiled_solve_kernel.fused_full_solve_tiled(*t_args, **t_kw), out_k4))
    emit("k4_vs_plain", n=N_BIG, m=M_BIG, batch=B_BIG, **k4_cmp)
    require(k4_cmp["ok"], f"K4 disagrees with its plain version: {k4_cmp}")
    require(k4_cmp["repeats_bits"], "K4 did not repeat its bits")
    errs["k4"] = [k4_cmp["max_abs_err"]]
    del out_p

    # -- phase 7: the streamed large-N path at full size ------------------
    route = pqp.route_solve(N_BIG, B_BIG, False, big_cfg, m_dim=M_BIG,
                            platform="cuda")
    require(route == "mixed", f"N={N_BIG} routed to {route!r}")
    k3_counts = tiled_kernel.streamed_pqp_iterations.launches
    k4_kernel = tiled_solve_kernel.fused_full_solve_tiled
    big_runs = {
        "mixed_route": (lambda: pqp.solve_auto(lp, ld, cfg=big_cfg),
                        "mixed"),
        "k4_route": (lambda: tiled_solve_kernel.solve_fused_tiled(
            lp, ld, cfg=big_cfg), "f32"),
        # the plain loop with its updates on K3's float32 mode
        "use_pallas_k3": (lambda: pqp.solve_batched(
            lp, ld, cfg=dataclasses.replace(big_cfg, use_pallas=True)),
                          "f32"),
        "plain": (lambda: pqp.solve_batched(lp, ld, cfg=big_cfg), "f32"),
    }
    big_rows, route_launches = {}, {}
    for name, (fn, record) in big_runs.items():
        # every count set to 0 just before the route's run, read just after
        k3_counts["float32"] = k3_counts["bfloat16"] = 0
        k4_kernel.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        route_launches[name] = dict(k3_float32=k3_counts["float32"],
                                    k3_bfloat16=k3_counts["bfloat16"],
                                    k4=k4_kernel.launches)
        conv = float(res.converged.float().mean())
        big_rows[name] = dict(
            converged_frac=conv, iters_mean=float(res.iters.float().mean()),
            iters_max=int(res.iters.max()),
            jax_record_iters_mean=JAX_ITERS[record],
            seconds_first_run=time.perf_counter() - t0,
            launches=route_launches[name])
        require(conv >= 0.99, f"{name}: only {conv:.4f} converged")
        if name == "plain":     # parallel_paths holds its solve to these
            big_plain = dict(U=res.U, iters=res.iters,
                             converged=res.converged)
        del res
    big_launches = {
        "k3_float32": route_launches["mixed_route"]["k3_float32"],
        "k3_bfloat16": route_launches["mixed_route"]["k3_bfloat16"],
        "k4": route_launches["k4_route"]["k4"],
        "k3_float32_use_pallas": route_launches["use_pallas_k3"][
            "k3_float32"]}
    emit("large_n_launches", **big_launches)
    require(big_launches["k3_bfloat16"] > 0,
            "solve_auto (mixed) did not launch K3 in bf16 mode")
    require(big_launches["k3_float32"] > 0,
            "solve_auto (mixed) did not launch K3 in f32 mode")
    require(big_launches["k4"] > 0, "solve_fused_tiled did not launch K4")
    require(big_launches["k3_float32_use_pallas"] > 0,
            "solve_batched(use_pallas=True) did not launch K3 in f32 mode")
    for name, (fn, _) in big_runs.items():
        ms = cuda_ms(fn, reps=1, warmup=False)
        big_rows[name]["seconds_per_batch"] = ms / 1e3
        if name == "plain":
            big_plain["seconds_per_batch"] = ms / 1e3
        emit("large_n_path", engine=name, n=N_BIG, m=M_BIG, batch=B_BIG,
             nvidia_smi=smi, **big_rows[name])
    # K3's float32 updates are the plain update's up to summation order
    emit("large_n_use_pallas_iters",
         iters_mean=big_rows["use_pallas_k3"]["iters_mean"],
         plain_iters_mean=big_rows["plain"]["iters_mean"],
         iters_equal_plain=big_rows["use_pallas_k3"]["iters_mean"]
         == big_rows["plain"]["iters_mean"])

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
        # f32: Q past the L2, re-read from HBM each update; bf16: Q (33.5
        # MB) fits the L2, so Q per update at the HBM rate is an upper floor
        floors["k3_" + mode] = stream_floor_ms(k3_kw["num_iters"] * q_bytes)
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
    spec64 = example_spec(64, 0.0)
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
    k5_plan = distinct_kernel.k5_plan(N_DR, M_DR)
    pick5 = distinct_kernel.card_cluster(N_DR, M_DR, B_DR,
                                         k5_plan["resident"])
    emit("k5_plan", plan=k5_plan, card_pick=pick5)
    require(k5_plan["resident"], f"K5 does not keep N={N_DR} resident")
    require(pick5["blocks_per_instance"] in k5_plan["sizes"],
            "K5's cluster size is not one of the plan's")
    k5 = distinct_kernel.fused_full_solve_distinct
    k5_plain = distinct_kernel.fused_full_solve_distinct_reference
    out_k5 = k5(*d_args, **d_kw)
    out_p = k5_plain(*d_args, **d_kw)
    torch.cuda.synchronize()
    k5_cmp = solve_parity(out_k5, out_p, dr_cfg.check_every)
    k5_cmp["repeats_bits"] = all(bool((a == b).all()) for a, b in zip(
        k5(*d_args, **d_kw), out_k5))
    emit("k5_vs_plain", n=N_DR, m=M_DR, batch=B_DR, resident=True, **k5_cmp)
    require(k5_cmp["ok"], f"K5 disagrees with its plain version: {k5_cmp}")
    require(k5_cmp["repeats_bits"], "K5 (resident) did not repeat its bits")
    errs["k5"] = [k5_cmp["max_abs_err"]]
    del out_p
    # past the cluster's capacity: the same body streams its rows of Qd
    # (tests/test_torch_cuda.py's n1024_m256_accel case)
    n5, m5 = 1024, 256
    require(not distinct_kernel.k5_plan(n5, m5)["resident"],
            f"K5 keeps N={n5} resident")
    c5_cfg = dataclasses.replace(dr_cfg, accel_every=8)
    p5 = distinct_workload(3, m5, n5, dev)
    c5_args, c5_kw = distinct_kernel.distinct_inputs(
        p5, pqp.dualize_distinct(p5, theta_floor=c5_cfg.theta_floor), None,
        c5_cfg)
    got = k5(*c5_args, **c5_kw)
    c5_cmp = solve_parity(got, k5_plain(*c5_args, **c5_kw),
                          c5_cfg.check_every, accel=True)
    c5_cmp["repeats_bits"] = all(bool((a == b).all()) for a, b in zip(
        k5(*c5_args, **c5_kw), got))
    emit("k5_vs_plain", n=n5, m=m5, batch=3, resident=False,
         accel_every=c5_cfg.accel_every, **c5_cmp)
    require(c5_cmp["ok"], f"K5 (streamed rows) disagrees with its plain "
                          f"version: {c5_cmp}")
    require(c5_cmp["repeats_bits"], "K5 (streamed rows) did not repeat its "
                                    "bits")
    errs["k5"].append(c5_cmp["max_abs_err"])
    del p5, c5_args, got
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
    # the design reads its resident Qd rows from shared memory: n^2 floats
    # per update and per check, 3 n^2 per accel step (Gp, Qp and Qp^-1
    # come from L2 at the check cadence)
    k5_flops, k5_smem = solve_work(
        N_DR, M_DR, out_k5[2], dr_cfg.check_every, dr_cfg.accel_every,
        4.0 * N_DR ** 2, 4.0 * N_DR ** 2, 12.0 * N_DR ** 2)
    bounds["k5"] = bound(stored_bytes(*d_args), sum(
        t.numel() * t.element_size() for t in out_k5), k5_flops, F32_FLOPS)
    # its inputs read once from HBM (Qd, Gp, Qp, Qp^-1, the panels and the
    # splits' diagonals; the splits themselves are never read)
    floors["k5_inputs_once"] = stream_floor_ms(
        stored_bytes(*d_args[2:]) + 8.0 * B_DR * N_DR)
    floors["k5_shared_memory"] = k5_smem / SMEM_BPS * 1e3
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k7_plans = {mode: distinct_tiled_kernel.k7_plan(N_DS, B_DS, mode, sms)
                for mode in k7_streams}
    k6_plan = distinct_tiled_kernel.k6_plan(N_DS, M_DS, B_DS, sms)
    emit("k7_plan", **k7_plans)
    emit("k6_plan", **k6_plan)
    floor_terms = {}
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
    k7_windows = {}
    for mode, (Q, th) in k7_streams.items():
        k7_args = (Q, th, sd.Fdn, sd.Fdp, Y7)
        # two five-launch windows each, in turns: kernel, plain, kernel,
        # plain
        w = [cuda_ms(lambda: k7(*k7_args, **k7_kw), 5),
             cuda_ms(lambda: k7_plain(*k7_args, **k7_kw), 5),
             cuda_ms(lambda: k7(*k7_args, **k7_kw), 5),
             cuda_ms(lambda: k7_plain(*k7_args, **k7_kw), 5)]
        k7_windows[mode] = dict(kernel_ms=w[0::2], plain_ms=w[1::2])
        times["k7_" + mode] = ((w[0] + w[2]) / 2, (w[1] + w[3]) / 2)
        bounds["k7_" + mode] = bound(
            stored_bytes(Q, th, sd.Fdn, sd.Fdp, Y7), 4 * Y7.numel(),
            k7_kw["num_iters"] * 4.0 * N_DS * N_DS * B_DS,
            F32_FLOPS if mode == "float32" else BF16_FLOPS)
        # the design's floor: the matrices once from HBM (first update),
        # then per later update the resident rows at the shared-memory
        # rate beside the remainder at the HBM rate (an L2 evict_last
        # hint on it gained nothing on an H100, PERF.md: it does not stay
        # in L2 across updates)
        plan = k7_plans[mode]
        terms = {"hbm_once": plan["matrix_bytes"] / HBM_BPS * 1e3,
                 "shared_memory_per_update":
                     plan["resident_bytes"] / SMEM_BPS * 1e3,
                 "remainder_hbm_per_update":
                     plan["l2_remainder_bytes"] / HBM_BPS * 1e3}
        floor_terms["k7_" + mode] = terms
        floors["k7_" + mode] = terms["hbm_once"] + (
            k7_kw["num_iters"] - 1) * max(
                terms["shared_memory_per_update"],
                terms["remainder_hbm_per_update"])
    times["k6"] = (cuda_ms(lambda: k6(*s_args, **s_kw), 1, warmup=False),
                   cuda_ms(lambda: k6_plain(*s_args, **s_kw), 1,
                           warmup=False))
    k6_flops, k6_smem = solve_work(
        N_DS, M_DS, out_k6[2], ds_cfg.check_every, ds_cfg.accel_every,
        4.0 * N_DS ** 2, 4.0 * N_DS ** 2, 12.0 * N_DS ** 2)
    bounds["k6"] = bound(stored_bytes(*s_args), sum(
        t.numel() * t.element_size() for t in out_k6), k6_flops, F32_FLOPS)
    # the design's floor, its phases in sequence: each instance's Qd_hat,
    # Gp, Qp and Qp^-1 once from HBM (the check re-reads the last three
    # from L2, whose rate this run does not measure); its rows' passes at
    # the shared-memory rate for the rows the plan keeps there, at the HBM
    # rate for the rest; the slot barriers are not in it
    # (tools/probe_k6.py times them)
    kept = 1.0 - k6_plan["streamed_rows"] / N_DS
    floor_terms["k6"] = {
        "hbm_once": stored_bytes(*s_args[:5]) / HBM_BPS * 1e3,
        "shared_memory": kept * k6_smem / SMEM_BPS * 1e3,
        "remainder_hbm": (1.0 - kept) * k6_smem / HBM_BPS * 1e3}
    floors["k6"] = sum(floor_terms["k6"].values())
    emit("distinct_kernel_times", nvidia_smi=smi,
         k7_num_iters=ds_cfg.check_every, k7_windows=k7_windows,
         **{f"{k}_ms": v[0] for k, v in times.items()},
         **{f"{k}_plain_ms": v[1] for k, v in times.items()})
    # the floors of the designs at this run's iterations: K4 re-reads its
    # matrix past the L2 each pass; K3 reads Q per update; K5, K6 and K7
    # read their matrices once from HBM, then from shared memory (and K7's
    # remainder from HBM again).  The kernel table's bound_ms is the
    # function's
    emit("stream_floors", **{f"{k}_ms": v for k, v in floors.items()},
         **{f"{k}_terms_ms": v for k, v in floor_terms.items()})
    del sp, sd, sd_free, k7_streams, Y7, s_args, out_k6
    torch.cuda.empty_cache()

    # -- phase 12: the stage-wise backend, the crossover, diff ----------
    h512_ms = stagewise_paths(dev, smi)
    torch.cuda.empty_cache()

    # -- phase 12b: estimation and offset-free control -------------------
    estimation_paths(dev, smi, mpc_h512_ms=h512_ms)
    torch.cuda.empty_cache()

    # -- phase 12c: data- and tensor-parallel solves (parallel/) ---------
    parallel_paths(dev, smi, main_plain, big_plain, big_cfg)
    del main_plain, big_plain
    torch.cuda.empty_cache()

    # -- phase 13: the command line on the card, as subprocesses ---------
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
        # the North-star line: the example benchmark at B = 2^22, held to
        # what the K1 route's row above implies
        rc, out_x, err = run_cli("bench-example", "--repeats", 3)
        example = json.loads(out_x.strip().splitlines()[-1]) if rc == 0 \
            else {}
        k1_rate = B_MAIN / main_rows["k1_route"]["seconds_per_batch"]
        example_vs_k1 = example.get("value", 0.0) / k1_rate
        emit("bench_example", line=example, k1_route_solves_per_s=k1_rate,
             ratio_to_k1_route=example_vs_k1, nvidia_smi=smi)
        require(example.get("metric") == "example_qp_solves_per_s"
                and example.get("converged_frac", 0.0) >= 0.99
                and example.get("engine") == "fused"
                and example.get("batch") == B_MAIN,
                f"cli bench-example: {rc} {out_x} {err}")
        require(abs(example_vs_k1 - 1.0) <= 0.1,
                f"bench-example's rate is {example_vs_k1:.3f} of the K1 "
                "route's")
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
        # the stage-wise backend and the robust tube from the command line:
        # the JSON line carries no verdicts, and an uncertified step runs
        # to max_iters, so every step certified <=> iters_max < max_iters
        lines_sw = {}
        for name, argv, max_iters in (
                ("rollout_stagewise_h512",
                 ("--backend", "stagewise", "--horizon", H_LONG, "--steps",
                  10), stagewise_mpc_config(H_LONG).max_iters),
                ("rollout_robust_w_stagewise",
                 ("--robust-w", "0.002,0.005", "--backend", "stagewise",
                  "--horizon", 128, "--steps", 20, "--jit"),
                 stagewise_mpc_config(128).max_iters),
                ("rollout_robust_w_auto",
                 ("--robust-w", "0.002,0.005", "--steps", 20),
                 MPC_CONFIG.max_iters)):
            rc, out_l, err = run_cli("rollout", *argv)
            line = json.loads(out_l.strip().splitlines()[-1]) if rc == 0 \
                else {}
            lines_sw[name] = line
            require(rc == 0 and line.get("iters_max", max_iters) < max_iters
                    and np.isfinite(line.get("final_state_norm", np.nan)),
                    f"cli {name}: {rc} {out_l} {err}")
        require(lines_sw["rollout_stagewise_h512"]["backend"] == "stagewise"
                and lines_sw["rollout_robust_w_auto"]["robust_w"]
                == "0.002,0.005", f"cli stage-wise lines: {lines_sw}")
        # a long-horizon spec request reaches the stage-wise backend
        rc, out_s5, err = run_cli(
            "serve", "--y0", "0.01", "--no-strict", "--accel-every", 8,
            "--check-every", 16, "--erc", "1e-3", "--eac", "1e-3", "--eaj",
            "1e-2", "--erj", "1e-3", "--max-iters", 5000,
            stdin=json.dumps({"spec": {"plant": "double_integrator",
                                       "horizon": H_LONG},
                              "x": [2.0, 0.0]}) + "\n")
        reply = json.loads(out_s5.strip().splitlines()[-1]) if rc == 0 \
            else {}
        require(rc == 0 and reply.get("converged") == 1
                and len(reply.get("U", [[]])[0]) == H_LONG,
                f"cli serve H=512: {rc} {out_s5[:500]} {err}")
        emit("cli", solve_file=lines, solve_file_cpu=out.strip(),
             card_agrees_with_cpu=agree, bench=bench, rollout_jit=roll,
             serve=[{k: r[k] for k in ("batch", "converged", "iters_max")}
                    for r in replies], stagewise=lines_sw,
             serve_h512={k: reply[k] for k in ("converged", "iters_max",
                                               "u0")}, nvidia_smi=smi)
        require(agree, "cli solve-file on the card disagrees with the CPU")

    rows = [
        ("k1", "K1 fused_full_solve (lane-tile engine)",
         "lane_tile_solve.cuh", "solve_kernel.py:295", launches["k1"],
         errs["k1"], k1_ms, k1_plain_ms),
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
        ("k8", "K8 fused_full_solve_packed (lane-tile engine)",
         "lane_tile_solve.cuh", "packed_kernel.py:276", launches["k8"],
         errs["k8"], k8_ms, k8_plain_ms),
    ]
    table = [{"name": name, "route": "cuda",
              "source": "pqp_for_mpc_tpu_torch/csrc/" + src,
              "replaces": "pqp_for_mpc_tpu/ops/" + tpu, "launches": n,
              "max_abs_err": max(err), "ms": ms, "plain_ms": plain_ms,
              **bounds[key]}
             for key, name, src, tpu, n, err, ms, plain_ms in rows]
    for row, (key, *_rest) in zip(table, rows):
        if key == "k3_float32":   # its own route, beside the mixed route's
            row["use_pallas_launches"] = big_launches[
                "k3_float32_use_pallas"]
        if key == "k7_bfloat16":
            row["ms_windows"] = k7_windows["bfloat16"]["kernel_ms"]
        if key in ("k1", "k8"):   # the C entry each launches the engine by
            row["entry"] = "pqp_for_mpc_tpu_torch/csrc/" + (
                "full_solve.cu" if key == "k1" else "full_solve_packed.cu")
    # K7's float32 mode (same source, same wrapper) is not on the path:
    # solve_mixed's float32 phase on 3-D Qd is the plain solve, as in the
    # JAX package.  Its numbers from this run sit beside the bf16 row.
    table[-2]["float32_mode"] = {
        "launches": launches["k7_float32"],
        "max_abs_err": errs["k7_float32"][0], "ms": times["k7_float32"][0],
        "plain_ms": times["k7_float32"][1], **bounds["k7_float32"]}
    emit("earlier_times", quoted_not_measured=True,
         source="PERF.md section 6: the previous designs' times, each "
                "from the last chip run before its redesign, NVIDIA H100 "
                "80GB HBM3, 700.00 W",
         **{f"{k}_ms": v for k, v in EARLIER_MS.items()})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
