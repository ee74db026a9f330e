"""The headline benchmark of the port: example-sized QP solves per second.

    python -m pqp_for_mpc_tpu_torch.bench [--device cuda] [--batch B]
                                          [--repeats 10] [--seed 0]
    python -m pqp_for_mpc_tpu_torch bench-example ...      (the same)

The counterpart of the repository's ``bench.py`` (the JAX package's
``bench-example``): a cold batch of example-sized condensed MPC problems
solved to certification through
:func:`~pqp_for_mpc_tpu_torch.routing.solve_auto` — on the card the
whole-solve kernel K1 — after one warm-up run (which builds the kernels),
``repeats`` timed runs, each ending on a scalar fence (``U.sum().item()``,
as ``bench.py`` fences with a 4-byte readback), timed with CUDA events on
the card; the minimum counts, as in ``bench.py``.  Prints one JSON line
with ``bench.py``'s keys, the engine the router picked and the device's
name.

Two differences from ``bench.py``, each because its own cannot run here:

* the workload is built in the repository (:func:`example_workload`: the
  double integrator condensed at horizon 7, M = 7 inputs and N = 28 dual
  constraints, the reference example's dimensions; x0 ~ N(0, 0.5^2) from
  a NumPy seed), not loaded from the reference's ``example/`` directory;
* the configuration is :data:`EXAMPLE_CFG`, not ``bench.py``'s
  ``SolverConfig(max_iters=5000, check_every=8, y0=1000.0)``, which fits
  the reference example's scale (Kp ~ 20, costs ~ 1e5) and certifies no
  lane of this workload, in either package and in float64 too: y0 = 1000
  starts the dual iterate some 1e3 times above this workload's
  multipliers, and 5,000 iterations leave it near 900
  (``tests/test_torch_bench.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from pqp_for_mpc_tpu_torch.config import MPC_CONFIG

#: the solver configuration of the benchmark: MPC_CONFIG's tolerances with
#: the reference's forcing-scale feasibility test (which the whole-solve
#: kernel certifies in-kernel) and no acceleration; mean ~265 iterations
#: per solve on this workload, close to the reference example's 313
EXAMPLE_CFG = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                                  accel_every=0, max_iters=5000)
#: the North star of BASELINE.json: solves per second per chip
NORTH_STAR = 1000.0
#: default batches: 2^22 on the card (the batch of PERF.md's small-N
#: figures), bench.py's CPU batch elsewhere
BATCH_CUDA, BATCH_CPU = 1 << 22, 262144
#: the least share of lanes a benchmark run must certify
MIN_CONVERGED = 0.99


def example_spec(horizon: int = 7, r: float = 2.5):
    """The double integrator at ``horizon`` (M = horizon, N = 4 horizon),
    Qy = I, R = 0.05 I, |u| <= 1, |du| <= 0.5, reference ``r``: horizon 7
    with r = 2.5 is the benchmark's workload."""
    from pqp_for_mpc_tpu_torch.models import MPCSpec, double_integrator
    return MPCSpec(double_integrator(), horizon=horizon, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([r]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))


def example_workload(batch: int, device, seed: int = 0, horizon: int = 7,
                     r: float = 2.5):
    """``(primal, dual)`` of a batch of ``example_spec(horizon, r)`` from
    x0 ~ N(0, 0.5^2), drawn as ``np.random.default_rng(seed).normal(0,
    0.5, (2, batch))`` in float32."""
    from pqp_for_mpc_tpu_torch import dualize
    from pqp_for_mpc_tpu_torch.models import condense
    data = condense(example_spec(horizon, r), device=device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0.0, 0.5, (2, batch)).astype(np.float32),
                        device=device)
    primal = data.assemble(x=x, Qp=data.qp())
    return primal, dualize(primal)


def _seconds(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events on the card, the host
    clock elsewhere (``fn`` ends on a scalar readback either way)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def example_bench(batch: int, device="cuda", repeats: int = 10,
                  seed: int = 0) -> dict:
    """Certified solves per second of ``batch`` cold example-sized
    problems on ``device`` (``"cuda"`` raises without a card): the keys of
    ``bench.py``'s line plus ``engine`` (the router's pick) and
    ``device_name``.  Raises when fewer than 99% of the lanes certify."""
    from pqp_for_mpc_tpu_torch.problem import resolve_device
    from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto
    if batch < 1 or repeats < 1:
        raise ValueError(f"batch and repeats must be >= 1, got {batch}, "
                         f"{repeats}")
    device = resolve_device(device)
    primal, dual = example_workload(batch, device, seed)
    engine = route_solve(dual.n_con, batch, False, EXAMPLE_CFG,
                         m_dim=primal.n_var, platform=device.type)

    def run():
        res = solve_auto(primal, dual, cfg=EXAMPLE_CFG, engine=engine)
        res.U.sum().item()                  # the scalar fence
        return res

    res = run()                             # warm-up: builds the kernels
    conv = float(res.converged.float().mean())
    iters = float(res.iters.float().mean())
    if conv < MIN_CONVERGED:
        raise RuntimeError(f"example bench: only {conv:.4f} of {batch} "
                           f"lanes certified on {engine!r}")
    dt = min(_seconds(run, device) for _ in range(repeats))
    solves_per_s = batch / dt
    return {
        "metric": "example_qp_solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / NORTH_STAR,
        "batch": batch,
        "mean_iters": iters,
        "converged_frac": conv,
        "seconds_per_batch": dt,
        "platform": device.type,
        "engine": engine,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The benchmark's flags (also those of the CLI's ``bench-example``)."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; pass cpu to run "
                        "without a card)")
    p.add_argument("--batch", type=int, default=None,
                   help=f"lanes per batch (default {BATCH_CUDA} on the "
                        f"card, {BATCH_CPU} on the CPU)")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)


def run(args: argparse.Namespace) -> int:
    """Run the benchmark for parsed :func:`add_arguments` flags and print
    its JSON line."""
    device = torch.device(args.device)
    batch = args.batch or (BATCH_CUDA if device.type == "cuda"
                           else BATCH_CPU)
    print(json.dumps(example_bench(batch, device, args.repeats, args.seed)),
          flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pqp_for_mpc_tpu_torch.bench",
                                description="example-sized QP solves/s")
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
