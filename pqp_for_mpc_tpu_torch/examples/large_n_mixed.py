"""Mixed-precision solving of large constraint systems (``solve_mixed``).

The bulk of the iterations runs against a consistently-rounded bfloat16
copy of the dual Hessian, then the solve refines and CERTIFIES in float32
on the true problem.  This example runs a small instance so it executes
anywhere; pass ``--n 4096`` on the card for the large-N regime
(``chip_smoke.py`` times it there).

    python -m pqp_for_mpc_tpu_torch.examples.large_n_mixed [--n 384]
        [--b 8] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from pqp_for_mpc_tpu_torch import (PrimalQP, SolverConfig, dualize,
                                   solve_batched, solve_mixed)
from pqp_for_mpc_tpu_torch.problem import resolve_device


def build(N, M, B, device, seed=0):
    """The example's random QP, drawn from ``seed`` with NumPy; its dual
    split-free (the plain and mixed solves never need the materialized
    Qd+-theta matrices)."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    primal = PrimalQP(
        Qp=t(Qp), Qp_inv=t(np.linalg.inv(Qp)),
        Fp=t(rng.normal(0, 3, (M, B))), Mp=t(np.zeros(B)),
        Gp=t(rng.normal(0, 1, (N, M))), Kp=t(rng.uniform(1, 10, N)))
    return primal, dualize(primal, materialize_splits=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    N, M, B = args.n, args.n // 4, args.b
    device = resolve_device(args.device)

    primal, dual = build(N, M, B, device)
    cfg = SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    runs = {"f32      ": solve_batched, "mixed    ": solve_mixed}
    out = {}
    for name, fn in runs.items():
        fn(primal, dual, cfg=cfg).U.sum().item()        # warm-up
        t0 = time.perf_counter()
        r = fn(primal, dual, cfg=cfg)
        r.U.sum().item()                                # the fence
        out[name] = (time.perf_counter() - t0, r)
        print(f"{name}: {out[name][0]*1e3:8.1f} ms   "
              f"certified {int(r.converged.sum())}/{B}   "
              f"iters {float(r.iters.float().mean()):.0f}")

    (t32, r32), (tmx, rmx) = out.values()
    both = r32.converged & rmx.converged
    dU = float((r32.U - rmx.U).abs()[:, both].max())
    print(f"speedup {t32/tmx:.2f}x   max |dU| {dU:.3g} "
          f"(certification is float32 on the TRUE problem either way)")
    assert bool(rmx.converged.all())
    assert dU < 1e-3


if __name__ == "__main__":
    main()
