"""Command-line surface: ``python -m pqp_for_mpc_tpu_torch <subcommand>``.

The counterpart of ``pqp_for_mpc_tpu/cli.py``, with the same subcommands,
flags, defaults, printed lines and JSON keys:

* ``solve DIR``        — solve a reference ``example/``-format problem and
  print iterations / Jp / Jd / U* (mirrors main, PQP_CPU.c:1005-1013).
* ``solve-file FILE``  — solve a generator-format instance
  (``testing/test_generator.c`` layout) through an engine of
  :func:`~pqp_for_mpc_tpu_torch.routing.solve_auto`.
* ``generate M N``     — emit a generator-format random instance (the same
  bytes as the JAX package for the same seed).
* ``bench``            — the fixed-iteration throughput harness: k pure
  multiplicative updates, no convergence checks (the reference's
  ``while(h<NUM_ITER)`` timing loops); on CUDA it rides the update kernel
  K2 where N fits it.
* ``rollout``          — receding-horizon closed loop on a model-zoo plant
  (condensed backend; ``--jit`` runs ``MPCController.rollout_jit``).
* ``serve``            — the JSON-lines solver daemon.

One addition: ``--device`` (default ``cuda``; without a card that raises,
``problem.resolve_device``).  Not ported yet, each exiting with code 1 and
naming its ROADMAP item: ``bench-example`` (it loads the JAX package's
``bench.py``; queue 1, item 3), ``estimate`` and ``rollout --robust-w /
--offset-free / --backend stagewise`` (the stage-wise family, item 10).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: what the unported subcommands and flags print before exiting with 1
_NOT_PORTED = {
    "bench-example": "bench-example loads the JAX package's bench.py; its "
                     "twin is not ported yet (ROADMAP queue 1, item 3)",
    "estimate": "estimate needs the state estimators, not ported yet "
                "(ROADMAP queue 1, item 10)",
    "stagewise": "the stage-wise backend is not ported yet (ROADMAP queue "
                 "1, item 10)",
    "robust_w": "rollout --robust-w needs models/robust.py, not ported yet "
                "(ROADMAP queue 1, item 10)",
    "offset_free": "rollout --offset-free needs the offset-free controller, "
                   "not ported yet (ROADMAP queue 1, item 10)",
}


def _not_ported(what: str) -> int:
    print(_NOT_PORTED[what], file=sys.stderr)
    return 1


def _device(args) -> torch.device:
    from pqp_for_mpc_tpu_torch.problem import resolve_device
    return resolve_device(args.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_solver_cfg(args, **overrides):
    from pqp_for_mpc_tpu_torch.config import SolverConfig

    kw = dict(erc=args.erc, eac=args.eac, eaj=args.eaj, erj=args.erj,
              theta_floor=args.theta_floor, y0=args.y0,
              max_iters=args.max_iters, check_every=args.check_every,
              accel_every=args.accel_every,
              strict_weak_duality=not args.no_strict)
    kw.update(overrides)
    return SolverConfig(**kw)


def _add_device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; pass "
                        "cpu to run without a card)")


def _add_solver_flags(p):
    p.add_argument("--erc", type=float, default=1e-6)
    p.add_argument("--eac", type=float, default=1e-6)
    p.add_argument("--eaj", type=float, default=1e-6)
    p.add_argument("--erj", type=float, default=1e-6)
    p.add_argument("--theta-floor", type=float, default=5.0)
    p.add_argument("--y0", type=float, default=1000.0,
                   help="cold-start value (reference: 1000; small values "
                        "like 0.01 converge far faster)")
    p.add_argument("--max-iters", type=int, default=200_000)
    p.add_argument("--check-every", type=int, default=8)
    p.add_argument("--accel-every", type=int, default=0,
                   help="projected-gradient acceleration cadence (0=off)")
    p.add_argument("--no-strict", action="store_true",
                   help="drop the reference's Jp<=-Jd termination quirk")
    _add_device_flag(p)


def _primal_from_generator(inst, device):
    from pqp_for_mpc_tpu_torch.io.generator import to_primal_arrays
    from pqp_for_mpc_tpu_torch.problem import PrimalQP

    qp, qpi, fp, mp, gp, kp = to_primal_arrays(inst)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return PrimalQP(Qp=t(qp), Qp_inv=t(qpi), Fp=t(fp), Mp=t(mp), Gp=t(gp),
                    Kp=t(kp))


def cmd_solve(args) -> int:
    from pqp_for_mpc_tpu_torch.dual import dualize
    from pqp_for_mpc_tpu_torch.io import load_example_dir
    from pqp_for_mpc_tpu_torch.solver import solve

    device = _device(args)
    data = load_example_dir(args.dir, device=device)
    cfg = _build_solver_cfg(args)
    t0 = time.perf_counter()
    primal = data.assemble(Qp=data.qp())
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    res = solve(primal, dual, cfg=cfg)
    _sync(device)
    dt = time.perf_counter() - t0
    # output format mirrors the reference driver (PQP_CPU.c:741,1005-1013)
    print(f"Printing number of iterations = {int(res.iters)}")
    print(f"Jp = {float(res.Jp):.6f}")
    print(f"Jd = {float(res.Jd):.6f}")
    print("U*:")
    for v in res.U.cpu().numpy().ravel():
        print(f"  {v:.6f}")
    print(f"converged = {bool(res.converged)}  feasible = {bool(res.feasible)}"
          f"  wall = {dt:.3f}s (incl. kernel build)")
    return 0 if bool(res.converged) else 2


def cmd_solve_file(args) -> int:
    from pqp_for_mpc_tpu_torch.dual import dualize
    from pqp_for_mpc_tpu_torch.io.generator import read_generator_file
    from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto
    from pqp_for_mpc_tpu_torch.solver import SolveResult, solve

    device = _device(args)
    inst = read_generator_file(args.file,
                               reference_quirks=args.reference_quirks)
    primal = _primal_from_generator(inst, device)
    cfg = _build_solver_cfg(args)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    engine = "mixed" if args.mixed else args.engine
    t0 = time.perf_counter()
    if engine == "xla":
        res = solve(primal, dual, cfg=cfg)
        engine_used = "xla"
    else:
        engine_used = (route_solve(dual.n_con, 1, False, cfg,
                                   m_dim=primal.Gp.shape[-1],
                                   platform=device.type)
                       if engine == "auto" else engine)
        r = solve_auto(primal, dual, cfg=cfg, engine=engine_used)
        res = SolveResult(**{k: None if v is None else v[..., 0]
                             for k, v in vars(r).items()})
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"M={inst.M} N={inst.N} iters={int(res.iters)} "
          f"converged={bool(res.converged)} feasible={bool(res.feasible)} "
          f"Jp={float(res.Jp):.6f} Jd={float(res.Jd):.6f} "
          f"engine={engine_used} wall={dt:.3f}s")
    return 0 if bool(res.converged) else 2


def cmd_generate(args) -> int:
    from pqp_for_mpc_tpu_torch.io.generator import (generate_instance,
                                                    write_generator_file)

    inst = generate_instance(args.M, args.N, seed=args.seed)
    write_generator_file(args.out, inst)
    print(f"wrote {args.out}: M={args.M} N={args.N} seed={args.seed}")
    return 0


def cmd_bench(args) -> int:
    """Fixed-iteration throughput: mirrors the reference testing/ harness
    (N=1000, M=500, 100 iterations, inert tolerances, no convergence
    checks inside the loop).  On CUDA the updates ride the kernel K2
    (``ops.kernels.fused_pqp_iterations``) where N fits it and
    ``--no-pallas`` is absent, else the plain ``pqp_update`` loop."""
    from pqp_for_mpc_tpu_torch.dual import dualize
    from pqp_for_mpc_tpu_torch.io.generator import generate_instance
    from pqp_for_mpc_tpu_torch.ops.kernels import (fits_resident,
                                                   fused_pqp_iterations)
    from pqp_for_mpc_tpu_torch.solver import pqp_update

    device = _device(args)
    M, N, iters, B = args.M, args.N, args.iters, args.batch
    primal = _primal_from_generator(generate_instance(M, N, seed=args.seed),
                                    device)
    dual = dualize(primal, theta_floor=100.0)  # harness floor (…test.c:240)

    use_kernel = (device.type == "cuda" and fits_resident(N)
                  and not args.no_pallas)
    Y0 = torch.full((N, B), 1000.0, dtype=torch.float32, device=device)
    Fdn = dual.Fdn[:, None].expand(N, B)
    Fdp = dual.Fdp[:, None].expand(N, B)

    if use_kernel:
        run = lambda Y: fused_pqp_iterations(
            dual.Qdn_theta, dual.Qdp_theta, Fdn, Fdp, Y, num_iters=iters)
    else:
        def run(Y):
            for _ in range(iters):
                Y = pqp_update(dual, Y, None, 1e-30)
            return Y

    run(Y0)                                   # first call builds the kernel
    _sync(device)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run(Y0)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    updates_per_s = iters * B / dt
    flops = 4.0 * N * N * B * iters         # two matvecs per update
    print(json.dumps({
        "metric": "pqp_iterations_per_s",
        "value": round(updates_per_s, 1),
        "unit": f"updates/s (M={M} N={N} B={B})",
        "seconds": round(dt, 4),
        "tflops": round(flops / dt / 1e12, 2),
        "kernel": "cuda" if use_kernel else "torch",
        "platform": device.type,
    }))
    return 0


def cmd_bench_example(args) -> int:
    return _not_ported("bench-example")


def cmd_estimate(args) -> int:
    return _not_ported("estimate")


#: zoo entries constructible with no arguments (random_stable needs dims)
_ROLLOUT_PLANTS = ("double_integrator", "mass_spring_damper", "thermal_rc",
                   "dc_motor", "aircraft_pitch", "quadruple_tank")


def cmd_rollout(args) -> int:
    from pqp_for_mpc_tpu_torch.models import (ZOO, MPCController, MPCSpec,
                                              auto_backend)

    if args.robust_w is not None:
        return _not_ported("robust_w")
    if args.offset_free is not None:
        return _not_ported("offset_free")
    plant = ZOO[args.plant]()
    ny, nu = plant.n_output, plant.n_input
    y_bound = args.y_max
    spec = MPCSpec(
        plant=plant, horizon=args.horizon,
        Qy=np.eye(ny, dtype=np.float32),
        R=0.05 * np.eye(nu, dtype=np.float32),
        r=np.zeros(ny, np.float32),
        u_min=-np.ones(nu, np.float32), u_max=np.ones(nu, np.float32),
        du_max=0.5 * np.ones(nu, np.float32),
        y_min=None if y_bound is None
        else np.full(ny, -y_bound, np.float32),
        y_max=None if y_bound is None
        else np.full(ny, y_bound, np.float32),
        moves=args.moves)
    backend = args.backend
    if backend == "auto":
        backend = auto_backend(spec)
    if backend == "stagewise":
        return _not_ported("stagewise")
    device = _device(args)
    rng = np.random.default_rng(args.seed)
    x0 = rng.uniform(-1, 1, plant.n_state).astype(np.float32)
    ctrl = MPCController(spec, backend=backend, warm_start=True,
                         retry_cold=args.retry_cold, device=device)
    if args.jit:
        ctrl.rollout_jit(x0, steps=args.steps)   # warm-up (kernel build)
        _sync(device)
        t0 = time.perf_counter()
        out = ctrl.rollout_jit(x0, steps=args.steps)
    else:
        t0 = time.perf_counter()
        out = ctrl.rollout(x0, steps=args.steps)
    _sync(device)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "plant": args.plant, "horizon": args.horizon, "steps": args.steps,
        "backend": backend, "moves": args.moves,
        "robust_w": args.robust_w,
        "final_state_norm": round(float(np.linalg.norm(out["x"][-1])), 4),
        "iters_mean": round(float(out["iters"].mean()), 1),
        "iters_max": int(out["iters"].max()),
        "wall_s": round(dt, 3),
        "steps_per_s": round(args.steps / dt, 1),
    }))
    return 0


def _json_sanitize(obj):
    """Recursively replace non-finite floats with None so the reply is
    strict JSON (json.dumps would otherwise emit bare NaN/Infinity
    tokens that non-Python clients reject)."""
    import math
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    return obj


def cmd_serve(args) -> int:
    """JSON-lines solver daemon: one request per stdin line, one result
    per stdout line.  Keeps the process (its built kernels and cached
    geometries) alive across requests.

    Request forms:
      {"example_dir": PATH, "x": [...]?, "batch_x": [[...], ...]?}
      {"generator_file": PATH}
      {"spec": {"plant": NAME, "horizon": H, "r"?, "u_min"?, "u_max"?,
                "du_max"?, "y_min"?, "y_max"?},
       "x": [...], "u_prev": [...]?}     — one MPC step; reply carries
                                           "u0" (controller cached per
                                           spec for the daemon's life)
      {"cmd": "quit"}
    Reply: the solve stats dict plus the solution —
      {"batch": n, "converged": n_ok, "feasible": n_feas,
       "iters_mean": ..., "iters_max": ..., "gap_abs_max": ...,
       "gap_rel_max": ..., "U": [[...] per instance], "diverged": n}
    or {"error": "..."}.  Problem geometry is kept per example_dir for the
    life of the daemon — files changed on disk after first load are NOT
    re-read.
    """
    from pqp_for_mpc_tpu_torch.dual import (dual_geometry, dualize,
                                            dualize_forcing)
    from pqp_for_mpc_tpu_torch.io import load_example_dir
    from pqp_for_mpc_tpu_torch.io.generator import read_generator_file
    from pqp_for_mpc_tpu_torch.solver import solve_batched

    device = _device(args)
    cfg = _build_solver_cfg(args)
    cache: dict = {}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    def solve_example(req):
        path = req["example_dir"]
        entry = cache.get(path)
        if entry is None:
            data = load_example_dir(path, device=device)
            Qp = data.qp()
            geom = dual_geometry(data.Gp, data.Qp_inv,
                                 theta_floor=cfg.theta_floor,
                                 precision=cfg.precision)
            entry = cache[path] = (data, Qp, geom)
        data, Qp, geom = entry
        if "batch_x" in req:
            x = f32(np.asarray(req["batch_x"], np.float32).T)
        elif "x" in req:
            x = f32(req["x"])
        else:
            x = None
        primal = data.assemble(x=x, Qp=Qp)
        dual = dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp,
                               precision=cfg.precision)
        return solve_batched(primal, dual, cfg=cfg)

    def solve_generator(req):
        primal = _primal_from_generator(
            read_generator_file(req["generator_file"]), device)
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
        return solve_batched(primal, dual, cfg=cfg)

    def solve_spec(req):
        """Spec-based MPC step: build (and cache) a controller from a
        JSON spec, solve one step from the given state."""
        from pqp_for_mpc_tpu_torch.models import ZOO, MPCController, MPCSpec
        s = req["spec"]
        key = ("spec", json.dumps(s, sort_keys=True))
        ctrl = cache.get(key)
        if ctrl is None:
            plant = ZOO[s["plant"]]()
            ny, nu = plant.n_output, plant.n_input
            arr = lambda k, default: (
                np.asarray(s[k], np.float32) if k in s else default)
            spec = MPCSpec(
                plant=plant, horizon=int(s["horizon"]),
                Qy=arr("Qy", np.eye(ny, dtype=np.float32)),
                R=arr("R", 0.05 * np.eye(nu, dtype=np.float32)),
                r=arr("r", np.zeros(ny, np.float32)),
                u_min=arr("u_min", -np.ones(nu, np.float32)),
                u_max=arr("u_max", np.ones(nu, np.float32)),
                du_max=arr("du_max", np.full(nu, 0.5, np.float32)),
                y_min=arr("y_min", None), y_max=arr("y_max", None))
            ctrl = cache[key] = MPCController(spec, backend="auto",
                                              warm_start=False,
                                              device=device)
        x = np.asarray(req["x"], np.float32)
        u_prev = (np.asarray(req["u_prev"], np.float32)
                  if "u_prev" in req else None)
        u0, res = ctrl.step(x, u_prev=u_prev)
        u0 = u0.cpu().numpy()
        return (u0[:, 0] if u0.ndim == 2 else u0), res

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                break
            u0 = None
            if "example_dir" in req:
                res = solve_example(req)
            elif "generator_file" in req:
                res = solve_generator(req)
            elif "spec" in req:
                u0, res = solve_spec(req)
            else:
                raise ValueError("request needs example_dir, "
                                 "generator_file, or spec")
            out = res.stats()
            if u0 is not None:
                out["u0"] = u0.tolist()
            out["U"] = res.U.cpu().numpy().T.tolist()
            out["diverged"] = int(res.diverged.sum())
            # strict JSON has no NaN/Infinity tokens: map non-finite floats
            # to null for non-Python clients of the JSON-lines protocol
            reply = json.dumps(_json_sanitize(out), allow_nan=False)
        except Exception as e:     # noqa: BLE001 — daemon must not die
            reply = json.dumps({"error": f"{type(e).__name__}: {e}"})
        try:
            print(reply, flush=True)
        except (BrokenPipeError, OSError):
            break                  # client hung up — clean shutdown
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pqp_for_mpc_tpu_torch",
        description="PQP engine for linear MPC (PyTorch and CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="solve a reference example/-format dir")
    p.add_argument("dir")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("solve-file", help="solve a generator-format file")
    p.add_argument("file")
    p.add_argument("--reference-quirks", action="store_true",
                   help="reproduce the reference harness reader's quirks "
                        "(random Kp overwrite; -1 entries flipped to 1)")
    p.add_argument("--mixed", action="store_true",
                   help="alias for --engine mixed (bf16 bulk phase + "
                        "f32 certification; wins for large N)")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "fused", "mixed"),
                   help="solve engine; auto = the routing map "
                        "(routing.route_solve); xla = the plain solve")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_solve_file)

    p = sub.add_parser("generate",
                       help="emit a random generator-format instance")
    p.add_argument("M", type=int)
    p.add_argument("N", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default="test.txt")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("bench", help="fixed-iteration throughput harness")
    p.add_argument("--M", type=int, default=500)
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--no-pallas", action="store_true",
                   help="run the plain update loop, not the kernel")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("bench-example", help="full-convergence solves/s "
                                             "on example/ (not ported)")
    p.set_defaults(fn=cmd_bench_example)

    p = sub.add_parser("rollout", help="receding-horizon closed loop")
    p.add_argument("--plant", default="double_integrator",
                   choices=_ROLLOUT_PLANTS)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("auto", "condensed", "stagewise"),
                   default="auto",
                   help="condensed = dense dual (the reference's "
                        "formulation); stagewise = not ported yet; auto = "
                        "pick by the n_con crossover (models.auto_backend)")
    p.add_argument("--retry-cold", action="store_true",
                   help="certify-or-recover: re-solve any step whose "
                        "warm start fails certification from the cold "
                        "start")
    p.add_argument("--jit", action="store_true",
                   help="run the closed loop on the device "
                        "(MPCController.rollout_jit: no per-step host "
                        "round-trips besides the solver's checks)")
    p.add_argument("--y-max", type=float, default=None,
                   help="symmetric output (state) bound |y| <= Y_MAX "
                        "— hard constraint rows")
    p.add_argument("--moves", type=int, default=None,
                   help="move blocking (condensed backend): hold the "
                        "input constant over MOVES blocks spread over "
                        "the horizon — the dual shrinks from 4*H*nu to "
                        "4*MOVES*nu rows")
    p.add_argument("--robust-w", default=None, metavar="W1,W2,...",
                   help="robust tube tightening (not ported yet)")
    p.add_argument("--offset-free", choices=("input", "output"),
                   default=None,
                   help="output-feedback offset-free loop (not ported yet)")
    p.add_argument("--d-true", default=None, metavar="D1,...",
                   help="true unmeasured disturbance for --offset-free")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_rollout)

    p = sub.add_parser("estimate", help="state estimation (KF / "
                                        "constrained MHE; not ported)")
    p.add_argument("--plant", default="double_integrator",
                   choices=_ROLLOUT_PLANTS)
    p.add_argument("--kind", choices=("kf", "mhe"), default="mhe")
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--data", default=None)
    p.add_argument("--simulate", type=int, default=120, metavar="T")
    p.add_argument("--one-sided", action="store_true")
    p.add_argument("--qw", type=float, default=1e-4)
    p.add_argument("--rv", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("serve", help="JSON-lines solver daemon on stdio")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
