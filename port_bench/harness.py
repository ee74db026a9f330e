"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that the harness finds by name (:class:`Bench`):

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): the
  configuration as run, with its ``kind``; ``problems/<kind>.py`` builds it
  for the program and drives the program's entries, ``reference/<kind>.py``
  builds the same QPs for the plain reference (``reference/pqp.py``):
  ``qp(conf, lanes, device)`` returns ``(Qp, Gp, Fp, Kp, Mp)`` in float64
  for the lanes' inputs (each a tensor whose last axis is the lane), with
  ``Fp`` (M, B), ``Kp`` (N, B), ``Mp`` (B,), and ``Qp`` and ``Gp`` either
  shared, (M, M) and (N, M), or per lane, (B, M, M) and (B, N, M), in any
  combination; ``scale(conf, U_ref)`` gives each lane's measure of an
  error.  The shapes ``qp`` returns are all that tells the harness that
  lanes have geometries of their own: it then solves them in blocks of
  as many lanes as :data:`REF_BYTES` holds (:func:`ref_blocks`);
* ``traffic/<mix>.json``: the mix's parameters, read by the two general
  runners below (``"mode": "batch"``, cold batches back to back;
  ``"mode": "loop"``, a warm closed loop one step after another);
* ``metrics/<metric>.py``, or ``metrics/<quantity>.py`` for a metric
  named ``<quantity>.<cells>``: the reader of a metric, ``read(ctx)``;
* ``limits/<cell>.json``: the limit of each number the comparison
  computes for that cell.

A run: set-up (the configuration, then ``warmup`` steps of the cell's own
traffic), the measured window of ``--seconds`` (the step, or the loop's
cycle, that straddles its end is finished and counted), with ``--trace 1`` a
traced window of ``trace_steps`` more steps under ``torch.profiler``, and
then the comparison of the window's answers with the float64 reference.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from port_bench import trace as tr
from port_bench.reference import pqp
from port_bench.roofline import stored_bytes

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pqp_for_mpc_tpu")
#: the program's kernel launch counters: name -> (module, function)
COUNTERS = {
    "k1": ("ops.solve_kernel", "fused_full_solve"),
    "k2": ("ops.kernels", "fused_pqp_iterations"),
    "k3": ("ops.tiled_kernel", "streamed_pqp_iterations"),
    "k4": ("ops.tiled_solve_kernel", "fused_full_solve_tiled"),
    "k5": ("ops.distinct_kernel", "fused_full_solve_distinct"),
    "k6": ("ops.distinct_tiled_kernel", "fused_full_solve_distinct_tiled"),
    "k7": ("ops.distinct_tiled_kernel", "distinct_streamed_iterations"),
    "k8": ("ops.packed_kernel", "fused_full_solve_packed"),
}
#: lanes per block of the reference where every lane shares one geometry
REF_BLOCK = 512
#: float64 bytes of the per-lane matrices a block of the reference holds
#: where lanes have geometries of their own (:func:`lane_bytes`)
REF_BYTES = 4 << 30


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def stream(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of run ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` and the files it names, looked up by name under
    ``roots`` (the first that has the file wins)."""

    def __init__(self, path=REPO / "BENCHMARK.json", roots=(HERE,)):
        self.path = Path(path)
        self.spec = json.loads(self.path.read_text())
        self.roots = [Path(r) for r in roots]

    def find(self, sub: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under "
                                f"{[str(r) for r in self.roots]}")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        f = self.path.parent / self._entry("configs", name)["file"]
        return json.loads(f.read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self.find("traffic", name, ".json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(self.find("limits", cell, ".json").read_text())

    def module(self, sub: str, name: str) -> types.ModuleType:
        try:
            path = self.find(sub, name, ".py")
        except FileNotFoundError:
            if "." not in name:
                raise
            # a quantity's reader serves each of its names, split by the
            # end-to-end metric they move: metrics/device_idle_share.py
            # reads device_idle_share.cold and device_idle_share.warm
            path = self.find(sub, name.split(".")[0], ".py")
        key = "port_bench_" + hashlib.sha256(
            str(path).encode()).hexdigest()[:12]
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return sys.modules[key]

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries the cell reports: with ``trace`` the
        per-layer ones, else the end-to-end ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """What one window records: spans (host seconds, ``bench.<name>`` in a
    trace), step times, iterations, certified lanes, work and the sample
    of answers for the reference."""

    def __init__(self, device, marks: bool):
        self.device, self.marks = device, marks
        self.spans = {}
        self.step_s = []
        self.steps = self.lanes = 0
        self.iters = []          # batch: per-batch histograms; loop: per step
        self.certified = []      # device scalars
        self.io_bytes = []       # batch: (in, out) bytes of each solve
        self.samples = []        # (lane inputs, answers)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        mark = (torch.profiler.record_function("bench." + name)
                if self.marks else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
            if sync:
                _sync(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def _sample(seed, tag, i, lanes: int, k: int, iters, device):
    """``k`` lanes drawn from the seed, and the lane that took the most
    iterations."""
    g = torch.Generator().manual_seed(stream(seed, "sample", tag, i))
    idx = torch.randint(0, lanes, (k,), generator=g).to(device)
    return torch.cat([idx, iters.argmax().reshape(1).to(idx.dtype)])


class BatchTraffic:
    """``"mode": "batch"``: cold batches of ``lanes`` draws, back to back,
    each drawn afresh from the run's seed, built (ended by a synchronise)
    and solved (ended by a synchronise)."""

    def __init__(self, problem, traffic, seed, control=None):
        self.p, self.t, self.seed = problem, traffic, seed
        self.control = control
        self.i = 0
        self.rows = slice(None)
        self.cycle = 1
        self.hist_len = 2 * (problem.cfg.max_iters
                             + problem.cfg.check_every) + 2

    def step(self, rec: Recorder, tag="window"):
        p, dev = self.p, self.p.device
        gen = torch.Generator(dev).manual_seed(
            stream(self.seed, "batch", tag, self.i))
        with rec.span("draw"):
            params = p.draw(gen, self.t["lanes"])
        with rec.span("build", sync=True):
            built = p.build(params)
        with rec.span("solve", sync=True):
            res = (self.control(lambda: p.lanes(params)) if self.control
                   else p.solve(built))
        rec.io_bytes.append(_io_bytes(built, res))
        it = res.iters.long().clamp(0, self.hist_len - 1)
        rec.iters.append(torch.bincount(it, minlength=self.hist_len))
        rec.certified.append(res.converged.sum())
        idx = _sample(self.seed, tag, self.i, self.t["lanes"],
                      self.t["sample_lanes"], res.iters, dev)
        rec.samples.append((p.lanes(params, idx), res.U[:, idx]))
        rec.lanes += self.t["lanes"]
        rec.steps += 1
        self.i += 1


class LoopTraffic:
    """``"mode": "loop"``: a warm closed loop of one lane; a step runs from
    handing the entry its state to having its answer on the host, then the
    loop's plant advances the state.  Every step's answer is compared."""

    def __init__(self, problem, seed):
        self.loop = problem.loop(
            np.random.Generator(np.random.PCG64(stream(seed, "plant"))))
        self.rows, self.cycle = self.loop.rows, self.loop.cycle

    def step(self, rec: Recorder, tag="window"):
        loop = self.loop
        t0 = time.perf_counter()
        with rec.span("solve"):
            res, out = loop.solve()
        with rec.span("readback"):
            host = out.cpu().numpy()
        rec.step_s.append(time.perf_counter() - t0)
        rec.iters.append(res.iters)
        rec.certified.append(res.converged.sum())
        rec.samples.append((loop.lanes(), torch.as_tensor(host)))
        rec.lanes += 1
        rec.steps += 1
        with rec.span("plant"):
            loop.advance(host)


def _io_bytes(built, res):
    """(input, output) bytes of one solve: every tensor handed to the
    entry, and every tensor it returned, once each."""
    ins = [v for obj in built if obj is not None
           for v in vars(obj).values() if isinstance(v, torch.Tensor)]
    outs = [v for v in vars(res).values() if isinstance(v, torch.Tensor)]
    return stored_bytes(*ins), stored_bytes(*outs)


def counters() -> dict:
    """The program's kernel launch counters (``k3.bfloat16`` for a counter
    kept per mode); a counter the program no longer has is left out."""
    out = {}
    for name, (mod, fn) in COUNTERS.items():
        try:
            m = importlib.import_module("pqp_for_mpc_tpu_torch." + mod)
            c = getattr(m, fn).launches
        except (ImportError, AttributeError):
            continue
        if isinstance(c, dict):
            out.update({f"{name}.{k}": v for k, v in c.items()})
        else:
            out[name] = c
    return out


def lane_bytes(n_con: int, n_var: int) -> int:
    """Float64 bytes that one lane with a geometry of its own holds in the
    reference: ``Qd`` and its two splits, ``Gp Qp^-1``, its ``Gp``, ``Qp``
    and ``Qp^-1``, and the KKT finish's host copies of ``Qd`` and ``Gp``
    (164 MB at N = 2048, M = 512)."""
    N, M = n_con, n_var
    return 8 * (4 * N * N + 3 * N * M + 2 * M * M)


def ref_blocks(ref, conf, lanes: dict, device, shared):
    """The reference's blocks of ``lanes``: ``(first lane, the block's
    inputs, ref.qp of them)``.  Lanes that share one geometry come
    ``shared`` to a block (all in one where ``shared`` is None); lanes
    with geometries of their own, as many as :data:`REF_BYTES` holds.
    ``ref.qp`` of the first lane tells which."""
    K = next(iter(lanes.values())).shape[-1]
    Qp, Gp = ref.qp(conf, {k: v[..., :1] for k, v in lanes.items()},
                    device)[:2]
    if Qp.dim() == 3 or Gp.dim() == 3:
        size = max(1, REF_BYTES // lane_bytes(*Gp.shape[-2:]))
    else:
        size = shared or K
    for a in range(0, K, size):
        blk = {k: v[..., a:a + size] for k, v in lanes.items()}
        yield a, blk, ref.qp(conf, blk, device)


def control_solver(ref, conf, settings, device, dtype=torch.bfloat16):
    """The control: the reference at ``dtype`` in the program's place,
    solving each step's lanes with the configuration's algorithm and
    certificate (in one block where the lanes share one geometry)."""
    def solve(lanes):
        out = []
        for _, _, qp in ref_blocks(ref, conf, lanes(), device, None):
            dual = pqp.Dual(*qp, settings["theta_floor"], dtype)
            out.append(pqp.certified(dual, settings))
            del dual
        U, iters, done = (torch.cat(x, -1) for x in zip(*out))
        return types.SimpleNamespace(U=U.float(), Y=None, iters=iters,
                                     converged=done)
    return solve


def compare(ref, conf, settings, rows, samples, device,
            answer=None) -> tuple:
    """The comparison that decides ``correct``: every sampled answer
    against the float64 reference, re-solved from the same inputs (or, with
    ``answer``, the answers ``answer(lanes)`` gives on those inputs), in
    the blocks of :func:`ref_blocks`.  Returns ({"u_err": the worst lane's
    max |U - U_ref| / scale}, lanes compared, lanes the reference left
    unverified)."""
    lanes = {k: torch.cat([s[0][k].to(device, torch.float64)
                           for s in samples], dim=-1) for k in samples[0][0]}
    out = torch.cat([s[1].to(device, torch.float64) for s in samples], 1)
    K = out.shape[1]
    worst, unverified = 0.0, 0
    for a, blk, qp in ref_blocks(ref, conf, lanes, device, REF_BLOCK):
        dual = pqp.Dual(*qp, settings["theta_floor"], torch.float64)
        U_ref, unv = pqp.exact(dual, settings)
        del dual
        unverified += unv
        got = (out[:, a:a + U_ref.shape[1]] if answer is None
               else answer(lambda: blk).U[rows].to(torch.float64))
        err = (got - U_ref[rows]).abs().amax(0) / ref.scale(conf, U_ref)
        # a NaN answer is as wrong as can be
        worst = max(worst, float(torch.nan_to_num(err, nan=torch.inf).max()))
    return {"u_err": worst}, K, unverified


def route_counts() -> dict:
    """The program's ``route.<engine>`` counters so far, by engine (none
    for a program without its tracing module)."""
    try:
        from pqp_for_mpc_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return {k[len("route."):]: v
            for k, v in tracing.snapshot()["counters"].items()
            if k.startswith("route.")}


def run(bench: Bench, cell_name: str, seed: int, seconds: float,
        trace: bool, device="cuda", t_start=None, engine="program",
        overrides=None, keep_samples=False) -> dict:
    """One run of a cell; returns the result (the keys of the result line
    in order, ``checks`` last) and, under ``"_info"``, the route and the
    launch counters of the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    overrides = overrides or {}
    cell = bench.cell(cell_name)
    conf = {**bench.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**bench.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    mode = traffic["mode"]
    settings = conf["solver"][mode]
    from pqp_for_mpc_tpu_torch.config import SolverConfig
    cfg = SolverConfig(**settings)
    kind = bench.module("problems", conf["kind"])
    ref = bench.module("reference", conf["kind"])

    problem = kind.Problem(conf, cfg, traffic, device)
    control = (None if engine == "program"
               else control_solver(ref, conf, settings, device))
    drv = (BatchTraffic(problem, traffic, seed, control) if mode == "batch"
           else LoopTraffic(problem, seed))

    # set-up: the cell's own shapes, warmed up
    warm = Recorder(device, marks=False)
    for _ in range(traffic["warmup"]):
        drv.step(warm, tag="warmup")
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    before = counters()
    rec = Recorder(device, marks=False)
    t0 = time.perf_counter()
    while True:
        drv.step(rec)
        if (time.perf_counter() - t0 >= seconds
                and rec.steps % drv.cycle == 0):
            break
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in counters().items()}

    trace_summary = routes = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        seg = Recorder(device, marks=True)
        routed = route_counts()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(traffic["trace_steps"]):
                drv.step(seg, tag="trace")
            _sync(device)
        trace_summary = tr.reduce(prof, seg.steps)
        del prof
        routes = {k: v - routed.get(k, 0) for k, v in route_counts().items()
                  if v > routed.get(k, 0)}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    if trace_summary is not None:
        dev_info["busy_s"] = trace_summary["busy_s"]
        dev_info["window_s"] = trace_summary["window_s"]

    certified = int(torch.stack(rec.certified).sum())
    if mode == "batch":
        hist = torch.stack(rec.iters).sum(0).cpu().numpy()
        iters = dict(values=np.nonzero(hist)[0], lanes=hist[hist > 0])
    else:
        per_step = torch.stack([i.reshape(-1).max() for i in rec.iters])
        iters = dict(per_step=per_step.cpu().numpy())
    mean_it = (float((iters["values"] * iters["lanes"]).sum()
                     / iters["lanes"].sum()) if mode == "batch"
               else float(iters["per_step"].mean()))
    log(f"window {wall:.3f} s, {rec.steps} steps, mean iterations "
        f"{mean_it:.2f}")
    ctx = types.SimpleNamespace(
        cell=cell, conf=conf, traffic=traffic, cfg=cfg, mode=mode,
        setup_s=setup_s, wall_s=wall, steps=rec.steps, lanes=rec.lanes,
        certified=certified, step_s=np.asarray(rec.step_s), spans=rec.spans,
        iters=iters, io_bytes=rec.io_bytes, n_con=problem.n_con,
        n_var=problem.n_var, trace=trace_summary)
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
    # traced: the engines the program counted in the traced window, the
    # most used first; untraced: the engine the router picks for the cell
    route = (problem.route(traffic["lanes"], mode == "loop")
             if routes is None else
             "+".join(sorted(routes, key=routes.get, reverse=True)) or None)
    info = {"route": route, "launches": launches}

    # the program's state is freed before the reference runs
    samples, rows = rec.samples, drv.rows
    del drv, problem, rec, warm, control
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values, compared, unverified = compare(ref, conf, settings, rows,
                                           samples, device)
    log(f"reference {time.perf_counter() - t_ref:.3f} s, {compared} "
        f"answers compared, {unverified} left unverified by the reference")
    limits = bench.limits(cell_name)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = bool(compared > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": ctx.lanes,
              "failed": ctx.lanes - certified, "metrics": metrics,
              "device": dev_info}
    if trace_summary is not None:
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["checks"] = checks
    result["_info"] = info
    if keep_samples:
        result["_samples"] = (samples, rows)
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Print the result line last on ``out`` (the route and counters on an
    earlier line when traced) and the numbers compared, each beside its
    limit, last on ``err``."""
    result = dict(result)
    info = result.pop("_info", None)
    if info is not None and "breakdown" in result:
        print(json.dumps(info), file=out, flush=True)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=err,
              flush=True)
    print(json.dumps(result), file=out, flush=True)
