"""The PQP multiplicative-update dual solver.

The PyTorch counterpart of ``pqp_for_mpc_tpu/solver.py`` (the reference hot
loop ``solveQuadraticDual``, PQP_CPU.c:694-750):

* the solve is a Python ``while`` whose body performs one convergence
  check followed by ``check_every`` multiplicative updates; the host reads
  ``done.all()`` once per check (the JAX package's ``lax.while_loop``
  condition).  The update never reads the check's outputs
  (PQP_CPU.c:718-724), so the iterate trajectory is the reference's;
* instances are batched with the batch last, ``Y (N, B)``, so each update
  is two ``(N, N) @ (N, B)`` products and an elementwise multiply;
* per-instance masks freeze solved lanes (``torch.where(done, Y, Y_next)``);
* with ``cfg.use_pallas`` the updates between checks run in one call of a
  hand-written kernel: the resident K2 of
  :mod:`pqp_for_mpc_tpu_torch.ops.kernels` where N fits shared memory, the
  streamed K3 of :mod:`pqp_for_mpc_tpu_torch.ops.tiled_kernel` past it
  (its matrix built once per solve).  On CPU tensors the kernels' plain
  versions run.

CUDA graphs (:class:`_SolveGraphs`).  At a small batch each update or
check is a chain of a few-microsecond kernels, and the host's launches set
the pace.  There the loop's two blocks, the check with its verdict's
bookkeeping and the updates between checks, replay as two CUDA graphs,
captured once per solve key; the host loop, its one read of
``done.all()`` per check, its ``max_iters`` test and its spans stay as
they are.  ``h`` lives on the device (a 0-d int32 tensor the update block
advances), so a replayed check stamps the current value.  The rule
(:func:`graphs_engage`) reads only what the code can observe: CUDA
tensors, a batch under the router's lane width (128), a plain body (no
``use_pallas`` kernel), and a key solved before.  The key
(:func:`_graph_key`) is the device, the shapes and dtypes, the cfg fields
the body reads and the identity of the geometry (``Qd``, its splits,
``theta``, ``Gp``, ``Qp``, ``Qp_inv``), which the graphs read in place; a
control loop, whose controller keeps its geometry, captures on its second
step, and a one-off solve never does.  The per-solve vectors and ``Y0``
are copied into the graphs' buffers before the first replay, and the
result is cloned out of them.  Eight keys are kept, least recently used
dropped first.  Everywhere else (the CPU, B >= 128, ``use_pallas``) the
same blocks run eagerly.

The convergence test (``terminate``, PQP_CPU.c:673-687), the lane batch and
the exit verdict are the lane contract every engine shares
(:mod:`pqp_for_mpc_tpu_torch.lanes`; its names are re-exported here).

Distinct geometry: a ``(B, N, N)`` ``Qd`` (``dual.dualize_distinct``)
holds one geometry per instance, and every product is per instance (the
JAX package's einsum branch).  :func:`solve_mixed` runs a bfloat16 bulk phase,
then certifies in float32 through :func:`solve_batched`, on either
geometry.  ``precision`` arguments are accepted for the JAX signatures and
ignored: products run in full float32.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dualize
from pqp_for_mpc_tpu_torch.lanes import (  # noqa: F401
    IdentityEntry, SolveResult, _as2d, _mv, _mvT, certificate,
    check_terminate, cold_start, complementarity_gap, costs, feasibility,
    lane_batch, recover_U, remember, termination_fail)
from pqp_for_mpc_tpu_torch.ops import distinct_kernel as _distinct
from pqp_for_mpc_tpu_torch.ops import distinct_tiled_kernel as _dt
from pqp_for_mpc_tpu_torch.ops import kernels as _kernels
from pqp_for_mpc_tpu_torch.ops import tiled_kernel as _tiled
from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu_torch.utils import tracing


def refuse_split_free_distinct(dual: DualQP) -> None:
    """Raise on a split-free distinct dual, which the multiplicative
    update cannot take: ``theta`` is per instance ``(B, N)``, and the JAX
    package's ``pqp_update`` (``pqp_for_mpc_tpu/solver.py:119``) multiplies
    ``theta.reshape(-1, 1)`` by ``Y (N, B)`` and fails with a shape
    ``TypeError`` (ROADMAP queue 3).  The port refuses it by name."""
    if dual.Qd.dim() == 3 and dual.Qdn_theta is None:
        raise ValueError(
            "a split-free distinct dual (dualize_distinct("
            "materialize_splits=False)) cannot run the multiplicative "
            "update of solve_batched: the JAX package fails on it with a "
            "shape TypeError (its solver.py:119).  Build the dual with "
            "materialize_splits=True, or use "
            "ops.distinct_tiled_kernel.solve_fused_distinct_tiled")


def pqp_update(dual: DualQP, Y: torch.Tensor, precision=None,
               den_eps: float = 0.0) -> torch.Tensor:
    """One multiplicative update
    ``Y <- Y * ((Qd^- + th) Y + Fd^-) / ((Qd^+ + th) Y + Fd^+)``
    (updateY2 + updY, PQP_CPU.c:603-618, 590-596).  Y: (N, B).

    A split-free dual builds the splits from ``Qd`` and applies theta as a
    separate elementwise term on both sides, as the JAX package does; a
    split-free distinct dual raises (:func:`refuse_split_free_distinct`).
    """
    refuse_split_free_distinct(dual)
    if dual.Qdn_theta is None:
        tY = dual.theta.reshape(-1, 1) * Y
        num = torch.clamp(-dual.Qd, min=0.0) @ Y + tY + _as2d(dual.Fdn)
        den = torch.clamp(dual.Qd, min=0.0) @ Y + tY + _as2d(dual.Fdp)
    else:
        num = _mv(dual.Qdn_theta, Y) + _as2d(dual.Fdn)
        den = _mv(dual.Qdp_theta, Y) + _as2d(dual.Fdp)
    if den_eps:
        den = torch.clamp(den, min=den_eps)        # NaN stays NaN
    return (num / den) * Y


def accel_step(dual: DualQP, Y: torch.Tensor, done: torch.Tensor,
               precision=None) -> torch.Tensor:
    """Projected steepest-descent step with exact line search on the dual
    objective ``f(Y) = 1/2 Y'Qd Y + Fd'Y`` over ``Y >= 0``, accepted per
    lane only when it does not increase f (the corrected form of the
    reference's acceleration branch, PQP_CPU.c:545-630; see the JAX
    ``accel_step``)."""
    Fd = _as2d(dual.Fd)
    grad = _mv(dual.Qd, Y) + Fd                                 # (N, B)
    p = torch.where((Y > 0.0) | (grad < 0.0), -grad, torch.zeros_like(grad))
    pQp = (p * _mv(dual.Qd, p)).sum(dim=0)                      # (B,)
    alpha = torch.where(pQp > 0,
                        (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                        torch.zeros_like(pQp))
    Yn = torch.clamp(Y + alpha[None, :] * p, min=0.0)
    fY = 0.5 * (Y * (grad + Fd)).sum(dim=0)
    fYn = 0.5 * (Yn * _mv(dual.Qd, Yn)).sum(dim=0) + (Fd * Yn).sum(dim=0)
    keep = (fYn <= fY) & ~done
    return torch.where(keep[None, :], Yn, Y)


def merge_lanes(ok: torch.Tensor, res_a: SolveResult,
                res_b: SolveResult) -> SolveResult:
    """Per-lane select between two :class:`SolveResult`\\ s: lane ``i``
    takes ``res_a`` where ``ok[i]`` else ``res_b``."""
    def pick(a, b):
        if a is None:
            return b
        m = ok[None, :] if a.dim() == 2 else ok
        return torch.where(m, a, b)
    return SolveResult(**{f.name: pick(getattr(res_a, f.name),
                                       getattr(res_b, f.name))
                          for f in dataclasses.fields(SolveResult)})


def retry_cold_solve(solve_fn: Callable[[torch.Tensor], SolveResult],
                     Y_warm: torch.Tensor,
                     Y_cold: torch.Tensor) -> SolveResult:
    """Certify-or-recover: solve from ``Y_warm``; when any lane fails the
    four-part certification, solve once more with certified lanes keeping
    their solution (they re-certify at the first check) and failed lanes
    reset to ``Y_cold``, and merge per lane.  ``iters`` and costs of a
    retried lane report the attempt that produced its result."""
    res = solve_fn(Y_warm)
    if tracing.sync(res.converged.all(), "retry"):
        return res
    Y0 = torch.where(res.converged[None, :], res.Y, Y_cold)
    return merge_lanes(res.converged, res, solve_fn(Y0))


def solve_batched(primal: PrimalQP, dual: DualQP,
                  Y0: Optional[torch.Tensor] = None,
                  cfg: SolverConfig = SolverConfig(),
                  retry_cold: bool = False) -> SolveResult:
    """Solve a batch of PQP instances.

    Shared geometry: ``primal.Fp`` / ``dual.Fd`` may be ``(M,)``/``(N,)`` or
    ``(M, B)``/``(N, B)``.  Distinct geometry: ``dual.Qd (B, N, N)`` and
    its splits, ``primal.Gp``/``Qp``/``Qp_inv`` per instance or shared
    (:func:`~pqp_for_mpc_tpu_torch.dual.dualize_distinct`); B is
    ``Qd.shape[0]``.  ``Y0`` warm-starts the solve; the default is the
    reference's cold start (:func:`~pqp_for_mpc_tpu_torch.lanes.lane_batch`
    maps either onto the lanes).  ``retry_cold`` (with a warm ``Y0``)
    re-solves failed lanes once from the cold start
    (:func:`retry_cold_solve`).
    """
    refuse_split_free_distinct(dual)
    warm = Y0 is not None
    Y0, B = lane_batch(dual, Y0, cfg)
    if retry_cold and warm:
        return retry_cold_solve(
            lambda y0: _solve_core(primal, dual, y0, cfg), Y0,
            cold_start(dual.n_con, B, cfg, Y0.device))
    return _solve_core(primal, dual, Y0, cfg)


def _loop_blocks(primal: PrimalQP, dual: DualQP, cfg: SolverConfig):
    """The two blocks of the solve loop over a :class:`_LoopState`, and
    whether they are plain PyTorch (no K2 or K3 launch).

    ``check``: the four-part test and its verdict's bookkeeping (``iters``
    stamped with ``h``, ``done``, ``div``); returns ``(U, feas, Jp, Jd)``.
    ``updates``: ``check_every`` updates under the ``done`` mask, then
    ``h += check_every``.  Each replaces the state's tensors it changes."""
    N = dual.n_con
    k = cfg.check_every

    # the update kernels take shared geometry; on 3-D Qd use_pallas is
    # ignored, as in the JAX package
    use_kernel = cfg.use_pallas and dual.Qd.dim() == 2
    streamed = None
    if use_kernel:
        if not _kernels.fits_resident(N):
            # past residency the update streams one Qd_hat (K3), built once
            # per solve; it never needed the materialized splits
            streamed = _tiled.streamed_matrix(dual.Qd, dual.theta, "float32")
        elif dual.Qdn_theta is None:
            # the resident kernel holds the materialized splits; a
            # split-free dual rides the plain body, as in the JAX package
            use_kernel = False

    def run_mult_updates(Y, done, n):
        if streamed is not None:
            Ynew = _tiled.streamed_pqp_iterations(
                *streamed, dual.Fdn, dual.Fdp, Y, num_iters=n,
                den_eps=cfg.den_eps)
            return torch.where(done[None, :], Y, Ynew)
        if use_kernel:
            Ynew = _kernels.fused_pqp_iterations(
                dual.Qdn_theta, dual.Qdp_theta, _as2d(dual.Fdn),
                _as2d(dual.Fdp), Y, num_iters=n, den_eps=cfg.den_eps)
            return torch.where(done[None, :], Y, Ynew)
        for _ in range(n):
            Y = torch.where(done[None, :], Y,
                            pqp_update(dual, Y, den_eps=cfg.den_eps))
        return Y

    def run_updates(Y, done):
        if not cfg.accel_every:
            return run_mult_updates(Y, done, k)
        # chunks of accel_every multiplicative updates, each followed by
        # one safeguarded projected-gradient step
        for _ in range(k // cfg.accel_every):
            Y = run_mult_updates(Y, done, cfg.accel_every)
            Y = accel_step(dual, Y, done)
        return Y

    def check(st: _LoopState):
        ok, U, feas, Jp, Jd = check_terminate(primal, dual, st.Y, cfg)
        # divergence: a non-finite iterate never recovers under the
        # multiplicative update — freeze the lane, stamping the freeze h
        bad = ~torch.isfinite(st.Y).all(dim=0) & ~st.done
        newly = ok & ~st.done & ~bad
        st.iters = torch.where(newly | bad, st.h, st.iters)
        st.done = st.done | ok | bad
        st.div = st.div | bad
        return U, feas, Jp, Jd

    def updates(st: _LoopState):
        st.Y = run_updates(st.Y, st.done)
        st.h = st.h + k

    return not use_kernel, check, updates


@dataclasses.dataclass
class _LoopState:
    """The solve loop's state between its blocks.  ``h`` (the iteration a
    check stamps) is a 0-d int32 tensor on the solve's device, so that a
    captured check stamps the value of the current replay."""

    Y: torch.Tensor          # (N, B)
    done: torch.Tensor       # (B,) bool
    iters: torch.Tensor      # (B,) int32
    div: torch.Tensor        # (B,) bool
    h: torch.Tensor          # () int32

    @classmethod
    def start(cls, Y0: torch.Tensor) -> "_LoopState":
        B, dev = Y0.shape[1], Y0.device
        lanes = lambda dt: torch.zeros(B, dtype=dt, device=dev)
        return cls(Y0, lanes(torch.bool), lanes(torch.int32),
                   lanes(torch.bool),
                   torch.ones((), dtype=torch.int32, device=dev))


def _solve_core(primal: PrimalQP, dual: DualQP, Y0: torch.Tensor,
                cfg: SolverConfig) -> SolveResult:
    """The masked-lane loop on a normalized ``Y0 (N, B)``: a check, then
    ``check_every`` updates, until every lane is done or ``h`` passes
    ``max_iters``; then a final check.  Where :func:`graphs_engage` holds,
    both blocks replay CUDA graphs (:class:`_SolveGraphs`)."""
    plain, check, updates = _loop_blocks(primal, dual, cfg)
    graphs = _graphs_for(primal, dual, Y0, cfg, plain)
    if graphs is None:
        st = _LoopState.start(Y0)
    else:
        st = graphs.load(primal, dual, Y0)
        check, updates = graphs.check, graphs.updates
    h = 1
    # one host sync per check: the JAX package's while-loop condition; the
    # host keeps its own h for the max_iters test
    while h <= cfg.max_iters and not tracing.sync(st.done.all(), "solve"):
        with tracing.span("solve.check"):
            check(st)
        with tracing.span("solve.updates"):
            updates(st)
        h += cfg.check_every

    # final check so exit diagnostics reflect the returned iterate: the
    # loop's own (a lane already done keeps its stamp and verdict), then
    # every lane still running stamped with the exit h
    with tracing.span("solve.check"):
        U, feas, Jp, Jd = check(st)
        iters = torch.where(st.done, st.iters, st.h)
    res = SolveResult(U=U, Y=st.Y, iters=iters, converged=st.done & ~st.div,
                      feasible=feas, Jp=Jp, Jd=Jd, diverged=st.div)
    return res if graphs is None else graphs.own(res)


#: lane quantum below which the JAX package's map keeps the small-batch
#: (receding-horizon) regime on the plain path: the batch under which the
#: plain solver replays CUDA graphs, and under which the router keeps the
#: forcing-scale test off K1 (``routing.route_solve``)
_LANE = 128


def graphs_engage(device_type: str, batch: int, plain: bool,
                  seen: bool) -> bool:
    """Whether a solve's loop replays CUDA graphs: on CUDA, at a batch
    under :data:`_LANE` (there a launch costs more than the work it
    starts), with a plain body (``plain``: no K2 or K3 wrapper, which
    launch through ctypes on their own stream), and only for a key solved
    before (``seen``), so a one-off solve never pays for a capture."""
    return device_type == "cuda" and batch < _LANE and plain and seen


#: the cfg fields the loop's body reads (max_iters is the host's test)
_BODY_FIELDS = ("erc", "eac", "eaj", "erj", "check_every", "accel_every",
                "strict_weak_duality", "gap_from_complementarity",
                "feas_from_dual_gradient", "den_eps")
#: solve keys kept, least recently used dropped first
GRAPH_KEYS = 8
_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
#: one side stream per device for every warm-up and capture: cuBLAS keeps a
#: workspace (32 MiB on Hopper) for each stream it has run on
_CAPTURE_STREAMS: dict = {}


def _geometry(primal: PrimalQP, dual: DualQP) -> tuple:
    """The inputs a solve's graphs read in place (None where absent)."""
    return (dual.Qd, dual.Qdn_theta, dual.Qdp_theta, dual.theta, primal.Gp,
            primal.Qp, primal.Qp_inv)


def _per_solve(primal: PrimalQP, dual: DualQP) -> tuple:
    """The inputs copied into a solve's graphs before the first replay."""
    return (dual.Fd, dual.Fdn, dual.Fdp, dual.Md, primal.Fp, primal.Mp,
            primal.Kp)


def _graph_key(primal: PrimalQP, dual: DualQP, Y0: torch.Tensor,
               cfg: SolverConfig):
    """The key of a solve's graphs: the device, the identity of the
    geometry, every input's shape and dtype (N, M, B, which vectors are
    batched) and the cfg fields the body reads.  None where an input is
    not a tensor on ``Y0``'s device or asks for a gradient."""
    dev = Y0.device
    geo = _geometry(primal, dual)
    ts = _per_solve(primal, dual) + (Y0,) + tuple(
        t for t in geo if t is not None)
    for t in ts:
        if not isinstance(t, torch.Tensor) or t.device != dev or (
                t.requires_grad and torch.is_grad_enabled()):
            return None
    return (dev, tuple(map(id, geo)),
            tuple((t.shape, t.dtype) for t in ts),
            tuple(getattr(cfg, f) for f in _BODY_FIELDS))


def _graphs_for(primal: PrimalQP, dual: DualQP, Y0: torch.Tensor,
                cfg: SolverConfig, plain: bool):
    """The :class:`_SolveGraphs` of this solve where
    :func:`graphs_engage` holds (captured here on the second solve of a
    key, or anew where the geometry moved), else None.  Records the key
    of a first solve."""
    if not graphs_engage(Y0.device.type, Y0.shape[1], plain, seen=True):
        return None                     # no solve of this kind engages
    key = _graph_key(primal, dual, Y0, cfg)
    if key is None:
        return None
    geo = _geometry(primal, dual)
    entry = _GRAPHS.get(key)
    seen = entry is not None and entry.alive()
    if not graphs_engage(Y0.device.type, Y0.shape[1], plain, seen):
        remember(_GRAPHS, key, geo, GRAPH_KEYS)
        return None
    _GRAPHS.move_to_end(key)
    # where each geometry tensor's data lies, as the graphs read it: a
    # graph replays only while the very tensors it was captured on live at
    # the same places, and reads a write into them in place, as an eager
    # solve does
    places = tuple(None if t is None else (t.data_ptr(), t.stride())
                   for t in geo)
    if entry.value is None or entry.places != places:
        entry.value = None              # free the old pools first
        entry.value = _SolveGraphs(primal, dual, Y0, cfg)
        entry.places = places
    return entry.value


def _into(block, st: _LoopState):
    """Run ``block`` on a copy of ``st``, then write each state tensor it
    replaced back into ``st``'s own: a graph's state stays at its
    addresses from replay to replay."""
    new = dataclasses.replace(st)
    out = block(new)
    for f in dataclasses.fields(st):
        old, cur = getattr(st, f.name), getattr(new, f.name)
        if cur is not old:
            old.copy_(cur)
    return out


class _SolveGraphs:
    """The check and update blocks of one solve key as two CUDA graphs
    over static buffers: the per-solve inputs (:func:`_per_solve`, copied
    in by :meth:`load`), the loop's state and the check's outputs.  The
    geometry (:func:`_geometry`) is read in place.  Captured after one
    warm-up round on the device's side stream (cuBLAS's handle and
    workspace), on that stream, each into a private memory pool."""

    def __init__(self, primal: PrimalQP, dual: DualQP, Y0: torch.Tensor,
                 cfg: SolverConfig):
        dev = Y0.device
        fresh = lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev)
        self.inputs = [fresh(t) for t in _per_solve(primal, dual)]
        Fd, Fdn, Fdp, Md, Fp, Mp, Kp = self.inputs
        _, check, updates = _loop_blocks(
            dataclasses.replace(primal, Fp=Fp, Mp=Mp, Kp=Kp),
            dataclasses.replace(dual, Fd=Fd, Fdn=Fdn, Fdp=Fdp, Md=Md), cfg)
        self.st = _LoopState.start(fresh(Y0))
        self.load(primal, dual, Y0)
        if dev not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side = _CAPTURE_STREAMS[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _into(check, self.st)
            _into(updates, self.st)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.g_check = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.g_check, stream=side):
            self.out = _into(check, self.st)
        self.g_updates = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.g_updates, stream=side):
            _into(updates, self.st)
        tracing.count("graph.capture")

    def load(self, primal: PrimalQP, dual: DualQP,
             Y0: torch.Tensor) -> _LoopState:
        """Copy a solve's inputs in and reset the loop's state."""
        for buf, t in zip(self.inputs, _per_solve(primal, dual)):
            buf.copy_(t)
        st = self.st
        st.Y.copy_(Y0)
        st.done.zero_()
        st.iters.zero_()
        st.div.zero_()
        st.h.fill_(1)
        return st

    def check(self, st: _LoopState):
        tracing.count("graph.replay")
        self.g_check.replay()
        return self.out

    def updates(self, st: _LoopState) -> None:
        tracing.count("graph.replay")
        self.g_updates.replay()

    @staticmethod
    def own(res: SolveResult) -> SolveResult:
        """``res`` with every field that lies in a graph's buffers cloned:
        a later replay never rewrites a returned result."""
        return dataclasses.replace(
            res, U=res.U.clone(), Y=res.Y.clone(),
            feasible=res.feasible.clone(), Jp=res.Jp.clone(),
            Jd=res.Jd.clone(), diverged=res.diverged.clone())


def solve_mixed(primal: PrimalQP, dual: DualQP,
                Y0: Optional[torch.Tensor] = None,
                cfg: SolverConfig = SolverConfig(),
                floor_frac: float = 0.25,
                floor_checks: int = 2) -> SolveResult:
    """Mixed-precision solve for large N: a bfloat16 bulk phase, then
    :func:`solve_batched` refines in float32 from the bf16 iterate to the
    full certification tolerances (the JAX ``solve_mixed``).  The result is
    certified on the TRUE float32 problem; bf16 only speeds the journey.

    The rules of the JAX docstring, each kept:

    * one consistent bf16 problem: ``Qd`` (its diagonal clamped at 0 when
      the kernel runs) is rounded ONCE to bfloat16 and split exactly by
      sign; theta comes from the ROUNDED negative part's rowsums (floored
      at ``cfg.theta_floor``) and is applied as the same float32 term on
      both sides of the update.  Products take ``Y`` rounded to bf16 and sum
      in float32;
    * phase 1 freezes a lane when it certifies (:func:`check_terminate` on
      the true problem), goes non-finite, or reaches the bf16 floor: the
      gap of the bf16 problem ``g_bf = Y'(Qd_bf Y + Fd)`` below
      ``floor_frac`` times the true gap for ``floor_checks`` consecutive
      checks;
    * non-finite phase-1 lanes restart phase 2 from the cold start ``y0``;
    * ``cfg.max_iters`` caps each phase; the reported ``iters`` is the sum
      of both phases.

    Distinct geometry (3-D ``Qd (B, N, N)``) takes the same path: theta
    then comes from each instance's own rounded negative rowsums, and every
    product is per instance.  A split-free distinct dual raises before
    phase 1, since phase 2 could not run it
    (:func:`refuse_split_free_distinct`).

    With ``cfg.use_pallas`` past residency the bulk updates run a streamed
    kernel in bf16 mode, its matrix built once per solve: K3 on shared
    geometry past N = 128 (phase 2 then rides K3's f32 mode), K7 on
    distinct geometry past ``distinct_fits_resident`` (phase 2 then runs
    the plain per-instance products, as in the JAX package).  CPU tensors
    run the kernels' plain versions.
    """
    distinct = dual.Qd.dim() == 3
    refuse_split_free_distinct(dual)
    N = dual.n_con
    dev = dual.Qd.device
    Y0, B = lane_batch(dual, Y0, cfg)

    use_kernel = False
    if cfg.use_pallas and distinct:
        use_kernel = not _distinct.distinct_fits_resident(N, primal.n_var)
        streamed_fn = (_dt.distinct_streamed_matrix,
                       _dt.distinct_streamed_iterations)
    elif cfg.use_pallas:
        use_kernel = not _kernels.fits_resident(N)
        streamed_fn = (_tiled.streamed_matrix,
                       _tiled.streamed_pqp_iterations)
    floor = torch.full_like(dual.theta, cfg.theta_floor)
    if use_kernel:
        # clamp the diagonal BEFORE the one rounding, exactly as the
        # kernel's bf16 stream is built: phase 1 is one perturbed problem
        # whichever engine runs a given step
        Qd_bf, theta = streamed_fn[0](dual.Qd, floor, "bfloat16")
    else:
        Qd_bf = dual.Qd.to(torch.bfloat16)
        theta = torch.maximum(
            floor, torch.clamp(-Qd_bf.float(), min=0.0).sum(dim=-1))
    Qbf = Qd_bf.float()                  # the rounded matrix, exactly
    if not use_kernel:
        Qdn_bf = torch.clamp(-Qbf, min=0.0)
        Qdp_bf = torch.clamp(Qbf, min=0.0)
    th = theta.T if distinct else theta[:, None]
    Fdn = _as2d(dual.Fdn).expand(N, B)
    Fdp = _as2d(dual.Fdp).expand(N, B)
    Fd = _as2d(dual.Fd)

    def dot_bf(A, Y):
        # bf16 x bf16 products are exact in float32; the sum stays float32
        return _mv(A, Y.bfloat16().float())

    def upd(Y):
        tY = th * Y
        num = dot_bf(Qdn_bf, Y) + tY + Fdn
        den = dot_bf(Qdp_bf, Y) + tY + Fdp
        if cfg.den_eps:
            den = torch.clamp(den, min=cfg.den_eps)
        return (num / den) * Y

    def accel_bf(Y, frozen):
        # accel_step on the bf16 problem (same safeguarded algebra)
        grad = dot_bf(Qbf, Y) + Fd
        p = torch.where((Y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * dot_bf(Qbf, p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        Yn = torch.clamp(Y + alpha[None, :] * p, min=0.0)
        fY = 0.5 * (Y * (grad + Fd)).sum(dim=0)
        fYn = (0.5 * (Yn * dot_bf(Qbf, Yn)).sum(dim=0)
               + (Fd * Yn).sum(dim=0))
        keep = (fYn <= fY) & ~frozen
        return torch.where(keep[None, :], Yn, Y)

    k = cfg.check_every

    def mult(n, Y, frozen):
        if use_kernel:
            Yn = streamed_fn[1](Qd_bf, theta, Fdn, Fdp, Y, num_iters=n,
                                den_eps=cfg.den_eps)
            return torch.where(frozen[None, :], Y, Yn)
        for _ in range(n):
            Y = torch.where(frozen[None, :], Y, upd(Y))
        return Y

    def run_updates(Y, frozen):
        if not cfg.accel_every:
            return mult(k, Y, frozen)
        for _ in range(k // cfg.accel_every):
            Y = accel_bf(mult(cfg.accel_every, Y, frozen), frozen)
        return Y

    Y = Y0
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    slow = torch.zeros(B, dtype=torch.int32, device=dev)
    h = 0
    # one host sync per check, as in solve_batched
    while h <= cfg.max_iters and not tracing.sync(frozen.all(), "mixed"):
        ok, _, _, Jp, Jd = check_terminate(primal, dual, Y, cfg)
        g = (complementarity_gap(dual, Y) if cfg.gap_from_complementarity
             else Jp + Jd).abs()
        g_bf = (Y * (dot_bf(Qbf, Y) + Fd)).sum(dim=0).abs()
        bad = ~torch.isfinite(Y).all(dim=0) & ~frozen
        slow = torch.where(g_bf < floor_frac * g, slow + 1,
                           torch.zeros_like(slow))
        newly = (ok | bad | (slow >= floor_checks)) & ~frozen
        iters = torch.where(newly, h, iters)
        frozen = frozen | newly
        Y = run_updates(Y, frozen)
        h += k
    it1 = torch.where(frozen, iters, h).to(torch.int32)

    # a non-finite lane would poison its f32 warm start forever (NaN/Inf
    # are absorbing under the multiplicative update): restart it cold
    lane_ok = torch.isfinite(Y).all(dim=0)
    Y1 = torch.where(lane_ok[None, :], Y, torch.full_like(Y, cfg.y0))
    res = solve_batched(primal, dual, Y0=Y1, cfg=cfg)
    return dataclasses.replace(res, iters=(res.iters + it1).to(torch.int32))


def solve(primal: PrimalQP, dual: Optional[DualQP] = None,
          Y0: Optional[torch.Tensor] = None,
          cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Single-instance convenience wrapper: dualizes if needed, solves, and
    squeezes the batch axis (mirrors main(), PQP_CPU.c:994-999).  Rejects
    batched inputs — use :func:`solve_batched` for those."""
    for name, arr in (("Fp", primal.Fp), ("Kp", primal.Kp),
                      ("Y0", Y0), ("Fd", None if dual is None else dual.Fd)):
        if arr is not None and arr.dim() == 2 and arr.shape[1] > 1:
            raise ValueError(
                f"solve() is single-instance but {name} has batch "
                f"{arr.shape[1]}; use solve_batched()")
    if dual is None:
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
    res = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    squeeze = lambda a: a[..., 0] if a.dim() >= 1 and a.shape[-1] == 1 else a
    return SolveResult(
        U=res.U[:, 0], Y=res.Y[:, 0], iters=squeeze(res.iters),
        converged=squeeze(res.converged), feasible=squeeze(res.feasible),
        Jp=squeeze(res.Jp), Jd=squeeze(res.Jd),
        diverged=squeeze(res.diverged))
