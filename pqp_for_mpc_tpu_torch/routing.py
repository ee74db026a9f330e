"""Automatic solve-engine routing.

The counterpart of ``pqp_for_mpc_tpu/routing.py``: :func:`route_solve` is
the pure decision function and :func:`solve_auto` dispatches through it.
The engines:

* ``"xla"`` — :func:`pqp_for_mpc_tpu_torch.solver.solve_batched`, the
  plain PyTorch masked-lane loop (the JAX package's XLA engine; the name
  is kept so engine choices carry across);
* ``"fused"`` — :func:`pqp_for_mpc_tpu_torch.ops.solve_kernel.solve_fused`,
  the whole-solve CUDA kernel (K1);
* ``"mixed"`` — :func:`pqp_for_mpc_tpu_torch.solver.solve_mixed`, the
  bfloat16 bulk phase and the float32 certification; on CUDA with
  acceleration the bulk phase rides a streamed update kernel in bf16 mode
  (K3 on shared geometry, K7 on distinct), as the JAX package forces
  ``use_pallas`` there;
* ``"fused_distinct"`` —
  :func:`pqp_for_mpc_tpu_torch.ops.distinct_kernel.solve_fused_distinct`,
  the distinct-geometry whole-solve kernel (K5);
* ``"fused_distinct_tiled"`` — :func:`pqp_for_mpc_tpu_torch.ops.
  distinct_tiled_kernel.solve_fused_distinct_tiled` (K6), requested
  explicitly only: the router never picks it (as in the JAX package).

The map on ``platform="cuda"`` (off CUDA every problem routes to
``"xla"``):

==============  ===============================  ===================
geometry        regime                           engine
==============  ===============================  ===================
shared (2-D)    N > 128 (past the resident       mixed
                kernels), warm B = 1 included
shared          N > FUSED_N_MAX (64, measured    xla
                on an H100), or K1's shared
                memory refuses (N, M)
shared          feas_from_dual_gradient: any     fused
                batch, warm or cold
shared          B < 128 (forcing-scale test)     xla
shared          otherwise                        fused
distinct (3-D)  past distinct_fits_resident      mixed
distinct        feas_from_dual_gradient or       xla
                gap_from_complementarity
distinct        otherwise                        fused_distinct
==============  ===============================  ===================

The shared branch is the JAX package's (its ``routing.py:141-175``) with
the shared-memory fit test in place of ``fits_vmem`` and one deliberate
difference (ROADMAP queue 3): K1 honours ``feas_from_dual_gradient`` (its
dual-gradient instantiation), which the JAX kernel ignores, and takes such
a cfg (``MPC_CONFIG``'s) at every batch, where JAX sends it, as it sends
every B < 128, to its plain path.  At B = 1 one K1 launch at B = 1 replaces the plain loop's
per-check launches and host reads; K1 was timed against the plain solve
with its CUDA graphs, warm, at B = 1, 8 and 64 and N = 28 and 64, and won
each (``PERF.md``).  The forcing-scale test keeps JAX's B < 128 line: K1
was not timed there, and its summation order can leave an instance the
plain solve certifies at that test's float32 floor uncertified (the
command line's ``solve-file`` on the generator's seed-3 12 x 30 instance).
JAX's lines at N >= 512 (the complementarity gap, warm starts) lie past
the port's residency line, on ``"mixed"``.  Its one measured H100
crossover is :data:`FUSED_N_MAX`.  ``warm`` changes no line of the map on
CUDA.  The distinct branch
is the JAX package's (its ``routing.py:136-140``) with one deliberate
difference: where K5 would run, a cfg that asks for a certificate K5 does
not compute — the dual-gradient feasibility or the complementarity gap; K5
certifies with the forcing-scale ``Gp U`` test and the explicit gap —
routes to ``"xla"`` (ROADMAP queue 3).  ``"mixed"`` certifies through
``check_terminate``, which honours both flags.
``distinct_fits_resident`` is the TPU's per-instance budget carried over
until an H100 cell measures the line (ROADMAP item 4.5c); the other
crossovers are the TPU's likewise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import SolveResult, cold_start, lane_batch
from pqp_for_mpc_tpu_torch.ops import (distinct_kernel, distinct_tiled_kernel,
                                       kernels, solve_kernel)
from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu_torch.solver import (_LANE, retry_cold_solve,
                                          solve_batched, solve_mixed)
from pqp_for_mpc_tpu_torch.utils import tracing

#: largest N the router sends to the whole-solve kernel.  The kernel takes
#: N up to 128, but its 128-entry build keeps the lane's arrays in local
#: memory: on an H100 it beat the plain solve at N = 64 and lost to it 5-9x
#: at N = 120 (PERF.md, "K1 crossover in N")
FUSED_N_MAX = 64

ENGINES = ("xla", "fused", "mixed", "fused_distinct",
           "fused_distinct_tiled")


def route_solve(n_con: int, batch: int, distinct: bool,
                cfg: SolverConfig, m_dim: Optional[int] = None,
                platform: Optional[str] = None,
                warm: bool = False) -> str:
    """Pick the solve engine for one problem shape (no device work).

    ``n_con`` = N, ``batch`` = B, ``distinct`` = per-instance Qd,
    ``m_dim`` = M, ``platform`` = the tensors' device type (``None`` asks
    whether CUDA is available), ``warm`` = a warm start is given (kept
    for the JAX package's signature: no line of the port's map reads it).
    Returns one of :data:`ENGINES` (never ``"fused_distinct_tiled"``).
    """
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform != "cuda":
        return "xla"
    if distinct:
        if m_dim is None or not distinct_kernel.distinct_fits_resident(
                n_con, m_dim):
            return "mixed"
        if cfg.feas_from_dual_gradient or cfg.gap_from_complementarity:
            # K5 certifies with the forcing-scale Gp U test and the
            # explicit gap; a cfg that asked for another certificate rides
            # the plain check (the JAX package routes it to K5 regardless)
            return "xla"
        return "fused_distinct"
    if not kernels.fits_resident(n_con):
        return "mixed"
    if n_con > FUSED_N_MAX:
        return "xla"
    if m_dim is not None and not solve_kernel.fits_resident(n_con, m_dim):
        return "xla"
    if batch < _LANE and not cfg.feas_from_dual_gradient:
        return "xla"
    return "fused"


def solve_auto(primal: PrimalQP, dual: DualQP,
               Y0: Optional[torch.Tensor] = None,
               cfg: SolverConfig = SolverConfig(),
               retry_cold: bool = False,
               engine: Optional[str] = None) -> SolveResult:
    """Solve through the engine :func:`route_solve` picks for this
    problem (pass ``engine`` to override).  Accepts what
    :func:`~pqp_for_mpc_tpu_torch.solver.solve_batched` does — shared or
    distinct geometry, warm starts and ``retry_cold`` (for every engine).

    A split-free dual cannot feed the resident kernels, which read the
    materialized splits: auto mode downgrades ``"fused"`` to ``"xla"`` and
    ``"fused_distinct"`` to ``"mixed"``, as the JAX package does.  On a
    split-free DISTINCT dual ``"mixed"`` then raises the ``ValueError`` of
    :func:`~pqp_for_mpc_tpu_torch.solver.refuse_split_free_distinct` (its
    float32 phase is ``solve_batched``, which the JAX package crashes on);
    ``engine="fused_distinct_tiled"`` takes such a dual."""
    distinct = dual.Qd.dim() == 3
    warm = Y0 is not None
    Y0, B = lane_batch(dual, Y0, cfg)
    platform = dual.Qd.device.type
    if engine is None:
        engine = route_solve(dual.n_con, B, distinct, cfg,
                             m_dim=primal.n_var, platform=platform,
                             warm=warm)
        if dual.Qdn_theta is None and engine in ("fused", "fused_distinct"):
            engine = "mixed" if distinct else "xla"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine.startswith("fused") and platform != "cuda":
        raise ValueError(
            f"engine {engine!r} is a CUDA kernel and the problem lies on "
            f"{platform!r} — use engine='xla' or 'mixed'")
    tracing.count("route." + engine)
    with tracing.span("solve.auto"):
        return _solve_on(engine, primal, dual, Y0, cfg,
                         retry_cold and warm)


def _solve_on(engine: str, primal: PrimalQP, dual: DualQP,
              Y0: torch.Tensor, cfg: SolverConfig,
              retry: bool) -> SolveResult:
    """:func:`solve_auto` on the engine it chose, from the lanes' ``Y0
    (N, B)``; ``retry``: re-solve failed lanes once from the cold start."""
    platform = dual.Qd.device.type
    if engine == "xla":
        return solve_batched(primal, dual, Y0=Y0, cfg=cfg, retry_cold=retry)
    if engine == "mixed":
        if platform == "cuda" and cfg.accel_every:
            # the JAX package forces its bf16 streamed update kernels under
            # acceleration (its routing.py:224-233); solve_mixed uses them
            # only past residency
            cfg = dataclasses.replace(cfg, use_pallas=True)
        fn = lambda y0: solve_mixed(primal, dual, Y0=y0, cfg=cfg)
    else:
        solve = {"fused": solve_kernel.solve_fused,
                 "fused_distinct": distinct_kernel.solve_fused_distinct,
                 "fused_distinct_tiled":
                     distinct_tiled_kernel.solve_fused_distinct_tiled}[engine]
        fn = lambda y0: solve(primal, dual, Y0=y0, cfg=cfg)
    if retry:
        # the warm start floored at 0, as the JAX package's solve_auto does
        N, B = Y0.shape
        return retry_cold_solve(fn, torch.clamp(Y0, min=0.0),
                                cold_start(N, B, cfg, Y0.device))
    return fn(Y0)
