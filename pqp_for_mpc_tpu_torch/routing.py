"""Automatic solve-engine routing.

The counterpart of ``pqp_for_mpc_tpu/routing.py``: :func:`route_solve` is
the pure decision function and :func:`solve_auto` dispatches through it.
This port has two engines so far:

* ``"xla"`` — :func:`pqp_for_mpc_tpu_torch.solver.solve_batched`, the
  plain PyTorch masked-lane loop (the JAX package's XLA engine; the name
  is kept so engine choices carry across);
* ``"fused"`` — :func:`pqp_for_mpc_tpu_torch.ops.solve_kernel.solve_fused`,
  the whole-solve CUDA kernel.

On ``platform="cuda"`` the decision tree is the JAX package's shared-
geometry branch (its ``routing.py:141-175``) with the shared-memory fit
test in place of ``fits_vmem``.  One crossover was measured on an H100:
the whole-solve kernel routes only up to :data:`FUSED_N_MAX` (see
``PERF.md``); the other crossovers are the TPU's until H100 cells measure
them (ROADMAP queue 1, item 5).  Off CUDA the answer is ``"xla"``.
``"mixed"`` (``solve_mixed``) and the distinct-geometry engines are not
ported yet: requesting one, or a problem the tree sends to one, raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu_torch.solver import (SolveResult, _as2d,
                                          retry_cold_solve, solve_batched)

#: lane quantum below which the JAX package's map keeps the small-batch
#: (receding-horizon) regime on the plain path
_LANE = 128

#: largest N the router sends to the whole-solve kernel.  The kernel takes
#: N up to 128, but its 128-entry build keeps the lane's arrays in local
#: memory: on an H100 it beat the plain solve at N = 64 and lost to it 5-9x
#: at N = 120 (PERF.md, "K1 crossover in N")
FUSED_N_MAX = 64

ENGINES = ("xla", "fused", "mixed", "fused_distinct",
           "fused_distinct_tiled")

_NOT_PORTED = {
    "mixed": "solve_mixed is not ported yet (ROADMAP queue 1, item 7)",
    "fused_distinct": "the distinct-geometry kernels are not ported yet "
                      "(ROADMAP queue 1, item 8; queue 2, K5)",
    "fused_distinct_tiled": "the distinct-geometry kernels are not ported "
                            "yet (ROADMAP queue 1, item 8; queue 2, K6)",
}


def route_solve(n_con: int, batch: int, distinct: bool,
                cfg: SolverConfig, m_dim: Optional[int] = None,
                platform: Optional[str] = None,
                warm: bool = False) -> str:
    """Pick the solve engine for one problem shape (no device work).

    ``n_con`` = N, ``batch`` = B, ``distinct`` = per-instance Qd,
    ``m_dim`` = M, ``platform`` = the tensors' device type (``None`` asks
    whether CUDA is available), ``warm`` = a warm start is given.
    Returns one of :data:`ENGINES`.
    """
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform != "cuda":
        return "xla"
    if distinct:
        raise NotImplementedError(_NOT_PORTED["fused_distinct"])
    from pqp_for_mpc_tpu_torch.ops.kernels import fits_resident
    if not fits_resident(n_con):
        return "mixed"
    if batch < _LANE:
        return "xla"
    if n_con >= 512 and cfg.gap_from_complementarity:
        return "xla" if warm else "mixed"
    if cfg.feas_from_dual_gradient:
        # the whole-solve kernel certifies feasibility with the
        # reference's forcing-scale Gp U program; a cfg that asked for the
        # operator-consistent certificate rides the plain check
        return "xla"
    if warm and n_con >= 512:
        return "xla"
    if n_con > FUSED_N_MAX:
        return "xla"
    if m_dim is not None:
        from pqp_for_mpc_tpu_torch.ops.solve_kernel import \
            fits_resident as fused_fits
        if not fused_fits(n_con, m_dim):
            return "xla"
    return "fused"


def solve_auto(primal: PrimalQP, dual: DualQP,
               Y0: Optional[torch.Tensor] = None,
               cfg: SolverConfig = SolverConfig(),
               retry_cold: bool = False,
               engine: Optional[str] = None) -> SolveResult:
    """Solve through the engine :func:`route_solve` picks for this
    problem (pass ``engine`` to override).  Accepts what
    :func:`~pqp_for_mpc_tpu_torch.solver.solve_batched` does, including
    warm starts and ``retry_cold``."""
    if dual.Qd.dim() == 3:
        raise NotImplementedError(_NOT_PORTED["fused_distinct"])
    N = dual.n_con
    B = _as2d(dual.Fd).shape[1]
    if Y0 is not None and _as2d(Y0).shape[1] > B:
        B = _as2d(Y0).shape[1]
    platform = dual.Qd.device.type
    if engine is None:
        engine = route_solve(N, B, False, cfg, m_dim=primal.Gp.shape[-1],
                             platform=platform, warm=Y0 is not None)
        if engine == "mixed":
            raise NotImplementedError(
                f"the router picks 'mixed' for N={N} on {platform} (past "
                f"the resident kernels), and {_NOT_PORTED['mixed']} — pass "
                "engine='xla' for the plain PyTorch solve")
        if dual.Qdn_theta is None and engine == "fused":
            # a split-free dual cannot feed the resident kernel, which
            # holds the materialized splits; auto mode downgrades
            engine = "xla"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if engine == "fused" and platform != "cuda":
        raise ValueError(
            f"engine 'fused' is a CUDA kernel and the problem lies on "
            f"{platform!r} — use engine='xla'")

    if engine == "xla":
        return solve_batched(primal, dual, Y0=Y0, cfg=cfg,
                             retry_cold=retry_cold and Y0 is not None)
    from pqp_for_mpc_tpu_torch.ops.solve_kernel import solve_fused
    fn = lambda y0: solve_fused(primal, dual, Y0=y0, cfg=cfg)
    if retry_cold and Y0 is not None:
        Y_warm = torch.clamp(_as2d(Y0), min=0.0)
        if Y_warm.shape[1] == 1 and B > 1:
            Y_warm = Y_warm.expand(N, B)
        Y_cold = torch.full((N, B), cfg.y0, dtype=torch.float32,
                            device=dual.Qd.device)
        return retry_cold_solve(fn, Y_warm, Y_cold)
    return fn(Y0)
