"""K1: the whole batched PQP solve in one kernel launch.

The counterpart of ``pqp_for_mpc_tpu/ops/solve_kernel.py``: multiplicative
updates, the periodic four-part termination check with the recovered U,
optional safeguarded acceleration, the stall freeze and the early exit, all
inside one launch.  The kernel is the lane-tile engine
(``csrc/lane_tile_solve.cuh``, entered through ``csrc/full_solve.cu``): a
block holds a tile of lane slots with the geometry in shared memory, every
product runs on a register tile of 4 rows x 4 lanes per thread, and a slot
takes the next lane from a global queue as soon as its lane retires (see
the note at the top of the source; :func:`k1_plan` mirrors its launch
plan, :func:`card_plan` asks the card).  K8
(:mod:`pqp_for_mpc_tpu_torch.ops.packed_kernel`) launches the same engine.
:func:`fused_full_solve_reference` is its plain PyTorch version, a
vectorised rendition of the TPU kernel's body.

Outputs of :func:`fused_full_solve`: ``Y (N, B)``, ``U = -Qp^-1(Fp+Gp'Y)
(M, B)``, ``iters (B,)`` int32 and a per-lane int32 state code (the TPU
kernel's codes): 0 = hit max_iters while active, 1 = certified by the
in-kernel termination test, 2 = stall-frozen at a fixed point without
certificate, 3 = batch padding (never produced here: the kernel needs no
padding).  :func:`solve_fused` wraps it into a
:class:`~pqp_for_mpc_tpu_torch.lanes.SolveResult`.

Feasibility: the TPU kernel's forcing-scale test ``Gp U > Kp_slack``, or,
with ``feas_dual`` (:func:`fused_inputs` sets it where the cfg asks for
``feas_from_dual_gradient``), the dual-gradient test of
:func:`~pqp_for_mpc_tpu_torch.lanes.check_terminate` on the ``Qd Y`` the
check forms for its gap, with ``Kp_slack`` then holding the slack
``max(erc*Kp, eac)``.  The TPU kernel has no such test (a deliberate
difference, ROADMAP queue 3).

The TPU kernel's batch-block picker and VMEM budgets have no meaning on the
GPU and are not ported; :func:`fits_resident` is the shared-memory fit
test.  Dispatch: CPU tensors go to the plain version; CUDA tensors launch
the kernel, and a failed build or launch raises.  The geometry's layout is
built once per geometry (:func:`geometry_layout`).
``fused_full_solve.launches`` counts the launches.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.lanes import (SolveResult, _mv, _mvT, certificate,
                                         certificate_slack, kernel_kwargs,
                                         lane_batch, lane_panels, remember)
from pqp_for_mpc_tpu_torch.ops import build
from pqp_for_mpc_tpu_torch.ops.kernels import (N_MAX, SMEM_LIMIT_BYTES,
                                               _matrix, _on_cuda, _panel,
                                               _round4)
from pqp_for_mpc_tpu_torch.utils import tracing

LANE_MAX_ITERS, LANE_CERTIFIED, LANE_STALLED, LANE_PADDING = 0, 1, 2, 3


def smem_bytes(n: int, m: int) -> int:
    """Bytes of the geometry the engine stages: Qd^-+th, Qd^++th, Qd, Gp,
    Gp', Qp^-1 and Qp, each with its rows padded to 4 floats
    (:func:`engine_geometry`)."""
    ldn, ldm = _round4(n), _round4(m)
    return (3 * n * ldn + n * ldm + m * ldn + 2 * m * ldm) * 4


def fits_resident(n: int, m: int) -> bool:
    """Does the whole-solve kernel take an ``N=n``, ``M=m`` problem: both
    at most 128, and the geometry within one block's shared memory?"""
    return (1 <= n <= N_MAX and 1 <= m <= N_MAX
            and smem_bytes(n, m) <= SMEM_LIMIT_BYTES)


#: the engine's thread tile (rows x lanes), its most threads and lane
#: groups per block, its shared words per slot beyond the columns and per
#: block, and its matrices in layout order
#: (``csrc/lane_tile_solve.cuh``: ``tile4::R``, ``tile4::L``,
#: ``kMaxThreads``, ``kMaxLaneGroups``, ``kSlotWords``, ``kCtlWords``)
K1_ROWS, K1_LANES, K1_MAX_THREADS, K1_MAX_LANE_GROUPS = 4, 4, 256, 32
K1_SLOT_WORDS, K1_CTL_WORDS = 12, 4
K1_MATRICES = ("Qdn_theta", "Qdp_theta", "Qd", "Gp", "Gp'", "Qp_inv", "Qp")


def k1_plan(n: int, m: int, B: int) -> dict:
    """The engine's launch plan for ``N=n``, ``M=m``, ``B`` lanes, as the
    kernel computes it: rows padded to ``K1_ROWS``; K2's widest block (the
    most power-of-two lane groups of ``K1_LANES`` lanes, at most
    ``K1_MAX_LANE_GROUPS``, within ``K1_MAX_THREADS`` threads), halved
    while the block's shared memory passes ``SMEM_LIMIT_BYTES``; at one
    lane group, the trailing matrices of :data:`K1_MATRICES` stay in device
    memory until it fits (``staged`` of them in shared memory, at least the
    two splits).  Shared memory holds the staged matrices, per slot two
    iterate columns, a work column, a scratch of max(n, 3m) rows, Fd,
    Kp_slack and Fp, and the slot's scalars, and the block's queue words.
    ``blocks`` is the most blocks the launch needs, ceil(B / lanes); the
    card caps it at the blocks it holds at once (:func:`card_plan`)."""
    if not fits_resident(n, m) or B < 1:
        raise ValueError(f"k1_plan needs fits_resident(n, m) and B >= 1, "
                         f"got n={n}, m={m}, B={B}")
    ldn, ldm = _round4(n), _round4(m)
    row_groups = ldn // K1_ROWS
    ends = [0]
    for size in (n * ldn, n * ldn, n * ldn, n * ldm, m * ldn, m * ldm,
                 m * ldm):
        ends.append(ends[-1] + size)
    lane_words = 5 * n + max(n, 3 * m) + m + K1_SLOT_WORDS
    block = lambda lanes, staged: 4 * (ends[staged] + lanes * lane_words
                                       + K1_CTL_WORDS)
    lg = 1
    while (2 * lg <= K1_MAX_LANE_GROUPS
           and 2 * lg * row_groups <= K1_MAX_THREADS):
        lg *= 2
    full = len(K1_MATRICES)
    while lg > 1 and block(K1_LANES * lg, full) > SMEM_LIMIT_BYTES:
        lg //= 2
    staged = full
    while staged > 2 and block(K1_LANES * lg, staged) > SMEM_LIMIT_BYTES:
        staged -= 1
    lanes = K1_LANES * lg
    return dict(rows_per_thread=K1_ROWS, lanes_per_thread=K1_LANES,
                row_groups=row_groups, lane_groups=lg,
                threads=row_groups * lg, lanes_per_block=lanes,
                staged=staged, geometry_floats=ends[-1],
                smem_bytes=block(lanes, staged), blocks=-(-B // lanes))


def card_plan(n: int, m: int, B: int) -> dict:
    """The engine's plan as this card launches it: lanes and threads per
    block, staged matrices, shared bytes per block, blocks per SM (the
    occupancy the card reports), SMs and the grid.  Needs the card."""
    import ctypes
    out = (ctypes.c_int * 7)()
    build.check(build.load_library().full_solve_plan(n, m, B, out),
                "full_solve_plan")
    return dict(zip(("lanes_per_block", "threads", "staged", "smem_bytes",
                     "blocks_per_sm", "sms", "grid"), out))


def _depth_major(A: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """``out[d, r] = A[r, d]`` with the rows padded with zeros to
    ``rows_pad``, flat."""
    out = A.new_zeros((A.shape[1], rows_pad))
    out[:, :A.shape[0]] = A.T
    return out.reshape(-1)


def engine_geometry(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv):
    """The engine's geometry layout, one float32 buffer: the matrices of
    :data:`K1_MATRICES` in that order, each depth-major as its product
    reads it (rows padded to 4 floats with zeros): the splits and Qd
    (products with Y), Gp for Gp'Y, Gp' for Gp U, Qp^-1 and Qp (products
    with U).  A block stages its first ``k1_plan(...)["staged"]`` matrices
    in shared memory."""
    n, m = Gp.shape
    ldn, ldm = _round4(n), _round4(m)
    return torch.cat([_depth_major(Qdn_theta, ldn),
                      _depth_major(Qdp_theta, ldn), _depth_major(Qd, ldn),
                      _depth_major(Gp.T, ldm), _depth_major(Gp, ldn),
                      _depth_major(Qp_inv, ldm), _depth_major(Qp, ldm)])


#: geometry layouts kept, least recently used dropped first
LAYOUT_KEYS = 8
_LAYOUTS: "collections.OrderedDict" = collections.OrderedDict()


def geometry_layout(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv):
    """:func:`engine_geometry` of these matrices, built once per geometry:
    a controller solves every step on the same tensors, so its layout is
    reused.  The key is each matrix's identity, the entry a
    ``lanes.IdentityEntry`` stamped with each matrix's data pointer and
    version counter, so a matrix written in place, or moved, gets a new
    layout.  Inference tensors, which keep no version counter, are laid
    out on every call."""
    mats = (Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv)
    if any(t.is_inference() for t in mats):
        return engine_geometry(*mats)
    key = tuple(map(id, mats))
    stamp = tuple((t.data_ptr(), t._version) for t in mats)
    entry = _LAYOUTS.get(key)
    if entry is not None and entry.alive() and entry.places == stamp:
        _LAYOUTS.move_to_end(key)
        return entry.value
    entry = remember(_LAYOUTS, key, mats, LAYOUT_KEYS)
    entry.places, entry.value = stamp, engine_geometry(*mats)
    return entry.value


def fused_full_solve_reference(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                               Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                               max_iters: int, check_every: int,
                               accel_every: int = 0, eaj: float = 1e-6,
                               erj: float = 1e-6, strict: bool = True,
                               den_eps: float = 1e-30,
                               precision: str = "highest",
                               gap_comp: bool = False,
                               feas_dual: bool = False):
    """The plain PyTorch version of the kernel: the TPU kernel's body
    (``pqp_for_mpc_tpu/ops/solve_kernel.py:_kernel``) over the whole batch,
    looping until no lane is active or ``h > max_iters``, with the
    dual-gradient feasibility test where ``feas_dual`` asks for it (as
    :func:`fused_full_solve`).  Panels may be per lane or shared, as for
    :func:`fused_full_solve`.  The matrices may also be per instance
    (``(B, N, N)``, ...): this body is then the plain version of the
    distinct-geometry kernel K5 too
    (:mod:`pqp_for_mpc_tpu_torch.ops.distinct_kernel`)."""
    N, B = Y0.shape
    M = Gp.shape[-1]
    lanes = lambda t, r: t.reshape(r, -1).expand(r, B)
    fp, fd = lanes(Fp, M), lanes(Fd, N)
    fdp, fdn, kps = lanes(Fdp, N), lanes(Fdn, N), lanes(Kp_slack, N)
    mp = Mp.reshape(-1).expand(B)
    md = Md.reshape(-1).expand(B)

    def one_update(y, done):
        num = _mv(Qdn_theta, y) + fdn
        den = _mv(Qdp_theta, y) + fdp
        if den_eps:
            den = torch.clamp(den, min=den_eps)
        return torch.where(done, y, (num / den) * y)

    def accel(y, done):
        grad = _mv(Qd, y) + fd
        p = torch.where((y > 0.0) | (grad < 0.0), -grad,
                        torch.zeros_like(grad))
        pQp = (p * _mv(Qd, p)).sum(dim=0)
        alpha = torch.where(pQp > 0,
                            (p * p).sum(dim=0) / torch.clamp(pQp, min=1e-30),
                            torch.zeros_like(pQp))
        yn = torch.clamp(y + alpha * p, min=0.0)
        fY = 0.5 * (y * (grad + fd)).sum(dim=0)
        fYn = 0.5 * (yn * _mv(Qd, yn)).sum(dim=0) + (fd * yn).sum(dim=0)
        keep = (fYn <= fY) & ~done
        return torch.where(keep, yn, y)

    def check(y):
        u = -_mv(Qp_inv, _mvT(Gp, y) + fp)
        qdy = _mv(Qd, y)
        if feas_dual:
            # Gp U - Kp = -(Qd Y + Fd); kps holds the slack; NaN violates
            feas = (qdy + fd >= -kps).all(dim=0)
        else:
            feas = ~(_mv(Gp, u) > kps).any(dim=0)
        s1 = (y * qdy).sum(dim=0)
        s2 = (fd * y).sum(dim=0)
        jd = 0.5 * s1 + s2 + 0.5 * md
        jp = 0.5 * (u * _mv(Qp, u)).sum(dim=0) + (fp * u).sum(dim=0) + 0.5 * mp
        if gap_comp:
            gap = s1 + s2
            weak_fail = gap > 0.0
        else:
            gap = jp + jd
            weak_fail = jp > -jd
        fail = ~feas | (gap > eaj) | (gap / jd.abs() > erj)
        if strict:
            fail = fail | weak_fail
        return ~fail, u

    n_chunks = max(1, check_every // max(accel_every, 1)) \
        if accel_every else 1
    y = Y0
    st = torch.zeros(B, dtype=torch.int32, device=Y0.device)
    it = torch.zeros(B, dtype=torch.int32, device=Y0.device)
    h, unsolved = 1, B
    while unsolved > 0 and h <= max_iters:
        done = st > 0
        ok, _ = check(y)
        newly = ok & ~done
        it = torch.where(newly, h, it)
        st = torch.where(newly, LANE_CERTIFIED, st)
        done = done | ok
        y_prev = y
        if accel_every:
            for _ in range(n_chunks):
                for _ in range(accel_every):
                    y = one_update(y, done)
                y = accel(y, done)
        else:
            for _ in range(check_every):
                y = one_update(y, done)
        # stall freeze: a bit-identical iterate after a whole block
        stalled = (y - y_prev).abs().sum(dim=0) == 0.0
        newly_stalled = stalled & (st == LANE_MAX_ITERS)
        it = torch.where(newly_stalled, h + check_every, it)
        st = torch.where(newly_stalled, LANE_STALLED, st)
        unsolved = int((st == LANE_MAX_ITERS).sum())
        h += check_every

    ok, u = check(y)
    newly = ok & (st == LANE_MAX_ITERS)
    it = torch.where(newly, h, it)
    st = torch.where(newly, LANE_CERTIFIED, st)
    it = torch.where(st > 0, it, h)
    return y, u, it.to(torch.int32), st.to(torch.int32)


def fused_full_solve(Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv,
                     Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                     max_iters: int, check_every: int,
                     accel_every: int = 0, eaj: float = 1e-6,
                     erj: float = 1e-6, strict: bool = True,
                     den_eps: float = 1e-30, precision: str = "highest",
                     gap_comp: bool = False, feas_dual: bool = False):
    """Run the full batched PQP solve in one launch.

    Matrices ``(N, N)``/``(N, M)``/``(M, M)``; ``Y0 (N, B)``; the panels
    ``Fp (M, .)``, ``Fd``/``Fdp``/``Fdn``/``Kp_slack (N, .)`` and ``Mp``/
    ``Md (.)`` are per lane (``B`` columns) or shared by every lane.
    ``Kp_slack`` is the pre-slackened threshold ``Kp + max(erc*Kp, eac)``
    (compare, PQP_CPU.c:334-343); with ``feas_dual`` it is the slack
    ``max(erc*Kp, eac)`` alone, and a lane is feasible where
    ``Qd Y + Fd >= -Kp_slack`` on every row.  Returns ``(Y, U, iters,
    lane_state)``.
    """
    kw = dict(max_iters=max_iters, check_every=check_every,
              accel_every=accel_every, eaj=eaj, erj=erj, strict=strict,
              den_eps=den_eps, precision=precision, gap_comp=gap_comp,
              feas_dual=feas_dual)
    if not _on_cuda(Y0, "Y0"):
        return fused_full_solve_reference(
            Qdn_theta, Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
            Kp_slack, Mp, Md, Y0, **kw)
    if Y0.dim() != 2 or Gp.dim() != 2:
        raise ValueError("fused_full_solve: expected Y0 (N, B), Gp (N, M)")
    N, B = Y0.shape
    M = Gp.shape[1]
    if not fits_resident(N, M):
        raise ValueError(
            f"fused_full_solve: N={N}, M={M} exceed the whole-solve "
            f"kernel's shared memory (max(N, M) <= {N_MAX} and "
            f"{SMEM_LIMIT_BYTES} bytes); use solve_batched")
    if check_every < 1 or accel_every < 0:
        raise ValueError("check_every must be >= 1 and accel_every >= 0")
    return launch_engine("full_solve_f32", fused_full_solve, Qdn_theta,
                         Qdp_theta, Qd, Gp, Qp, Qp_inv, Fp, Fd, Fdp, Fdn,
                         Kp_slack, Mp, Md, Y0, **kw)


#: the span of each C entry of the lane-tile engine (K1's, K8's)
ENGINE_SPANS = {"full_solve_f32": "kernel.k1",
                "full_solve_packed_f32": "kernel.k8"}


def launch_engine(entry: str, wrapper, Qdn_theta, Qdp_theta, Qd, Gp, Qp,
                  Qp_inv, Fp, Fd, Fdp, Fdn, Kp_slack, Mp, Md, Y0, *,
                  max_iters: int, check_every: int, accel_every: int,
                  eaj: float, erj: float, strict: bool, den_eps: float,
                  precision: str, gap_comp: bool, feas_dual: bool):
    """Launch the lane-tile engine through the C entry ``entry`` (K1's or
    K8's) on CUDA tensors whose shapes the caller checked: the geometry
    laid out by :func:`geometry_layout`, the panels per lane or shared, a
    zeroed int32 lane counter.  Adds one to ``wrapper.launches`` per
    launch and returns ``(Y, U, iters, lane_state)``; a refused launch
    raises naming ``wrapper``."""
    N, B = Y0.shape
    M = Gp.shape[1]
    dev = Y0.device
    geo = geometry_layout(_matrix(Qdn_theta, (N, N), "Qdn_theta", dev),
                          _matrix(Qdp_theta, (N, N), "Qdp_theta", dev),
                          _matrix(Qd, (N, N), "Qd", dev),
                          _matrix(Gp, (N, M), "Gp", dev),
                          _matrix(Qp, (M, M), "Qp", dev),
                          _matrix(Qp_inv, (M, M), "Qp_inv", dev))
    panels = [_panel(Fp, M, B, "Fp", dev), _panel(Fd, N, B, "Fd", dev),
              _panel(Fdp, N, B, "Fdp", dev), _panel(Fdn, N, B, "Fdn", dev),
              _panel(Kp_slack, N, B, "Kp_slack", dev),
              _panel(Mp.reshape(1, -1), 1, B, "Mp", dev),
              _panel(Md.reshape(1, -1), 1, B, "Md", dev),
              _panel(Y0, N, B, "Y0", dev)]
    y = torch.empty((N, B), dtype=torch.float32, device=dev)
    u = torch.empty((M, B), dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return y, u, iters, state
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    args = [geo.data_ptr()]
    for t, lane in panels:
        args += [t.data_ptr(), lane]
    args += [y.data_ptr(), u.data_ptr(), iters.data_ptr(), state.data_ptr(),
             queue.data_ptr(), N, M, B, int(max_iters), int(check_every),
             int(accel_every), float(eaj), float(erj), int(bool(strict)),
             float(den_eps), int(bool(gap_comp)), int(bool(feas_dual)),
             build.stream_handle(dev)]
    launch = getattr(build.load_library(), entry)
    with tracing.span(ENGINE_SPANS[entry], device=dev):
        code = launch(*args)
        build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return y, u, iters, state


fused_full_solve.launches = 0


def fused_inputs(primal, dual, Y0: Optional[torch.Tensor] = None,
                 cfg: Optional[SolverConfig] = None,
                 name: str = "solve_fused",
                 feas_dual: Optional[bool] = None):
    """The arguments :func:`solve_fused` hands the kernel for this problem:
    ``(args, kwargs)`` for :func:`fused_full_solve` or, identically, for
    :func:`fused_full_solve_reference` (and the packed kernel K8, whose
    entry point ``name`` the errors then give).  Panels shared by every
    lane stay shared (stride-0 views).  ``feas_dual`` (default: the cfg's
    ``feas_from_dual_gradient``) asks for the dual-gradient feasibility
    test: the threshold panel is then the slack ``max(erc*Kp, eac)`` and
    ``kwargs`` carries ``feas_dual=True``; without it ``kwargs`` are the
    TPU kernel's."""
    cfg = cfg or SolverConfig()
    if dual.Qd.dim() != 2:
        raise ValueError(f"{name} requires shared Qd geometry")
    if dual.Qdn_theta is None:
        raise ValueError(
            f"{name} holds the MATERIALIZED Qd splits in shared memory "
            "— rebuild the dual with dualize(materialize_splits=True), or "
            "use solve_batched (it never needs them)")
    Y0, B = lane_batch(dual, Y0, cfg)
    if feas_dual is None:
        feas_dual = cfg.feas_from_dual_gradient
    kp_slack = certificate_slack(primal.Kp, cfg.erc, cfg.eac)
    if not feas_dual:
        kp_slack = primal.Kp + kp_slack
    if kp_slack.dim() == 2 and kp_slack.shape[1] not in (1, B):
        raise ValueError(
            f"Kp batch {kp_slack.shape[1]} != instance batch {B}")
    Fp, Fd, Fdp, Fdn, Mp, Md = lane_panels(primal, dual, B)
    args = (dual.Qdn_theta, dual.Qdp_theta, dual.Qd, primal.Gp, primal.Qp,
            primal.Qp_inv, Fp, Fd, Fdp, Fdn, kp_slack, Mp, Md, Y0)
    kwargs = dict(kernel_kwargs(cfg), accel_every=cfg.accel_every,
                  gap_comp=cfg.gap_from_complementarity)
    if feas_dual:
        kwargs["feas_dual"] = True
    return args, kwargs


def fused_result(primal, dual, cfg: Optional[SolverConfig], Y, U, iters,
                 lane_state):
    """A :class:`~pqp_for_mpc_tpu_torch.lanes.SolveResult` from the
    kernel's outputs.  The exit-time costs and feasibility are recomputed
    in PyTorch under the cfg's certificate
    (:func:`~pqp_for_mpc_tpu_torch.lanes.certificate`, the verdict of
    ``check_terminate``), and a lane the kernel did not certify
    (stall-frozen or out of iterations) counts as converged when its exit
    state passes the verdict there — the rescue of
    ``pqp_for_mpc_tpu/ops/solve_kernel.py:464-490``."""
    cfg = cfg or SolverConfig()
    fail, feas, Jp, Jd = certificate(primal, dual, Y, U, cfg)
    div = ~torch.isfinite(Y).all(dim=0)
    cert = lane_state == LANE_CERTIFIED
    conv = (cert | ~fail) & ~div
    return SolveResult(U=U, Y=Y, iters=iters, converged=conv,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def solve_fused(primal, dual, Y0: Optional[torch.Tensor] = None,
                cfg: Optional[SolverConfig] = None):
    """Drop-in analog of the plain engine's ``solver.solve_batched``
    running the whole solve in one launch (shared geometry only); see
    :func:`fused_inputs` and :func:`fused_result`."""
    args, kwargs = fused_inputs(primal, dual, Y0, cfg)
    return fused_result(primal, dual, cfg, *fused_full_solve(*args, **kwargs))
