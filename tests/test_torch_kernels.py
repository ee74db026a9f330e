"""The port's two kernels (K1 whole solve, K2 fused updates) against the
JAX package's Pallas kernels, and against their plain versions on a GPU.

On the CPU each wrapper runs its plain PyTorch version, which is held to
the JAX kernel run in interpret mode on the same NumPy inputs: K2 at rtol
1e-5 (as ``tests/test_kernels.py``), K1 through ``solve_fused`` to the
oracle parity bar (converged equal, iterations within max(5, iters/5)
rounded up to whole checks, U within 5e-3 * max(1, |U|max)).  The CUDA
kernels themselves are held to these plain versions on the GPU by
``tests/test_torch_cuda.py``.

K1's dual-gradient feasibility test (``feas_dual``, which the JAX kernel
does not have) is held to the port's own plain solve under
``MPC_CONFIG``: the same verdicts, iterations within one check period and
U within 1e-5, cold and warm; ``fused_result``'s exit verdict is
``check_terminate``'s on the same Y (NaN lanes included), and the
geometry's layout is built once per geometry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu.ops.kernels import fused_pqp_iterations as j_k2
from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused as j_solve_fused
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.ops import kernels, solve_kernel

B = 72   # not a multiple of the 128-lane block: exercises the ragged edge
SMOKE = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                            accel_every=0, max_iters=5000)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def iters_bar(iters, check_every):
    """The oracle bar max(5, iters/5), rounded up to whole checks: a count
    reported every ``check_every`` updates resolves no finer than that."""
    bar = np.maximum(5, np.asarray(iters) // 5)
    return -(-bar // check_every) * check_every


def _jcfg(cfg):
    from pqp_for_mpc_tpu.config import SolverConfig as JConfig
    return JConfig(**dataclasses.asdict(cfg))


def _workload(per_lane_kp=False):
    spec = MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec)
    x = np.random.default_rng(0).normal(0.0, 0.5, (2, B)).astype(np.float32)
    jp = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    if per_lane_kp:
        # bounds loosened per lane (all lanes stay feasible; each sees its
        # own active set)
        kp = (np.asarray(jp.Kp)[:, None] + np.random.default_rng(7)
              .uniform(0.0, 2.0, (jp.Kp.shape[0], B))).astype(np.float32)
        jp = dataclasses.replace(jp, Kp=jnp.asarray(kp))
    jd = jdualize(jp)
    return (jp, jd,
            convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"),
            convert.dual_from_numpy(convert.to_numpy(jd), device="cpu"))


def _k2_inputs(jd, shared):
    N = jd.n_con
    Y = np.random.default_rng(1).uniform(0.01, 10.0, (N, B)) \
        .astype(np.float32)
    Fdn, Fdp = np.asarray(jd.Fdn), np.asarray(jd.Fdp)
    if shared:
        Fdn, Fdp = Fdn[:, :1], Fdp[:, :1]
    return (np.asarray(jd.Qdn_theta), np.asarray(jd.Qdp_theta), Fdn, Fdp, Y)


@pytest.mark.parametrize("shared", [False, True])
def test_k2_plain_matches_jax_kernel(shared):
    jp, jd, tp, td = _workload()
    qdn, qdp, fdn, fdp, Y = _k2_inputs(jd, shared)
    N = qdn.shape[0]
    want = j_k2(jnp.asarray(qdn), jnp.asarray(qdp),
                jnp.broadcast_to(jnp.asarray(fdn), (N, B)),
                jnp.broadcast_to(jnp.asarray(fdp), (N, B)), jnp.asarray(Y),
                num_iters=8, interpret=True, den_eps=1e-30)
    got = kernels.fused_pqp_iterations(
        *(torch.tensor(a) for a in (qdn, qdp, fdn, fdp, Y)),
        num_iters=8, den_eps=1e-30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


K1_CASES = {
    # explicit gap with the reference's strict weak-duality test
    "explicit_gap": (dataclasses.replace(
        SMOKE, gap_from_complementarity=False, strict_weak_duality=True),
        False),
    "complementarity_gap": (SMOKE, False),
    # a check every 4 updates: iteration counts come in steps of the
    # check cadence, and the parity bar is 5 iterations at small counts
    "accel": (dataclasses.replace(SMOKE, check_every=4, accel_every=4),
              False),
    "per_lane_kp": (dataclasses.replace(SMOKE,
                                        gap_from_complementarity=False),
                    True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_jax_solve_fused(case):
    cfg, per_lane_kp = K1_CASES[case]
    jp, jd, tp, td = _workload(per_lane_kp)
    want = j_solve_fused(jp, jd, cfg=_jcfg(cfg), interpret=True)
    got = solve_kernel.solve_fused(tp, td, cfg=cfg)
    assert np.asarray(want.converged).mean() > 0.9
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    it_w = np.asarray(want.iters).astype(np.int64)
    assert (np.abs(got.iters.numpy() - it_w)
            <= iters_bar(it_w, cfg.check_every)).all()
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


def test_cpu_tensors_leave_launch_counters_at_zero():
    jp, jd, tp, td = _workload()
    qdn, qdp, fdn, fdp, Y = (torch.tensor(a)
                             for a in _k2_inputs(jd, False))
    k1, k2 = solve_kernel.fused_full_solve, kernels.fused_pqp_iterations
    k1.launches = k2.launches = 0
    kernels.fused_pqp_iterations(qdn, qdp, fdn, fdp, Y, num_iters=2)
    solve_kernel.solve_fused(tp, td, cfg=dataclasses.replace(
        SMOKE, max_iters=16))
    assert (k1.launches, k2.launches) == (0, 0)


def test_fits_resident():
    assert kernels.fits_resident(28) and kernels.fits_resident(128)
    assert not kernels.fits_resident(129)
    assert solve_kernel.fits_resident(28, 7)
    assert solve_kernel.smem_bytes(28, 7) < 48 * 1024
    # N=128 fits the update kernel but not the whole solve's 5 matrices
    assert not solve_kernel.fits_resident(128, 32)
    assert not solve_kernel.fits_resident(64, 129)


def test_panel_checks_dtype_and_shape():
    dev = torch.device("cpu")
    t, lane = kernels._panel(torch.ones(4, 3), 4, 3, "P", dev)
    assert lane == 1 and t.shape == (4, 3)
    t, lane = kernels._panel(torch.ones(4, 1).expand(4, 3), 4, 3, "P", dev)
    assert lane == 0 and t.shape == (4,)
    with pytest.raises(ValueError, match="float32"):
        kernels._panel(torch.ones(4, 3, dtype=torch.float64), 4, 3, "P", dev)
    with pytest.raises(ValueError, match="expected"):
        kernels._panel(torch.ones(4, 2), 4, 3, "P", dev)


def test_solve_fused_rejects_split_free_dual():
    jp, jd, tp, td = _workload()
    td = dataclasses.replace(td, Qdp_theta=None, Qdn_theta=None)
    with pytest.raises(ValueError, match="MATERIALIZED"):
        solve_kernel.solve_fused(tp, td, cfg=SMOKE)


def test_k2_plain_carries_a_nan_lane_like_jax_kernel():
    # a NaN entry of Y stays in its own lane: the card's K2 is held to the
    # plain version's NaN lanes (tests/test_torch_cuda.py), the plain
    # version here to the JAX kernel's
    jp, jd, tp, td = _workload()
    qdn, qdp, fdn, fdp, Y = _k2_inputs(jd, False)
    Y[3, 5] = np.nan
    N = qdn.shape[0]
    want = np.asarray(j_k2(jnp.asarray(qdn), jnp.asarray(qdp),
                           jnp.asarray(fdn), jnp.asarray(fdp),
                           jnp.asarray(Y), num_iters=8, interpret=True,
                           den_eps=1e-30))
    got = kernels.fused_pqp_iterations(
        *(torch.tensor(a) for a in (qdn, qdp, fdn, fdp, Y)),
        num_iters=8, den_eps=1e-30).numpy()
    assert np.isnan(want[:, 5]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert N == 28 and not np.isnan(np.delete(got, 5, axis=1)).any()


@pytest.mark.parametrize("n,B", [(1, 7), (28, 1 << 22), (30, 1000),
                                 (64, 129), (120, 1), (128, 4096)])
def test_k2_plan(n, B):
    p = kernels.k2_plan(n, B)
    rows = p["row_groups"] * p["rows_per_thread"]
    assert n <= rows < n + p["rows_per_thread"]
    lg = p["lane_groups"]
    assert lg & (lg - 1) == 0 and lg <= kernels.K2_MAX_LANE_GROUPS
    assert p["threads"] == p["row_groups"] * lg <= kernels.K2_MAX_THREADS
    # the widest block: one more doubling of the lane groups would not fit
    assert (2 * lg > kernels.K2_MAX_LANE_GROUPS
            or 2 * p["threads"] > kernels.K2_MAX_THREADS)
    assert p["lanes_per_block"] == p["lanes_per_thread"] * lg
    assert (p["blocks"] - 1) * p["lanes_per_block"] < B \
        <= p["blocks"] * p["lanes_per_block"]
    assert p["smem_bytes"] <= kernels.SMEM_LIMIT_BYTES


def test_k2_plan_main_path_and_limits():
    # the main path's N = 28: 7 row groups x 32 lane groups over 128 lanes
    p = kernels.k2_plan(28, 1 << 22)
    assert (p["threads"], p["lanes_per_block"], p["blocks"]) == (224, 128,
                                                                 32768)
    assert kernels.k2_plan(128, 1)["smem_bytes"] == 4 * (2 * 128 * 128
                                                         + 2 * 128 * 32)
    for n, B in ((0, 4), (129, 4), (28, 0)):
        with pytest.raises(ValueError):
            kernels.k2_plan(n, B)


def test_aligned16_copies_only_a_misaligned_view():
    buf = torch.arange(13, dtype=torch.float32)
    whole = buf[:12].view(3, 4)
    assert whole.data_ptr() % 16 == 0
    assert kernels._aligned16(whole) is whole
    odd = buf[1:].view(3, 4)
    got = kernels._aligned16(odd)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)


def test_k1_plan_main_path():
    # the main path's N = 28, M = 7: K2's block (7 row groups x 32 lane
    # groups, 128 slots), every matrix staged, two blocks per SM
    p = solve_kernel.k1_plan(28, 7, 1 << 22)
    assert (p["threads"], p["lanes_per_block"], p["staged"]) == (224, 128, 7)
    assert p["blocks"] == (1 << 22) // 128
    assert p["geometry_floats"] * 4 == solve_kernel.smem_bytes(28, 7)
    assert p["smem_bytes"] == 4 * (2884 + 128 * (5 * 28 + 28 + 7 + 12) + 4)
    assert 2 * (p["smem_bytes"] + 1024) <= 233472


def test_k1_plan_takes_every_resident_shape():
    limit = kernels.SMEM_LIMIT_BYTES
    shapes = [(n, m) for n in range(1, 129) for m in range(1, 129)
              if solve_kernel.fits_resident(n, m)]
    assert (128, 28) in shapes and (120, 30) in shapes
    for n, m in shapes:
        p = solve_kernel.k1_plan(n, m, 1)
        assert 1 <= p["lanes_per_block"] and p["smem_bytes"] <= limit
        assert 2 <= p["staged"] <= len(solve_kernel.K1_MATRICES)
        assert p["threads"] == p["row_groups"] * p["lane_groups"] \
            <= solve_kernel.K1_MAX_THREADS
    # the card test's n120_m30 keeps every matrix staged at 4 slots; at
    # N = 128, M = 28 Gp' and Qp^-1, Qp stay in device memory
    assert solve_kernel.k1_plan(120, 30, 1000)["staged"] == 7
    assert solve_kernel.k1_plan(128, 28, 1000)["staged"] == 4


@pytest.mark.parametrize("n,m,B", [(129, 7, 1), (28, 129, 1), (128, 32, 1),
                                   (0, 7, 1), (28, 7, 0)])
def test_k1_plan_raises_past_the_limits(n, m, B):
    with pytest.raises(ValueError):
        solve_kernel.k1_plan(n, m, B)


@pytest.mark.parametrize("n,m", [(28, 7), (5, 9), (30, 30)])
def test_engine_geometry_layout(n, m):
    rng = np.random.default_rng(n + m)
    mats = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for s in ((n, n), (n, n), (n, n), (n, m), (m, m), (m, m))]
    qdn, qdp, qd, gp, qp, qpi = mats
    geo = solve_kernel.engine_geometry(qdn, qdp, qd, gp, qp, qpi)
    ldn, ldm = -(-n // 4) * 4, -(-m // 4) * 4
    assert geo.numel() == solve_kernel.k1_plan(n, m, 1)["geometry_floats"]
    # each matrix depth-major: block[d, r] is the (r, d) entry of what its
    # product multiplies, rows past the matrix zero
    want = [(qdn, ldn), (qdp, ldn), (qd, ldn), (gp.T, ldm), (gp, ldn),
            (qpi, ldm), (qp, ldm)]
    off = 0
    for A, pad in want:
        block = geo[off:off + A.shape[1] * pad].reshape(A.shape[1], pad)
        assert torch.equal(block[:, :A.shape[0]], A.T)
        assert not block[:, A.shape[0]:].any()
        assert off % 4 == 0
        off += A.shape[1] * pad
    assert off == geo.numel()


def _port_workload(lanes, seed):
    """The double integrator at H=7 (M=7, N=28) for ``lanes`` states
    x0 ~ N(0, 0.5^2), built by the port alone: (primal, dual)."""
    from pqp_for_mpc_tpu_torch import dualize
    from pqp_for_mpc_tpu_torch.models import MPCSpec as TSpec
    from pqp_for_mpc_tpu_torch.models import condense as tcondense
    from pqp_for_mpc_tpu_torch.models import double_integrator as tdi

    spec = TSpec(tdi(), horizon=7, Qy=np.eye(1), R=0.05 * np.eye(1),
                 r=np.array([2.5]), u_min=-np.ones(1), u_max=np.ones(1),
                 du_max=0.5 * np.ones(1))
    data = tcondense(spec, device="cpu")
    x = np.random.default_rng(seed).normal(0.0, 0.5, (2, lanes))
    primal = data.assemble(x=torch.as_tensor(x.astype(np.float32)),
                           Qp=data.qp())
    return primal, dualize(primal)


@pytest.mark.parametrize("warm", [False, True])
def test_k1_plain_dual_gradient_matches_solve_batched(warm):
    from pqp_for_mpc_tpu_torch.solver import solve_batched

    cfg = MPC_CONFIG
    assert cfg.feas_from_dual_gradient
    primal, dual = _port_workload(B, 0)
    Y0 = None
    if warm:
        # the next states' solves from the last ones' multipliers, floored
        # as the controller floors them
        prev = solve_batched(*_port_workload(B, 1), cfg=cfg)
        Y0 = torch.clamp(prev.Y, min=1e-6)
    args, kw = solve_kernel.fused_inputs(primal, dual, Y0, cfg)
    assert kw["feas_dual"] is True
    # the threshold panel is the slack alone
    slack = torch.clamp(cfg.erc * primal.Kp, min=cfg.eac)
    assert torch.equal(args[10], slack)
    got = solve_kernel.solve_fused(primal, dual, Y0=Y0, cfg=cfg)
    want = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    assert bool(want.converged.all())
    assert torch.equal(got.converged, want.converged)
    assert int((got.iters - want.iters).abs().max()) <= cfg.check_every
    assert float((got.U - want.U).abs().max()) <= 1e-5


def _verdict_iterates(primal, dual):
    """Iterates of every kind for one verdict: solved lanes, lanes a few
    updates from their cold start, and a NaN lane."""
    from pqp_for_mpc_tpu_torch.solver import solve_batched

    solved = solve_batched(primal, dual, cfg=MPC_CONFIG).Y
    Y = solved.clone()
    few = solve_batched(primal, dual, cfg=dataclasses.replace(
        MPC_CONFIG, max_iters=8)).Y
    Y[:, 1::3] = few[:, 1::3]
    Y[5, 4] = float("nan")
    return Y


@pytest.mark.parametrize("feas_dual", [True, False])
def test_fused_result_verdict_is_check_terminates(feas_dual):
    from pqp_for_mpc_tpu_torch.solver import check_terminate, recover_U

    cfg = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=feas_dual)
    primal, dual = _port_workload(B, 2)
    Y = _verdict_iterates(primal, dual)
    ok, U, feas, Jp, Jd = check_terminate(primal, dual, Y, cfg)
    assert 0 < int(ok.sum()) < B - 1 and not bool(ok[4])
    lane_state = torch.full((B,), solve_kernel.LANE_MAX_ITERS,
                            dtype=torch.int32)
    res = solve_kernel.fused_result(primal, dual, cfg, Y, recover_U(
        primal, Y), torch.zeros(B, dtype=torch.int32), lane_state)
    assert torch.equal(res.converged, ok)
    assert torch.equal(res.feasible, feas)
    for got, want in ((res.Jp, Jp), (res.Jd, Jd), (res.U, U)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    # a lane the kernel certified stays certified, a NaN lane never is
    cert = torch.full((B,), solve_kernel.LANE_CERTIFIED, dtype=torch.int32)
    res = solve_kernel.fused_result(primal, dual, cfg, Y, U,
                                    torch.zeros(B, dtype=torch.int32), cert)
    assert torch.equal(res.converged, Y.isfinite().all(dim=0))


def test_geometry_layout_is_built_once_per_geometry():
    solve_kernel._LAYOUTS.clear()
    _, dual = _port_workload(4, 3)
    primal, _ = _port_workload(4, 3)
    mats = [dual.Qdn_theta, dual.Qdp_theta, dual.Qd, primal.Gp, primal.Qp,
            primal.Qp_inv]
    first = solve_kernel.geometry_layout(*mats)
    assert torch.equal(first, solve_kernel.engine_geometry(*mats))
    assert solve_kernel.geometry_layout(*mats) is first
    # a matrix written in place gets a new layout of its new values
    mats[4].mul_(2.0)
    second = solve_kernel.geometry_layout(*mats)
    assert second is not first
    assert torch.equal(second, solve_kernel.engine_geometry(*mats))
    assert solve_kernel.geometry_layout(*mats) is second
    # so does another tensor of the same values, and the cache is bounded
    mats[2] = mats[2].clone()
    assert solve_kernel.geometry_layout(*mats) is not second
    kept = []
    for _ in range(solve_kernel.LAYOUT_KEYS + 2):
        mats[0] = mats[0].clone()
        kept.append(mats[0])        # alive, so no two share an id
        solve_kernel.geometry_layout(*mats)
    assert len(solve_kernel._LAYOUTS) == solve_kernel.LAYOUT_KEYS


def test_k8_refuses_the_dual_gradient_test():
    from pqp_for_mpc_tpu_torch.ops import packed_kernel

    primal, dual = _port_workload(4, 4)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, MPC_CONFIG)
    with pytest.raises(TypeError, match="feas_dual"):
        packed_kernel.fused_full_solve_packed(*args, **kw)
    # its solve wrapper hands it the forcing-scale inputs
    args, kw = solve_kernel.fused_inputs(primal, dual, None, MPC_CONFIG,
                                         feas_dual=False)
    assert "feas_dual" not in kw
    res = packed_kernel.solve_fused_packed(primal, dual, cfg=MPC_CONFIG)
    assert bool(res.converged.all())
