"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
host without JAX (``--noconftest`` skips the JAX set-up of conftest.py):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Bars: K2 at rtol/atol 1e-5 after 8 updates (as ``tests/test_kernels.py``),
and K3's float32 mode likewise (as ``tests/test_tiled_kernel.py``).  K3's
bfloat16 mode at rtol 1e-3, a quarter of one bf16 step (2^-8): a one-ulp
float32 difference between the kernel's and the plain version's sums can
flip the bf16 rounding of an entry of y in the next update and move that
entry's products by a bf16 step; such flips are rare and each moves a row
sum by about 2^-8 / N, so the two may differ past float32 rounding but
stay far inside one bf16 step.  K1 and K4 with equal lane states,
iterations within max(5, iters/5) rounded up to whole checks, and U within
5e-3 * max(1, |U|max) — the kernels sum in another order than the plain
versions' matrix products.  With acceleration the iteration bar holds on
99% of lanes: the accel step is kept when f(Y_new) <= f(Y), two float32
values that agree to rounding near the optimum, so two correct summation
orders can take different steps and a rare lane's trajectory (never its
state or U bar) drifts further.  K5, K6 and K8 are held like K1 and K4,
K7 like K3.  Every kernel whose reductions run in a fixed order repeats
every bit on a second launch; the tests of K4–K8 check it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pqp_for_mpc_tpu_torch as pqp
from pqp_for_mpc_tpu_torch import dualize, dualize_distinct
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import (distinct_kernel, distinct_tiled_kernel,
                                       kernels, packed_kernel, solve_kernel,
                                       tiled_kernel, tiled_solve_kernel)
from pqp_for_mpc_tpu_torch.problem import PrimalQP

pytestmark = pytest.mark.cuda

SMOKE = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                            accel_every=0, max_iters=5000)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


def _workload(dev, H, B, per_lane_kp=False):
    """Double integrator condensed at horizon H (M=H, N=4H), x0 ~ N(0, 0.5^2)."""
    spec = MPCSpec(double_integrator(), horizon=H, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec, device=dev)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0.0, 0.5, (2, B)).astype(np.float32),
                        device=dev)
    primal = data.assemble(x=x, Qp=data.qp())
    if per_lane_kp:
        kp = torch.as_tensor(rng.uniform(0.0, 2.0, (primal.Kp.shape[0], B))
                             .astype(np.float32), device=dev)
        primal = dataclasses.replace(primal, Kp=primal.Kp[:, None] + kp)
    return primal, dualize(primal)


def _bar(iters, check_every):
    bar = torch.clamp(iters // 5, min=5)
    return -(-bar // check_every) * check_every


@pytest.mark.parametrize("H,B,shared", [(7, 1000, False), (7, 1000, True),
                                        (16, 3000, False), (30, 777, False)])
def test_k2_kernel_matches_plain(dev, H, B, shared):
    primal, dual = _workload(dev, H, B)
    N = dual.n_con
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.01, 10.0, (N, B))
                        .astype(np.float32), device=dev)
    fdn, fdp = ((dual.Fdn[:, :1], dual.Fdp[:, :1]) if shared
                else (dual.Fdn, dual.Fdp))
    before = kernels.fused_pqp_iterations.launches
    got = kernels.fused_pqp_iterations(dual.Qdn_theta, dual.Qdp_theta, fdn,
                                       fdp, Y, num_iters=8, den_eps=1e-30)
    want = kernels.fused_pqp_iterations_reference(
        dual.Qdn_theta, dual.Qdp_theta, fdn, fdp, Y, num_iters=8,
        den_eps=1e-30)
    torch.cuda.synchronize()
    assert kernels.fused_pqp_iterations.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


K1_CASES = {
    "explicit_gap": (dataclasses.replace(
        SMOKE, gap_from_complementarity=False, strict_weak_duality=True),
        7, False),
    "complementarity_gap": (SMOKE, 7, False),
    "accel": (dataclasses.replace(SMOKE, check_every=4, accel_every=4), 7,
              False),
    "per_lane_kp": (dataclasses.replace(SMOKE,
                                        gap_from_complementarity=False),
                    7, True),
    "n64_m16": (SMOKE, 16, False),
    "n120_m30": (SMOKE, 30, False),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_kernel_matches_plain(dev, case):
    cfg, H, per_lane_kp = K1_CASES[case]
    primal, dual = _workload(dev, H, 1000, per_lane_kp)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, cfg)
    before = solve_kernel.fused_full_solve.launches
    y, u, it, st = solve_kernel.fused_full_solve(*args, **kw)
    y_p, u_p, it_p, st_p = solve_kernel.fused_full_solve_reference(*args,
                                                                   **kw)
    torch.cuda.synchronize()
    assert solve_kernel.fused_full_solve.launches == before + 1
    assert bool((st == st_p).all())
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every)).float()
    assert float(within.mean()) >= (0.99 if cfg.accel_every else 1.0)
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p).abs().max()) <= 5e-3 * scale


def test_solve_auto_routes_cold_batch_to_the_kernel(dev):
    import pqp_for_mpc_tpu_torch as pqp
    primal, dual = _workload(dev, 7, 4096)
    before = solve_kernel.fused_full_solve.launches
    res = pqp.solve_auto(primal, dual, cfg=SMOKE)
    torch.cuda.synchronize()
    assert solve_kernel.fused_full_solve.launches == before + 1
    assert float(res.converged.float().mean()) >= 0.99


def _random_problem(dev, N, M, B, seed=0, fp_scale=3.0):
    """A random PSD geometry (tests/test_tiled_solve_kernel.py's family)."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    primal = PrimalQP(Qp=t(Qp), Qp_inv=t(np.linalg.inv(Qp)),
                      Fp=t(rng.normal(0, fp_scale, (M, B))),
                      Mp=t(np.zeros(B)),
                      Gp=t(rng.normal(0, 1, (N, M))),
                      Kp=t(rng.uniform(1, 10, N)))
    return primal, dualize(primal)


@pytest.mark.parametrize("N,B", [(200, 72), (1024, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_kernel_matches_plain(dev, N, B, dtype):
    primal, dual = _random_problem(dev, N, N // 4, B)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (N, B))
                        .astype(np.float32), device=dev)
    args = (dual.Qd, dual.theta, dual.Fdn, dual.Fdp, Y)
    before = tiled_kernel.streamed_pqp_iterations.launches[dtype]
    got = tiled_kernel.fused_pqp_iterations_tiled(*args, num_iters=16,
                                                  den_eps=1e-30, dtype=dtype)
    want = tiled_kernel.fused_pqp_iterations_tiled_reference(
        *args, num_iters=16, den_eps=1e-30, dtype=dtype)
    torch.cuda.synchronize()
    assert tiled_kernel.streamed_pqp_iterations.launches[dtype] == before + 1
    rtol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)


K4_CASES = {
    "complementarity_gap": (SolverConfig(
        max_iters=4000, check_every=8, y0=10.0, strict_weak_duality=False,
        gap_from_complementarity=True), 200, 64, 72, 3.0),
    # the explicit gap Jp + Jd of a lane whose constraints are all inactive
    # is rounding noise (its Y underflows to 0), so this case forces active
    # constraints (Fp ~ N(0, 30^2)) and certifies at 1e-4
    "explicit_gap": (SolverConfig(
        max_iters=4000, check_every=8, y0=10.0, erc=1e-4, eac=1e-4,
        eaj=1e-4, erj=1e-4, strict_weak_duality=False), 200, 64, 72, 30.0),
    "accel": (SolverConfig(max_iters=4000, check_every=8, accel_every=8,
                           strict_weak_duality=False,
                           gap_from_complementarity=True), 200, 64, 72, 3.0),
    "n1024_accel": (SolverConfig(max_iters=4000, check_every=16,
                                 accel_every=16, strict_weak_duality=False,
                                 gap_from_complementarity=True),
                    1024, 256, 128, 3.0),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_kernel_matches_plain(dev, case):
    cfg, N, M, B, fp_scale = K4_CASES[case]
    primal, dual = _random_problem(dev, N, M, B, fp_scale=fp_scale)
    kp = primal.Kp + torch.clamp(cfg.erc * primal.Kp, min=cfg.eac)
    args = (dual.Qd, dual.theta, primal.Gp, primal.Qp, primal.Qp_inv,
            primal.Fp, dual.Fd, dual.Fdp, dual.Fdn, kp, primal.Mp, dual.Md,
            torch.full((N, B), cfg.y0, device=dev))
    kw = dict(max_iters=cfg.max_iters, check_every=cfg.check_every,
              accel=cfg.accel_every > 0, eaj=cfg.eaj, erj=cfg.erj,
              strict=cfg.strict_weak_duality, den_eps=cfg.den_eps,
              gap_comp=cfg.gap_from_complementarity)
    before = tiled_solve_kernel.fused_full_solve_tiled.launches
    y, u, it, st = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    y_p, u_p, it_p, st_p = \
        tiled_solve_kernel.fused_full_solve_tiled_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tiled_solve_kernel.fused_full_solve_tiled.launches == before + 1
    assert bool((st == st_p).all())
    assert bool((st_p == 1).any())
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every))[st_p == 1]
    assert float(within.float().mean()) >= (0.99 if cfg.accel_every
                                            else 1.0)
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p).abs().max()) <= 5e-3 * scale
    # the reductions are deterministic: a second launch repeats every bit
    y2, u2, it2, st2 = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    assert bool((it2 == it).all()) and bool((y2 == y).all())


def test_past_the_resident_kernels_ride_the_streamed_kernel(dev):
    # N = 132: past the resident kernels, use_pallas rides K3's f32 mode and
    # the router's "mixed" K3's bf16 bulk phase (forced under acceleration)
    import pqp_for_mpc_tpu_torch as pqp
    primal, dual = _workload(dev, 33, 256)
    cfg = dataclasses.replace(MPC_CONFIG, max_iters=20000)
    launches = tiled_kernel.streamed_pqp_iterations.launches
    f32, bf16 = launches["float32"], launches["bfloat16"]
    got = pqp.solve_batched(primal, dual,
                            cfg=dataclasses.replace(cfg, use_pallas=True))
    want = pqp.solve_batched(primal, dual, cfg=cfg)
    torch.cuda.synchronize()
    assert launches["float32"] > f32
    # the few lanes still open near max_iters sit at the float32 floor of
    # the complementarity gap, where summation order decides the verdict
    # (ROADMAP queue 3, the fan-out lanes): 4 of 256 on an H100
    assert float((got.converged == want.converged).float().mean()) >= 0.97
    # lanes certified by both agree on U; their iteration counts are not
    # held per lane: under acceleration (check_every = 8) the accel
    # acceptance flips on summation order and moved 9 of 248 lanes past the
    # oracle bar on an H100 (ROADMAP queue 3)
    both = got.converged & want.converged
    scale = max(1.0, float(want.U[:, both].abs().max()))
    assert float((got.U - want.U)[:, both].abs().max()) <= 5e-3 * scale
    assert pqp.route_solve(132, 256, False, cfg, m_dim=33,
                           platform="cuda") == "mixed"
    # solve_mixed certifies fewer of these ill-conditioned lanes than the
    # float32 solve in the same budget (as in the JAX package): only the
    # route and the kernels are held here
    f32 = launches["float32"]
    res = pqp.solve_auto(primal, dual,
                         cfg=dataclasses.replace(cfg, max_iters=400))
    torch.cuda.synchronize()
    assert launches["bfloat16"] > bf16 and launches["float32"] > f32
    assert bool(torch.isfinite(res.U).all())


def test_kernels_refuse_what_they_do_not_take(dev):
    primal, dual = _workload(dev, 7, 256)
    Y = torch.ones(dual.n_con, 256, device=dev)
    with pytest.raises(ValueError, match="float32"):
        kernels.fused_pqp_iterations(dual.Qdn_theta.double(),
                                     dual.Qdp_theta, dual.Fdn, dual.Fdp, Y,
                                     num_iters=1)
    with pytest.raises(ValueError, match=r"got \(28, 5\)"):
        kernels.fused_pqp_iterations(dual.Qdn_theta, dual.Qdp_theta,
                                     dual.Fdn[:, :5], dual.Fdp, Y,
                                     num_iters=1)
    big = torch.ones(130, 130, device=dev)
    with pytest.raises(ValueError, match="N=130"):
        kernels.fused_pqp_iterations(big, big, torch.ones(130, device=dev),
                                     torch.ones(130, device=dev),
                                     torch.ones(130, 4, device=dev),
                                     num_iters=1)
    with pytest.raises(ValueError, match="cpu"):
        kernels.fused_pqp_iterations(dual.Qdn_theta.cpu(), dual.Qdp_theta,
                                     dual.Fdn, dual.Fdp, Y, num_iters=1)


def _distinct(dev, N, M, B, gaussian, seed=0, materialize=True):
    """benchmarks/bench_distinct.py's instances (make_instances), drawn from
    NumPy as there: {-1, 0, 1} Gp, or gaussian Gp with the strongly
    regularized Qp of its streamed family."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, M, M)).astype(np.float32) / np.sqrt(M)
    Qp = np.einsum("bij,bkj->bik", L, L) + 2.0 * np.eye(M, dtype=np.float32)
    if gaussian:
        Qp = Qp + (M - 2.0) * np.eye(M, dtype=np.float32)
        Gp = rng.standard_normal((B, N, M)).astype(np.float32)
        Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
        Mp = np.zeros(B, np.float32)
        Kp = rng.uniform(1.0, 10.0, (N, B)).astype(np.float32)
    else:
        Gp = rng.integers(-1, 2, (B, N, M)).astype(np.float32)
        Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
        Mp = rng.standard_normal(B).astype(np.float32)
        Kp = rng.uniform(1.0, 8.0, (N, B)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    primal = PrimalQP(Qp=t(Qp), Qp_inv=t(np.linalg.inv(Qp)), Fp=t(Fp),
                      Mp=t(Mp), Gp=t(Gp), Kp=t(Kp))
    return primal, dualize_distinct(primal, materialize_splits=materialize)


#: bench_distinct.py's configuration (its lines 83-85)
DISTINCT_CFG = SolverConfig(max_iters=20000, check_every=8, y0=1.0, erc=1e-4,
                            eac=1e-4, eaj=1e-3, erj=1e-4,
                            strict_weak_duality=False)

K5_CASES = {
    "n200_m50": (DISTINCT_CFG, 200, 50, 3),
    "ragged_n203_m51": (DISTINCT_CFG, 203, 51, 3),
    "accel": (dataclasses.replace(DISTINCT_CFG, check_every=4,
                                  accel_every=4), 200, 50, 3),
    # accelerated: ~2,200 iterations where the plain update needs ~10x more
    "n1024_m256_accel": (dataclasses.replace(DISTINCT_CFG, accel_every=8),
                         1024, 256, 3),
}


def _whole_solve_parity(out, out_p, check_every, accel):
    y, u, it, st = out
    y_p, u_p, it_p, st_p = out_p
    assert bool((st == st_p).all())
    assert bool((st_p == 1).any())
    within = ((it - it_p).abs() <= _bar(it_p, check_every)).float()
    assert float(within.mean()) >= (0.99 if accel else 1.0)
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p).abs().max()) <= 5e-3 * scale


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_kernel_matches_plain(dev, case):
    cfg, N, M, B = K5_CASES[case]
    primal, dual = _distinct(dev, N, M, B, gaussian=False)
    args, kw = distinct_kernel.distinct_inputs(primal, dual, None, cfg)
    k5 = distinct_kernel.fused_full_solve_distinct
    before = k5.launches
    out = k5(*args, **kw)
    out_p = distinct_kernel.fused_full_solve_distinct_reference(*args, **kw)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    _whole_solve_parity(out, out_p, cfg.check_every, cfg.accel_every)
    again = k5(*args, **kw)
    assert all(bool((a == b).all()) for a, b in zip(again, out))


#: bench_mixed.py --distinct --accel's configuration (its lines 78-83)
STREAMED_CFG = SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                            strict_weak_duality=False,
                            gap_from_complementarity=True, erc=1e-6,
                            eac=1e-6, eaj=1e-6, erj=1e-6)

K6_CASES = {
    "explicit_gap_n200": (SolverConfig(max_iters=4000, check_every=8,
                                       y0=10.0, strict_weak_duality=True),
                          200, 50, 3),
    "accel_n200": (STREAMED_CFG, 200, 50, 3),
    "ragged_n203_m51": (STREAMED_CFG, 203, 51, 3),
    "accel_n1024": (STREAMED_CFG, 1024, 256, 3),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_kernel_matches_plain(dev, case):
    cfg, N, M, B = K6_CASES[case]
    primal, dual = _distinct(dev, N, M, B, gaussian=True, materialize=False)
    args, kw = distinct_tiled_kernel.distinct_tiled_inputs(primal, dual,
                                                           None, cfg)
    k6 = distinct_tiled_kernel.fused_full_solve_distinct_tiled
    before = k6.launches
    out = k6(*args, **kw)
    out_p = distinct_tiled_kernel.fused_full_solve_distinct_tiled_reference(
        *args, **kw)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    _whole_solve_parity(out, out_p, cfg.check_every, cfg.accel_every)
    again = k6(*args, **kw)
    assert all(bool((a == b).all()) for a, b in zip(again, out))


@pytest.mark.parametrize("N", [200, 203, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_kernel_matches_plain(dev, N, dtype):
    _, dual = _distinct(dev, N, N // 4, 3, gaussian=True,
                        materialize=False)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (N, 3))
                        .astype(np.float32), device=dev)
    Q, th = distinct_tiled_kernel.distinct_streamed_matrix(dual.Qd,
                                                           dual.theta, dtype)
    args = (Q, th, dual.Fdn, dual.Fdp, Y)
    k7 = distinct_tiled_kernel.distinct_streamed_iterations
    before = k7.launches[dtype]
    got = k7(*args, num_iters=16, den_eps=1e-30)
    want = distinct_tiled_kernel.distinct_streamed_iterations_reference(
        *args, num_iters=16, den_eps=1e-30)
    torch.cuda.synchronize()
    assert k7.launches[dtype] == before + 1
    rtol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)
    assert bool((k7(*args, num_iters=16, den_eps=1e-30) == got).all())


def test_distinct_routes_launch_their_kernels(dev):
    # resident: solve_auto -> "fused_distinct" -> K5
    primal, dual = _distinct(dev, 200, 50, 16, gaussian=False)
    k5 = distinct_kernel.fused_full_solve_distinct
    before = k5.launches
    res = pqp.solve_auto(primal, dual, cfg=DISTINCT_CFG)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert float(res.converged.float().mean()) >= 0.99
    # past the K5 line: solve_auto -> "mixed" -> K7 bf16, then plain f32
    primal, dual = _distinct(dev, 1216, 304, 2, gaussian=True)
    assert pqp.route_solve(1216, 2, True, STREAMED_CFG, m_dim=304,
                           platform="cuda") == "mixed"
    k7 = distinct_tiled_kernel.distinct_streamed_iterations.launches
    bf16, f32 = k7["bfloat16"], k7["float32"]
    res = pqp.solve_auto(primal, dual, cfg=STREAMED_CFG)
    torch.cuda.synchronize()
    assert k7["bfloat16"] > bf16 and k7["float32"] == f32
    assert bool(res.converged.all())


K8_CASES = {
    "n28": (SMOKE, 7, 4096, False),
    "n28_accel": (dataclasses.replace(SMOKE, check_every=4, accel_every=4),
                  7, 4096, False),
    "n28_per_lane_kp": (dataclasses.replace(
        SMOKE, gap_from_complementarity=False), 7, 4096, True),
    "n64": (SMOKE, 16, 2048, False),
    "n64_accel": (dataclasses.replace(MPC_CONFIG,
                                      feas_from_dual_gradient=False),
                  16, 2048, False),
    # n_pad 24 and 40: G = 5 and 3, 6 and 10 threads per instance, a
    # ragged last packed column
    "n24": (SMOKE, 6, 1001, False),
    "n40": (SMOKE, 10, 999, False),
}


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_k8_kernel_matches_plain(dev, case):
    cfg, H, B, per_lane_kp = K8_CASES[case]
    primal, dual = _workload(dev, H, B, per_lane_kp)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, cfg)
    k8 = packed_kernel.fused_full_solve_packed
    before = k8.launches
    out = k8(*args, **kw)
    y_p, u_p, it_p, st_p = packed_kernel.fused_full_solve_packed_reference(
        *args, **kw)
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    y, u, it, st = out
    assert set(st.unique().tolist()) <= {0, 1, 2}
    same = st == st_p
    if cfg.accel_every and H == 16:
        # accelerated H=16 lanes: the accel step's projection can make an
        # absorbing zero in one summation order and not the other, so a
        # lane stalls (state 2) on one side and certifies on the other; on
        # an H100 that happened on 8 of 2,048 lanes of this draw (and K1
        # against its plain version on 5), every one a stall on one side
        assert float(same.float().mean()) >= 0.995
        assert bool(((st == 2) | (st_p == 2))[~same].all())
    else:
        assert bool(same.all())
    # the iteration bar on the lanes that end alike: all of them without
    # acceleration, 99% with it at H=7 (as K1), 90% at H=16, where the
    # accel drift is wider (on an H100: 95.8% of this draw's 2,048 lanes,
    # 99.1% of 4,096 lanes at r = 0; tests/test_torch_packed.py holds 85%
    # against the JAX package for the same reason)
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every))[same]
    share = 1.0 if not cfg.accel_every else (0.90 if H == 16 else 0.99)
    assert float(within.float().mean()) >= share
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p)[:, same].abs().max()) <= 5e-3 * scale
    again = k8(*args, **kw)
    assert all(bool((a == b).all()) for a, b in zip(out, again))


def test_solve_fused_packed_gives_k1_verdicts(dev):
    primal, dual = _workload(dev, 7, 1 << 14)
    k8 = packed_kernel.solve_fused_packed(primal, dual, cfg=SMOKE)
    k1 = solve_kernel.solve_fused(primal, dual, cfg=SMOKE)
    assert bool((k8.converged == k1.converged).all())
    assert float(k8.converged.float().mean()) >= 0.99
    assert float((k8.U - k1.U).abs().max()) <= 5e-3 * max(
        1.0, float(k1.U.abs().max()))


def test_k8_refuses_what_it_does_not_take(dev):
    big = torch.ones(130, 130, device=dev)
    with pytest.raises(ValueError, match="does not pack"):
        packed_kernel.fused_full_solve_packed(
            big, big, big, torch.ones(130, 4, device=dev),
            torch.eye(4, device=dev), torch.eye(4, device=dev),
            torch.ones(4, device=dev), torch.ones(130, device=dev),
            torch.ones(130, device=dev), torch.ones(130, device=dev),
            torch.ones(130, device=dev), torch.zeros(1, device=dev),
            torch.zeros(1, device=dev), torch.ones(130, 4, device=dev),
            max_iters=8, check_every=8)
    n, m = 64, 3000
    sq = torch.eye(n, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        packed_kernel.fused_full_solve_packed(
            sq, sq, sq, torch.zeros(n, m, device=dev),
            torch.eye(m, device=dev), torch.eye(m, device=dev),
            torch.zeros(m, device=dev), torch.ones(n, device=dev),
            torch.ones(n, device=dev), torch.ones(n, device=dev),
            torch.ones(n, device=dev), torch.zeros(1, device=dev),
            torch.zeros(1, device=dev), torch.ones(n, 4, device=dev),
            max_iters=8, check_every=8)


def test_rollout_jit_on_the_card_matches_rollout(dev):
    from pqp_for_mpc_tpu_torch.models import MPCController
    spec = MPCSpec(double_integrator(), horizon=16, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    a = MPCController(spec, device=dev).rollout_jit([2.0, 0.0], 30)
    b = MPCController(spec, device=dev).rollout([2.0, 0.0], 30)
    assert a["converged"].all() and b["converged"].all()
    np.testing.assert_allclose(a["u"], b["u"], atol=5e-3)
