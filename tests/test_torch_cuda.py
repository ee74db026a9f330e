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
state or U bar) drifts further.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu_torch import dualize
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import (kernels, solve_kernel, tiled_kernel,
                                       tiled_solve_kernel)
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
