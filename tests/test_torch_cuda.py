"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
host without JAX (``--noconftest`` skips the JAX set-up of conftest.py):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Bars: K2 at rtol/atol 1e-5 after 8 updates (as ``tests/test_kernels.py``);
K1 with equal lane states, iterations within max(5, iters/5) rounded up to
whole checks, and U within 5e-3 * max(1, |U|max) — the kernel sums in
another order than the plain version's matrix products.  With acceleration
the iteration bar holds on 99% of lanes: the accel step is kept when
f(Y_new) <= f(Y), two float32 values that agree to rounding near the
optimum, so two correct summation orders can take different steps and a
rare lane's trajectory (never its state or U bar) drifts further.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu_torch import dualize
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu_torch.ops import kernels, solve_kernel

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


def test_past_the_resident_kernels_cuda_raises(dev):
    # N = 132: the kernels' port stops at N = 128, and the streamed engines
    # are not ported, so a CUDA problem there raises instead of running
    # without a kernel
    import pqp_for_mpc_tpu_torch as pqp
    primal, dual = _workload(dev, 33, 256)
    with pytest.raises(NotImplementedError, match="K3"):
        pqp.solve_batched(primal, dual,
                          cfg=dataclasses.replace(SMOKE, use_pallas=True))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        pqp.solve_auto(primal, dual, cfg=SMOKE)
    res = pqp.solve_auto(primal, dual, cfg=dataclasses.replace(
        SMOKE, max_iters=16), engine="xla")
    assert res.U.shape == (primal.n_var, 256)


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
