"""The streamed kernels' plain versions (K3 streamed updates, K4 streamed
whole solve) against the JAX package's Pallas kernels in interpret mode.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held to these plain versions on the GPU by ``tests/test_torch_cuda.py``.
Bars, each with its reason:

* K3, both modes: rtol = atol = 1e-5 after a few updates, the bar of
  ``tests/test_tiled_kernel.py`` — the two sides differ only in float32
  summation order (the bf16 products are exact in float32 on both).
* K4 / ``solve_fused_tiled``: converged verdicts equal; iteration counts
  equal on >= 97% of lanes in the unaccelerated cases (the same float
  program up to summation order — the bar of
  ``tests/test_tiled_solve_kernel.py``) and within the oracle bar
  max(5, iters/5) rounded up to whole checks with acceleration (its
  ``fYn <= fY`` acceptance flips on summation order near convergence,
  ROADMAP queue 3) and for the explicit gap on active constraints (see
  the case); U within 5e-3 * max(1, |U|max).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.config import SolverConfig as JConfig
from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.ops.tiled_kernel import \
    fused_pqp_iterations_tiled as j_k3
from pqp_for_mpc_tpu.ops.tiled_solve_kernel import \
    solve_fused_tiled as j_solve_fused_tiled
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu.solver import solve_batched as j_solve_batched
from pqp_for_mpc_tpu_torch import convert
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import tiled_kernel, tiled_solve_kernel


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _random_problem(N, M, B, seed, fp_scale):
    """The random PSD geometry of tests/test_tiled_kernel.py and
    tests/test_tiled_solve_kernel.py, built by the JAX package and carried
    to the port as NumPy arrays."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    Gp = rng.normal(0, 1, (N, M)).astype(np.float32)
    Fp = rng.normal(0, fp_scale, (M, B)).astype(np.float32)
    Kp = rng.uniform(1, 10, (N,)).astype(np.float32)
    jp = JPrimal(Qp=jnp.asarray(Qp), Qp_inv=jnp.asarray(np.linalg.inv(Qp)),
                 Fp=jnp.asarray(Fp), Mp=jnp.zeros((B,), jnp.float32),
                 Gp=jnp.asarray(Gp), Kp=jnp.asarray(Kp))
    jd = jdualize(jp)
    return (jp, jd,
            convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"),
            convert.dual_from_numpy(convert.to_numpy(jd), device="cpu"))


@pytest.mark.parametrize("N,B,iters", [
    (200, 72, 7),     # two 128-row slabs on the TPU side, odd T
    (256, 300, 8),    # exact slab tiling, several batch blocks
    (130, 40, 4),     # one slab
])
def test_k3_f32_plain_matches_jax_kernel(N, B, iters):
    jp, jd, tp, td = _random_problem(N, max(8, N // 3), B, N + B, 10.0)
    Y = np.full((N, B), 1000.0, np.float32)
    Fdn = np.broadcast_to(np.asarray(jd.Fdn), (N, B))
    Fdp = np.broadcast_to(np.asarray(jd.Fdp), (N, B))
    want = j_k3(jd.Qd, jd.theta, jnp.asarray(Fdn), jnp.asarray(Fdp),
                jnp.asarray(Y), num_iters=iters, interpret=True)
    got = tiled_kernel.fused_pqp_iterations_tiled(
        td.Qd, td.theta, torch.tensor(Fdn), torch.tensor(Fdp),
        torch.tensor(Y), num_iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _bf16_case():
    """The bf16 construction case of tests/test_tiled_kernel.py."""
    rng = np.random.default_rng(0)
    N, B = 160, 8
    Qd = rng.normal(0, 1, (N, N)).astype(np.float32)
    Qd = (Qd + Qd.T) / 2
    np.fill_diagonal(Qd, np.abs(np.diagonal(Qd)))
    theta = np.maximum(np.sum(np.maximum(-Qd, 0), axis=1), 5.0) \
        .astype(np.float32)
    Fdn = rng.uniform(0, 1, (N, B)).astype(np.float32)
    Fdp = rng.uniform(0, 1, (N, B)).astype(np.float32)
    Y0 = rng.uniform(0.5, 2, (N, B)).astype(np.float32)
    return Qd, theta, Fdn, Fdp, Y0


def test_k3_bf16_plain_matches_jax_kernel():
    args = _bf16_case()
    want = np.asarray(j_k3(*(jnp.asarray(a) for a in args), num_iters=5,
                           interpret=True, dtype="bfloat16"))
    got = tiled_kernel.fused_pqp_iterations_tiled(
        *(torch.tensor(a) for a in args), num_iters=5, dtype="bfloat16")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k3_bf16_products_keep_a_float32_sum():
    # torch.matmul of two bf16 tensors rounds its sum to bf16; the TPU's
    # preferred_element_type=f32 keeps float32.  The plain version must
    # take the float32 sum, and the bar above is tight enough to see the
    # difference: the rounded form misses the JAX kernel by far more.
    Qd, theta, Fdn, Fdp, Y0 = (torch.tensor(a) for a in _bf16_case())
    want = np.asarray(j_k3(*(jnp.asarray(a.numpy()) for a in
                             (Qd, theta, Fdn, Fdp, Y0)),
                           num_iters=1, interpret=True, dtype="bfloat16"))
    Q, th = tiled_kernel.streamed_matrix(Qd, theta, "bfloat16")
    got = tiled_kernel.streamed_pqp_iterations_reference(Q, th, Fdn, Fdp, Y0,
                                                         num_iters=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    yb, tY = Y0.bfloat16(), th[:, None] * Y0
    q_neg = torch.clamp(-Q, min=0)
    q_pos = torch.clamp(Q, min=0)
    rounded = ((q_neg @ yb).float() + tY + Fdn) \
        / ((q_pos @ yb).float() + tY + Fdp) * Y0
    rel = np.abs(rounded.numpy() - want) / np.abs(want)
    assert rel.max() > 1e-3


def test_streamed_matrix_construction():
    Qd, theta, _, _, _ = (torch.tensor(a) for a in _bf16_case())
    Qd[3, 3] = -1e-7                       # float-noise negative diagonal
    Q, th = tiled_kernel.streamed_matrix(Qd, theta, "float32")
    assert Q.dtype == torch.float32
    torch.testing.assert_close(torch.diagonal(Q),
                               torch.clamp(torch.diagonal(Qd), min=0) + theta,
                               rtol=0, atol=0)
    off = ~torch.eye(Qd.shape[0], dtype=torch.bool)
    assert bool((Q[off] == Qd[off]).all())
    torch.testing.assert_close(th, theta, rtol=0, atol=0)
    Qb, thb = tiled_kernel.streamed_matrix(Qd, theta, "bfloat16")
    assert Qb.dtype == torch.bfloat16 and float(Qb[3, 3]) == 0.0
    # theta dominates the ROUNDED negative rowsums, and the split of the one
    # rounded matrix is exact
    rs = torch.clamp(-Qb.float(), min=0).sum(dim=1)
    assert bool((thb >= rs).all()) and bool((thb >= theta).all())
    assert bool((torch.clamp(Qb.float(), min=0)
                 - torch.clamp(-Qb.float(), min=0) == Qb.float()).all())
    with pytest.raises(ValueError, match="dtype"):
        tiled_kernel.streamed_matrix(Qd, theta, "float16")


def _k4_parity(got, want, check_every, oracle_bar):
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    it_g = got.iters.numpy().astype(np.int64)
    if oracle_bar:
        bar = np.maximum(5, it_w // 5)
        bar = -(-bar // check_every) * check_every
        assert (np.abs(it_g - it_w) <= bar).all(), (it_g, it_w)
    else:
        assert (it_g == it_w).mean() >= 0.97, (it_g, it_w)
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


K4_CASES = {
    # the cases of tests/test_tiled_solve_kernel.py: N=384 spans three
    # 128-row slabs there, B=72 pads its batch block.  From y0 = 1000 no
    # lane certifies within 4000 iterations (on both sides), so the
    # iterates and U at max_iters are compared
    "explicit_gap": (SolverConfig(max_iters=4000, check_every=8), 72, 3,
                     3.0),
    "complementarity_gap": (SolverConfig(
        max_iters=4000, check_every=8, strict_weak_duality=False,
        gap_from_complementarity=True), 72, 3, 3.0),
    # a cold start that certifies every lane (~90 iterations)
    "complementarity_gap_y0_10": (SolverConfig(
        max_iters=4000, check_every=8, strict_weak_duality=False,
        gap_from_complementarity=True, y0=10.0), 72, 3, 3.0),
    "accel": (SolverConfig(max_iters=4000, check_every=8, accel_every=8,
                           strict_weak_duality=False,
                           gap_from_complementarity=True), 40, 5, 3.0),
    # the explicit gap on lanes with active constraints (Fp ~ N(0, 30^2)),
    # certified at 1e-4: every lane certifies.  With all constraints
    # inactive a lane's Y underflows to 0 and Jp + Jd is rounding noise
    "explicit_gap_active": (SolverConfig(
        max_iters=4000, check_every=8, y0=10.0, erc=1e-4, eac=1e-4,
        eaj=1e-4, erj=1e-4, strict_weak_duality=False), 72, 3, 30.0),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_plain_matches_jax_solve_fused_tiled(case):
    cfg, B, seed, fp_scale = K4_CASES[case]
    jp, jd, tp, td = _random_problem(384, 128, B, seed, fp_scale)
    want = j_solve_fused_tiled(jp, jd, cfg=_jcfg(cfg), interpret=True)
    got = tiled_solve_kernel.solve_fused_tiled(tp, td, cfg=cfg)
    if case in ("complementarity_gap_y0_10", "accel", "explicit_gap_active"):
        assert bool(np.asarray(want.converged).all())
    # the explicit gap Jp + Jd cancels two costs of |J| ~ 1e3 on lanes with
    # active constraints, so summation order moves the check at which it
    # crosses the tolerance: the oracle bar, as with acceleration
    _k4_parity(got, want, cfg.check_every,
               cfg.accel_every > 0 or case == "explicit_gap_active")


def test_k4_warm_start_exits_at_the_first_check():
    """A warm start at the solution certifies at the first check (the early
    exit) and returns it untouched, as the JAX kernel does."""
    jp, jd, tp, td = _random_problem(256, 96, 32, 3, 3.0)
    cfg = SolverConfig(max_iters=4000, check_every=8, y0=10.0,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    ref = j_solve_batched(jp, jd, cfg=_jcfg(cfg))
    conv = np.asarray(ref.converged)
    assert conv.mean() > 0.9
    Y0 = np.asarray(ref.Y)
    want = j_solve_fused_tiled(jp, jd, Y0=jnp.asarray(Y0), cfg=_jcfg(cfg),
                               interpret=True)
    got = tiled_solve_kernel.solve_fused_tiled(tp, td, Y0=torch.tensor(Y0),
                                               cfg=cfg)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    first = conv & (got.iters.numpy() == 1)
    assert first.mean() >= 0.7
    np.testing.assert_array_equal(got.Y.numpy()[:, first], Y0[:, first])


def test_k4_rejects_bad_config():
    jp, jd, tp, td = _random_problem(256, 96, 8, 3, 3.0)
    with pytest.raises(ValueError, match="even check_every"):
        tiled_solve_kernel.solve_fused_tiled(
            tp, td, cfg=SolverConfig(check_every=7))
    with pytest.raises(ValueError, match="accel_every"):
        tiled_solve_kernel.solve_fused_tiled(
            tp, td, cfg=SolverConfig(check_every=8, accel_every=4))


def test_cpu_tensors_leave_streamed_counters_at_zero():
    jp, jd, tp, td = _random_problem(160, 48, 8, 1, 3.0)
    k3, k4 = (tiled_kernel.streamed_pqp_iterations,
              tiled_solve_kernel.fused_full_solve_tiled)
    k3.launches.update(float32=0, bfloat16=0)
    k4.launches = 0
    Y = torch.full((160, 8), 10.0)
    for dtype in ("float32", "bfloat16"):
        tiled_kernel.fused_pqp_iterations_tiled(td.Qd, td.theta, td.Fdn,
                                                td.Fdp, Y, 2, dtype=dtype)
    tiled_solve_kernel.solve_fused_tiled(tp, td, cfg=SolverConfig(
        max_iters=16, check_every=8))
    assert k3.launches == {"float32": 0, "bfloat16": 0}
    assert k4.launches == 0


def test_k3_bf16_tile_plan():
    plan = tiled_kernel.k3_bf16_plan
    # the streamed workload fills the card: one block per SM at least
    p = plan(4096, 128)
    assert p["blocks"] >= 132 and p["staged_by_cp_async"]
    assert (p["tile_rows"], p["tile_lanes"]) == (32, 64)
    # the H=64 closed loop (B = 1) and a ragged shape: one valid plan each
    for n, B in ((256, 1), (203, 5)):
        p = plan(n, B)
        assert p["tile_rows"] in (16, 32, 64) and p["tile_lanes"] in (16, 32,
                                                                      64)
        assert p["tile_lanes"] >= B and not p["staged_by_cp_async"]
        assert p["blocks"] == -(-n // p["tile_rows"])
    with pytest.raises(ValueError):
        plan(0, 4)


@pytest.mark.parametrize("n", [200, 4096])
@pytest.mark.parametrize("B", [1, 5, 72, 128])
def test_k3_f32_tile_plan(n, B):
    p = tiled_kernel.k3_f32_plan(n, B)
    lanes = p["tile_lanes"]
    assert p["tile_rows"] == 32 and lanes in (32, 64, 128)
    assert p["threads"] == 256
    assert p["blocks"] == -(-n // 32) * -(-B // lanes)
    # the FMA tile's lanes for the batch, as K4's
    assert lanes == tiled_kernel.fma_tile_lanes(B)
    assert lanes == tiled_solve_kernel.k4_plan(n, n // 4, B)["tile_lanes"]
    # the ring of three 64-deep slabs fits a block's 227 KB
    assert p["smem_bytes"] == 4 * 3 * (2304 + 64 * lanes) <= 232448
    assert p["staged_by_cp_async"] == (n % 4 == 0 and B % 4 == 0)


def test_k3_f32_tile_plan_measured_shapes():
    # N=4096, B=128: 128 blocks of 32 x 128 (123 KB each), one per SM, Q
    # read once per update; N=1024, B=128: 32 blocks of 32 x 128
    plan = tiled_kernel.k3_f32_plan
    p = plan(4096, 128)
    assert (p["tile_lanes"], p["blocks"], p["smem_bytes"]) == (128, 128,
                                                                125952)
    assert p["staged_by_cp_async"]
    assert (plan(1024, 128)["tile_lanes"], plan(1024, 128)["blocks"]) == (
        128, 32)
    with pytest.raises(ValueError):
        plan(0, 4)


def test_k4_plain_carries_a_nan_lane_like_jax():
    # a NaN entry of Y0 stays in its own lane on both sides: the lane passes
    # the in-kernel test at the first check (every comparison with NaN is
    # false) and the rescue's verdict leaves it unconverged; the other
    # lanes solve as without it.  The card's K4 is held to the plain
    # version's NaN lanes (tests/test_torch_cuda.py)
    jp, jd, tp, td = _random_problem(256, 96, 8, 3, 3.0)
    cfg = SolverConfig(max_iters=200, check_every=8, y0=10.0,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    Y0 = np.full((256, 8), 10.0, np.float32)
    Y0[7, 2] = np.nan
    want = j_solve_fused_tiled(jp, jd, Y0=jnp.asarray(Y0), cfg=_jcfg(cfg),
                               interpret=True)
    got = tiled_solve_kernel.solve_fused_tiled(tp, td, Y0=torch.tensor(Y0),
                                               cfg=cfg)
    nan_lanes = np.isnan(np.asarray(want.Y)).any(axis=0)
    assert nan_lanes.tolist() == [b == 2 for b in range(8)]
    np.testing.assert_array_equal(np.isnan(got.Y.numpy()).any(axis=0),
                                  nan_lanes)
    np.testing.assert_array_equal(np.isnan(got.U.numpy()).any(axis=0),
                                  np.isnan(np.asarray(want.U)).any(axis=0))
    assert not bool(got.converged[2]) and int(got.iters[2]) == 1
    _k4_parity(got, want, cfg.check_every, False)


@pytest.mark.parametrize("n,m,B", [(4096, 1024, 128), (1024, 256, 128),
                                   (200, 64, 72), (203, 50, 40),
                                   (256, 64, 5), (384, 128, 300)])
def test_k4_plan(n, m, B):
    p = tiled_solve_kernel.k4_plan(n, m, B)
    lanes = p["tile_lanes"]
    assert p["tile_rows"] == 32 and lanes in (32, 64, 128)
    # the narrowest lane tile that holds the batch: each row of Qd_hat is
    # streamed once per update up to B = 128
    assert lanes >= min(B, 128) and (lanes == 32 or lanes // 2 < B)
    assert p["q_reads_per_update"] == -(-B // lanes)
    assert p["q_reads_per_update"] == 1 or B > 128
    assert p["blocks"] == -(-n // 32) * p["q_reads_per_update"]
    assert p["check_tiles"] == p["blocks"] + -(-m // 32) * -(-B // lanes)
    assert p["vector_staging"] == (n % 4 == 0 and m % 4 == 0 and B % 4 == 0)
    assert p["smem_bytes"] <= 232448


def test_k4_plan_streamed_workload():
    # N=4096/M=1024/B=128: 128 tiles of 32 x 128 for 132 SMs, Q read once
    # per update, 16-byte staging; the ring of three 64-deep slabs in 123 KB
    p = tiled_solve_kernel.k4_plan(4096, 1024, 128)
    assert (p["tile_lanes"], p["blocks"], p["q_reads_per_update"]) == (
        128, 128, 1)
    assert p["vector_staging"] and p["smem_bytes"] == 125952
    for bad in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError):
            tiled_solve_kernel.k4_plan(*bad)
