"""The streamed distinct-geometry kernels' plain versions — K6 (whole solve)
and K7 (updates) — against the JAX package's Pallas kernels in interpret
mode, and the slice as a whole: ``solve_mixed`` on 3-D ``Qd`` riding K7.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held to these plain versions on the GPU by ``tests/test_torch_cuda.py``.
Bars, each with its reason:

* K7, both modes: rtol 2e-5, atol 2e-6 after five updates, the bar of
  ``tests/test_distinct_tiled_kernel.py`` — the two sides differ only in
  float32 summation order (the bf16 products are exact in float32 on both);
* K6: converged verdicts equal, U to 1e-4 relative plus 2e-3 on lanes both
  certify, and iteration counts within the oracle bar max(5, iters/5)
  rounded up to whole checks (the JAX test holds the kernel against its
  einsum path to equal counts on 3 of 4 lanes; a verdict at a check can
  move one check on float32 summation order, and with acceleration the
  ``f(Y_new) <= f(Y)`` acceptance can flip, ROADMAP queue 3);
* the slice: the oracle bar of ``tests/test_torch_mixed.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import solver as jsolver
from pqp_for_mpc_tpu.config import SolverConfig as JConfig
from pqp_for_mpc_tpu.dual import dualize_distinct as j_dualize_distinct
from pqp_for_mpc_tpu.ops import distinct_kernel as j_distinct_kernel
from pqp_for_mpc_tpu.ops.distinct_tiled_kernel import (
    fused_pqp_iterations_distinct_tiled as j_k7,
    solve_fused_distinct_tiled as j_solve_fused_distinct_tiled)
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
import pqp_for_mpc_tpu_torch as pqp
from pqp_for_mpc_tpu_torch import convert, solver as tsolver
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import distinct_kernel, distinct_tiled_kernel


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _distinct_problem(B, M, N, seed=0):
    """tests/test_distinct_tiled_kernel.py's gaussian-Gp instances with a
    split-free dual: (JAX primal, JAX dual, port primal, port dual)."""
    rng = np.random.default_rng(seed)
    Qps, Gps, Fps, Kps = [], [], [], []
    for _ in range(B):
        L = rng.standard_normal((M, M)).astype(np.float32)
        Qps.append(L @ L.T + M * np.eye(M, dtype=np.float32))
        Gps.append(rng.standard_normal((N, M)).astype(np.float32))
        Fps.append(rng.standard_normal(M).astype(np.float32) * 3)
        Kps.append(rng.uniform(1.0, 8.0, N).astype(np.float32))
    jp = JPrimal(
        Qp=jnp.asarray(np.stack(Qps)),
        Qp_inv=jnp.asarray(np.stack([np.linalg.inv(q) for q in Qps])
                           .astype(np.float32)),
        Fp=jnp.asarray(np.stack(Fps, axis=1)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(np.stack(Gps)),
        Kp=jnp.asarray(np.stack(Kps, axis=1)))
    jd = j_dualize_distinct(jp, materialize_splits=False)
    return (jp, jd,
            convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"),
            convert.dual_from_numpy(convert.to_numpy(jd), device="cpu"))


def _k6_parity(got, want, check_every):
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    assert conv.any()
    np.testing.assert_allclose(got.U.numpy()[:, conv],
                               np.asarray(want.U)[:, conv],
                               rtol=1e-4, atol=2e-3)
    it_w = np.asarray(want.iters).astype(np.int64)
    bar = -(-np.maximum(5, it_w // 5) // check_every) * check_every
    assert (np.abs(got.iters.numpy() - it_w) <= bar).all(), \
        (got.iters, it_w)


# y0 = 10 certifies every lane of the unaccelerated cases within ~100
# iterations; from the default y0 = 1000 none certifies in 4,000
K6_CASES = {
    "explicit_gap": (0, SolverConfig(max_iters=4000, check_every=8, y0=10.0,
                                     strict_weak_duality=True)),
    "complementarity_gap": (0, SolverConfig(
        max_iters=4000, check_every=8, y0=10.0, strict_weak_duality=False,
        gap_from_complementarity=True)),
    "accel": (2, SolverConfig(max_iters=4000, check_every=8, accel_every=8,
                              strict_weak_duality=False,
                              gap_from_complementarity=True)),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_plain_matches_jax_kernel(case):
    # N = 384 spans three of the TPU kernel's row slabs
    seed, cfg = K6_CASES[case]
    jp, jd, tp, td = _distinct_problem(B=4, M=128, N=384, seed=seed)
    want = j_solve_fused_distinct_tiled(jp, jd, cfg=_jcfg(cfg),
                                        interpret=True)
    before = distinct_tiled_kernel.fused_full_solve_distinct_tiled.launches
    got = pqp.solve_fused_distinct_tiled(tp, td, cfg=cfg)
    assert (distinct_tiled_kernel.fused_full_solve_distinct_tiled.launches
            == before)
    _k6_parity(got, want, cfg.check_every)


def test_k6_per_instance_early_exit():
    """Warm-started from its own solution every instance certifies at its
    first check, in both packages."""
    jp, jd, tp, td = _distinct_problem(B=3, M=96, N=256, seed=7)
    cfg = SolverConfig(max_iters=4000, check_every=8,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    cold = pqp.solve_fused_distinct_tiled(tp, td, cfg=cfg)
    assert bool(cold.converged.all())
    warm = pqp.solve_fused_distinct_tiled(tp, td, Y0=cold.Y, cfg=cfg)
    assert bool((warm.iters <= 1 + cfg.check_every).all()), warm.iters
    want = j_solve_fused_distinct_tiled(jp, jd, Y0=jnp.asarray(cold.Y.numpy()),
                                        cfg=_jcfg(cfg), interpret=True)
    np.testing.assert_array_equal(warm.iters.numpy(), np.asarray(want.iters))


def test_k6_value_errors():
    _, _, tp, td = _distinct_problem(B=2, M=32, N=64)
    with pytest.raises(ValueError, match="accel_every"):
        pqp.solve_fused_distinct_tiled(
            tp, td, cfg=SolverConfig(check_every=8, accel_every=4))
    with pytest.raises(ValueError, match=r"needs Qd \(B, N, N\)"):
        pqp.solve_fused_distinct_tiled(
            tp, dataclasses.replace(td, Qd=td.Qd[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,B", [(2048, 8), (200, 3), (203, 5), (4096, 1),
                                 (400, 1024), (58112, 2)])
def test_k7_plan_fits_and_covers_every_row(n, B, dtype):
    plan = distinct_tiled_kernel.k7_plan(n, B, dtype)
    size = 2 if dtype == "bfloat16" else 4
    assert plan["smem_bytes"] <= distinct_tiled_kernel.SMEM_LIMIT_BYTES
    assert 0 <= plan["resident_rows"] <= plan["rows_per_block"]
    assert plan["blocks"] * plan["rows_per_block"] >= B * n
    assert plan["matrix_bytes"] == B * n * n * size
    assert plan["resident_bytes"] + plan["l2_remainder_bytes"] \
        == plan["matrix_bytes"]
    # every row of a block fits, or shared memory is full
    spare = distinct_tiled_kernel.SMEM_LIMIT_BYTES - plan["smem_bytes"]
    assert plan["resident_rows"] == plan["rows_per_block"] \
        or spare < n * size


def test_k7_plan_at_the_path_shape():
    # bench_mixed.py --distinct: B = 8, N = 2048 on 132 SMs; 125 rows a
    # block, 55 of them resident in bf16 (44% of the 67 MB), 27 in f32
    bf, f32 = (distinct_tiled_kernel.k7_plan(2048, 8, d)
               for d in ("bfloat16", "float32"))
    assert (bf["blocks"], bf["rows_per_block"], bf["resident_rows"]) \
        == (132, 125, 55)
    assert bf["l2_remainder_bytes"] == 37371904
    assert f32["resident_rows"] == 27 and f32["l2_remainder_bytes"] > 50e6
    assert bf["vector_rows"] and f32["vector_rows"]


@pytest.mark.parametrize("n,m,B", [(2048, 512, 8), (2048, 512, 2),
                                   (200, 50, 3), (203, 51, 3),
                                   (1024, 256, 3), (400, 100, 1024),
                                   (8192, 2048, 2), (5, 3, 2)])
def test_k6_plan_fits_and_covers_every_row(n, m, B):
    plan = distinct_tiled_kernel.k6_plan(n, m, B)
    P = plan["blocks_per_instance"]
    assert plan["smem_bytes"] <= distinct_tiled_kernel.SMEM_LIMIT_BYTES
    assert plan["blocks"] == plan["slots"] * P <= 132
    assert plan["slots"] <= B and plan["waves"] * plan["slots"] >= B
    assert plan["rows_per_block"] == -(-n // P)
    # resident rows and the streamed rest cover every row once
    base, rem = divmod(n, P)
    kept = sum(min(base + (k < rem), plan["resident_rows"])
               for k in range(P))
    assert kept + plan["streamed_rows"] == n
    assert plan["ranks"] <= min(16, n)
    assert plan["exchange_floats"] >= max(2 * n + m, plan["ranks"] * m)


def test_k6_plan_at_the_path_shape_and_grouped():
    # the path's shape: two instances side by side, each over 66 blocks
    # with 19 of its 32 rows a block resident; the 2 x 794 streamed rows
    # (13 MB) within the L2 budget, three instances' (30 MB) past it
    path = distinct_tiled_kernel.k6_plan(2048, 512, 8)
    assert (path["slots"], path["blocks_per_instance"], path["waves"]) \
        == (2, 66, 4)
    assert (path["rows_per_block"], path["resident_rows"]) == (32, 19)
    assert path["streamed_rows"] == 794 and path["ranks"] == 16
    assert 2 * path["streamed_rows"] * 4 * 2048 \
        <= distinct_tiled_kernel.K6_L2_BUDGET
    # every row resident when the card holds them: one wave of three
    assert distinct_tiled_kernel.k6_plan(1024, 256, 3)["streamed_rows"] == 0
    # small N, large B: many instances side by side, each on a few blocks
    small = distinct_tiled_kernel.k6_plan(400, 100, 1024)
    assert small["slots"] == 64 and small["blocks_per_instance"] == 2
    assert small["waves"] == 16
    assert path["staged"] and small["staged"]
    # past the staged layout: the reductions read their rows from L2
    big = distinct_tiled_kernel.k6_plan(8192, 2048, 2)
    assert not big["staged"] and big["streamed_rows"] > 0


def _k7_case():
    """tests/test_distinct_tiled_kernel.py's update case: B=3, N=200."""
    rng = np.random.default_rng(0)
    B, N = 3, 200
    G = rng.standard_normal((B, N, 24)).astype(np.float32)
    Qd = (np.einsum("bik,bjk->bij", G, G) * 0.05).astype(np.float32)
    theta = np.maximum(np.maximum(-Qd, 0).sum(2), 5.0).astype(np.float32)
    Fdn = np.abs(rng.standard_normal((N, B))).astype(np.float32)
    Fdp = (np.abs(rng.standard_normal((N, B))) + 0.5).astype(np.float32)
    Y = np.abs(rng.standard_normal((N, B))).astype(np.float32)
    return Qd, theta, Fdn, Fdp, Y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_matches_jax_kernel(dtype):
    args = _k7_case()
    want = np.asarray(j_k7(*(jnp.asarray(a) for a in args), num_iters=5,
                           interpret=True, dtype=dtype))
    k7 = distinct_tiled_kernel.distinct_streamed_iterations
    before = dict(k7.launches)
    got = distinct_tiled_kernel.fused_pqp_iterations_distinct_tiled(
        *(torch.tensor(a) for a in args), num_iters=5, dtype=dtype)
    assert k7.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_k7_theta_raise_is_a_no_op_on_solve_mixed_theta():
    """solve_mixed's distinct phase-1 problem is one problem whichever
    engine takes a step: the stream's theta raise leaves the theta that
    solve_mixed builds from the ROUNDED rowsums as it is."""
    rng = np.random.default_rng(1)
    B, N = 2, 160
    G = rng.standard_normal((B, N, 16)).astype(np.float32)
    Qd = torch.tensor(np.einsum("bik,bjk->bij", G, G) * 0.1)
    Qc = Qd.clone()
    torch.diagonal(Qc, dim1=1, dim2=2).clamp_(min=0.0)
    rs = torch.clamp(-Qc.bfloat16().float(), min=0.0).sum(dim=2)
    theta = torch.clamp(rs, min=5.0)
    Qb, raised = distinct_tiled_kernel.distinct_streamed_matrix(
        Qd, theta, "bfloat16")
    torch.testing.assert_close(raised, theta, rtol=0, atol=0)
    torch.testing.assert_close(Qb, Qc.bfloat16(), rtol=0, atol=0)
    Qh, th = distinct_tiled_kernel.distinct_streamed_matrix(Qd, theta)
    torch.testing.assert_close(torch.diagonal(Qh, dim1=1, dim2=2),
                               torch.diagonal(Qc, dim1=1, dim2=2) + theta,
                               rtol=0, atol=0)


def _mixed_problem():
    """tests/test_mixed_precision.py's distinct problem: B=3, M=16, N=48."""
    rng = np.random.default_rng(2)
    B, M, N = 3, 16, 48
    Qps = []
    for _ in range(B):
        Q = rng.normal(0, 1, (M, M)).astype(np.float32)
        Qps.append(Q @ Q.T + M * np.eye(M, dtype=np.float32))
    jp = JPrimal(
        Qp=jnp.asarray(np.stack(Qps)),
        Qp_inv=jnp.asarray(np.stack([np.linalg.inv(q) for q in Qps])
                           .astype(np.float32)),
        Fp=jnp.asarray(rng.normal(0, 2, (M, B)).astype(np.float32)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(rng.normal(0, 1, (B, N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1, 5, (N, B)).astype(np.float32)))
    jd = j_dualize_distinct(jp)
    return (jp, jd,
            convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"),
            convert.dual_from_numpy(convert.to_numpy(jd), device="cpu"))


# tests/test_mixed_precision.py's cfg with y0 = 300: ~200 iterations in
# all, of which the bf16 phase takes most, where the default y0 = 1000 takes
# ~850 — the JAX kernel's interpret mode costs ~15 ms per update here
MIXED_CFG = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                         y0=300.0, strict_weak_duality=False,
                         gap_from_complementarity=True)


def _mixed_parity(got, want, check_every):
    conv = np.asarray(want.converged)
    assert conv.all()
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    bar = -(-np.maximum(5, it_w // 5) // check_every) * check_every
    assert (np.abs(got.iters.numpy() - it_w) <= bar).all(), \
        (got.iters, it_w)
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


def test_slice_solve_mixed_distinct_rides_k7(monkeypatch):
    """The slice as a whole: with ``use_pallas`` and the residency lines
    patched so that N = 48 counts as past them in both packages, the port's
    bulk phase runs K7's bf16 mode (its plain version here) and the JAX
    package its Pallas kernel in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    jp, jd, tp, td = _mixed_problem()
    cfg = dataclasses.replace(MIXED_CFG, use_pallas=True)
    monkeypatch.setattr(j_distinct_kernel, "distinct_fits_vmem",
                        lambda n, m: False)
    monkeypatch.setattr(distinct_kernel, "distinct_fits_resident",
                        lambda n, m: False)
    with pltpu.force_tpu_interpret_mode():
        want = jsolver.solve_mixed(jp, jd, cfg=_jcfg(cfg))
    calls = []
    real = distinct_tiled_kernel.distinct_streamed_iterations_reference

    def spy(Q, *args, **kwargs):
        calls.append(Q.dtype)
        return real(Q, *args, **kwargs)

    monkeypatch.setattr(distinct_tiled_kernel,
                        "distinct_streamed_iterations_reference", spy)
    got = tsolver.solve_mixed(tp, td, cfg=cfg)
    assert calls and set(calls) == {torch.bfloat16}
    _mixed_parity(got, want, cfg.check_every)


def test_slice_solve_mixed_distinct_without_kernel():
    jp, jd, tp, td = _mixed_problem()
    want = jsolver.solve_mixed(jp, jd, cfg=_jcfg(MIXED_CFG))
    got = tsolver.solve_mixed(tp, td, cfg=MIXED_CFG)
    _mixed_parity(got, want, MIXED_CFG.check_every)
