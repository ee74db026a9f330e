"""Distinct geometry in the port — one geometry per instance — against the
JAX package: ``dualize_distinct``, ``solve_batched`` on 3-D ``Qd`` (the
per-instance products), and the whole-solve kernel K5's plain version with
its wrapper ``solve_fused_distinct`` against the JAX Pallas kernel in
interpret mode.

Inputs come from NumPy seeds (``tests/test_distinct_kernel.py``'s
instances), are built by the JAX package and carried to the port with
``convert``.  Bars, each with its reason:

* ``dualize_distinct``: every field to 1e-5 relative (``Md`` scaled by
  |Mp|: ``Fp'Qp^-1 Fp - Mp`` cancels terms of that size) — the two
  frameworks' batched products sum in another order;
* ``solve_batched``: converged verdicts equal, iterations within the
  oracle bar max(5, iters/5) rounded up to whole checks, U within
  5e-3 * max(1, |U|max) (``tests/test_native_oracle.py``'s bar);
* K5: the bars of ``tests/test_distinct_kernel.py`` between the kernel and
  the einsum path — iterations within max(16, 2%) (no acceleration) or
  max(8, 10%) (with it: the accel step's ``f(Y_new) <= f(Y)`` acceptance
  flips on summation order near the optimum), U to 1e-4 relative plus
  2e-3 — with converged verdicts equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu.config import SolverConfig as JConfig
from pqp_for_mpc_tpu.dual import dualize_distinct as j_dualize_distinct
from pqp_for_mpc_tpu.ops.distinct_kernel import \
    solve_fused_distinct as j_solve_fused_distinct
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu.solver import solve_batched as j_solve_batched
import pqp_for_mpc_tpu_torch as pqp
from pqp_for_mpc_tpu_torch import convert, solver as tsolver
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.ops import distinct_kernel


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def _instances(B=5, M=6, N=16, seed=0):
    """tests/test_distinct_kernel.py's instances, stacked: the JAX primal
    with matrices (B, ., .) and vectors (., B)."""
    rng = np.random.default_rng(seed)
    Qp, Qpi, Fp, Mp, Gp, Kp = [], [], [], [], [], []
    for _ in range(B):
        L = rng.standard_normal((M, M)).astype(np.float32)
        q = L @ L.T + M * np.eye(M, dtype=np.float32)
        Qp.append(q)
        Qpi.append(np.linalg.inv(q).astype(np.float32))
        Fp.append(rng.standard_normal(M).astype(np.float32) * 3)
        Mp.append(np.float32(rng.standard_normal()))
        Gp.append(rng.integers(-1, 2, (N, M)).astype(np.float32))
        Kp.append(rng.uniform(1.0, 8.0, N).astype(np.float32))
    return JPrimal(Qp=jnp.asarray(np.stack(Qp)),
                   Qp_inv=jnp.asarray(np.stack(Qpi)),
                   Fp=jnp.asarray(np.stack(Fp, axis=1)),
                   Mp=jnp.asarray(np.stack(Mp)),
                   Gp=jnp.asarray(np.stack(Gp)),
                   Kp=jnp.asarray(np.stack(Kp, axis=1)))


def _both(jp, materialize=True):
    """(JAX dual, port primal, port dual) for a JAX distinct primal."""
    jd = j_dualize_distinct(jp, materialize_splits=materialize)
    tp = convert.primal_from_numpy(convert.to_numpy(jp), device="cpu")
    td = convert.dual_from_numpy(convert.to_numpy(jd), device="cpu")
    return jd, tp, td


def _oracle_parity(got, want, check_every):
    conv = np.asarray(want.converged)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    it_w = np.asarray(want.iters).astype(np.int64)
    bar = np.maximum(5, it_w // 5)
    bar = -(-bar // check_every) * check_every
    assert (np.abs(got.iters.numpy() - it_w) <= bar).all(), \
        (got.iters, it_w)
    scale = max(1.0, float(np.abs(np.asarray(want.U)).max()))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               atol=5e-3 * scale, rtol=5e-3)


@pytest.mark.parametrize("materialize", [True, False])
def test_dualize_distinct_matches_jax(materialize):
    jp = _instances()
    want = j_dualize_distinct(jp, materialize_splits=materialize)
    tp = convert.primal_from_numpy(convert.to_numpy(jp), device="cpu")
    assert tp.Gp.shape == (5, 16, 6) and tp.Qp.shape == (5, 6, 6)
    got = pqp.dualize_distinct(tp, materialize_splits=materialize)
    assert got.Qd.shape == (5, 16, 16) and got.theta.shape == (5, 16)
    mp_scale = float(np.abs(np.asarray(jp.Mp)).max())
    for field, w in convert.to_numpy(want).items():
        g = getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        scale = max(1.0, float(np.abs(w).max()))
        if field == "Md":
            scale = max(scale, mp_scale)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=field)


def test_dualize_distinct_shared_forcing_broadcasts():
    # a shared Fp (M,) and Kp (N,) broadcast over the instances, as in JAX
    jp = _instances(B=3)
    jp1 = dataclasses.replace(jp, Fp=jp.Fp[:, 0], Kp=jp.Kp[:, 0])
    want = j_dualize_distinct(jp1)
    got = pqp.dualize_distinct(
        convert.primal_from_numpy(convert.to_numpy(jp1), device="cpu"))
    assert got.Fd.shape == (16, 3)
    np.testing.assert_allclose(got.Fd.numpy(), np.asarray(want.Fd),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accel", [False, True])
def test_solve_batched_distinct_matches_jax(accel):
    jp = _instances()
    jd, tp, td = _both(jp)
    cfg = SolverConfig(max_iters=20_000, check_every=4,
                       accel_every=4 if accel else 0,
                       strict_weak_duality=False)
    want = j_solve_batched(jp, jd, cfg=_jcfg(cfg))
    got = pqp.solve_batched(tp, td, cfg=cfg)
    assert np.asarray(want.converged).all()
    _oracle_parity(got, want, cfg.check_every)
    # use_pallas is ignored on 3-D Qd (the update kernels take shared
    # geometry), as in the JAX package: the same iterates exactly
    again = pqp.solve_batched(tp, td,
                              cfg=dataclasses.replace(cfg, use_pallas=True))
    torch.testing.assert_close(again.U, got.U, rtol=0, atol=0)


def test_split_free_distinct_dual_raises_by_name():
    # the JAX solver fails here with a shape TypeError (its solver.py:119);
    # the port refuses with a ValueError that names it
    jp = _instances(B=3)
    _, tp, td = _both(jp, materialize=False)
    assert td.Qdn_theta is None and td.theta.shape == (3, 16)
    cfg = SolverConfig(max_iters=200, check_every=4)
    for fn in (pqp.solve_batched, pqp.solve_mixed):
        with pytest.raises(ValueError, match="split-free distinct"):
            fn(tp, td, cfg=cfg)
    with pytest.raises(ValueError, match="split-free distinct"):
        tsolver.pqp_update(td, torch.ones(16, 3))


def test_distinct_fits_resident_is_the_tpu_budget():
    fits = distinct_kernel.distinct_fits_resident
    assert fits(400, 100)                   # bench_distinct's workload: K5
    assert not fits(2048, 512)              # bench_mixed --distinct
    assert fits(1200, 300) and not fits(1210, 302)   # crosses near 1,200
    # K5 itself holds any N whose plan exists: past the router's line it
    # streams its rows, up to the vectors of 16 blocks per instance
    assert distinct_kernel.fits_kernel(5256, 1314)
    n_max = distinct_kernel.K5_N_MAX
    assert distinct_kernel.fits_kernel(n_max, -(-n_max // 4))
    assert not distinct_kernel.fits_kernel(n_max + 4, -(-(n_max + 4) // 4))


def test_k5_plan_resident_and_streamed():
    plan = distinct_kernel.k5_plan
    # bench_distinct's workload: its Qd rows resident at 4, 8 or 16 blocks
    # per instance
    p = plan(400, 100)
    assert p["resident"] and sorted(p["sizes"]) == [4, 8, 16]
    # past the cluster's capacity: the same body streams its rows
    for n, m in ((1024, 256), (2048, 512)):
        p = plan(n, m)
        assert not p["resident"] and 16 in p["sizes"]
    # every (N, M) that K5 took before the cluster design (N <= 5,256 at
    # M = N/4) has a plan, and its sizes fit a block
    for n in list(range(1, 5257, 37)) + [5256]:
        p = plan(n, -(-n // 4))
        assert p["sizes"] and all(b <= 232448 for b in p["sizes"].values())
    n_max = distinct_kernel.K5_N_MAX
    with pytest.raises(ValueError, match=f"N <= {n_max}"):
        plan(n_max + 4, -(-(n_max + 4) // 4))


@pytest.mark.parametrize("N", [200, 203])
def test_split_identity_rebuilds_the_materialized_splits(N):
    """K5 reads Qd and the splits' diagonals only: relu(+-Qd) off the
    diagonal plus the split diagonals equal dualize_distinct's materialized
    splits bit for bit."""
    jp = _instances(B=3, M=N // 4, N=N, seed=1)
    td = pqp.dualize_distinct(
        convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"))
    eye = torch.eye(N, dtype=torch.bool)
    for split, sign in ((td.Qdp_theta, 1.0), (td.Qdn_theta, -1.0)):
        off = torch.clamp(sign * td.Qd, min=0.0).masked_fill(eye, 0.0)
        rebuilt = off + torch.diag_embed(torch.diagonal(split, dim1=1,
                                                        dim2=2))
        assert torch.equal(rebuilt, split)


def test_k5_reads_only_the_split_diagonals():
    """K5 takes the splits' diagonals and rebuilds the rest from Qd: the
    wrapper hands it dualize_distinct's diagonals and refuses a pair of
    splits that differs off the diagonal; the plain version takes any."""
    jp = _instances(B=2, M=12, N=48, seed=2)
    td = pqp.dualize_distinct(
        convert.primal_from_numpy(convert.to_numpy(jp), device="cpu"))
    split_diagonal = distinct_kernel.split_diagonal
    for split, sign, name in ((td.Qdn_theta, -1.0, "Qdn_theta"),
                              (td.Qdp_theta, 1.0, "Qdp_theta")):
        diag = split_diagonal(split, td.Qd, sign, name, td.Qd.device)
        assert torch.equal(diag, torch.diagonal(split, dim1=1, dim2=2))
        bad = split.clone()
        bad[0, 0, 1] += 1.0
        with pytest.raises(ValueError, match=name):
            split_diagonal(bad, td.Qd, sign, name, td.Qd.device)
        with pytest.raises(ValueError, match="expected float32"):
            split_diagonal(split[:, :-1], td.Qd, sign, name, td.Qd.device)


K5_CASES = {
    # (B, seed, cfg, iteration bar (floor, fraction))
    "no_accel": (5, 0, SolverConfig(max_iters=20_000, check_every=8,
                                    strict_weak_duality=False), (16, 0.02)),
    "accel": (4, 3, SolverConfig(max_iters=20_000, check_every=4,
                                 accel_every=4, strict_weak_duality=False),
              (8, 0.10)),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_plain_matches_jax_kernel(case):
    B, seed, cfg, (floor, frac) = K5_CASES[case]
    jp = _instances(B=B, seed=seed)
    jd, tp, td = _both(jp)
    want = j_solve_fused_distinct(jp, jd, cfg=_jcfg(cfg), interpret=True)
    before = distinct_kernel.fused_full_solve_distinct.launches
    got = pqp.solve_fused_distinct(tp, td, cfg=cfg)
    assert distinct_kernel.fused_full_solve_distinct.launches == before
    conv = np.asarray(want.converged)
    assert conv.all()
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    wi = np.asarray(want.iters).astype(float)
    gi = got.iters.numpy().astype(float)
    assert (np.abs(gi - wi) <= np.maximum(floor, frac * wi)).all(), (gi, wi)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               rtol=1e-4, atol=2e-3)


def test_k5_shared_kp_and_warm_start_match_jax():
    """A shared Kp broadcasts; an (N, 1) warm start seeds every instance;
    a warm start of another batch raises."""
    jp = _instances(B=3)
    jp = dataclasses.replace(jp, Kp=jp.Kp[:, 0])
    jd, tp, td = _both(jp)
    cfg = SolverConfig(max_iters=20_000, check_every=8,
                       strict_weak_duality=False)
    Y0 = np.full((16, 1), 10.0, np.float32)
    want = j_solve_fused_distinct(jp, jd, Y0=jnp.asarray(Y0),
                                  cfg=_jcfg(cfg), interpret=True)
    got = pqp.solve_fused_distinct(tp, td, Y0=torch.tensor(Y0), cfg=cfg)
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    wi = np.asarray(want.iters).astype(float)
    assert (np.abs(got.iters.numpy() - wi) <= np.maximum(16, 0.02 * wi)).all()
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U),
                               rtol=1e-4, atol=2e-3)
    with pytest.raises(ValueError, match="warm start batch"):
        pqp.solve_fused_distinct(tp, td, Y0=torch.ones(16, 2), cfg=cfg)


def test_k5_refuses_split_free_and_shared_geometry():
    jp = _instances(B=2)
    _, tp, td = _both(jp, materialize=False)
    with pytest.raises(ValueError, match="MATERIALIZED"):
        pqp.solve_fused_distinct(tp, td)
    _, tp, td = _both(jp)
    shared = dataclasses.replace(td, Qd=td.Qd[0])
    with pytest.raises(ValueError, match=r"Qd \(B, N, N\)"):
        pqp.solve_fused_distinct(tp, shared)


def _bench_distinct_draw(B, M, N, lanes, seed=0):
    """benchmarks/bench_distinct.py:make_instances (its {-1, 0, 1} Gp
    branch), drawn with NumPy for B instances, then cut to ``lanes``: the
    JAX primal."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, M, M)).astype(np.float32) / np.sqrt(M)
    Qp = np.einsum("bij,bkj->bik", L, L) + 2.0 * np.eye(M, dtype=np.float32)
    Qp_inv = np.linalg.inv(Qp).astype(np.float32)
    Gp = rng.integers(-1, 2, (B, N, M)).astype(np.float32)
    Fp = (rng.standard_normal((M, B)) * 3).astype(np.float32)
    Mp = rng.standard_normal(B).astype(np.float32)
    Kp = rng.uniform(1.0, 8.0, (N, B)).astype(np.float32)
    return JPrimal(Qp=jnp.asarray(Qp[lanes]), Qp_inv=jnp.asarray(Qp_inv[lanes]),
                   Fp=jnp.asarray(Fp[:, lanes]), Mp=jnp.asarray(Mp[lanes]),
                   Gp=jnp.asarray(Gp[lanes]), Kp=jnp.asarray(Kp[:, lanes]))


#: iterations of the first eight lanes of bench_distinct.py's seed-0
#: B=1024/N=400/M=100 draw through K5 on an H100 (NVIDIA H100 80GB HBM3,
#: 700 W; chip_smoke.py's ``distinct_resident_verdicts`` line).  The run
#: left 58 of the 1,024 lanes uncertified, kernel and plain alike; lanes 0,
#: 2 and 7 are three of them.
K5_ITERS_FIRST_LANES_H100 = [20_001, 3_913, 20_001, 11_017, 4_361, 4_113,
                             4_345, 20_001]
#: the same run: K5's iterations on lanes 8-11, and the 58 lanes it left
#: uncertified (infeasible at 20,001 iterations; the plain route alike)
K5_ITERS_LANES_8_11_H100 = [6_161, 9_577, 3_569, 5_585]
K5_UNCERTIFIED_H100 = (
    0, 2, 7, 108, 120, 146, 169, 178, 204, 208, 220, 233, 253, 264, 286, 290,
    315, 372, 411, 412, 429, 465, 473, 487, 516, 523, 527, 535, 540, 548, 553,
    556, 580, 597, 609, 617, 641, 657, 704, 708, 726, 732, 784, 825, 829, 843,
    846, 853, 881, 900, 908, 909, 920, 934, 966, 968, 981, 1011)
BENCH_DISTINCT_CFG = SolverConfig(max_iters=20_000, check_every=8, y0=1.0,
                                  erc=1e-4, eac=1e-4, eaj=1e-3, erj=1e-4,
                                  strict_weak_duality=False)


def _k5_iters_bar(it):
    """The oracle bar: max(5, iters/5) rounded up to whole checks."""
    every = BENCH_DISTINCT_CFG.check_every
    return -(-np.maximum(5, it // 5) // every) * every


def test_bench_distinct_edge_lane_fails_alike():
    """bench_distinct.py's workload under its configuration leaves some
    lanes infeasible at max_iters: 58 of 1,024 on an H100, kernel and plain
    alike.  The first eight lanes of that very draw, solved on the CPU: the
    JAX package and the port both end lanes 0, 2 and 7 infeasible at 20,001
    iterations and certify the other five, in thousands of iterations (not
    the "few hundred" of bench_distinct.py's comment).  Bars: the oracle
    parity bar between the packages, and between the JAX package and K5's
    iterations on the card.  The port's side runs with subnormals flushed
    to zero, as XLA's CPU runtime runs the JAX side: the iterates of the
    failing lanes decay through the subnormal range, where the CPU's
    unflushed arithmetic is ~20x slower."""
    jp = _bench_distinct_draw(1024, 100, 400, list(range(8)))
    jd, tp, td = _both(jp)
    cfg = BENCH_DISTINCT_CFG
    want = j_solve_batched(jp, jd, cfg=_jcfg(cfg))
    flushed = torch.set_flush_denormal(True)
    try:
        got = pqp.solve_batched(tp, td, cfg=cfg)
    finally:
        if flushed:
            torch.set_flush_denormal(False)
    certified = [False, True, False, True, True, True, True, False]
    failing = ~np.asarray(certified)
    for res in (np.asarray(want.converged), np.asarray(want.feasible),
                got.converged.numpy(), got.feasible.numpy()):
        np.testing.assert_array_equal(res, certified)
    assert (np.asarray(want.iters)[failing] == 20_001).all()
    assert (got.iters.numpy()[failing] == 20_001).all()
    _oracle_parity(got, want, cfg.check_every)
    it_w = np.asarray(want.iters).astype(np.int64)
    print("iterations, JAX:", it_w.tolist(), "port:", got.iters.tolist())
    assert (np.abs(np.asarray(K5_ITERS_FIRST_LANES_H100) - it_w)
            <= _k5_iters_bar(it_w)).all(), it_w
    assert it_w[~failing].min() > 3_000


def test_bench_distinct_failing_lanes_across_the_batch_fail_alike():
    """The witness beyond the draw's first eight lanes: six more of the 58
    lanes K5 left uncertified on an H100, spread over the batch, and lanes
    8-11, which it certified.  The JAX package's ``solve_batched`` on the
    CPU gives each lane the card's verdict — the six infeasible at 20,001
    iterations — and certifies the other four in K5's iterations within the
    oracle bar (mean ~6,200, not a few hundred)."""
    failing = [108, 290, 516, 726, 920, 1011]
    lanes = [8, 9, 10, 11] + failing
    assert set(failing) <= set(K5_UNCERTIFIED_H100)
    jp = _bench_distinct_draw(1024, 100, 400, lanes)
    want = j_solve_batched(jp, j_dualize_distinct(jp),
                           cfg=_jcfg(BENCH_DISTINCT_CFG))
    card = [lane not in K5_UNCERTIFIED_H100 for lane in lanes]
    np.testing.assert_array_equal(np.asarray(want.converged), card)
    np.testing.assert_array_equal(np.asarray(want.feasible), card)
    it_w = np.asarray(want.iters).astype(np.int64)
    print("iterations, JAX:", it_w.tolist(), "mean of the certified:",
          it_w[:4].mean())
    assert (it_w[4:] == 20_001).all()
    k5 = np.asarray(K5_ITERS_LANES_8_11_H100 + [20_001] * len(failing))
    assert (np.abs(k5 - it_w) <= _k5_iters_bar(it_w)).all(), it_w
