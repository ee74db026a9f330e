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
every bit on a second launch; the tests of K2, K3 and K4–K8 check it; K3's
float32 mode also gives the same bits at every lane width of its tile.  K2
and K4 also carry a NaN lane of Y to NaN where the plain version does, and
no further, and K2, K3's float32 mode and K4 take operands that are
contiguous views at a storage offset that is not 16-byte aligned, with the
bits of an aligned launch.  K1 is
also held on a batch whose lanes retire after 1 to 25 checks (its slots
are refilled from the lane queue), at B = 1, 5, 129 and 4,099, with a NaN
lane that leaves every other lane's bits as they were, with panels at an
odd offset, and with its launch plan against the card's; K8, which
launches K1's engine, gives K1's bits.  K1's forcing-scale instantiation
gives the bits it gave before the engine took the dual-gradient test
(:data:`K1_BITS`); its dual-gradient one (``MPC_CONFIG``, cold and warm,
and without acceleration) ends every lane in its plain version's state,
within K1's iteration and U bars, and a 200-step controller loop routed
to K1, one launch a step, gives the plain route's u0 at every step within
the U bar, every step certified.
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


def _at_odd_offset(t):
    """A contiguous view of a copy of ``t`` one float into its storage, so
    its data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    view = buf[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


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



def _k2_inputs(dev, case):
    """(Qdn, Qdp, Fdn, Fdp, Y) of one K2 edge case: N = 1 (a random 1 x 1
    problem), N = 128 (horizon 32, the largest resident N), a single lane,
    and a batch that is not a multiple of the block's lanes (N = 64: 64
    lanes per block, B = 129)."""
    rng = np.random.default_rng(2)
    if case == "n1":
        B = 300
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return (t([[0.5]]), t([[2.0]]), t(rng.uniform(0.1, 1.0, (1, B))),
                t(rng.uniform(0.1, 1.0, (1, B))),
                t(rng.uniform(0.01, 10.0, (1, B))))
    H, B = {"n128": (32, 200), "b1": (7, 1), "ragged_b129": (16, 129)}[case]
    primal, dual = _workload(dev, H, B)
    Y = torch.as_tensor(rng.uniform(0.01, 10.0, (dual.n_con, B))
                        .astype(np.float32), device=dev)
    return dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Y


@pytest.mark.parametrize("case", ["n1", "n128", "b1", "ragged_b129"])
def test_k2_edges_match_plain_and_repeat_bits(dev, case):
    args = _k2_inputs(dev, case)
    before = kernels.fused_pqp_iterations.launches
    got = kernels.fused_pqp_iterations(*args, num_iters=8, den_eps=1e-30)
    want = kernels.fused_pqp_iterations_reference(*args, num_iters=8,
                                                  den_eps=1e-30)
    again = kernels.fused_pqp_iterations(*args, num_iters=8, den_eps=1e-30)
    torch.cuda.synchronize()
    assert kernels.fused_pqp_iterations.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((again == got).all())


def test_k2_takes_panels_at_an_odd_offset(dev):
    # per-lane panels and B % 4 == 0: the kernel reads them as float4
    qdn, qdp, fdn, fdp, Y = _k2_inputs(dev, "n128")
    assert fdn.shape == Y.shape and Y.shape[1] % 4 == 0
    want = kernels.fused_pqp_iterations(qdn, qdp, fdn, fdp, Y, num_iters=8,
                                        den_eps=1e-30)
    got = kernels.fused_pqp_iterations(
        qdn, qdp, *(_at_odd_offset(t) for t in (fdn, fdp, Y)), num_iters=8,
        den_eps=1e-30)
    torch.cuda.synchronize()
    assert bool((got == want).all())


def test_k2_carries_a_nan_lane_like_plain(dev):
    primal, dual = _workload(dev, 7, 300)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(
        0.01, 10.0, (dual.n_con, 300)).astype(np.float32), device=dev)
    Y[3, 130] = float("nan")
    args = (dual.Qdn_theta, dual.Qdp_theta, dual.Fdn, dual.Fdp, Y)
    got = kernels.fused_pqp_iterations(*args, num_iters=8, den_eps=1e-30)
    want = kernels.fused_pqp_iterations_reference(*args, num_iters=8,
                                                  den_eps=1e-30)
    torch.cuda.synchronize()
    assert bool(want[:, 130].isnan().all())
    assert bool((got.isnan() == want.isnan()).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)

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
    again = solve_kernel.fused_full_solve(*args, **kw)
    assert _bits_equal((y, u, it, st), again)


def _bits_equal(a, b):
    """Every output of two whole-solve launches equal bit for bit (NaN
    included)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _k1_against_plain(args, kw):
    """K1 on ``args``: states equal to its plain version's, iterations
    in the bar, U within 5e-3 * max(1, |U|max), and a relaunch repeating
    every bit.  Returns the kernel's outputs."""
    out = solve_kernel.fused_full_solve(*args, **kw)
    y_p, u_p, it_p, st_p = solve_kernel.fused_full_solve_reference(*args,
                                                                   **kw)
    _, u, it, st = out
    assert bool((st == st_p).all())
    assert bool(((it - it_p).abs() <= _bar(it_p, kw["check_every"])).all())
    nan = u_p.isnan()
    assert bool((u.isnan() == nan).all())
    scale = max(1.0, float(u_p[~nan].abs().max()))
    assert float((u - u_p)[~nan].abs().max()) <= 5e-3 * scale
    assert _bits_equal(out, solve_kernel.fused_full_solve(*args, **kw))
    return out


def _digest(out):
    """sha256 of a whole-solve launch's outputs, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


#: sha256 (:func:`_digest`) of K1's outputs on each of :data:`K1_CASES`,
#: as the engine gave them on an H100 (sm_90a) before it took the
#: dual-gradient test: its forcing-scale instantiation must keep them.  A
#: guard for that one change only, beside the comparisons with the plain
#: version that hold K1 for good: the next change to K1's summation order
#: (ROADMAP 4.3), or another card or toolkit, changes these bits rightly,
#: and then this table and its test go
K1_BITS = {
    "accel":
        "9a9417c0fa4a7a4c13d5aed5a88b8e05f7ebf73be160d349dbdafd1402b7923e",
    "complementarity_gap":
        "6d4f702420e0c296a19cef5914651f8102ea947648e43e051e627b2647de8f1d",
    "explicit_gap":
        "6d4f702420e0c296a19cef5914651f8102ea947648e43e051e627b2647de8f1d",
    "n120_m30":
        "4fd43e634307732f7363bcc14b4cdbfbf909048356c83aff0aacd45336c15809",
    "n64_m16":
        "48710ceab82ae5c78151519c3aaad419efc72edd1e753eb16adb87abcc585448",
    "per_lane_kp":
        "38d334bf8c86d535fd8bfbfbad8a1dad805d772c2b2198f2d64222cd37296922",
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_forcing_scale_keeps_its_bits(dev, case):
    cfg, H, per_lane_kp = K1_CASES[case]
    primal, dual = _workload(dev, H, 1000, per_lane_kp)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, cfg)
    assert "feas_dual" not in kw
    assert _digest(solve_kernel.fused_full_solve(*args, **kw)) == \
        K1_BITS[case]


K1_DUAL_CASES = {
    # MPC_CONFIG, accelerated, cold and warm (the next states from the
    # last ones' multipliers, floored as the controller floors them)
    "cold": (MPC_CONFIG, False),
    "warm": (MPC_CONFIG, True),
    "cold_no_accel": (dataclasses.replace(MPC_CONFIG, accel_every=0),
                      False),
}


@pytest.mark.parametrize("case", sorted(K1_DUAL_CASES))
def test_k1_dual_gradient_matches_plain(dev, case):
    # the certificate Qd Y + Fd >= -max(erc Kp, eac) on every row: every
    # lane ends in its plain version's state, the iteration and U bars of
    # test_k1_kernel_matches_plain (on an H100 the accelerated cases drift
    # as K1's "accel" case does: iterations equal on 752 and 745 of 1,000
    # lanes, at most 32 apart, U within 1.6e-3 relative)
    from pqp_for_mpc_tpu_torch.bench import example_workload
    cfg, warm = K1_DUAL_CASES[case]
    primal, dual = example_workload(1000, dev, seed=0)
    Y0 = None
    if warm:
        prev = pqp.solve_batched(*example_workload(1000, dev, seed=1),
                                 cfg=cfg)
        Y0 = torch.clamp(prev.Y, min=1e-6)
    args, kw = solve_kernel.fused_inputs(primal, dual, Y0, cfg)
    assert kw["feas_dual"] is True
    out = solve_kernel.fused_full_solve(*args, **kw)
    y_p, u_p, it_p, st_p = solve_kernel.fused_full_solve_reference(*args,
                                                                   **kw)
    y, u, it, st = out
    assert bool((st == st_p).all())
    assert float((st == 1).float().mean()) >= 0.99
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every)).float()
    assert float(within.mean()) >= (0.99 if cfg.accel_every else 1.0)
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p).abs().max()) <= 5e-3 * scale
    assert _bits_equal(out, solve_kernel.fused_full_solve(*args, **kw))


def test_controller_loop_on_k1_matches_the_plain_route(dev, monkeypatch):
    import functools
    from pqp_for_mpc_tpu_torch import routing
    from pqp_for_mpc_tpu_torch.bench import example_spec
    from pqp_for_mpc_tpu_torch.models import MPCController, mpc
    spec = example_spec(7, 2.5)
    A, Bm = (np.asarray(m, np.float64) for m in (spec.plant.A,
                                                 spec.plant.B))

    def loop(fed=None):
        """200 warm steps at B = 1 (x redrawn at step 100, plant noise
        w ~ N(0, 0.05^2)), or the (x, u_prev) pairs ``fed``: (u0 per
        step, converged per step, the pairs handed to each step)."""
        ctrl = MPCController(spec, device=dev)
        rng = np.random.default_rng(11)
        x, u = rng.normal(0.0, 0.5, 2), np.zeros(1)
        us, conv, pairs = [], [], []
        for i in range(200):
            if fed is not None:
                x, u = fed[i]
            pairs.append((x, u))
            u0, res = ctrl.step(x, u_prev=u)
            u = u0.cpu().numpy().astype(np.float64).reshape(-1)
            us.append(u)
            conv.append(bool(res.converged.all()))
            x = (rng.normal(0.0, 0.5, 2) if i == 99 else
                 A @ x + Bm @ u + rng.normal(0.0, 0.05, 2))
        return np.array(us), conv, pairs

    k1 = solve_kernel.fused_full_solve
    before = k1.launches
    routed, conv_k1, pairs = loop()
    assert k1.launches - before == 200       # one launch a step
    monkeypatch.setattr(mpc, "solve_auto", functools.partial(
        routing.solve_auto, engine="xla"))
    before = k1.launches
    plain, conv_plain, _ = loop(pairs)
    assert k1.launches == before
    assert all(conv_k1) and all(conv_plain)
    # the U bar of the card's closed loops (test_rollout_jit_on_the_card_
    # matches_rollout, chip_smoke's H=16 loop); on an H100 the two routes'
    # u0 lay at most 1.09e-4 apart over these 200 steps
    bar = 5e-3 * max(1.0, float(np.abs(plain).max()))
    assert float(np.abs(routed - plain).max()) <= bar


def test_k1_refills_lanes_of_every_length(dev):
    # half the lanes warm-started at their solution (certified at the
    # first check), half cold, and max_iters short enough that some cold
    # lanes end active: slots retire after 1 to 25 checks and are refilled
    primal, dual = _workload(dev, 7, 3000)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, SMOKE)
    solved, _, _, cold_st = solve_kernel.fused_full_solve(*args, **kw)
    Y0 = torch.full_like(solved, SMOKE.y0)
    Y0[:, ::2] = solved[:, ::2]
    cfg = dataclasses.replace(SMOKE, max_iters=200)
    args, kw = solve_kernel.fused_inputs(primal, dual, Y0, cfg)
    _, _, it, st = _k1_against_plain(args, kw)
    warm_cert = cold_st[::2] == 1
    assert float(warm_cert.float().mean()) >= 0.99
    assert bool(((st[::2] == 1) & (it[::2] == 1))[warm_cert].all())
    assert 0 < int((st == 0).sum()) < 1500


@pytest.mark.parametrize("B", [1, 5, 129, 4099])
def test_k1_batch_edges(dev, B):
    # fewer lanes than one block's slots, a ragged last tile, and a
    # batch of many tiles
    primal, dual = _workload(dev, 7, B)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, SMOKE)
    _k1_against_plain(args, kw)


def test_k1_keeps_a_nan_lane_to_itself(dev):
    primal, dual = _workload(dev, 7, 300)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, SMOKE)
    clean = solve_kernel.fused_full_solve(*args, **kw)
    Y0 = torch.full((dual.n_con, 300), SMOKE.y0, device=dev)
    Y0[3, 130] = float("nan")
    args, kw = solve_kernel.fused_inputs(primal, dual, Y0, SMOKE)
    out = _k1_against_plain(args, kw)
    others = torch.arange(300, device=dev) != 130
    assert _bits_equal([t[..., others] for t in out],
                       [t[..., others] for t in clean])
    assert bool(out[0][:, 130].isnan().any())


def test_k1_takes_panels_at_an_odd_offset(dev):
    primal, dual = _workload(dev, 7, 1000, per_lane_kp=True)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, SMOKE)
    want = solve_kernel.fused_full_solve(*args, **kw)
    odd = [_at_odd_offset(t.contiguous()) if t.dim() == 2 and
           t.shape[-1] == 1000 else t for t in args]
    assert sum(t.data_ptr() % 16 == 4 for t in odd) >= 2
    assert _bits_equal(solve_kernel.fused_full_solve(*odd, **kw), want)


@pytest.mark.parametrize("n,m", [(28, 7), (64, 16), (120, 30), (128, 28),
                                 (8, 128)])
def test_k1_plan_matches_the_card(dev, n, m):
    B = 1 << 22
    plan, card = solve_kernel.k1_plan(n, m, B), solve_kernel.card_plan(n, m,
                                                                       B)
    for key in ("lanes_per_block", "threads", "staged", "smem_bytes"):
        assert card[key] == plan[key], key
    assert card["blocks_per_sm"] >= 1
    assert card["grid"] == min(plan["blocks"],
                               card["blocks_per_sm"] * card["sms"])


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


@pytest.mark.parametrize("N,B", [(4096, 128), (256, 1), (203, 5)])
def test_k3_bf16_tensor_core_plans_match_plain(dev, N, B):
    # the streamed workload's shape (32 x 64 tiles, cp.async), the H=64
    # loop's single lane and a ragged shape (both staged entry by entry)
    primal, dual = _random_problem(dev, N, N // 4, B)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (N, B))
                        .astype(np.float32), device=dev)
    Q, th = tiled_kernel.streamed_matrix(dual.Qd, dual.theta, "bfloat16")
    args = (Q, th, dual.Fdn, dual.Fdp, Y)
    k3 = tiled_kernel.streamed_pqp_iterations
    before = k3.launches["bfloat16"]
    got = k3(*args, num_iters=16, den_eps=1e-30)
    want = tiled_kernel.streamed_pqp_iterations_reference(
        *args, num_iters=16, den_eps=1e-30)
    torch.cuda.synchronize()
    assert k3.launches["bfloat16"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
    assert bool((k3(*args, num_iters=16, den_eps=1e-30) == got).all())


def _k3_f32_args(dev, N, B):
    primal, dual = _random_problem(dev, N, N // 4, B)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (N, B))
                        .astype(np.float32), device=dev)
    Q, th = tiled_kernel.streamed_matrix(dual.Qd, dual.theta, "float32")
    return Q, th, dual.Fdn, dual.Fdp, Y


@pytest.mark.parametrize("N,B", [(4096, 128), (256, 1), (203, 5)])
def test_k3_f32_plans_repeat_their_bits(dev, monkeypatch, N, B):
    # the FMA tile at 32, 64 and 128 lanes: the streamed workload's shape
    # (cp.async in 16-byte chunks), the H=64 loop's single lane and a
    # ragged shape (entry by entry); each entry's sum is one FMA chain in
    # ascending k whatever the tiling, so every plan gives the same bits
    args = _k3_f32_args(dev, N, B)
    k3 = tiled_kernel.streamed_pqp_iterations
    want = tiled_kernel.streamed_pqp_iterations_reference(
        *args, num_iters=16, den_eps=1e-30)
    shipped = tiled_kernel.k3_f32_plan
    outs = []
    for lanes in (32, 64, 128):
        plan = dict(shipped(N, B), tile_lanes=lanes)
        monkeypatch.setattr(tiled_kernel, "k3_f32_plan", lambda n, b: plan)
        before = k3.launches["float32"]
        got = k3(*args, num_iters=16, den_eps=1e-30)
        torch.cuda.synchronize()
        assert k3.launches["float32"] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(k3(*args, num_iters=16, den_eps=1e-30)
                           .view(torch.int32), got.view(torch.int32))
        outs.append(got)
    for got in outs[1:]:
        assert torch.equal(got.view(torch.int32), outs[0].view(torch.int32))


def test_k3_f32_takes_y_at_an_odd_offset(dev):
    # the tile stages y by 16-byte cp.async: the wrapper copies a view that
    # does not start 16-byte aligned, and the bits are an aligned launch's
    Q, th, fdn, fdp, Y = _k3_f32_args(dev, 1024, 128)
    k3 = tiled_kernel.streamed_pqp_iterations
    want = k3(Q, th, fdn, fdp, Y, num_iters=4, den_eps=1e-30)
    got = k3(Q, th, fdn, fdp, _at_odd_offset(Y), num_iters=4, den_eps=1e-30)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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



#: K4 at the edges of k4_plan: N not a multiple of the 32-row tile with M
#: and B not multiples of 4 (entry-by-entry staging, 64-lane tiles), and a
#: batch below 32 lanes
K4_PLAN_EDGES = {
    "n203_m50_b40": (203, 50, 40),
    "n256_m64_b5": (256, 64, 5),
}


@pytest.mark.parametrize("case", sorted(K4_PLAN_EDGES))
def test_k4_plan_edges_match_plain(dev, case):
    N, M, B = K4_PLAN_EDGES[case]
    cfg = K4_CASES["complementarity_gap"][0]
    plan = tiled_solve_kernel.k4_plan(N, M, B)
    assert plan["tile_lanes"] == (64 if B == 40 else 32)
    assert not plan["vector_staging"] or N % 4 == 0
    primal, dual = _random_problem(dev, N, M, B)
    args, kw = tiled_solve_kernel.tiled_inputs(primal, dual, None, cfg)
    y, u, it, st = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    y_p, u_p, it_p, st_p = \
        tiled_solve_kernel.fused_full_solve_tiled_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bool((st == st_p).all()) and bool((st_p == 1).any())
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every))[st_p == 1]
    assert bool(within.all())
    scale = max(1.0, float(u_p.abs().max()))
    assert float((u - u_p).abs().max()) <= 5e-3 * scale
    again = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    assert all(bool((a == b).all()) for a, b in zip(again, (y, u, it, st)))


def test_k4_takes_matrices_at_an_odd_offset(dev):
    cfg = K4_CASES["complementarity_gap"][0]
    primal, dual = _random_problem(dev, 200, 64, 72)
    args, kw = tiled_solve_kernel.tiled_inputs(primal, dual, None, cfg)
    assert tiled_solve_kernel.k4_plan(200, 64, 72)["vector_staging"]
    want = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    # Qd and theta (Qd_hat is built from them), and Gp, Qp and Qp_inv,
    # which the tile stages in 16-byte chunks
    odd = tuple(_at_odd_offset(t) for t in args[:5]) + tuple(args[5:])
    got = tiled_solve_kernel.fused_full_solve_tiled(*odd, **kw)
    torch.cuda.synchronize()
    assert all(bool((g == w).all()) for g, w in zip(got, want))


def test_k4_carries_a_nan_lane_like_plain(dev):
    cfg = K4_CASES["complementarity_gap"][0]
    primal, dual = _random_problem(dev, 200, 64, 72)
    Y0 = torch.full((200, 72), cfg.y0, device=dev)
    Y0[7, 40] = float("nan")
    args, kw = tiled_solve_kernel.tiled_inputs(primal, dual, Y0, cfg)
    y, u, it, st = tiled_solve_kernel.fused_full_solve_tiled(*args, **kw)
    y_p, u_p, it_p, st_p = \
        tiled_solve_kernel.fused_full_solve_tiled_reference(*args, **kw)
    torch.cuda.synchronize()
    nan_lanes = y_p.isnan().any(dim=0)
    assert nan_lanes.tolist() == [b == 40 for b in range(72)]
    assert bool((y.isnan().any(dim=0) == nan_lanes).all())
    assert bool((u.isnan().any(dim=0) == u_p.isnan().any(dim=0)).all())
    assert bool((st == st_p).all()) and bool((it == it_p)[40])
    ok = ~nan_lanes
    within = ((it - it_p).abs() <= _bar(it_p, cfg.check_every))[ok]
    assert bool(within.all())
    scale = max(1.0, float(u_p[:, ok].abs().max()))
    assert float((u - u_p)[:, ok].abs().max()) <= 5e-3 * scale

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
    # accelerated: ~2,200 iterations where the plain update needs ~10x more;
    # past the cluster's capacity (its rows streamed)
    "n1024_m256_accel": (dataclasses.replace(DISTINCT_CFG, accel_every=8),
                         1024, 256, 3),
    # bench_distinct's shape: every owned row resident in shared memory
    "n400_m100_resident": (DISTINCT_CFG, 400, 100, 3),
    # the accel step every 4 updates inside 8-update rounds
    "chunked_accel_n200": (dataclasses.replace(DISTINCT_CFG, check_every=8,
                                               accel_every=4), 200, 50, 3),
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


def test_k5_card_pick_is_in_the_plan(dev):
    # the launcher's layout for bench_distinct's workload is one of the
    # plan's, and the card holds at least one such cluster
    plan = distinct_kernel.k5_plan(400, 100)
    pick = distinct_kernel.card_cluster(400, 100, 1024, plan["resident"])
    sizes = plan["sizes"]
    assert pick["blocks_per_instance"] in sizes
    assert pick["active_clusters"] >= 1
    assert pick["smem_bytes"] == sizes[pick["blocks_per_instance"]]


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
    # the path's shape: one instance spans more blocks than a cluster
    # holds, two side by side (B=2) and one over every SM (B=1)
    "n2048_m512_past_a_cluster": (STREAMED_CFG, 2048, 512, 2),
    "n2048_m512_b1_spans_the_card": (STREAMED_CFG, 2048, 512, 1),
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


@pytest.mark.parametrize("N", [200, 203, 1024, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_kernel_matches_plain(dev, N, dtype):
    # N = 2048 is the path's shape (B = 8): rows spill past shared memory
    B = 8 if N == 2048 else 3
    _, dual = _distinct(dev, N, N // 4, B, gaussian=True,
                        materialize=False)
    Y = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (N, B))
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
    # K8 launches K1's engine: Y, U, iters and state equal bit for bit
    primal, dual = _workload(dev, 7, 1 << 14)
    args, kw = solve_kernel.fused_inputs(primal, dual, None, SMOKE)
    assert _bits_equal(packed_kernel.fused_full_solve_packed(*args, **kw),
                       solve_kernel.fused_full_solve(*args, **kw))
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


def test_stagewise_solve_on_the_card_matches_cpu(dev):
    """The stage-wise solve (H=64: the log-depth scans) on the card against
    the port's CPU run of the same inputs (8 states x0 ~ U(-2, 2), the
    fan-out's draw): the same verdicts and U within 5e-3 * max(1, |U|max)
    on every lane, and the batch's total iterations within a fifth of the
    CPU's; every result tensor on the card.  A lane's own count is not
    held: the accelerated iteration's count moves with the summation order
    (on the CPU alone the sequential and log-depth recursions take 7,241
    and 1,049 iterations on lane 3 of this draw, U within 3e-4), and on an
    H100 the card took 2617, 1745, 2089, 3713, 2105, 1593, 1257, 1801
    against the CPU's 2641, 1649, 2081, 3097, 2113, 2041, 1257, 1409 (lanes
    3, 5 and 7 at or past max(5, iters/5)), totals 3.9% apart."""
    from pqp_for_mpc_tpu_torch.config import stagewise_mpc_config
    from pqp_for_mpc_tpu_torch.models import solve_stagewise, stagewise_dual
    spec = MPCSpec(double_integrator(), horizon=64, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    cfg = stagewise_mpc_config(64)
    x0 = np.random.default_rng(0).uniform(-2.0, 2.0, (2, 8)).astype(
        np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        sd = stagewise_dual(spec, device=d)
        out[d.type] = solve_stagewise(sd, torch.from_numpy(x0).to(d),
                                      cfg=cfg)
    card, cpu = out["cuda"], out["cpu"]
    for f in dataclasses.fields(card):
        v = getattr(card, f.name)
        assert v is None or v.device.type == "cuda", f.name
    assert cpu.converged.all()
    assert torch.equal(card.converged.cpu(), cpu.converged)
    total_card, total_cpu = int(card.iters.sum()), int(cpu.iters.sum())
    assert abs(total_card - total_cpu) <= total_cpu / 5, (card.iters,
                                                           cpu.iters)
    tol = 5e-3 * max(1.0, float(cpu.U.abs().max()))
    assert float((card.U.cpu() - cpu.U).abs().max()) <= tol


def test_implicit_gradient_on_the_card_matches_cpu(dev):
    """solve_qp_implicit's gradients on the card against the CPU's (rtol
    1e-3), and a vmap batch on the card against one at a time."""
    from pqp_for_mpc_tpu_torch import solve_qp_implicit
    cfg = SolverConfig(max_iters=100_000, check_every=4, accel_every=4,
                       y0=0.1, strict_weak_duality=False, eaj=1e-5,
                       erj=1e-6)
    rng = np.random.default_rng(2)
    L = rng.standard_normal((4, 4)).astype(np.float32)
    arrays = (L @ L.T + 4 * np.eye(4, dtype=np.float32),
              (rng.standard_normal(4) * 5).astype(np.float32),
              rng.integers(-1, 2, (10, 4)).astype(np.float32),
              rng.uniform(0.5, 2.0, 10).astype(np.float32))
    grads = {}
    for d in (dev, torch.device("cpu")):
        ts = [torch.tensor(a, device=d, requires_grad=True) for a in arrays]
        U = solve_qp_implicit(*ts, cfg)
        assert U.device.type == d.type
        (U * torch.arange(1.0, 5.0, device=d)).sum().backward()
        grads[d.type] = [t.grad for t in ts]
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_card.device.type == "cuda"
        torch.testing.assert_close(g_card.cpu(), g_cpu, rtol=1e-3,
                                   atol=1e-3 * float(g_cpu.abs().max()))
    Qp, Fp, Gp, Kp = (torch.tensor(a, device=dev) for a in arrays)
    Fps = Fp + torch.as_tensor(rng.standard_normal((16, 4)).astype(
        np.float32), device=dev)
    f = lambda fp: solve_qp_implicit(Qp, fp, Gp, Kp, cfg)
    Ub = torch.func.vmap(f)(Fps)
    assert Ub.device.type == "cuda"
    for b in range(16):
        torch.testing.assert_close(Ub[b], f(Fps[b]), rtol=1e-5, atol=1e-5)


def _loop_bars(card, cpu, keys, conv_keys=("converged",)):
    """Card against CPU for a closed loop or record: equal verdicts (every
    step certified), each of ``keys`` within 5e-3 * max(1, |cpu|max) at
    every step (the oracle bar)."""
    for k in conv_keys:
        assert cpu[k].all()
        np.testing.assert_array_equal(card[k], cpu[k])
    for k in keys:
        tol = 5e-3 * max(1.0, float(np.abs(cpu[k]).max()))
        np.testing.assert_allclose(card[k], cpu[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_offset_free_loop_on_the_card_matches_cpu(dev):
    """tests/test_offset_free.py's input-disturbance loop (double integrator,
    H=20, d = 0.3, 60 steps) on both backends, on the card against the CPU;
    every solve stays off the hand-written kernels (the plain solve, as in
    the JAX package)."""
    from pqp_for_mpc_tpu_torch.models import OffsetFreeController
    spec = MPCSpec(double_integrator(), horizon=20, Qy=np.eye(1),
                   R=0.1 * np.eye(1), r=np.ones(1), u_min=-2 * np.ones(1),
                   u_max=2 * np.ones(1), du_max=np.ones(1))
    for backend in ("condensed", "stagewise"):
        out = {}
        before = solve_kernel.fused_full_solve.launches
        for d in (dev, torch.device("cpu")):
            ctrl = OffsetFreeController(spec, kind="input", backend=backend,
                                        device=d)
            out[d.type] = ctrl.rollout_jit(np.zeros(2, np.float32), 60,
                                           np.array([0.3], np.float32))
        assert solve_kernel.fused_full_solve.launches == before
        _loop_bars(out["cuda"], out["cpu"], ("u", "y", "d_hat"))
        assert np.abs(out["cuda"]["y"][-10:] - 1.0).max() < 1e-2


def test_mhe_record_on_the_card_matches_cpu(dev):
    """The CLI's one-sided quadruple-tank record (120 steps, seed 0) through
    the linear MHE (window 10) on the card against the CPU."""
    from pqp_for_mpc_tpu_torch.cli import simulated_record
    from pqp_for_mpc_tpu_torch.models import (MovingHorizonEstimator,
                                              quadruple_tank)
    plant = quadruple_tank()
    x0, U, Y, _ = simulated_record(plant, 120, 1e-4, 1e-4, True, 0)
    out = {}
    for d in (dev, torch.device("cpu")):
        mhe = MovingHorizonEstimator(plant, 10, 1e-4 * np.eye(4),
                                     1e-4 * np.eye(2),
                                     w_min=np.zeros(4, np.float32),
                                     device=d)
        out[d.type] = mhe.run(x0, U, Y)
    _loop_bars(out["cuda"], out["cpu"], ("x_hat",))


def test_rti_loop_on_the_card_matches_cpu(dev):
    """tests/test_rti.py's swing (H=16, two SQP passes, 20 steps from 2.5
    rad) with the Jacobians from torch.func on the card, against the CPU."""
    from pqp_for_mpc_tpu_torch.models import LTVPlant, RTIController

    def f_disc(x, u):
        def f(x):
            return torch.stack([x[1], 10.0 * torch.sin(x[0]) - 0.1 * x[1]
                                + u[0]])
        k1 = f(x)
        k2 = f(x + 0.025 * k1)
        k3 = f(x + 0.025 * k2)
        k4 = f(x + 0.05 * k3)
        return x + (0.05 / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    H = 16
    A, B = (j.numpy() for j in torch.func.jacrev(f_disc, (0, 1))(
        torch.zeros(2), torch.zeros(1)))
    plant = LTVPlant(A=np.tile(A[None], (H, 1, 1)),
                     B=np.tile(B[None], (H, 1, 1)),
                     E=np.tile(np.eye(2, dtype=np.float32)[None], (H, 1, 1)),
                     C=np.tile(np.array([[[1.0, 0.0]]], np.float32),
                               (H, 1, 1)))
    spec = MPCSpec(plant, horizon=H, Qy=np.eye(1), R=0.02 * np.eye(1),
                   r=np.zeros(1), u_min=-12 * np.ones(1),
                   u_max=12 * np.ones(1), du_max=6 * np.ones(1))
    cfg = SolverConfig(max_iters=20_000, check_every=8, accel_every=4,
                       y0=0.01, eaj=1e-3, erj=1e-4, erc=1e-4, eac=1e-4,
                       strict_weak_duality=False)
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = RTIController(f_disc, spec, cfg=cfg, sqp_iters=2,
                                    device=d).rollout([2.5, 0.0], 20)
    _loop_bars(out["cuda"], out["cpu"], ("u", "x"))
    assert abs(out["cuda"]["x"][-1, 0]) < 1.25
