"""The solve loop's CUDA graphs against the same loop run eagerly, on the
GPU.

Every test here is marked ``cuda`` and skips without a CUDA device; the
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_graphs_cuda.py -q --noconftest

Eager means the engagement rule forced off (``solver.graphs_engage``
patched to refuse) in the test alone.  The benchmark's warm loop
(``port_bench/configs/double_integrator_h7.json``: its plant, horizon and
loop settings; x redrawn at step 100, plant noise w ~ N(0, 0.05^2)), its
solves sent to the plain engine (the router sends them to K1), runs
200 steps both ways: u0, Y, U and iters are the same bits at every step,
one capture serves the 200 steps, and a returned result is unchanged by
the steps after it.  A warm batch of 4 lanes that certify at different
checks stamps eager's iterations (``h`` lives on the device), a poisoned
warm start under ``retry_cold`` gives eager's answer, and the cache keeps
eight keys.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pqp_for_mpc_tpu_torch import routing, solver
from pqp_for_mpc_tpu_torch.config import SolverConfig
from pqp_for_mpc_tpu_torch.dual import dual_geometry, dualize_forcing
from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec, condense
from pqp_for_mpc_tpu_torch.models import mpc
from pqp_for_mpc_tpu_torch.models.plants import LinearPlant
from pqp_for_mpc_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

CONF = json.loads((Path(__file__).resolve().parents[1] / "port_bench" /
                   "configs" / "double_integrator_h7.json").read_text())
LOOP = SolverConfig(**CONF["solver"]["loop"])
STEPS = 200


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the GPU")
    return torch.device("cuda", 0)


def _spec():
    a = lambda v: np.asarray(v, np.float64)
    p = CONF["plant"]
    plant = LinearPlant(A=a(p["A"]), B=a(p["B"]), E=a(p["E"]), C=a(p["C"]),
                        name=p["name"])
    return MPCSpec(plant, horizon=CONF["horizon"], Qy=a(CONF["Qy"]),
                   R=a(CONF["R"]), r=a(CONF["r"]), u_min=a(CONF["u_min"]),
                   u_max=a(CONF["u_max"]), du_max=a(CONF["du_max"]))


def _eager(monkeypatch):
    monkeypatch.setattr(solver, "graphs_engage", lambda *a, **k: False)


def _loop(dev, xs=None):
    """200 closed-loop steps at B = 1; returns (per-step (u0, Y, U, iters)
    clones, the states and inputs handed to each step, whether every
    returned result kept its bits through the next step, the tracing
    snapshot).  ``xs``: replay these (x, u_prev) pairs in place of the
    plant."""
    ctrl = MPCController(_spec(), cfg=LOOP, device=dev)
    A = np.asarray(CONF["plant"]["A"], np.float64)
    Bm = np.asarray(CONF["plant"]["B"], np.float64)
    rng = np.random.default_rng(7)
    x, u = rng.normal(0.0, 0.5, 2), np.zeros(1)
    out, fed, kept, prev = [], [], [], None
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(STEPS):
            if xs is not None:
                x, u = xs[i]
            fed.append((x, u))
            u0, res = ctrl.step(x, u_prev=u)
            if prev is not None:
                # the previous step's result, after this step ran
                kept.append(all(torch.equal(a, b) for a, b in
                                zip(prev[0], prev[1])))
            fields = (res.Y, res.iters, res.converged, res.U)
            prev = (fields, [t.clone() for t in fields])
            out.append((u0.clone(), res.Y.clone(), res.U.clone(),
                        res.iters.clone()))
            u = u0.cpu().numpy().astype(np.float64).reshape(-1)
            x = (rng.normal(0.0, 0.5, 2) if i == 99 else
                 A @ x + Bm @ u + rng.normal(0.0, 0.05, 2))
        torch.cuda.synchronize(dev)
    return out, fed, kept, tracing.snapshot()


@pytest.fixture(scope="module")
def loops(dev):
    solver._GRAPHS.clear()
    mp = pytest.MonkeyPatch()
    # the controller's solves on the plain engine, whose loop has the graphs
    mp.setattr(mpc, "solve_auto", functools.partial(routing.solve_auto,
                                                    engine="xla"))
    try:
        graphs = _loop(dev)
        _eager(mp)
        eager = _loop(dev, xs=graphs[1])
    finally:
        mp.undo()
    return graphs, eager


def test_loop_is_the_same_bits_with_graphs(loops):
    (got, _, _, _), (want, _, _, _) = loops
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("u0", "Y", "U", "iters"), g, w):
            assert torch.equal(a, b), (i, name, a, b)


def test_one_capture_serves_the_loop(loops):
    (_, _, _, snap), (_, _, _, eager) = loops
    c = snap["counters"]
    assert c.get("graph.capture") == 1
    # steps 2..200 replay: two graphs a check, one for the final check
    assert c.get("graph.replay", 0) >= 3 * (STEPS - 1)
    assert "graph.replay" not in eager["counters"]
    assert c["sync.solve"] == eager["counters"]["sync.solve"]


def test_returned_results_do_not_alias_the_graphs(loops):
    (_, _, kept, _), _ = loops
    assert len(kept) == STEPS - 1 and all(kept)


def _batch(dev, lanes, seed):
    data = condense(_spec(), device=dev)
    Qp = data.qp()
    geom = dual_geometry(data.Gp, data.Qp_inv, theta_floor=LOOP.theta_floor)
    rng = np.random.default_rng(seed)

    def build(x):
        primal = data.assemble(x=torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev), Qp=Qp)
        return primal, dualize_forcing(geom, primal.Fp, primal.Mp,
                                       primal.Kp)

    x = rng.normal(0.0, 0.5, (2, lanes))
    # the next states: each lane moved by its own amount
    x2 = x + rng.normal(0.0, 0.05, (2, lanes)) * np.arange(1, lanes + 1)
    return build(x), build(x2)


def _warm_batch(dev, cfg):
    solver._GRAPHS.clear()
    (p1, d1), (p2, d2) = _batch(dev, 4, 3)
    Y0 = torch.clamp(solver.solve_batched(p1, d1, cfg=cfg).Y, min=1e-6)
    # the same key three times: eager, then captured, then replayed
    return [solver.solve_batched(p2, d2, Y0=Y0, cfg=cfg) for _ in range(3)]


def test_warm_batch_stamps_eager_iterations(dev, monkeypatch):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _warm_batch(dev, LOOP)
    assert tracing.snapshot()["counters"].get("graph.capture") == 1
    _eager(monkeypatch)
    want = _warm_batch(dev, LOOP)
    assert len(set(want[0].iters.tolist())) > 1    # lanes stop apart
    for g, w in zip(got, want):
        assert torch.equal(g.iters, w.iters)
        assert torch.equal(g.converged, w.converged)
        assert torch.equal(g.Y, w.Y)


def _retry(dev):
    solver._GRAPHS.clear()
    cfg = dataclasses.replace(LOOP, accel_every=0, max_iters=800)
    (p1, d1), (p2, d2) = _batch(dev, 8, 5)
    Y0 = torch.clamp(solver.solve_batched(p1, d1, cfg=cfg).Y, min=1e-6)
    Y0[:, ::2] = 0.0                    # the absorbing zero on half
    alone = solver.solve_batched(p2, d2, Y0=Y0, cfg=cfg)
    runs = [solver.solve_batched(p2, d2, Y0=Y0, cfg=cfg, retry_cold=True)
            for _ in range(2)]
    return alone, runs


def test_retry_cold_gives_the_eager_answer(dev, monkeypatch):
    alone, got = _retry(dev)
    assert not bool(alone.converged.all())       # the retry runs
    _eager(monkeypatch)
    _, want = _retry(dev)
    for g, w in zip(got, want):
        for f in dataclasses.fields(solver.SolveResult):
            assert torch.equal(getattr(g, f.name), getattr(w, f.name)), \
                f.name


def test_the_cache_keeps_eight_keys(dev):
    solver._GRAPHS.clear()
    (p, d), _ = _batch(dev, 1, 0)
    Y = torch.full((d.n_con, 1), LOOP.y0, device=dev)
    for b in range(1, 11):
        for _ in range(2):
            solver.solve_batched(p, d, Y0=Y.expand(-1, b).contiguous(),
                                 cfg=LOOP)
    assert len(solver._GRAPHS) == solver.GRAPH_KEYS
    assert all(e.value is not None for e in solver._GRAPHS.values())
