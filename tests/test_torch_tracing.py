"""The port's spans and counters (``utils/tracing.py``) on the CPU.

Tracing is on exactly while a ``torch.profiler`` session records: off, a
controller step records nothing; on, a B = 1 ``MPCController.step`` gives
the layer spans nested under ``mpc.step`` on one request, self times that
add up, one blocking read per check (``(iters - 1) / check_every + 2``
from a cold start), the route the router picks, the kernel wrappers'
launch deltas, the same bits as with tracing off, spans that hold the
``aten::`` operators they launched on the profiler's clock, no event of
the program's in the profiler's trace, and the spans in
``profiling.trace``'s export.  The card's side (device times, K1) is
``tests/test_torch_tracing_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec
from pqp_for_mpc_tpu_torch.models.plants import double_integrator
from pqp_for_mpc_tpu_torch.ops import solve_kernel, tiled_kernel
from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto
from pqp_for_mpc_tpu_torch.utils import profiling, tracing

#: the spans of a condensed step, and each one's parent
CONDENSED = {"mpc.build": "mpc.step", "build.assemble": "mpc.build",
             "build.dualize_forcing": "mpc.build", "solve.auto": "mpc.step",
             "solve.check": "solve.auto", "solve.updates": "solve.auto",
             "sync": "solve.auto"}
STAGEWISE = {"mpc.build": "mpc.step", "sync": "mpc.step"}
#: the program's span and counter names; none may reach the profiler
PREFIXES = ("mpc.", "build.", "solve.", "kernel.", "route.", "sync")
SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _spec():
    return MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]),
                   u_min=np.array([-1.0]), u_max=np.array([1.0]),
                   du_max=np.array([0.5]))


def _ctrl(backend="condensed"):
    return MPCController(_spec(), backend=backend, device="cpu")


def _loop(ctrl, steps=4, x0=(1.0, 0.0)):
    """``steps`` closed-loop steps from ``x0``; every step's result."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    x, u, out = np.asarray(x0), np.zeros(1), []
    for _ in range(steps):
        u0, res = ctrl.step(x, u_prev=u)
        out.append(res)
        u = u0.numpy().reshape(-1).astype(np.float64)
        x = A @ x + B @ u
    return out


def _steps(ctrl, u, xs=((1.0, 0.0), (0.9, -0.2), (0.7, -0.3))):
    """A step at each state of ``xs`` from the input ``u``, the slew rows
    then at the last step's input as the controller returned it: no
    operator of the caller's between the steps."""
    for x in xs:
        u, _ = ctrl.step(np.asarray(x), u_prev=u)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_off_a_step_records_nothing(backend):
    _loop(_ctrl(backend), steps=2)
    snap = tracing.snapshot()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["dropped"] == 0 and tracing.records_since() == []
    assert set(snap["launches"].values()) == {0}


@pytest.mark.parametrize("backend,expected", [("condensed", CONDENSED),
                                              ("stagewise", STAGEWISE)])
def test_step_spans_nest_under_the_root(backend, expected):
    ctrl = _ctrl(backend)
    _traced(lambda: ctrl.step(np.array([1.0, 0.0]), u_prev=np.zeros(1)))
    recs = tracing.records_since()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["mpc.step"]
    assert set(tracing.snapshot()["spans"]) == set(expected) | {"mpc.step"}
    for r in recs:
        assert r["request"] == roots[0]["id"]
        if r["parent"] is not None:
            assert by_id[r["parent"]]["name"] == expected[r["name"]]


def test_self_times_and_the_childrens_cover():
    ctrl = _ctrl()
    _traced(lambda: _loop(ctrl, steps=3))
    recs = tracing.records_since()
    cover = {}
    for r in recs:
        if r["parent"] is not None:
            cover[r["parent"]] = (cover.get(r["parent"], 0)
                                  + r["end_ns"] - r["start_ns"])
    for r in recs:
        assert cover.get(r["id"], 0) <= r["end_ns"] - r["start_ns"]
    spans = tracing.snapshot()["spans"]
    assert spans["mpc.step"]["count"] == 3
    for name, a in spans.items():
        assert 0.0 <= a["self_s"] <= a["host_s"], name
        assert a["device_s"] is None, name


@pytest.mark.parametrize("x0", [(1.0, 0.0), (-0.4, 0.3)])
def test_one_sync_per_check_from_a_cold_start(x0):
    ctrl = _ctrl()
    (_, res), _ = _traced(lambda: ctrl.step(np.asarray(x0),
                                            u_prev=np.zeros(1)))
    k = ctrl.cfg.check_every
    expect = (int(res.iters) - 1) // k + 2
    counters = tracing.snapshot()["counters"]
    assert counters["sync"] == counters["sync.solve"] == expect
    assert tracing.snapshot()["spans"]["sync"]["count"] == expect


@pytest.mark.parametrize("engine", [None, "mixed"])
def test_route_counter_matches_the_router(engine):
    ctrl = _ctrl()
    primal = ctrl.data.assemble(x=torch.randn(2, 4), D=torch.zeros(7),
                                Qp=ctrl.Qp)
    from pqp_for_mpc_tpu_torch.dual import dualize_forcing
    dual = dualize_forcing(ctrl._geom, primal.Fp, primal.Mp, primal.Kp)
    _traced(lambda: solve_auto(primal, dual, cfg=ctrl.cfg, engine=engine))
    routed = engine or route_solve(dual.n_con, 4, False, ctrl.cfg,
                                   m_dim=primal.n_var, platform="cpu")
    counters = tracing.snapshot()["counters"]
    assert {k: v for k, v in counters.items()
            if k.startswith("route.")} == {"route." + routed: 1}
    assert tracing.snapshot()["spans"]["solve.auto"]["count"] == 1


def test_launch_counts_are_the_wrappers_deltas(monkeypatch):
    ctrl = _ctrl()
    k1, k3 = (solve_kernel.fused_full_solve.launches,
              dict(tiled_kernel.streamed_pqp_iterations.launches))
    monkeypatch.setattr(tiled_kernel.streamed_pqp_iterations, "launches",
                        dict(k3))

    def run():
        ctrl.step(np.array([1.0, 0.0]), u_prev=np.zeros(1))
        # stand-ins for launches, which a CPU tensor never makes
        monkeypatch.setattr(solve_kernel.fused_full_solve, "launches",
                            k1 + 2)
        tiled_kernel.streamed_pqp_iterations.launches["bfloat16"] += 3

    _traced(run)
    snap = tracing.snapshot()["launches"]
    assert snap["k1"] == solve_kernel.fused_full_solve.launches - k1 == 2
    assert snap["k3.bfloat16"] == 3 and snap["k3.float32"] == 0
    assert sum(snap.values()) == 5


def test_results_are_the_same_bits_on_and_off():
    off = _loop(_ctrl(), steps=5)
    on, _ = _traced(lambda: _loop(_ctrl(), steps=5))
    assert tracing.snapshot()["spans"]["mpc.step"]["count"] == 5
    for a, b in zip(off, on):
        for f in ("U", "Y", "iters", "converged"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def _aten(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("aten::")]


def test_spans_hold_their_aten_events_on_the_profilers_clock():
    ctrl = _ctrl()
    u = torch.zeros(1)
    _, prof = _traced(lambda: _steps(ctrl, u))
    recs = tracing.records_since()
    aten = _aten(prof)
    assert aten
    for name, s, e in aten:
        inside = [r for r in recs if r["start_ns"] <= s <= r["end_ns"]]
        assert inside, name
        innermost = max(inside, key=lambda r: r["start_ns"])
        assert e <= innermost["end_ns"] + SLACK_NS, (name, innermost)
    # every einsum is assemble's, every step's operators the step's
    steps = [r for r in recs if r["name"] == "mpc.step"]
    asm = [r for r in recs if r["name"] == "build.assemble"]
    for name, s, e in aten:
        owners = asm if name == "aten::einsum" else steps
        assert any(r["start_ns"] - SLACK_NS <= s and e <= r["end_ns"]
                   + SLACK_NS for r in owners), name


def test_the_program_adds_no_profiler_event():
    ctrl = _ctrl()
    _, prof = _traced(lambda: _loop(ctrl, steps=2))
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not any(n.startswith(PREFIXES) for n in names)
    assert tracing.snapshot()["spans"]


def test_trace_exports_the_spans_over_their_operators(tmp_path):
    ctrl = _ctrl()
    with profiling.trace(str(tmp_path / "tr")):
        _loop(ctrl, steps=2)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "pqp_span"]
    assert {e["name"] for e in spans} == set(CONDENSED) | {"mpc.step"}
    assert len(spans) == len(tracing.records_since())
    asm = [e for e in spans if e["name"] == "build.assemble"]
    einsums = [e for e in doc["traceEvents"]
               if e.get("name") == "aten::einsum" and e.get("ph") == "X"]
    assert einsums
    slack_us = SLACK_NS / 1e3
    for e in einsums:
        assert any(a["ts"] - slack_us <= e["ts"] and e["ts"] + e["dur"]
                   <= a["ts"] + a["dur"] + slack_us for a in asm)


def test_records_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    ctrl = _ctrl()
    _traced(lambda: ctrl.step(np.array([1.0, 0.0]), u_prev=np.zeros(1)))
    snap = tracing.snapshot()
    assert len(tracing.records_since()) == 3 and snap["dropped"] > 0
    assert sum(a["count"] for a in snap["spans"].values()) == 3
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["dropped"] == 0
