"""``graph_replays_per_step``'s reader on synthetic snapshots of the
program's spans and counters: replays per ``mpc.step``, 0 for a program
with graphs that replayed none, and nothing for an untraced run, a window
without steps, or a program whose solver has no graphs."""

import types

import pb_helpers  # noqa: F401  (puts the repo on sys.path)
import pytest

from port_bench import harness
from port_bench.metrics import program_spans
from pqp_for_mpc_tpu_torch import solver

STEP = {"count": 200, "host_s": 2.4, "self_s": 0.1, "device_s": None}


def _read(monkeypatch, snap, trace=True):
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda ctx: None if ctx.trace is None else snap)
    ctx = types.SimpleNamespace(trace={} if trace else None)
    return harness.Bench().module(
        "metrics", "graph_replays_per_step.warm").read(ctx)


@pytest.mark.parametrize("replays,want", [(1900, 9.5), (0, 0.0)])
def test_replays_per_step(monkeypatch, replays, want):
    snap = {"spans": {"mpc.step": STEP},
            "counters": {"graph.replay": replays, "graph.capture": 0}}
    assert _read(monkeypatch, snap) == want


def test_no_counter_reads_zero_where_the_solver_has_graphs(monkeypatch):
    snap = {"spans": {"mpc.step": STEP}, "counters": {"sync": 947}}
    assert _read(monkeypatch, snap) == 0.0
    monkeypatch.delattr(solver, "graphs_engage")
    assert _read(monkeypatch, snap) is None


def test_nothing_without_a_trace_or_steps(monkeypatch):
    snap = {"spans": {}, "counters": {"graph.replay": 10}}
    assert _read(monkeypatch, snap) is None
    assert _read(monkeypatch, {"spans": {"mpc.step": STEP},
                               "counters": {}}, trace=False) is None
