"""The route on the line before a traced result is what the program
counted (its ``route.<engine>`` counter over the traced window); an
untraced run gives the engine the router picks for the cell."""

import pb_helpers
import pytest

from port_bench import harness


@pytest.mark.parametrize("cell", sorted(pb_helpers.TINY))
def test_traced_route_comes_from_the_programs_counter(cell, monkeypatch):
    bench = harness.Bench()
    kind = bench.module("problems", bench.config(
        bench.cell(cell)["config"])["kind"])
    monkeypatch.setattr(kind.Problem, "route",
                        lambda self, lanes, warm: "planned")
    run = lambda trace: harness.run(
        bench, cell, pb_helpers.SEED, pb_helpers.SECONDS, trace,
        device="cpu", overrides=pb_helpers.TINY[cell])["_info"]
    assert run(False)["route"] == "planned"
    assert run(True)["route"] == "xla"
