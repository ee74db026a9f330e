"""The comparison sees a broken timed path: with the program's solve
broken underneath, a run (the harness's look for a card skipped, the rest
as the benchmark runs it) comes out not correct, once for each fault the
cell can have.  The cells run on one card, so no exchange between cards
can be left out; a loop of one lane has no half batch."""

import dataclasses

import pb_helpers
import pytest
import torch

import pqp_for_mpc_tpu_torch.models.mpc as port_mpc
from port_bench import harness
from pqp_for_mpc_tpu_torch.solver import recover_U


def stale(real):
    """A step that returns its state unchanged: the previous step's
    result, and at the first step the initial iterate."""
    prev = {}

    def solve(primal, dual, Y0=None, cfg=None, **kw):
        res = real(primal, dual, Y0=Y0, cfg=cfg, **kw)
        out = prev.get("res")
        if out is None or out.U.shape != res.U.shape:
            Y = torch.full_like(res.Y, cfg.y0)
            out = dataclasses.replace(res, Y=Y, U=recover_U(primal, Y))
        prev["res"] = res
        return out
    return solve


def half(real):
    """Half of the batch left out: its lanes get the other half's
    answers."""
    def solve(*a, **kw):
        res = real(*a, **kw)
        U = res.U.clone()
        h = U.shape[1] // 2
        U[:, h:] = res.U[:, :U.shape[1] - h]
        return dataclasses.replace(res, U=U)
    return solve


def altered(real):
    """An answer altered where it is produced: every fourth lane's first
    input moved by a tenth of the lane's largest."""
    def solve(*a, **kw):
        res = real(*a, **kw)
        U = res.U.clone()
        U[0, ::4] += 0.1 * U[:, ::4].abs().amax(0)
        return dataclasses.replace(res, U=U)
    return solve


def not_a_number(real):
    """An answer that is not a number: every fourth lane's first input."""
    def solve(*a, **kw):
        res = real(*a, **kw)
        U = res.U.clone()
        U[0, ::4] = float("nan")
        return dataclasses.replace(res, U=U)
    return solve


CASES = [(cell, fault) for cell in sorted(pb_helpers.TINY)
         for fault in (stale, half, altered, not_a_number)
         if not (fault is half and cell == "di_h7.loop_warm")]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    bench = harness.Bench()
    conf = bench.config(bench.cell(cell)["config"])
    kind = bench.module("problems", conf["kind"])
    monkeypatch.setattr(kind, "solve_auto", fault(kind.solve_auto))
    monkeypatch.setattr(port_mpc, "solve_auto", fault(port_mpc.solve_auto))
    r = harness.run(bench, cell, pb_helpers.SEED, pb_helpers.SECONDS, False,
                    device="cpu", overrides=pb_helpers.TINY[cell])
    assert r["correct"] is False
    assert not r["checks"]["u_err"]["value"] <= r["checks"]["u_err"]["limit"]
