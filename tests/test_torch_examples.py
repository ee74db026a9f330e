"""The twins of ``examples/`` (``pqp_for_mpc_tpu_torch.examples``) on the
CPU, each at its JAX test's arguments (``tests/test_examples.py``) with
``--device cpu``, asserting the line that test asserts, and held to the
JAX example itself: the example runs as its own test runs it, on the same
seeded inputs, and the numbers the twin prints are held to the ones it
prints (``hold_to_jax``).  Here the linear closed loops (condensed, and
the stage-wise long horizon) and the scenario fan-out, whose JAX example
reads the reference implementation's example directory: its printed
counts are held against the JAX package's solve of the same seeded
workload instead.  The other twins are in ``test_torch_examples_*.py``.
"""

import ast
import dataclasses
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import SolverConfig as JConfig
from pqp_for_mpc_tpu import dualize as jdualize
from pqp_for_mpc_tpu import solve_batched as jsolve_batched
from pqp_for_mpc_tpu.models import MPCSpec, condense, double_integrator
from pqp_for_mpc_tpu_torch.bench import EXAMPLE_CFG
from pqp_for_mpc_tpu_torch.examples import (long_horizon_mpc, offset_free_mpc,
                                            production_mpc, receding_horizon,
                                            scenario_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_twin(module, argv, capsys):
    """The twin's ``main`` on the CPU; its standard output."""
    module.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def run_jax(name, argv, capsys, monkeypatch, tmp_path):
    """``examples/<name>.py`` run as ``tests/test_examples.py`` runs it
    (its compile cache under ``tmp_path``); its standard output."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def hold_to_jax(got, want, fields):
    """Hold the twin's printout ``got`` to the JAX example's ``want``.

    ``fields`` are ``(regex, kind)`` or ``(regex, "iters", check_every)``:
    every group of every match is read from both, and must match as many
    times in each.  ``"same"`` groups are equal as text (verdicts,
    certified shares); ``"iters"`` numbers agree within max(5, iters/5),
    rounded up to whole checks where ``check_every`` is given, and
    ``"value"`` numbers within 5e-3 * max(1, |JAX's|): ROADMAP's parity
    bar.
    """
    def groups(text, pattern):
        found = re.findall(pattern, text)
        return [g for m in found for g in (m if isinstance(m, tuple)
                                           else (m,))]
    for pattern, kind, *check in fields:
        g, w = groups(got, pattern), groups(want, pattern)
        assert w and len(g) == len(w), (pattern, g, w)
        for gs, ws in zip(g, w):
            if kind == "same":
                assert gs == ws, (pattern, gs, ws)
                continue
            gv = np.array(_NUMBER.findall(gs), float)
            wv = np.array(_NUMBER.findall(ws), float)
            assert wv.size and gv.shape == wv.shape, (pattern, gs, ws)
            if kind == "iters":
                bar = np.maximum(5.0, np.abs(wv) / 5)
                bar = -(-bar // check[0]) * check[0] if check else bar
            else:
                bar = 5e-3 * max(1.0, np.abs(wv).max())
            assert (np.abs(gv - wv) <= bar).all(), (pattern, gs, ws)


def test_receding_horizon(capsys, monkeypatch, tmp_path):
    out = run_twin(receding_horizon, ["30"], capsys)
    assert "steps in" in out
    assert "all converged: True" in out
    ref = run_jax("receding_horizon", ["30"], capsys, monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"final x = (\[.*?\])", "value"),
                           (r"iters mean (\d+) max (\d+)", "iters", 8),
                           (r"all converged: (\w+)", "same")])


def test_scenario_batch_counts_match_jax(capsys):
    out = run_twin(scenario_batch, ["64"], capsys)
    assert "solves/s" in out
    stats = ast.literal_eval(out.splitlines()[0])
    # the JAX package's solve of the same workload: bench.example_workload's
    # spec and NumPy draw, under the same configuration
    spec = MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))
    data = condense(spec)
    x = np.random.default_rng(0).normal(0.0, 0.5, (2, 64)).astype(np.float32)
    primal = data.assemble(x=jnp.asarray(x), Qp=data.qp())
    want = jsolve_batched(primal, jdualize(primal),
                          cfg=JConfig(**dataclasses.asdict(EXAMPLE_CFG)))
    assert stats["batch"] == 64
    assert stats["converged"] == int(np.asarray(want.converged).sum()) == 64
    assert stats["feasible"] == int(np.asarray(want.feasible).sum())
    it = float(np.asarray(want.iters).mean())
    assert abs(stats["iters_mean"] - it) <= max(5.0, it / 5)


def test_offset_free(capsys, monkeypatch, tmp_path):
    out = run_twin(offset_free_mpc, ["60"], capsys)
    assert "offset-free" in out
    assert "all converged: True" in out
    ref = run_jax("offset_free_mpc", ["60"], capsys, monkeypatch, tmp_path)
    # the max is step 0's cold solve: 41 iterations in JAX, 25 here
    # (ROADMAP queue 3), two checks of MPC_CONFIG's 8 apart
    hold_to_jax(out, ref, [(r"final \|y - r\| = (\S+)", "value"),
                           (r"d_hat = (\S+)", "value"),
                           (r"iters mean (\d+) max (\d+)", "iters", 8),
                           (r"all converged: (\w+)", "same")])


def test_long_horizon_mpc(capsys, monkeypatch, tmp_path):
    out = run_twin(long_horizon_mpc, ["64", "12"], capsys)
    assert "steps/s" in out
    assert "certified 100%" in out
    ref = run_jax("long_horizon_mpc", ["64", "12"], capsys, monkeypatch,
                  tmp_path)
    hold_to_jax(out, ref, [(r"certified (\d+%)", "same"),
                           (r"mean (\d+) iters/step", "iters"),
                           (r"\|x_final\| = (\S+)", "value")])


def test_production_mpc(capsys, monkeypatch, tmp_path):
    out = run_twin(production_mpc, ["80"], capsys)
    assert "production stack guarantees: OK" in out
    ref = run_jax("production_mpc", ["80"], capsys, monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"certified steps: (\d+%)", "same"),
                           (r"iters/step mean (\d+)", "iters", 8),
                           (r"max y = (\S+)", "value"),
                           (r"mean y over last period = (\S+)", "value"),
                           (r"d_hat settled at (\S+)", "value"),
                           (r"guarantees: (\w+)", "same")])
