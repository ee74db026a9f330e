"""Twins of ``examples/`` on the CPU (see ``test_torch_examples.py``): the
nonlinear loops (real-time iteration on the pendulum, and the same with
the relinearizing MHE closing the loop from angle-only measurements), each
at its JAX test's arguments, asserting that test's line and held to the
JAX example's printed numbers."""

import pytest
import torch

from pqp_for_mpc_tpu_torch.examples import (nonlinear_mpc,
                                            output_feedback_nonlinear_mpc)
from tests.test_torch_examples import hold_to_jax, run_jax, run_twin


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_nonlinear_mpc(capsys, monkeypatch, tmp_path):
    # 30 steps: the swing-up is under way (|theta| < 0.5 rad from 2.5)
    out = run_twin(nonlinear_mpc, ["30"], capsys)
    assert "theta: start +2.500" in out
    ref = run_jax("nonlinear_mpc", ["30"], capsys, monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"start (\S+) rad -> final (\S+) rad", "value"),
                           (r"\|u\| max (\S+),", "value"),
                           (r"solver iters mean (\d+)", "iters")])


def test_output_feedback_nonlinear_mpc(capsys, monkeypatch, tmp_path):
    out = run_twin(output_feedback_nonlinear_mpc, ["40"], capsys)
    assert "stabilized upright from angle-only measurements: OK" in out
    ref = run_jax("output_feedback_nonlinear_mpc", ["40"], capsys,
                  monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"certified: mhe (\d+%) / rti (\d+%)", "same"),
                           (r"iters/step mhe (\d+) / rti (\d+)", "iters"),
                           (r"theta (\S+), omega (\S+)", "value"),
                           (r"final \|x\| = (\[.*?\])", "value"),
                           (r"measurements: (\w+)", "same")])
