"""Twins of ``examples/`` on the CPU (see ``test_torch_examples.py``): the
output-constrained loop on the stage-wise backend at its JAX test's
arguments, asserting that test's line and held to the JAX example's
printed numbers."""

import pytest
import torch

from pqp_for_mpc_tpu_torch.examples import constrained_outputs_mpc
from tests.test_torch_examples import hold_to_jax, run_jax, run_twin


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_constrained_outputs_mpc(capsys, monkeypatch, tmp_path):
    out = run_twin(constrained_outputs_mpc, ["48", "20"], capsys)
    assert "certified 100%" in out
    assert "bound honored: True" in out
    ref = run_jax("constrained_outputs_mpc", ["48", "20"], capsys,
                  monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"certified (\d+%)", "same"),
                           (r"y peak (\S+)", "value"),
                           (r"bound honored: (\w+)", "same"),
                           (r"y final (\S+)", "value")])
