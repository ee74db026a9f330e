"""Twins of ``examples/`` on the CPU (see ``test_torch_examples.py``): the
closed-loop weight tuning through 25 differentiated solves per rollout,
which the JAX package runs by hand, at its default, asserting the
example's result line (the example also asserts its goal: the closed-loop
cost down by 0.5) and held to the JAX example's printed costs and tuned
R."""

import pytest
import torch

from pqp_for_mpc_tpu_torch.examples import learned_mpc_closed_loop
from tests.test_torch_examples import hold_to_jax, run_jax, run_twin


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_learned_mpc_closed_loop(capsys, monkeypatch, tmp_path):
    out = run_twin(learned_mpc_closed_loop, [], capsys)
    assert "closed-loop cost" in out and "->" in out
    ref = run_jax("learned_mpc_closed_loop", [], capsys, monkeypatch,
                  tmp_path)
    hold_to_jax(out, ref, [(r"closed-loop cost (\S+) -> (\S+) \(tuned "
                            r"R = (\S+);", "value")])
