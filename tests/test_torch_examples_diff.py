"""Twins of ``examples/`` on the CPU (see ``test_torch_examples.py``):
the batched Adam training through the solver (``solve_qp_implicit``) at
its JAX test's arguments, asserting that test's line, and the one-step
input tuning the JAX package runs by hand, at its default, asserting the
example's own result line (the example also asserts its goal: the tuned
input within 0.05 of its target).  Each is held to the JAX example's
printed numbers: the losses and R of the printed steps, the tuned R and
the first input.  ``learned_mpc_closed_loop`` is in
``test_torch_examples_learned.py``."""

import pytest
import torch

from pqp_for_mpc_tpu_torch.examples import differentiable_mpc, train_mpc_optax
from tests.test_torch_examples import hold_to_jax, run_jax, run_twin


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_train_mpc_optax(capsys, monkeypatch, tmp_path):
    """Batched training through the implicit-diff solve: the loss over a
    scenario batch must decrease (the example asserts it), step by step as
    optax's clipped Adam takes it in the JAX example."""
    out = run_twin(train_mpc_optax, ["4", "6"], capsys)
    assert "->" in out and "scenarios" in out
    ref = run_jax("train_mpc_optax", ["4", "6"], capsys, monkeypatch,
                  tmp_path)
    hold_to_jax(out, ref, [(r"step\s+(\d+)", "same"),
                           (r"step\s+\d+\s+loss (\S+)\s+R=(\S+)", "value"),
                           (r"loss (\S+) -> (\S+) over", "value")])


def test_differentiable_mpc(capsys, monkeypatch, tmp_path):
    out = run_twin(differentiable_mpc, [], capsys)
    assert "(target -0.6)" in out
    ref = run_jax("differentiable_mpc", [], capsys, monkeypatch, tmp_path)
    hold_to_jax(out, ref, [(r"tuned R = (\S+); first input (\S+)",
                            "value")])
