"""Twins of ``examples/`` on the CPU (see ``test_torch_examples.py``):
the large-N mixed-precision solve (its printed certified counts held
against the JAX package's ``solve_batched`` and ``solve_mixed`` on the same
seeded problem) and the row-sharded large-N solve under ``torchrun`` on an
8-process gloo ring (2 x 4, so ``'converged': 16`` as in JAX's test on 8
devices; its printed counts held to the JAX example's on the 8-device
virtual CPU mesh).  The nonlinear loops are in
``test_torch_examples_nonlinear.py``."""

import os
import re
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pqp_for_mpc_tpu import SolverConfig as JConfig
from pqp_for_mpc_tpu import solve_batched as jsolve_batched
from pqp_for_mpc_tpu import solve_mixed as jsolve_mixed
from pqp_for_mpc_tpu.dual import dualize as jdualize
from pqp_for_mpc_tpu.problem import PrimalQP as JPrimal
from pqp_for_mpc_tpu_torch.examples import large_n_mixed
from tests.test_torch_examples import hold_to_jax, run_jax, run_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_large_n_mixed_counts_match_jax(capsys):
    out = run_twin(large_n_mixed, [], capsys)
    assert "certified 8/8" in out
    assert "max |dU|" in out
    got = {m.group(1): (int(m.group(2)), float(m.group(3))) for m in
           re.finditer(r"(f32|mixed)\s*:.*certified (\d+)/8\s+iters (\S+)",
                       out)}
    # examples/large_n_mixed.py's build of the same seeded problem
    N, M, B = 384, 96, 8
    rng = np.random.default_rng(0)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    primal = JPrimal(
        Qp=jnp.asarray(Qp),
        Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
        Fp=jnp.asarray(rng.normal(0, 3, (M, B)).astype(np.float32)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(rng.normal(0, 1, (N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1, 10, N).astype(np.float32)))
    dual = jdualize(primal, materialize_splits=False)
    cfg = JConfig(max_iters=30000, check_every=16, accel_every=16,
                  strict_weak_duality=False, gap_from_complementarity=True)
    for name, fn in (("f32", jsolve_batched), ("mixed", jsolve_mixed)):
        want = jax.jit(partial(fn, cfg=cfg))(primal, dual)
        assert got[name][0] == int(np.asarray(want.converged).sum())
        it = float(np.asarray(want.iters).mean())
        assert abs(got[name][1] - it) <= max(16.0, it / 5), (name, it)


def test_sharded_large_n_under_torchrun(capsys, monkeypatch, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=8", "-m",
         "pqp_for_mpc_tpu_torch.examples.sharded_large_n", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh: {'data': 2, 'model': 4}" in proc.stdout
    assert "'converged': 16" in proc.stdout
    ref = run_jax("sharded_large_n", [], capsys, monkeypatch, tmp_path)
    hold_to_jax(proc.stdout, ref, [(r"(mesh: .*)", "same"),
                                   (r"'batch': (\d+)", "same"),
                                   (r"'converged': (\d+)", "same"),
                                   (r"'feasible': (\d+)", "same"),
                                   (r"'iters_mean': (\S+),", "iters")])
