"""The loop's states: with a pool, every seed runs the same segments in
another order, the warm-up the segment before the window's first; with
``"pool": 0``, each seed draws its own."""

import numpy as np
import pb_helpers
import pytest
import torch

from port_bench import harness


def states(seed, pool, steps):
    """The state of each of ``steps`` steps, the warm-up's first."""
    bench = harness.Bench()
    conf = bench.config("double_integrator_h7")
    traffic = dict(bench.traffic("loop_warm"), pool=pool, redraw_every=5)
    kind = bench.module("problems", conf["kind"])
    from pqp_for_mpc_tpu_torch.config import SolverConfig
    problem = kind.Problem(conf, SolverConfig(**conf["solver"]["loop"]),
                           traffic, torch.device("cpu"))
    loop = problem.loop(np.random.Generator(
        np.random.PCG64(harness.stream(seed, "plant"))))
    out = []
    for _ in range(steps):
        out.append(loop.x.copy())
        loop.advance(np.zeros(problem.nu))
    return np.array(out)


@pytest.mark.parametrize("seed", [pb_helpers.SEED, 7])
def test_a_pool_runs_the_same_segments_in_another_order(seed):
    a = states(seed, 4, 25)
    b = states(seed + 1, 4, 25)
    # a segment's first state is its drawn one: the same four in each run
    first = lambda s: {tuple(s[i]) for i in range(0, 20, 5)}
    assert first(a) == first(b)
    # the window (after one warm-up segment) runs the circle on, so the
    # warm-up's segment comes back as the window's last of a cycle
    np.testing.assert_array_equal(a[0:5], a[20:25])


def test_pool_zero_draws_each_seed_its_own():
    a = states(pb_helpers.SEED, 0, 10)
    b = states(pb_helpers.SEED + 1, 0, 10)
    assert not np.isin(a, b).any()
    np.testing.assert_array_equal(a, states(pb_helpers.SEED, 0, 10))
