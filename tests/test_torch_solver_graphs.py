"""The solve loop's device-side ``h`` and the rule that decides where the
loop's blocks replay CUDA graphs, on the CPU.

``_solve_core`` keeps ``h`` (the iteration a check stamps into ``iters``)
as a 0-d int32 tensor on the solve's device, advanced by the update
block, so that a captured check stamps the value of the current replay.
Here the loop is held bit for bit against the loop with a host integer
``h`` (the body before the graphs, copied below) on the double integrator
at horizon 7: cold, warm, with acceleration and the dual-gradient
certificate, with a NaN lane and at an exhausted ``max_iters``.  The rule
(:func:`~pqp_for_mpc_tpu_torch.solver.graphs_engage`) is held as a pure
function, and a controller's successive steps are held to one graph key.
The graphs themselves run only on a GPU: ``tests/test_torch_graphs_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pqp_for_mpc_tpu_torch import dualize
from pqp_for_mpc_tpu_torch import solver as tsolver
from pqp_for_mpc_tpu_torch.config import MPC_CONFIG
from pqp_for_mpc_tpu_torch.models import MPCController, MPCSpec, condense
from pqp_for_mpc_tpu_torch.models import double_integrator
from pqp_for_mpc_tpu_torch.solver import (SolveResult, accel_step,
                                          check_terminate, pqp_update)

B = 8
SMOKE = dataclasses.replace(MPC_CONFIG, feas_from_dual_gradient=False,
                            accel_every=0, max_iters=5000)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec():
    return MPCSpec(double_integrator(), horizon=7, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.array([2.5]), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=0.5 * np.ones(1))


@pytest.fixture(scope="module")
def problem():
    data = condense(_spec(), device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(0.0, 0.5, (2, B))
                        .astype(np.float32))
    primal = data.assemble(x=x, Qp=data.qp())
    return primal, dualize(primal)


def _host_h_loop(primal, dual, Y0, cfg):
    """The plain loop with a host integer ``h``, as it stood before the
    loop kept ``h`` on the device."""
    B = Y0.shape[1]
    k = cfg.check_every

    def run_updates(Y, done):
        def mult(Y, n):
            for _ in range(n):
                Y = torch.where(done[None, :], Y,
                                pqp_update(dual, Y, den_eps=cfg.den_eps))
            return Y
        if not cfg.accel_every:
            return mult(Y, k)
        for _ in range(k // cfg.accel_every):
            Y = accel_step(dual, mult(Y, cfg.accel_every), done)
        return Y

    Y = Y0
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    div = torch.zeros(B, dtype=torch.bool)
    h = 1
    while h <= cfg.max_iters and not bool(done.all()):
        ok = check_terminate(primal, dual, Y, cfg)[0]
        bad = ~torch.isfinite(Y).all(dim=0) & ~done
        newly = ok & ~done & ~bad
        iters = torch.where(newly | bad, h, iters)
        done = done | ok | bad
        div = div | bad
        Y = run_updates(Y, done)
        h += k
    ok, U, feas, Jp, Jd = check_terminate(primal, dual, Y, cfg)
    bad = ~torch.isfinite(Y).all(dim=0)
    newly_bad = bad & ~done
    div = div | newly_bad
    newly = ok & ~done & ~bad
    iters = torch.where(newly | newly_bad, h, iters)
    done = done | ok | bad
    iters = torch.where(done, iters, h).to(torch.int32)
    return SolveResult(U=U, Y=Y, iters=iters, converged=done & ~div,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def _warm(primal, dual):
    """Multipliers of the batch's own solve at looser tolerances."""
    loose = dataclasses.replace(SMOKE, eaj=1e-2, erj=1e-2)
    return torch.clamp(tsolver.solve_batched(primal, dual, cfg=loose).Y,
                       min=1e-6)


def _nan_lane(primal, dual):
    Y0 = torch.full((dual.n_con, B), SMOKE.y0)
    Y0[3, 5] = float("nan")
    return Y0


CASES = {
    "cold": (SMOKE, None),
    "warm": (SMOKE, _warm),
    "loop_cfg": (MPC_CONFIG, None),
    "loop_cfg_warm": (MPC_CONFIG, _warm),
    "nan_lane": (SMOKE, _nan_lane),
    "max_iters": (dataclasses.replace(SMOKE, max_iters=17), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_side_h_matches_the_host_h_loop(problem, case):
    primal, dual = problem
    cfg, start = CASES[case]
    Y0 = (torch.full((dual.n_con, B), cfg.y0) if start is None
          else start(primal, dual))
    got = tsolver._solve_core(primal, dual, Y0, cfg)
    want = _host_h_loop(primal, dual, Y0, cfg)
    assert got.iters.dtype == torch.int32
    for f in dataclasses.fields(SolveResult):
        torch.testing.assert_close(getattr(got, f.name),
                                   getattr(want, f.name), rtol=0, atol=0,
                                   equal_nan=True, msg=f.name)
    if case == "nan_lane":
        assert bool(got.diverged[5]) and int(got.diverged.sum()) == 1
    if case == "max_iters":
        # h after three rounds of 8 updates: 25 on every unfinished lane
        assert not bool(got.converged.all())
        assert set(got.iters[~got.converged].tolist()) == {25}
    else:
        assert int(got.converged.sum()) >= B - 1


RULE = {
    # (device type, batch, plain body, key solved before) -> engages
    "cuda_repeat": (("cuda", 1, True, True), True),
    "cuda_lane_width_less_one": (("cuda", 127, True, True), True),
    "cuda_first_solve": (("cuda", 1, True, False), False),
    "cpu": (("cpu", 1, True, True), False),
    "cuda_lane_width": (("cuda", 128, True, True), False),
    "cuda_wide_batch": (("cuda", 1 << 22, True, True), False),
    "cuda_use_pallas": (("cuda", 1, False, True), False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_graphs_engage_rule(case):
    args, want = RULE[case]
    assert tsolver.graphs_engage(*args) is want


def test_use_pallas_makes_the_body_not_plain(problem):
    primal, dual = problem
    assert tsolver._loop_blocks(primal, dual, SMOKE)[0]
    assert not tsolver._loop_blocks(
        primal, dual, dataclasses.replace(SMOKE, use_pallas=True))[0]


def test_cpu_solves_keep_no_graph_key(problem):
    primal, dual = problem
    tsolver._GRAPHS.clear()
    for _ in range(3):
        tsolver.solve_batched(primal, dual, cfg=SMOKE)
    assert len(tsolver._GRAPHS) == 0


def _step_keys(monkeypatch, ctrl, steps):
    keys = []
    core = tsolver._solve_core

    def spy(primal, dual, Y0, cfg):
        keys.append(tsolver._graph_key(primal, dual, Y0, cfg))
        return core(primal, dual, Y0, cfg)

    monkeypatch.setattr(tsolver, "_solve_core", spy)
    x, u = np.array([0.5, -0.2]), np.zeros(1)
    for _ in range(steps):
        u0, _ = ctrl.step(x, u_prev=u)
        u = u0.numpy().astype(np.float64)
        x = np.array([[1.0, 0.1], [0.0, 1.0]]) @ x + 0.1 * u[0] * \
            np.array([0.05, 1.0])
    return keys


def test_a_controllers_steps_share_one_key(monkeypatch):
    ctrl = MPCController(_spec(), device="cpu")
    keys = _step_keys(monkeypatch, ctrl, 4)
    # the cold first step and the warm ones: one key, so a control loop
    # captures on its second step
    assert keys[0] is not None and len(set(keys)) == 1
    other = _step_keys(monkeypatch, MPCController(_spec(), device="cpu"), 1)
    assert other[0] != keys[0]          # another controller's geometry


def test_the_key_follows_shapes_and_the_loop_settings(problem):
    primal, dual = problem
    Y0 = torch.full((dual.n_con, B), 1.0)
    key = tsolver._graph_key(primal, dual, Y0, SMOKE)
    assert key == tsolver._graph_key(primal, dual, Y0.clone(), SMOKE)
    # max_iters is the host's test, not the body's
    assert key == tsolver._graph_key(
        primal, dual, Y0, dataclasses.replace(SMOKE, max_iters=7))
    assert key != tsolver._graph_key(
        primal, dual, Y0, dataclasses.replace(SMOKE, check_every=4))
    assert key != tsolver._graph_key(primal, dual, Y0[:, :4],
                                     SMOKE)
    grad = dataclasses.replace(primal, Kp=primal.Kp.clone()
                               .requires_grad_(True))
    assert tsolver._graph_key(grad, dual, Y0, SMOKE) is None
