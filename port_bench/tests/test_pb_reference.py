"""The float64 reference against the port at a tiny size, and the control
(the reference's own algorithm in bfloat16, in the program's place),
which the comparison has to reject at every cell's limit."""

import json

import numpy as np
import pb_helpers
import pytest
import torch

from port_bench import harness
from port_bench.reference import condensed_mpc, pqp


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


def _run(bench, cell, **kw):
    return harness.run(bench, cell, pb_helpers.SEED, pb_helpers.SECONDS,
                       False, device="cpu", overrides=pb_helpers.TINY[cell],
                       **kw)


@pytest.mark.parametrize("cell", sorted(pb_helpers.TINY))
def test_port_agrees_and_the_control_fails(bench, cell):
    r = _run(bench, cell, keep_samples=True)
    limit = bench.limits(cell)["u_err"]
    assert r["checks"]["u_err"]["value"] <= limit
    samples, rows = r["_samples"]
    conf = {**bench.config(bench.cell(cell)["config"]),
            **pb_helpers.TINY[cell].get("config", {})}
    mode = bench.traffic(bench.cell(cell)["traffic"])["mode"]
    ref = bench.module("reference", conf["kind"])
    control = harness.control_solver(ref, conf, conf["solver"][mode],
                                     torch.device("cpu"))
    values, compared, unverified = harness.compare(
        ref, conf, conf["solver"][mode], rows, samples, torch.device("cpu"),
        answer=control)
    assert compared > 0 and unverified == 0
    assert values["u_err"] > limit


def test_reference_condensing_matches_the_port():
    from pqp_for_mpc_tpu_torch.models import condense
    from port_bench.problems import condensed_mpc as prog
    conf = json.loads((pb_helpers.REPO / "port_bench" / "configs" /
                       "double_integrator_h7.json").read_text())
    x0 = torch.tensor([[0.3, -1.2], [0.1, 0.4]], dtype=torch.float64)
    u_prev = torch.tensor([[0.0, 0.2]], dtype=torch.float64)
    Qp, Gp, Fp, Kp, Mp = condensed_mpc.qp(
        conf, {"x0": x0, "u_prev": u_prev}, "cpu")
    data = condense(prog.spec(conf), device="cpu")
    primal = data.assemble(x=x0.float())
    np.testing.assert_allclose(Qp.numpy(), data.qp().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Gp.numpy(), data.Gp.numpy())
    np.testing.assert_allclose(Fp.numpy(), primal.Fp.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(Mp.numpy(), primal.Mp.numpy(), rtol=1e-5)
    np.testing.assert_allclose(Kp[:, 0].numpy(), data.Kp.numpy())
    assert float(Kp[14, 1]) == pytest.approx(0.5 + 0.2)
    assert float(Kp[21, 1]) == pytest.approx(0.5 - 0.2)


def test_exact_finish_verifies_degenerate_lanes():
    """Where a box and a slew bound meet (u_0 = 0.5 from rest, then
    u_1 = 1), more rows are active than are independent; the finish still
    verifies, and agrees with a long float64 iteration."""
    conf = json.loads((pb_helpers.REPO / "port_bench" / "configs" /
                       "double_integrator_h7.json").read_text())
    s = conf["solver"]["batch"]
    g = torch.Generator().manual_seed(1)
    x0 = 0.5 * torch.randn(2, 64, generator=g, dtype=torch.float64)
    lanes = {"x0": x0, "u_prev": torch.zeros(1, 64, dtype=torch.float64)}
    dual = pqp.Dual(*condensed_mpc.qp(conf, lanes, "cpu"), s["theta_floor"],
                    torch.float64)
    U, unverified = pqp.exact(dual, s)
    assert unverified == 0
    Ul, _ = pqp.exact(dual, dict(s, max_iters=20000, accel_every=4))
    assert float((U - Ul).abs().max()) < 1e-9
    Gp, Kp = dual.Gp, dual.Kp
    assert float((Gp @ U - Kp).max()) < 1e-9
