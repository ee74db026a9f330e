"""The reference with a geometry per lane (``Qp`` (B, M, M), ``Gp``
(B, N, M)) and every certificate the program computes: per-lane copies of
one geometry agree with the shared path, each lane of a fleet of
quadruple tanks with its own valve split agrees with itself solved alone,
the certificate agrees with the program's ``check_terminate`` on every
lane for every setting of its three flags, and a small fleet runs through
``harness.run`` from a root of its own, where a broken answer, swapped
geometries and the bfloat16 control all fail its limit.  The shared cells'
comparisons read the same bits as the frozen shared-only reference."""

import itertools
import json
import shutil

import fleet_reference
import frozen_pqp
import pb_helpers
import pytest
import torch
from test_pb_faults import altered, not_a_number

from port_bench import harness
from port_bench.reference import condensed_mpc, pqp

F64 = torch.float64
TESTS = pb_helpers.REPO / "port_bench" / "tests"
DI = json.loads((pb_helpers.REPO / "port_bench" / "configs" /
                 "double_integrator_h7.json").read_text())
FLAGS = ("gap_from_complementarity", "strict_weak_duality",
         "feas_from_dual_gradient")
FLEET_CELL = "tank_fleet.cold"


def fleet_conf(horizon: int) -> dict:
    """A quadruple-tank fleet at the port's operating point P- (Johansson
    2000), each lane's valve split drawn between P+ and P-, dt = 1 s; the
    certificate is the explicit gap with the weak-duality test."""
    eye = lambda w: [[w if i == j else 0.0 for j in range(2)]
                     for i in range(2)]
    return {
        "kind": "quadruple_tank_fleet",
        "plant": {"dt": 1.0, "T": [62.0, 90.0, 23.0, 30.0],
                  "areas": [28.0, 32.0, 28.0, 32.0], "k": [3.33, 3.35],
                  "C": [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]],
                  "gamma_lo": [0.43, 0.34], "gamma_hi": [0.70, 0.60]},
        "horizon": horizon, "Qy": eye(1.0), "R": eye(0.1), "r": [1.0, 1.0],
        "u_min": [-1.0, -1.0], "u_max": [1.0, 1.0], "du_max": [0.5, 0.5],
        "n_var": 2 * horizon, "n_con": 8 * horizon,
        "solver": {"batch": dict(DI["solver"]["batch"],
                                 gap_from_complementarity=False,
                                 strict_weak_duality=True)}}


def di_qp(lanes=48, seed=1):
    g = torch.Generator().manual_seed(seed)
    x0 = 0.5 * torch.randn(2, lanes, generator=g, dtype=F64)
    return condensed_mpc.qp(DI, {"x0": x0, "u_prev": torch.zeros(
        1, lanes, dtype=F64)}, "cpu")


def fleet_lanes(lanes=8, seed=2):
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([[0.43], [0.34]], dtype=F64)
    hi = torch.tensor([[0.70], [0.60]], dtype=F64)
    return {"x0": 0.5 * torch.randn(4, lanes, generator=g, dtype=F64),
            "gamma": lo + (hi - lo) * torch.rand(2, lanes, generator=g,
                                                 dtype=F64),
            "u_prev": torch.zeros(2, lanes, dtype=F64)}


def rel(U, V):
    return float(((U - V).abs().amax(0) / V.abs().amax(0).clamp(min=1.0))
                 .max())


@pytest.mark.parametrize("mode", ["batch", "loop"])
@pytest.mark.parametrize("per_lane", [("Qp",), ("Gp",), ("Qp", "Gp")],
                         ids="+".join)
def test_per_lane_copies_of_one_geometry_match_the_shared_path(per_lane,
                                                               mode):
    s = DI["solver"][mode]
    Qp, Gp, Fp, Kp, Mp = di_qp()
    B = Fp.shape[1]
    U, unverified = pqp.exact(pqp.Dual(Qp, Gp, Fp, Kp, Mp,
                                       s["theta_floor"], F64), s)
    wide = lambda name, a: (a.expand(B, *a.shape).clone()
                            if name in per_lane else a)
    dual = pqp.Dual(wide("Qp", Qp), wide("Gp", Gp), Fp, Kp, Mp,
                    s["theta_floor"], F64)
    assert dual.Qd.shape == (B, 28, 28)
    Ul, unverified_l = pqp.exact(dual, s)
    assert unverified_l == unverified == 0
    assert rel(Ul, U) <= 1e-12


@pytest.mark.parametrize("gp", ["shared", "per_lane"])
def test_each_lane_of_a_fleet_is_the_lane_solved_alone(gp):
    conf = fleet_conf(8)
    s = conf["solver"]["batch"]
    lanes = fleet_lanes()
    Qp, Gp, Fp, Kp, Mp = fleet_reference.qp(conf, lanes, "cpu")
    assert Qp.shape == (8, 16, 16) and Gp.shape == (64, 16)
    # each lane its own Hessian
    assert min(float((Qp[i] - Qp[j]).abs().max())
               for i, j in itertools.combinations(range(8), 2)) > 1e-3
    if gp == "per_lane":
        Gp = Gp.expand(8, *Gp.shape).clone()
    U, unverified = pqp.exact(pqp.Dual(Qp, Gp, Fp, Kp, Mp, s["theta_floor"],
                                       F64), s)
    assert unverified == 0
    active = 0
    for b in range(8):
        one = {k: v[:, b:b + 1] for k, v in lanes.items()}
        q = fleet_reference.qp(conf, one, "cpu")
        dual = pqp.Dual(q[0][0], *q[1:], s["theta_floor"], F64)
        Ub, unv = pqp.exact(dual, s)
        assert unv == 0
        assert rel(U[:, b:b + 1], Ub) <= 1e-9, b
        active += int(((dual.Gp @ Ub - dual.Kp).abs() < 1e-7).sum())
    assert active > 0          # the fleet's answers sit on their bounds


def _checkpoints(dual: pqp.Dual, s: dict, checks: int):
    """The reference's own iterates at its first ``checks`` checks."""
    seen = []

    def stop(Y, h, done):
        seen.append(Y)
        return torch.zeros_like(done), Y
    pqp._iterate(dual, dict(s, max_iters=s["check_every"] * (checks - 1)),
                 stop)
    return seen


@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=3)),
                         ids=lambda f: "".join("FT"[x] for x in f))
@pytest.mark.parametrize("geometry", ["shared", "per_lane"])
def test_certificate_agrees_with_the_programs_check(geometry, flags):
    from pqp_for_mpc_tpu_torch.config import SolverConfig
    from pqp_for_mpc_tpu_torch.problem import DualQP, PrimalQP
    from pqp_for_mpc_tpu_torch.solver import check_terminate
    if geometry == "shared":
        qp, s = di_qp(), DI["solver"]["batch"]
    else:
        conf = fleet_conf(8)
        qp, s = fleet_reference.qp(conf, fleet_lanes(), "cpu"), \
            conf["solver"]["batch"]
    s = dict(s, **dict(zip(FLAGS, flags)))
    cfg = SolverConfig(**s)
    d = pqp.Dual(*qp, s["theta_floor"], F64)
    primal = PrimalQP(Qp=d.Qp, Qp_inv=d.Qpi, Fp=d.Fp, Mp=d.Mp, Gp=d.Gp,
                      Kp=d.Kp)
    theta = torch.diagonal(d.Qdp, dim1=-2, dim2=-1) - torch.clamp(
        torch.diagonal(d.Qd, dim1=-2, dim2=-1), min=0.0)
    dual = DualQP(Qd=d.Qd, Fd=d.Fd, Md=d.Md, theta=theta, Qdp_theta=d.Qdp,
                  Qdn_theta=d.Qdn, Fdp=d.Fdp, Fdn=d.Fdn)
    passed = 0
    for Y in _checkpoints(d, s, 200):
        ours = d.certificate(Y, s)
        theirs = check_terminate(primal, dual, Y, cfg)[0]
        assert torch.equal(ours, theirs)
        passed += int(ours.sum())
    if not (s["strict_weak_duality"]
            and not s["gap_from_complementarity"]):
        # (the explicit gap's weak-duality test needs a rounding to pass)
        assert 0 < passed < 200 * d.Fd.shape[1]


def test_frozen_reference_reads_the_same_bits_on_the_shared_cells(
        monkeypatch):
    bench = harness.Bench()
    for cell in sorted(pb_helpers.TINY):
        r = harness.run(bench, cell, pb_helpers.SEED, pb_helpers.SECONDS,
                        False, device="cpu",
                        overrides=pb_helpers.TINY[cell], keep_samples=True)
        samples, rows = r["_samples"]
        conf = bench.config(bench.cell(cell)["config"])
        s = conf["solver"][bench.traffic(bench.cell(cell)["traffic"])
                           ["mode"]]
        ref = bench.module("reference", conf["kind"])
        args = (ref, conf, s, rows, samples, torch.device("cpu"))
        now = harness.compare(*args)
        with monkeypatch.context() as m:
            m.setattr(harness, "pqp", frozen_pqp)
            then = harness.compare(*args)
        assert now == then
        assert now[0]["u_err"] == r["checks"]["u_err"]["value"] > 0.0
        lanes = {k: torch.cat([x[0][k].double() for x in samples], -1)
                 for k in samples[0][0]}
        qp = ref.qp(conf, {k: v[:, :64] for k, v in lanes.items()}, "cpu")
        U, _ = pqp.exact(pqp.Dual(*qp, s["theta_floor"], F64), s)
        Uf, _ = frozen_pqp.exact(frozen_pqp.Dual(*qp, s["theta_floor"], F64),
                                 s)
        assert torch.equal(U, Uf)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A benchmark whose extra cell, a fleet of 4 quadruple tanks at H=4
    per batch, lives in a root of its own: its configuration, traffic,
    limit, ``problems/`` and ``reference/`` kind."""
    root = tmp_path_factory.mktemp("fleet_bench")
    for sub in ("configs", "traffic", "limits", "problems", "reference"):
        (root / sub).mkdir()
    shutil.copy(TESTS / "fleet_problem.py",
                root / "problems" / "quadruple_tank_fleet.py")
    shutil.copy(TESTS / "fleet_reference.py",
                root / "reference" / "quadruple_tank_fleet.py")
    (root / "configs" / "tank_fleet_h4.json").write_text(
        json.dumps(fleet_conf(4)))
    (root / "traffic" / "fleet_cold.json").write_text(json.dumps(
        {"mode": "batch", "lanes": 4, "draw_std": 0.5, "warmup": 1,
         "trace_steps": 1, "sample_lanes": 16}))
    # between the program's readings on the CPU (at most 8.0e-4 over five
    # seeds) and the bfloat16 control's (at least 0.070)
    (root / "limits" / f"{FLEET_CELL}.json").write_text(
        json.dumps({"u_err": 0.01}))
    spec = json.loads(harness.Bench().path.read_text())
    spec["configs"].append({"name": "tank_fleet_h4", "source": "x",
                            "file": str(root / "configs" /
                                        "tank_fleet_h4.json"),
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": FLEET_CELL, "config": "tank_fleet_h4",
                              "traffic": "fleet_cold", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append(FLEET_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root / "BENCHMARK.json", roots=(root, harness.HERE))


def _fleet_run(fleet, **kw):
    return harness.run(fleet, FLEET_CELL, pb_helpers.SEED,
                       pb_helpers.SECONDS, kw.pop("trace", False),
                       device="cpu", **kw)


def test_fleet_dry_run_through_the_harness(fleet):
    r = _fleet_run(fleet, trace=True)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["u_err"]["value"] <= r["checks"]["u_err"]["limit"]
    # the route the program counted in the traced window
    assert r["_info"]["route"] == "xla"
    # the cells already there are untouched
    assert fleet.cell("di_h7.fanout_cold") == \
        harness.Bench().cell("di_h7.fanout_cold")


def test_fleet_blocks_by_bytes(fleet, monkeypatch):
    """Lanes with geometries of their own are solved as many to a block as
    REF_BYTES holds, and read as in one block."""
    r = _fleet_run(fleet, keep_samples=True)
    samples, rows = r["_samples"]
    conf = fleet.config("tank_fleet_h4")
    ref = fleet.module("reference", conf["kind"])
    args = (ref, conf, conf["solver"]["batch"], rows, samples,
            torch.device("cpu"))
    whole = harness.compare(*args)
    monkeypatch.setattr(harness, "REF_BYTES", 3 * harness.lane_bytes(32, 8))
    sizes = [len(b["x0"][0]) for _, b, _ in harness.ref_blocks(
        ref, conf, {"x0": torch.zeros(4, 10), "gamma": torch.full(
            (2, 10), 0.5), "u_prev": torch.zeros(2, 10)}, "cpu", 512)]
    assert sizes == [3, 3, 3, 1]
    assert harness.compare(*args) == whole


@pytest.mark.parametrize("fault", ["swapped", "altered", "not_a_number"])
def test_broken_fleet_answers_are_not_correct(fleet, fault, monkeypatch):
    kind = fleet.module("problems", "quadruple_tank_fleet")
    if fault == "swapped":
        build = kind.Problem.build

        def swapped(self, params):
            """Lanes 0 and 1 solved with each other's geometry."""
            gam = params["gamma"].clone()
            gam[:, [0, 1]] = gam[:, [1, 0]]
            return build(self, dict(params, gamma=gam))
        monkeypatch.setattr(kind.Problem, "build", swapped)
    else:
        wrap = {"altered": altered, "not_a_number": not_a_number}[fault]
        monkeypatch.setattr(kind, "solve_auto", wrap(kind.solve_auto))
    r = _fleet_run(fleet)
    assert r["correct"] is False
    assert not r["checks"]["u_err"]["value"] <= r["checks"]["u_err"]["limit"]


def test_fleet_bf16_control_fails_the_limit(fleet):
    r = _fleet_run(fleet, keep_samples=True)
    samples, rows = r["_samples"]
    conf = fleet.config("tank_fleet_h4")
    s = conf["solver"]["batch"]
    ref = fleet.module("reference", conf["kind"])
    control = harness.control_solver(ref, conf, s, torch.device("cpu"))
    values, compared, unverified = harness.compare(
        ref, conf, s, rows, samples, torch.device("cpu"), answer=control)
    assert compared > 0 and unverified == 0
    assert values["u_err"] > fleet.limits(FLEET_CELL)["u_err"]
