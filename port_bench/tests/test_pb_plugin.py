"""A configuration, a traffic mix, a metric and a limit added as files
only, in a directory of their own, are picked up by name: no file of the
benchmark is edited."""

import json

import pb_helpers
from port_bench import harness

METRIC = '''"""lanes_per_step.fake: lanes the window solved per step."""


def read(ctx):
    return ctx.lanes / ctx.steps
'''


def test_files_added_elsewhere_are_found_by_name(tmp_path):
    extra = tmp_path / "more_bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (extra / sub).mkdir(parents=True)
    base = harness.Bench()
    conf = base.config("double_integrator_h7")
    conf.update(horizon=3, n_var=3, n_con=12)
    (extra / "configs" / "double_integrator_h3.json").write_text(
        json.dumps(conf))
    mix = dict(base.traffic("fanout_cold"), lanes=64, sample_lanes=4,
               trace_steps=1)
    (extra / "traffic" / "small_cold.json").write_text(json.dumps(mix))
    (extra / "metrics" / "lanes_per_step.fake.py").write_text(METRIC)
    (extra / "limits" / "di_h3.small_cold.json").write_text(
        json.dumps({"u_err": 0.025}))
    spec = json.loads(base.path.read_text())
    spec["configs"].append({"name": "double_integrator_h3", "source": "x",
                            "file": "more_bench/configs/double_integrator_h3.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "di_h3.small_cold",
                              "config": "double_integrator_h3",
                              "traffic": "small_cold", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "lanes_per_step.fake", "unit": "lanes",
                              "better": "higher", "source": "host_clock",
                              "layer": "solver", "moves": "solves_per_s",
                              "workloads": ["di_h3.small_cold"]})
    for m in spec["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("di_h3.small_cold")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(tmp_path / "BENCHMARK.json",
                          roots=(extra, harness.HERE))
    r = harness.run(bench, "di_h3.small_cold", pb_helpers.SEED,
                    pb_helpers.SECONDS, True, device="cpu")
    assert r["metrics"]["lanes_per_step.fake"] == {"value": 64.0,
                                                   "unit": "lanes"}
    assert r["correct"] is True
    # the cells already there are untouched
    assert bench.cell("di_h7.fanout_cold") == base.cell("di_h7.fanout_cold")
