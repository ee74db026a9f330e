"""BENCHMARK.json against the format and limits its readers hold it to,
and every file it needs found by name."""

import json
import re

import pb_helpers  # noqa: F401
import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"])
    assert len(spec["command"]) <= 32
    assert all(line_ok(w) for w in spec["command"])
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    cells = len(spec["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(spec["configs"]) <= 24
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units_use_only_allowed_characters(bench):
    spec = bench.spec
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))
    metrics = [n for is_metric, n in names if is_metric]
    assert len(metrics) == len(set(metrics))


def test_entries_have_just_the_allowed_keys(bench):
    spec = bench.spec
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
    assert len({c["source"] for c in spec["configs"]}) == len(spec["configs"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(spec["workloads"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in bench.spec["workloads"]:
        reported = [m["name"] for m in bench.metrics(w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = bench.metrics(w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in reported
    for m in bench.spec["per_layer"]:
        assert m["moves"] in e2e


def test_every_file_of_every_cell_is_found_by_name(bench):
    for w in bench.spec["workloads"]:
        conf = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert traffic["mode"] in ("batch", "loop")
        assert traffic["mode"] in conf["solver"]
        for sub in ("problems", "reference"):
            assert bench.module(sub, conf["kind"])
        assert set(bench.limits(w["name"])) == {"u_err"}
        for trace in (False, True):
            for m in bench.metrics(w["name"], trace):
                assert callable(bench.module("metrics", m["name"]).read)


def test_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench.spec["per_layer"]}
    assert layers == {"build and dualize", "solver", "kernels", "device"}
