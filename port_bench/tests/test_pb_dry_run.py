"""A tiny CPU run of every cell through the port's plain routes, in a
process of its own: one last line with the result's keys, the compared
numbers last on standard error, and neither JAX nor the JAX package
loaded."""

import json
import subprocess
import sys

import pb_helpers
import pytest

SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
from port_bench import harness
r = harness.run(harness.Bench(), {cell!r}, {seed}, {seconds}, {trace},
                device="cpu", overrides={over!r})
harness.emit(r)
print(json.dumps({{"loaded": harness.forbidden_modules()}}), file=sys.stderr)
"""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(pb_helpers.TINY))
def test_cpu_dry_run_prints_one_result_line(cell, trace):
    code = SCRIPT.format(repo=str(pb_helpers.REPO), cell=cell,
                         seed=pb_helpers.SEED, seconds=pb_helpers.SECONDS,
                         trace=bool(trace), over=pb_helpers.TINY[cell])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=pb_helpers.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys[5:-1]) <= ({"breakdown"} if trace else set())
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu"
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        earlier = json.loads(lines[-2])
        assert earlier["route"] == "xla" and "k1" in earlier["launches"]
        assert "busy_s" in result["device"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"]
    err = proc.stderr.strip().splitlines()
    assert json.loads(err[-1]) == {"loaded": []}
    name, value, word, limit = err[-2].split()
    assert (name, word) == ("u_err", "limit")
    assert float(value) == result["checks"]["u_err"]["value"]


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "di_h7.loop_warm", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=pb_helpers.REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
