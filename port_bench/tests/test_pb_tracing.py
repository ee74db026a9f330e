"""A traced CPU dry run of every cell, in a process of its own: the loop's
line carries the five metrics read from the program's own spans and
counters, and no cell's line a device-timed one (no CUDA events on the
CPU)."""

import json
import subprocess
import sys

import pb_helpers
import pytest

SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
from port_bench import harness
r = harness.run(harness.Bench(), {cell!r}, {seed}, {seconds}, True,
                device="cpu", overrides={over!r})
harness.emit(r)
"""
WARM = {"host_syncs_per_step.warm", "sync_wait_ms.warm",
        "build_host_ms.warm", "check_host_ms.warm", "update_host_ms.warm"}
DEVICE_TIMED = {"build_device_ms.cold", "kernel_roofline_share.cold"}


@pytest.mark.parametrize("cell", sorted(pb_helpers.TINY))
def test_traced_cpu_run_reads_the_programs_spans(cell):
    code = SCRIPT.format(repo=str(pb_helpers.REPO), cell=cell,
                         seed=pb_helpers.SEED, seconds=pb_helpers.SECONDS,
                         over=pb_helpers.TINY[cell])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=pb_helpers.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    assert not set(metrics) & DEVICE_TIMED
    if cell.endswith("loop_warm"):
        assert WARM <= set(metrics)
        # a warm step reads the device at least once per check
        assert metrics["host_syncs_per_step.warm"]["value"] >= 2.0
        for name in WARM - {"host_syncs_per_step.warm"}:
            assert metrics[name]["value"] > 0.0, name
    else:
        assert not set(metrics) & WARM
