"""On the card: each cell's command, as the benchmark's check runs it, for
a short window.  Skips without a CUDA device (decided in the fixture)."""

import json
import subprocess
import sys

import pb_helpers
import pytest


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(pb_helpers.TINY))
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(pb_helpers.SEED), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=pb_helpers.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    launches = json.loads(lines[-2])["launches"]
    if cell == "di_h7.fanout_cold":
        assert launches["k1"] > 0
    if cell == "di_h7.loop_warm":
        assert launches["k1"] == 0
