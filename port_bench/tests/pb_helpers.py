"""Shared pieces of the benchmark's own tests: tiny sizes of every cell
for a CPU run through the port's plain routes."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: every cell at a size a CPU test holds (the widths are the
#: configuration's own)
TINY = {
    "di_h7.fanout_cold": {"traffic": {"lanes": 256, "sample_lanes": 8,
                                      "trace_steps": 1}},
    "di_h7.loop_warm": {"traffic": {"pool": 2, "redraw_every": 20,
                                    "warmup": 20, "trace_steps": 5}},
}
SEED = 2147483659      # past 2^31
SECONDS = 0.3
