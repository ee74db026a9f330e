"""step_ms_p95: the 95th percentile of the window's control steps, each
from handing the entry its state to its answer on the host, host clock."""

import numpy as np


def read(ctx):
    if ctx.mode == "loop":
        return float(np.percentile(ctx.step_s, 95)) * 1e3
