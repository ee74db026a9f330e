"""The benchmark's own copy of the work and roofline arithmetic.

Copied from ``chip_smoke.py`` (``solve_work``, ``bound``, ``stored_bytes``
and the H100 peaks), so that a change to the program cannot move the
yardstick.  Operations are counted from shapes and the iterations each
lane reports, whatever implements them.
"""

from __future__ import annotations

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and FLOP/s by
#: the lowest precision an update may run in
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def solve_work(n: int, m: int, iters, check_every: int, accel_every: int,
               lanes=None) -> float:
    """Operations of whole solves whose lanes exited at ``iters``
    (``lanes[i]`` lanes at ``iters[i]``, one each by default): per lane
    ``iters - 1`` updates (two n x n products), one check per
    ``check_every`` updates plus the final one (Gp'Y, Qp^-1 t, Gp U, Qd Y,
    Qp U), one accel step (three Qd products) per ``accel_every``
    updates."""
    upd = np.maximum(np.asarray(iters, np.float64) - 1.0, 0.0)
    checks = np.floor(upd / check_every) + 2.0
    acc = np.floor(upd / accel_every) if accel_every else 0.0 * upd
    flops = (upd * 4 * n * n + checks * (4 * n * m + 2 * n * n + 4 * m * m)
             + acc * 6 * n * n)
    if lanes is not None:
        flops = flops * np.asarray(lanes, np.float64)
    return float(flops.sum())


def stored_bytes(*tensors) -> int:
    """Bytes of the distinct storages behind ``tensors`` (a stride-0 view
    counts as the storage it reads)."""
    seen = {}
    for t in tensors:
        if t is None:
            continue
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def least_seconds(in_bytes: float, out_bytes: float, flops: float,
                  peak: float) -> float:
    """The least time the card could take: bytes (inputs once, outputs
    once) over HBM against operations over ``peak``, the larger."""
    return max((in_bytes + out_bytes) / HBM_BPS, flops / peak)
