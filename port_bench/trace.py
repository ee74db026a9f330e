"""Reduce a ``torch.profiler`` trace of the traced window to what the
benchmark reports: the device's busy time, the kernels it ran, the device
operations that took most time, and the idle gaps by the benchmark span
the host was in (``bench.<name>``, from ``record_function``)."""

from __future__ import annotations

import bisect
import collections

SPAN_PREFIX = "bench."
#: device events that are not kernels (as ``chip_smoke.profiled_launches``
#: counts them)
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 160


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every profiler event."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def reduce(prof, steps: int) -> dict:
    """The traced window runs from the first benchmark span's start to the
    last one's end.  Returns ``busy_s`` (union of device activity in it),
    ``window_s``, ``kernels`` (device kernels, copies and sets apart),
    ``steps``, ``device_ops`` and ``idle_gaps`` (``[name, seconds]``, the
    largest first, at most :data:`TOP`)."""
    evs = _events(prof)
    spans = sorted((s, e, n[len(SPAN_PREFIX):]) for n, dev, s, e in evs
                   if not dev and n.startswith(SPAN_PREFIX))
    if not spans:
        raise RuntimeError("the trace holds no benchmark span")
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    # the device side of a benchmark span is an annotation, not work
    dev = sorted((max(s, w0), min(e, w1), n) for n, d, s, e in evs
                 if d and e > w0 and s < w1
                 and not n.startswith(SPAN_PREFIX))
    by_op = collections.Counter()
    kernels = 0
    for s, e, n in dev:
        by_op[n[:NAME_CHARS]] += (e - s) * 1e-9
        kernels += not n.startswith(NOT_KERNELS)
    busy, gaps, cur = 0, [], w0
    for s, e, _ in dev:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    idle = collections.Counter()
    starts = [s for s, _, _ in spans]
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = spans[i][2] if i >= 0 and spans[i][1] >= mid else "between"
        idle[label] += (b - a) * 1e-9
    top = lambda c: [[k, v] for k, v in c.most_common(TOP)]
    return dict(busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
                kernels=kernels, steps=steps, device_ops=top(by_op),
                idle_gaps=top(idle))
