"""Profiling helpers.

The counterpart of ``pqp_for_mpc_tpu/utils/profiling.py``'s ``trace``: a
context manager around ``torch.profiler`` writing a Chrome/Perfetto trace
of the wrapped region, with the port's own spans
(:mod:`~pqp_for_mpc_tpu_torch.utils.tracing`) on a track of their own over
the operators and kernels they launched.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

from pqp_for_mpc_tpu_torch.utils import tracing

#: the thread id of the spans' track in the exported trace
SPAN_TID = 0


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace('/tmp/pqp_trace'): run()`` then open
    ``logdir/trace.json`` in ui.perfetto.dev or chrome://tracing.  Traces
    the CPU and, where a card is present, CUDA; the port's spans of the
    region lie on the track "pqp_for_mpc_tpu_torch spans"."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = tracing.record_count()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    add_spans(path, tracing.records_since(first))


def add_spans(path: str, records: list) -> None:
    """Write ``records`` (:func:`tracing.records_since`) into the Chrome
    trace at ``path`` as complete events of one track, on the file's own
    time base (``baseTimeNanoseconds``; ``ts`` and ``dur`` in µs)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID,
                   "args": {"name": "pqp_for_mpc_tpu_torch spans"}})
    for r in records:
        args = {"id": r["id"], "parent": r["parent"],
                "request": r["request"]}
        if r["device_s"] is not None:
            args["device_ms"] = r["device_s"] * 1e3
        events.append({"ph": "X", "cat": "pqp_span", "name": r["name"],
                       "pid": pid, "tid": SPAN_TID,
                       "ts": (r["start_ns"] - base) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
