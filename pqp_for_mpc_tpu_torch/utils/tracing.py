"""The port's own spans and counters, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records (the
benchmark's ``--trace 1`` window, :func:`~pqp_for_mpc_tpu_torch.utils.
profiling.trace`); there is no other switch.  Off, :func:`span`,
:func:`count` and :func:`sync` cost one test of torch's module flag
``torch.autograd.profiler._is_profiler_enabled``.

On, a span records its name, its parent span, a request id (the id of its
outermost span, shared by everything under it) and its start and end on
``time.perf_counter_ns()``.  Each outermost span also takes one
(``perf_counter_ns``, ``time_ns``) pair as it opens, which maps its records
onto the profiler's clock (Unix-epoch nanoseconds, as
``torch.profiler``'s events are stamped).  A span opened with a CUDA
``device`` also records a ``torch.cuda.Event`` pair on the current stream;
its device time is read when :func:`snapshot` asks.  Records stay in
memory (at most :data:`CAP`; past it they are counted as ``dropped``) and
are never emitted to the profiler: a ``record_function`` range would put a
device-side annotation over the kernels it holds, which a reader of the
trace takes for device work.  :func:`profiling.trace` writes them into the
Chrome trace it exports.

The spans and counters at the layer boundaries:

==========================  ==================================================
``mpc.step``                ``MPCController.step`` (both backends)
``mpc.build``               the step's build: slew rows, copies, ``assemble``,
                            ``dualize_forcing``, the warm start
``build.assemble``          ``CondensedMPCData.assemble`` (device-timed)
``build.dualize_forcing``   ``dual.dualize_forcing`` (device-timed)
``solve.auto``              ``routing.solve_auto`` after its decision; counter
                            ``route.<engine>``
``solve.check``             each check of ``solver._solve_core`` (the check
                            and its verdict's bookkeeping), the final one
                            included; counter ``graph.replay`` where it
                            replays the check's CUDA graph
``solve.updates``           each round of updates of ``_solve_core``;
                            counter ``graph.replay`` where it replays the
                            updates' graph; counter ``graph.capture`` at
                            each capture of a solve key's two graphs
                            (``solver._SolveGraphs``)
``sync``                    each blocking read through :func:`sync`;
                            counters ``sync`` and ``sync.<site>``
``kernel.k1`` … ``k8``      each kernel launch (device-timed)
==========================  ==================================================

:func:`snapshot` aggregates the records per name, with the counters, the
kernel launch counts (read from the wrappers' ``.launches`` attributes:
the change since the first record after :func:`reset`) and ``dropped``;
:func:`reset` clears it all.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch
from torch.autograd import profiler as _profiler

#: records kept before further spans are only counted as dropped
CAP = 1 << 18
#: the kernel launch counters: key -> (module under ``ops``, wrapper); a
#: wrapper that counts per mode gives one key per mode
KERNELS = {
    "k1": ("solve_kernel", "fused_full_solve"),
    "k2": ("kernels", "fused_pqp_iterations"),
    "k3": ("tiled_kernel", "streamed_pqp_iterations"),
    "k4": ("tiled_solve_kernel", "fused_full_solve_tiled"),
    "k5": ("distinct_kernel", "fused_full_solve_distinct"),
    "k6": ("distinct_tiled_kernel", "fused_full_solve_distinct_tiled"),
    "k7": ("distinct_tiled_kernel", "distinct_streamed_iterations"),
    "k8": ("packed_kernel", "fused_full_solve_packed"),
}
_MODES = ("float32", "bfloat16")


def launch_counts() -> dict:
    """Every kernel wrapper's ``.launches`` (``k3.float32`` for a counter
    kept per mode); a module not yet imported has launched nothing."""
    out = {}
    for key, (mod, fn) in KERNELS.items():
        m = sys.modules.get("pqp_for_mpc_tpu_torch.ops." + mod)
        c = getattr(m, fn).launches if m is not None else None
        if key in ("k3", "k7"):
            for mode in _MODES:
                out[f"{key}.{mode}"] = c[mode] if c is not None else 0
        else:
            out[key] = c if c is not None else 0
    return out


class _Span:
    """One record, and the context manager that fills it."""

    __slots__ = ("tracer", "name", "id", "parent", "request", "offset",
                 "t0", "t1", "events", "device_s")

    def __init__(self, tracer, name: str, device):
        self.tracer, self.name = tracer, name
        self.t1 = self.events = self.device_s = None
        if device is not None and device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), device)

    def __enter__(self):
        tr = self.tracer
        stack = tr.stack
        self.id = len(tr.records)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
            self.offset = top.offset
        else:
            self.parent, self.request = None, self.id
            self.offset = time.time_ns() - time.perf_counter_ns()
        tr.records.append(self)
        stack.append(self)
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(self.events[2]))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.events[2]))
        self.tracer.stack.pop()
        return False

    def device_seconds(self):
        """Device time between the span's two events (after a
        synchronise), or None for a span without them."""
        if self.device_s is None and self.events is not None:
            self.device_s = self.events[0].elapsed_time(self.events[1]) * 1e-3
        return self.device_s


#: the span of a call while tracing is off, or past :data:`CAP`
_OFF = contextlib.nullcontext()


class Tracer:
    """The process's records, counters and launch baseline."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.records, self.stack = [], []
        self.counters = {}
        self.dropped = 0
        self.base = None

    def _start(self) -> None:
        if self.base is None:
            self.base = launch_counts()

    def span(self, name: str, device=None):
        self._start()
        if len(self.records) >= CAP:
            self.dropped += 1
            return _OFF
        if isinstance(device, torch.Tensor):
            device = device.device
        return _Span(self, name, device)

    def count(self, name: str) -> None:
        self._start()
        self.counters[name] = self.counters.get(name, 0) + 1

    def _closed(self, first: int) -> list:
        """The closed records from index ``first`` on, their devices
        synchronised once where any was device-timed."""
        done = [r for r in self.records[first:] if r.t1 is not None]
        for dev in {r.events[2] for r in done if r.events is not None}:
            torch.cuda.synchronize(dev)
        return done

    def snapshot(self) -> dict:
        """The closed spans aggregated per name (``count``, ``host_s``,
        ``self_s``: the span less its children's cover, ``device_s``: None
        where no record of the name was device-timed), the counters, the
        launch counts since the first record and ``dropped``."""
        done = self._closed(0)
        cover = {}
        for r in done:
            if r.parent is not None:
                cover[r.parent] = cover.get(r.parent, 0) + r.t1 - r.t0
        spans = {}
        for r in done:
            a = spans.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                          "self_s": 0.0, "device_s": None})
            a["count"] += 1
            a["host_s"] += (r.t1 - r.t0) * 1e-9
            a["self_s"] += (r.t1 - r.t0 - cover.get(r.id, 0)) * 1e-9
            d = r.device_seconds()
            if d is not None:
                a["device_s"] = (a["device_s"] or 0.0) + d
        now = launch_counts()
        base = self.base or now
        return {"spans": spans, "counters": dict(self.counters),
                "launches": {k: v - base.get(k, 0) for k, v in now.items()},
                "dropped": self.dropped}

    def records_since(self, first: int = 0) -> list:
        """The closed records from index ``first`` on, each a dict with
        ``name``, ``id``, ``parent``, ``request``, ``start_ns`` and
        ``end_ns`` on the profiler's clock and ``device_s`` (after a
        synchronise where any was device-timed)."""
        done = self._closed(first)
        return [{"name": r.name, "id": r.id, "parent": r.parent,
                 "request": r.request, "start_ns": r.t0 + r.offset,
                 "end_ns": r.t1 + r.offset, "device_s": r.device_seconds()}
                for r in done]


_TRACER = Tracer()


def span(name: str, device=None):
    """A context manager recording span ``name`` while tracing is on.
    ``device`` (a ``torch.device`` or a tensor on it): on CUDA, the span is
    also timed on the device's current stream."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _TRACER.span(name, device)


def count(name: str) -> None:
    """Add one to counter ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        _TRACER.count(name)


def sync(t, site: str) -> bool:
    """``bool(t)``: a blocking read of a device scalar.  While tracing is
    on, counted (``sync``, ``sync.<site>``) and spanned (``sync``)."""
    if not _profiler._is_profiler_enabled:
        return bool(t)
    _TRACER.count("sync")
    _TRACER.count("sync." + site)
    with _TRACER.span("sync"):
        return bool(t)


def snapshot() -> dict:
    """See :meth:`Tracer.snapshot`; synchronises once."""
    return _TRACER.snapshot()


def reset() -> None:
    """Clear every record, counter and the launch baseline."""
    _TRACER.reset()


def record_count() -> int:
    """Records held so far (the ``first`` of a later
    :func:`records_since`)."""
    return len(_TRACER.records)


def records_since(first: int = 0) -> list:
    """See :meth:`Tracer.records_since`."""
    return _TRACER.records_since(first)
