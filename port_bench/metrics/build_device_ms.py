"""build_device_ms.<cells>: device milliseconds of the program's
``build.assemble`` and ``build.dualize_forcing`` spans per ``solve.auto``
of the traced window: the current stream's time between each span's two
CUDA events, so the stream's idle gaps inside the span count; None where
they were not device-timed."""

from port_bench.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    solves = program_spans.span(snap, "solve.auto")
    parts = [program_spans.span(snap, n)
             for n in ("build.assemble", "build.dualize_forcing")]
    if solves is None or any(p is None or p["device_s"] is None
                             for p in parts):
        return None
    return sum(p["device_s"] for p in parts) / solves["count"] * 1e3
