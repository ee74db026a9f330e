"""host_syncs_per_step.<cells>: the program's blocking reads of the device
(its ``sync`` counter) over its ``mpc.step`` spans in the traced
window."""

from port_bench.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    steps = program_spans.span(snap, "mpc.step")
    if steps is None:
        return None
    return snap["counters"].get("sync", 0) / steps["count"]
