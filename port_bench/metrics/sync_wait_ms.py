"""sync_wait_ms.<cells>: host milliseconds inside the program's ``sync``
spans (blocking reads of the device: the host waits there for the card)
per ``mpc.step`` of the traced window."""

from port_bench.metrics import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, "sync", "host_s")
