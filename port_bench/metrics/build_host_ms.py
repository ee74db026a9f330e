"""build_host_ms.<cells>: host milliseconds of the program's ``mpc.build``
span (slew rows, copies, ``assemble``, ``dualize_forcing``, the warm
start) per ``mpc.step`` of the traced window."""

from port_bench.metrics import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, "mpc.build", "host_s")
