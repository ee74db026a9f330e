"""update_host_ms.<cells>: host milliseconds of the program's
``solve.updates`` spans (the multiplicative updates and accel steps
between two checks), less their children, per ``mpc.step`` of the traced
window."""

from port_bench.metrics import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, "solve.updates", "self_s")
