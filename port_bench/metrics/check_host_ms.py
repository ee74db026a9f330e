"""check_host_ms.<cells>: host milliseconds of the program's
``solve.check`` spans (each convergence check and its verdict), less
their children, per ``mpc.step`` of the traced window."""

from port_bench.metrics import program_spans


def read(ctx):
    return program_spans.per_step_ms(ctx, "solve.check", "self_s")
