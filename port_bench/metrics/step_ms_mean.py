"""step_ms_mean: the window's wall time over its steps (plant or drift
included), host clock."""


def read(ctx):
    if ctx.mode == "loop":
        return ctx.wall_s / ctx.steps * 1e3
