"""iters_per_step.<cells>: mean over the window's steps of the most
``SolveResult.iters`` of a lane in the step (the program's own count)."""


def read(ctx):
    if ctx.mode == "loop":
        return float(ctx.iters["per_step"].mean())
