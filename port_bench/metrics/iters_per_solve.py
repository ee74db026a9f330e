"""iters_per_solve.<cells>: mean of ``SolveResult.iters`` over every lane
the window solved (the program's own count)."""


def read(ctx):
    if ctx.mode == "batch":
        it = ctx.iters
        return float((it["values"] * it["lanes"]).sum() / it["lanes"].sum())
