"""solves_per_s (and solves_per_s.<cells>): certified solves completed in the window over its wall
time (the batch that straddles the end finished and counted), host clock."""


def read(ctx):
    if ctx.mode == "batch":
        return ctx.certified / ctx.wall_s
