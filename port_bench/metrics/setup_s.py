"""setup_s: process start to the first timed step (imports, CUDA start,
loading or building the kernel library, the configuration from the seed,
the warm-up of the cell's own shapes), host clock."""


def read(ctx):
    return ctx.setup_s
