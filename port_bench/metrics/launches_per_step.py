"""launches_per_step.<cells>: device kernels in the traced window (copies and
sets apart, ``torch.profiler``) over its steps."""


def read(ctx):
    t = ctx.trace
    if t is not None and t["busy_s"] > 0 and ctx.mode == "loop":
        return t["kernels"] / t["steps"]
