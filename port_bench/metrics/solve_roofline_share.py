"""solve_roofline_share.<cells>: the least time of the window's solves over
the wall time of its ``solve`` spans, in %.  The least time of a solve is
the larger of its operations (``roofline.solve_work`` at the iterations
each lane reports) over the peak of the lowest precision the configuration
lets an update run in, and its bytes (every input and output once) over
HBM."""

from port_bench import roofline


def read(ctx):
    spans = ctx.spans.get("solve")
    if ctx.mode != "batch" or not spans:
        return None
    it, cfg = ctx.iters, ctx.cfg
    flops = roofline.solve_work(ctx.n_con, ctx.n_var, it["values"],
                                cfg.check_every, cfg.accel_every,
                                lanes=it["lanes"])
    peak = roofline.PEAK_FLOPS[ctx.conf["lowest_update_precision"]]
    ins = sum(i for i, _ in ctx.io_bytes)
    outs = sum(o for _, o in ctx.io_bytes)
    return 100.0 * roofline.least_seconds(ins, outs, flops, peak) / sum(spans)
