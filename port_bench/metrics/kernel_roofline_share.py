"""kernel_roofline_share.<cells>: the least time of a batch over K1's
device time per launch, in %.  The least time is ``solve_roofline_share``'s
(operations at the iterations each lane reported, and every input and
output once, over the measured window's batches); K1's time is the device
time of the program's ``kernel.k1`` spans (CUDA events around each launch)
over their count in the traced window.  Every batch is a cold batch of the
same size, so the two per-batch figures compare."""

from port_bench import roofline
from port_bench.metrics import program_spans


def read(ctx):
    k1 = program_spans.span(program_spans.snapshot(ctx), "kernel.k1")
    if ctx.mode != "batch" or k1 is None or not k1["device_s"]:
        return None
    it, cfg = ctx.iters, ctx.cfg
    flops = roofline.solve_work(ctx.n_con, ctx.n_var, it["values"],
                                cfg.check_every, cfg.accel_every,
                                lanes=it["lanes"])
    peak = roofline.PEAK_FLOPS[ctx.conf["lowest_update_precision"]]
    ins = sum(i for i, _ in ctx.io_bytes)
    outs = sum(o for _, o in ctx.io_bytes)
    least = roofline.least_seconds(ins, outs, flops, peak) / ctx.steps
    return 100.0 * least / (k1["device_s"] / k1["count"])
