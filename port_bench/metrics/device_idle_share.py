"""device_idle_share.<cells>: the traced window's wall time less the device's
busy time (``torch.profiler``), as a share of the window, in %."""


def read(ctx):
    t = ctx.trace
    if t is not None and t["busy_s"] > 0:
        return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
