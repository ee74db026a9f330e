"""The program's own spans and counters
(``pqp_for_mpc_tpu_torch.utils.tracing``) as the per-layer readers take
them.  Tracing is on exactly while a ``torch.profiler`` session records,
so under ``--trace 1`` a snapshot holds the traced window alone.  Host
times of that window include the profiler's own cost per operator.  A
program without the module, or a window without the spans a reader
needs, gives None."""


def snapshot(ctx):
    """The program's snapshot of the traced window, or None."""
    if ctx.trace is None:
        return None
    try:
        from pqp_for_mpc_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span(snap, name: str):
    """The aggregate of span ``name`` (``count``, ``host_s``, ``self_s``,
    ``device_s``), or None."""
    if snap is None:
        return None
    return snap["spans"].get(name)


def per_step_ms(ctx, name: str, field: str):
    """``field`` of span ``name`` summed over the traced window, per
    ``mpc.step``, in ms; None without either span."""
    snap = snapshot(ctx)
    steps, s = span(snap, "mpc.step"), span(snap, name)
    if steps is None or s is None:
        return None
    return s[field] / steps["count"] * 1e3
