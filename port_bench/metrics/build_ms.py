"""build_ms.<cells>: mean milliseconds of the benchmark's span around a
batch's build (the draw, ``assemble`` and ``dualize_forcing``), ended by a
synchronise."""


def read(ctx):
    spans = ctx.spans.get("build")
    if ctx.mode == "batch" and spans:
        return sum(spans) / len(spans) * 1e3
