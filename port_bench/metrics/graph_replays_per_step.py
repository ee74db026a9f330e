"""graph_replays_per_step.<cells>: the program's CUDA graph replays (its
``graph.replay`` counter: one per check and one per round of updates
where the solver replays its graphs) over its ``mpc.step`` spans in the
traced window.  A program whose solver has no graphs reads nothing; one
that has them and replayed none reads 0."""

from port_bench.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    steps = program_spans.span(snap, "mpc.step")
    if steps is None:
        return None
    n = snap["counters"].get("graph.replay")
    if n is None:
        from pqp_for_mpc_tpu_torch import solver
        if not hasattr(solver, "graphs_engage"):
            return None
        n = 0
    return n / steps["count"]
