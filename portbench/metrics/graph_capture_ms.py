"""graph_capture_ms: the wall ms of every CUDA graph capture of the set-up,
summed from the program's graph.stats()."""


def read(ctx):
    stats = ctx.setup_graphs
    return sum(s["capture_ms"] for s in stats) if stats else None
