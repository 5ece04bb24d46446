"""view_p50_ms: the median (nearest rank) of every render request's latency
in the window (CUDA events, as view_p95_ms)."""

from portbench.core import percentile


def read(ctx):
    lat = ctx.window.get("render_ms")
    return percentile(lat, 50) if lat else None
