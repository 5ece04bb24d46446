"""view_p95_ms: the 95th percentile (nearest rank) of every render request's
latency in the window, from the call to render_view until its result is
complete on the card (CUDA events: the device clock)."""

from portbench.core import percentile


def read(ctx):
    lat = ctx.window.get("render_ms")
    return percentile(lat, 95) if lat else None
