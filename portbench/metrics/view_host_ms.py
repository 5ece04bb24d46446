"""view_host_ms: the median host ms inside render_view a request (the
port's span ``render_view``: the graph's key and lookup, the pose's copy,
the replay's launch and the result's copies enqueued), host clock."""

from portbench.program_trace import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "render_view")
