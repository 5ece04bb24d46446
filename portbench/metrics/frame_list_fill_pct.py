"""frame_list_fill_pct: the share of the rows that a brick frame's fusion
kernel is launched over which carry a brick, in %: the traced frames' mean
band bricks and carve slots (the port's device counts ``activation.lists``,
recorded inside the frame graph with tracing on) over the update budget
plus the carve budget, the rows of every frame's update list."""

from portbench.metrics._common import is_loop
from portbench.program_trace import report


def read(ctx):
    if not is_loop(ctx, "fuse", "bricks"):
        return None
    rep = report(ctx)
    counters = {} if rep is None else rep["counters"]
    lists = [counters.get(f"activation.lists.{name}") for name in ("band", "carve")]
    if None in lists:
        return None
    return 100.0 * sum(c["mean"] for c in lists) / sum(c["budget"] for c in lists)
