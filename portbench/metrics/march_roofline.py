"""march_roofline: the ray-march kernel's share of its roofline, in %: the
least time of the traced renders' marches (the operations that the frozen
plain march of work/march.py counts on the same state and poses) over
raycast_kernel's device time in the trace."""

from portbench.check import field_of
from portbench.metrics._common import bound_s, cached, is_loop
from portbench.work.march import render_work


def read(ctx):
    if not is_loop(ctx, "view"):
        return None
    t = ctx.trace.device_s("raycast_kernel")
    if t <= 0:
        return None
    steps = int(ctx.traffic["render"]["max_steps"])

    def work():
        field = field_of(ctx.system)
        return {p: render_work(ctx.system.cfg, field, ctx.frames["poses"][p], steps)
                for p in set(ctx.slice["pose_ids"])}

    w = cached(ctx, "render_work", work)
    return 100.0 * sum(bound_s(ctx, *w[p]) for p in ctx.slice["pose_ids"]) / t
