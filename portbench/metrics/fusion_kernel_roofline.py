"""fusion_kernel_roofline: the brick fusion kernel's share of its roofline,
in %: the least time of the traced frames' fusion (the voxels of the live
bricks each frame observes, read and written once; work/fusion.py) over the
kernel's device time in the trace."""

from portbench.metrics._common import bound_s, cached, is_loop
from portbench.work.fusion import brick_frame_work


def read(ctx):
    if not is_loop(ctx, "fuse", "bricks"):
        return None
    t = ctx.trace.device_s("fuse_kernel")
    if t <= 0:
        return None
    sysm = ctx.system
    work = cached(ctx, "brick_frame_work", lambda: brick_frame_work(
        sysm.cfg, ctx.frames, sysm.live_rows(), sysm.vol.brick_size))
    bound = sum(bound_s(ctx, *work[f]) for f in ctx.slice["frame_ids"])
    return 100.0 * bound / t
