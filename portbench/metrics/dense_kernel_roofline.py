"""dense_kernel_roofline: the dense fusion kernels' share of their roofline,
in %: the least time of the traced frames' dense fusion (the observed
voxels' state and color read and written once and the images, or the
candidate voxels projected and tested and the observed ones updated,
whichever bounds; work/dense_fusion.py) over the device time of
fuse_dense_kernel and depth_max_kernel in the trace."""

from portbench.metrics._common import bound_s, cached, is_loop
from portbench.work.dense_fusion import dense_frame_work


def read(ctx):
    if not is_loop(ctx, "fuse", "dense"):
        return None
    t = ctx.trace.device_s("fuse_dense_kernel") + ctx.trace.device_s("depth_max_kernel")
    if t <= 0:
        return None
    work = cached(ctx, "dense_frame_work", lambda: dense_frame_work(ctx.system.cfg, ctx.frames))
    bound = sum(bound_s(ctx, *work[f][:2]) for f in ctx.slice["frame_ids"])
    return 100.0 * bound / t
