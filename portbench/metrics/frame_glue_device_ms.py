"""frame_glue_device_ms: device ms a brick frame spends outside the fusion
kernel (fuse_kernel): activation, allocation and the fusion batch's glue,
summed over the traced frames' device operations."""

from portbench.metrics._common import is_loop


def read(ctx):
    if not is_loop(ctx, "fuse", "bricks"):
        return None
    return ctx.trace.device_s(exclude="fuse_kernel") / ctx.slice["frames"] * 1e3
