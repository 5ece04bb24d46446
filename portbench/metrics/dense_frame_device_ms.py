"""dense_frame_device_ms: device ms a dense frame (ops.fusion.integrate)
takes, summed over the traced frames' device operations."""

from portbench.metrics._common import is_loop


def read(ctx):
    if not is_loop(ctx, "fuse", "dense"):
        return None
    return ctx.trace.device_s() / ctx.slice["frames"] * 1e3
