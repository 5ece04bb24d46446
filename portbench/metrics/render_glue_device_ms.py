"""render_glue_device_ms: device ms a render spends outside the ray-march
kernel (raycast_kernel): the render glue of ops/raycast (rays, packing by
bricks.pack_render, colors, assembly) and the result's copies."""

from portbench.metrics._common import is_loop


def read(ctx):
    if not is_loop(ctx, "view"):
        return None
    return (ctx.trace.device_s(span="portbench.render", exclude="raycast_kernel")
            / ctx.slice["requests"] * 1e3)
