"""render_pack_device_ms: mean device ms of a render's packing of the
volume (the stage ``render.pack``: bricks.pack_render over the live
bricks), on the device clock, from the port's own stamps inside the render
graph."""

from portbench.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "render.pack")
