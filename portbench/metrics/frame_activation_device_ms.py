"""frame_activation_device_ms: mean device ms of a brick frame's activation
(the stage ``frame.activation`` of bricks.fuse_frame: the depth mips, the
band candidates, the jitter, the carve candidates and their compaction),
on the device clock, from the port's own stamps inside the frame graph."""

from portbench.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame.activation")
