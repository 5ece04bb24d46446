"""frame_allocation_device_ms: mean device ms of a brick frame's allocation
(the stage ``frame.allocation``: bricks._allocate_from_list, the slot
lookup and the update list's assembly), on the device clock, from the
port's own stamps inside the frame graph."""

from portbench.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame.allocation")
