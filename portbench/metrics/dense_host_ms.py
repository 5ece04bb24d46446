"""dense_host_ms: the median host ms inside the dense integrate a frame
(the port's span ``integrate``: its inputs, fuse_dense's preparation and
the kernel's launch), host clock."""

from portbench.program_trace import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "integrate")
