"""dense_idle_pct: the card's idle share in %, measured by the port: the
device time from one public call's ``call.end`` stamp to the next call's
``call.begin`` over the time from the first call's begin to the last
call's end, over the traced slice of the cell's loop (profiler off)."""

from portbench.program_trace import idle_pct


def read(ctx):
    return idle_pct(ctx)
