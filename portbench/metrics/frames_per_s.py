"""frames_per_s: brick frames fused in the window over the window's seconds
(host clock; the window ends in a synchronize)."""


def read(ctx):
    w = ctx.window
    return w["frames"] / w["seconds"] if "frames" in w else None
