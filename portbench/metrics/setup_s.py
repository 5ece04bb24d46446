"""setup_s: seconds from the process start to the first timed operation:
loading, the kernels' build (cached in the checkout after the first run), the
frames made on the card, the set-up passes and every graph capture."""


def read(ctx):
    return ctx.setup_s
