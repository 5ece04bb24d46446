"""What the metric readers share: the roofline arithmetic and the work
counts, each counted once a run. A reader (``metrics/<name>.py``) defines
``read(ctx)``, returning the metric's value or None where the run has
nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations


def bound_s(ctx, nbytes: float, nops: float) -> float:
    """The least time of work of nbytes and nops on the card: the larger of
    the bytes over the memory bandwidth and the operations over the float32
    rate."""
    return max(nbytes / ctx.peaks["hbm_bytes_per_s"], nops / ctx.peaks["fp32_ops_per_s"])


def cached(ctx, key: str, make):
    if key not in ctx.cache:
        ctx.cache[key] = make()
    return ctx.cache[key]


def is_loop(ctx, loop: str, kind: str | None = None) -> bool:
    return (ctx.trace is not None and ctx.traffic["loop"] == loop
            and (kind is None or ctx.system.kind == kind))

