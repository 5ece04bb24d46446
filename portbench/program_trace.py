"""The port's own spans, device stages and counters (``cpu_tsdf_tpu_torch.tracing``)
over a traced slice of the cell's own loop, for the readers of the
program's per-layer metrics.

A ``--trace 1`` run reads it once (kept in the readers' cache), after the
window and the profiler's slice: tracing on, the cell's loop run
``WARM[loop]`` times (the graphs captured anew with their stages' stamps:
the graph keys hold the tracing state), the report reset, the loop run
``COUNT[loop]`` times, the report read (the profiler is off by then), and
tracing off again. The port's graphs are dropped first (``graph.clear()``:
the window's are not replayed again): on the H100 hosts measured a capture
while another graph was kept slowed every replay by ~25 % for seconds
(PERF.md), which the slice would read as stage time. A fusion loop fuses
into a copy of the volume, so the state the comparison reads is the
window's; renders leave the state as it is. The whole report goes to
standard error.

Where the port has no tracing module (a parent commit older than it), or
the run is not traced, there is nothing to read: None."""

from __future__ import annotations

import copy
import dataclasses
import json

import torch

from portbench import core, loops
from portbench.metrics._common import cached

# passes (fuse) or requests (view) before the traced slice, and in it
WARM = {"fuse": 2, "view": 100}
COUNT = {"fuse": 4, "view": 200}


def _copy_system(system):
    """The system with a copy of its volume, so that fusing into it leaves
    the original's state as it was."""
    vol = system.vol
    out = copy.copy(system)
    out.vol = dataclasses.replace(vol, **{
        f.name: t.clone() for f in dataclasses.fields(vol)
        if isinstance(t := getattr(vol, f.name), torch.Tensor)})
    return out


def measure(system, frames: dict, traffic: dict) -> dict | None:
    """The tracing report of COUNT units of the traffic's loop on the system
    (a copy of it where the loop fuses), or None without the port's
    tracing module."""
    try:
        from cpu_tsdf_tpu_torch import tracing
    except ImportError:
        return None
    loop = traffic["loop"]
    if loop == "fuse":
        system = _copy_system(system)
    runner = loops.RUNNERS[loop](system, frames, traffic, 0)
    if loop == "view":
        runner.n_views, runner.sample = 0, None          # View.setup's, without its passes
    from cpu_tsdf_tpu_torch import graph

    graph.clear()
    tracing.enable()
    try:
        runner.run(count=WARM[loop])
        loops.sync(system.device)
        tracing.reset()
        runner.run(count=COUNT[loop])
        report = tracing.report()
    finally:
        tracing.disable()
    core.log(f"program trace, {COUNT[loop]} {'passes' if loop == 'fuse' else 'requests'}: "
             + json.dumps(report))
    return report


def report(ctx) -> dict | None:
    """The traced run's report (measured once a run), or None."""
    if ctx.trace is None:
        return None
    return cached(ctx, "program_trace", lambda: measure(ctx.system, ctx.frames, ctx.traffic))


def stage_ms(ctx, name: str) -> float | None:
    """Mean device ms of stage `name` over the slice."""
    rep = report(ctx)
    stage = None if rep is None else rep["stages"].get(name)
    return None if stage is None else stage["mean_ms"]


def span_median_ms(ctx, name: str) -> float | None:
    """Median host ms of span `name` over the slice."""
    rep = report(ctx)
    span = None if rep is None else rep["spans"].get(name)
    return None if span is None else span["median_ms"]


def idle_pct(ctx) -> float | None:
    """The card's idle share of the slice in %: the device time from one
    call's end to the next call's begin over the time from the first
    call's begin to the last call's end."""
    rep = report(ctx)
    share = None if rep is None else rep["calls"]["idle_share"]
    return None if share is None else 100.0 * share
