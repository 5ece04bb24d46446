"""The traced slice of a ``--trace 1`` run: torch.profiler (CPU and CUDA
activities) around a few steady steps, the harness's own spans around each
call into the program (``torch.profiler.record_function``), and the trace
reduced to what the per-layer readers need:

  * every device operation (kernels, copies, memsets) with its name, start,
    end and the span whose host call launched it (by the launch's
    correlation id; a CUDA graph's kernels carry its launch's);
  * busy time: the union of the device intervals inside the slice, so
    overlapping operations count once and copies and memsets count;
  * the slice's length: the host span around it, which ends in a
    synchronize;
  * the ten device operations that took the most time, and the ten longest
    kinds of idle gap by the host operation running when the gap opened.

The trace is written to a temporary file under ``TMPDIR`` and removed."""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

import torch

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: list):
        sl = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
        if not sl:
            raise RuntimeError("the traced slice's span is missing from the trace")
        s = sl[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in events if e.get("ph") == "X"
                       and e.get("cat") == "user_annotation" and e["name"] != SLICE)
        launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                     if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            at = launch_at.get(e.get("args", {}).get("correlation"))
            span = next((n for s0, s1, n in spans if at is not None and s0 <= at <= s1), None)
            self.ops.append(dict(name=e["name"], start=max(a, self.t0), end=min(b, self.t1),
                                 span=span))
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in events if e.get("ph") == "X"
                           and e.get("cat") in ("cpu_op", "python_function") + LAUNCH_CATS)
        self.spans = spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def merged(self) -> list:
        out = []
        for a, b in sorted((o["start"], o["end"]) for o in self.ops):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-6

    def device_s(self, kernel: str | None = None, span: str | None = None,
                 exclude: str | None = None) -> float:
        """Summed device seconds of the operations whose name holds the word
        ``kernel`` (all when None), launched under ``span`` (any when None),
        leaving out those whose name holds the word ``exclude``."""
        def word(w, name):
            return re.search(r"\b" + re.escape(w) + r"\b", name) is not None

        return sum(o["end"] - o["start"] for o in self.ops
                   if (kernel is None or word(kernel, o["name"]))
                   and (span is None or o["span"] == span)
                   and (exclude is None or not word(exclude, o["name"]))) * 1e-6

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for o in self.ops:
            by_name[o["name"][:120]] += (o["end"] - o["start"]) * 1e-6
        gaps, edge = [], self.t0
        for a, b in self.merged() + [[self.t1, self.t1]]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        idle = defaultdict(float)
        for (a, b), label in zip(gaps, self._host_at([g[0] for g in gaps])):
            idle[label] += (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in worst]}

    def _host_at(self, times: list) -> list:
        """For each of the increasing times, the innermost host operation
        running then (a sweep over the host operations), else the harness
        span, else the harness."""
        out, active, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] >= t]
            if active:
                name = min(active, key=lambda h: h[1] - h[0])[2]
                out.append("host: " + name[:100])
                continue
            span = next((n for s0, s1, n in self.spans if s0 <= t <= s1), None)
            out.append("host: python in " + (span or "the harness"))
        return out


def traced(fn) -> Trace:
    """Run fn under the profiler inside the slice's span, ending in a
    synchronize; return its reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
