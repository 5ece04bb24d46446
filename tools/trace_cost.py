#!/usr/bin/env python3
"""What the port's tracing costs when on, and what it reads over whole
windows of a benchmark cell, on one NVIDIA card.

    python3 tools/trace_cost.py --workload <cell> [<cell> ...] --seconds <s> --seeds <n> [<n> ...]

For each cell of BENCHMARK.json: the set-up of portbench/run.py (the
kernels, the scene's frames on the card, the port's volume, the set-up
passes and the cell's own warm-up), the graphs with the stages' stamps
captured (a few units of the loop with tracing on), then the loop with
tracing off until its units are back at the warm-up's pace (a capture
slows every graph replay for 2-36 s on the H100 hosts measured, PERF.md;
at most ``--settle`` seconds), then for each seed (the trajectory's start,
as run.py draws it) two windows of ``--seconds`` of the cell's loop, one
with tracing off and one with it on (``cpu_tsdf_tpu_torch.tracing``), in
turns (off, on; on, off; ...). A JSON line a window: the cell's end-to-end
number (frames/s, or a render's p95 and p50 ms by CUDA events), and with
tracing on the tracing report of the whole window (stages, host spans,
calls, the idle share, the gaps by span). Then a summary line a cell: the
medians off and on and their ratio. First, a stamp's own device time: 1000
stamps enqueued back to back, and 100 replayed from one CUDA graph, timed
by CUDA events.

Without a CUDA card it exits non-zero."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[trace_cost] {msg}", file=sys.stderr, flush=True)


def stamp_cost(torch, tracing) -> dict:
    """Device us a stamp: back to back on the stream, and inside a graph."""
    dev = torch.device("cuda")
    tracing.enable()
    try:
        for _ in range(10):
            tracing.stage("probe", dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(1000):
            tracing.stage("probe", dev)
        b.record()
        b.synchronize()
        eager_us = a.elapsed_time(b)
        g = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            g.capture_begin()
            for _ in range(100):
                tracing.stage("probe", dev)
            g.capture_end()
        torch.cuda.synchronize()
        g.replay()
        torch.cuda.synchronize()
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        graph_us = a.elapsed_time(b) * 10.0
    finally:
        tracing.disable()
    return {"eager_us": eager_us, "graph_us": graph_us}


def number(window: dict) -> dict:
    from portbench.core import percentile

    if "frames" in window:
        return {"frames_per_s": window["frames"] / window["seconds"]}
    lat = window["render_ms"]
    return {"view_p95_ms": percentile(lat, 95), "view_p50_ms": percentile(lat, 50),
            "requests": len(lat)}


def settle(runner, seconds: float) -> float:
    """Run the loop untraced, a second at a time, until a second's median
    unit is within 2 % of the warm-up's last fifth, or for `seconds`.
    Returns the seconds run (0 without a warm-up to compare with)."""
    units = runner.warmup.get("pass_ms") or runner.warmup.get("render_ms")
    if not units:
        return 0.0
    tail = sorted(units[-max(1, len(units) // 5):])
    pace = tail[len(tail) // 2]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        w = runner.run(seconds=1.0)
        got = sorted(w.get("pass_ms") or w["render_ms"])
        if got[len(got) // 2] <= 1.02 * pace:
            break
    return time.perf_counter() - t0


def run_cell(torch, tracing, files: dict, seeds: list, seconds: float,
             device: str = "cuda", settle_s: float = 45.0) -> dict:
    """The windows of one cell (``files``: portbench.core.cell_files')."""
    from portbench import core, loops
    from portbench.system import System

    cell = files["cell"]["name"]
    cfg = core.tsdf_config(files["config"])
    traffic = files["traffic"]
    dev = torch.device(device)
    frames = core.scene_module(traffic["scene"]).frames(traffic["scene_params"], cfg, dev)
    F = frames["depths"].shape[0]

    def ordered(seed):
        order = (seed % F + torch.arange(F, device=dev)) % F
        return {k: v[order].contiguous() for k, v in frames.items()}

    system = System(files["config"], cfg, dev)
    t0 = time.perf_counter()
    runner = loops.RUNNERS[traffic["loop"]](system, ordered(seeds[0]), traffic, seeds[0])
    runner.setup()
    warm = {"fuse": 2, "view": 100}[traffic["loop"]]
    tracing.enable()
    try:
        runner.run(count=warm)
    finally:
        tracing.disable()
    settled = settle(runner, settle_s)
    loops.sync(dev)
    log(f"{cell}: set-up {time.perf_counter() - t0:.1f} s, of which {settled:.1f} s to settle")
    rows = []
    for i, seed in enumerate(seeds):
        runner = loops.RUNNERS[traffic["loop"]](system, ordered(seed), traffic, seed)
        if traffic["loop"] == "view":
            runner.n_views, runner.sample = 0, None     # View.setup's, without its passes
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            row = {"cell": cell, "seed": seed, "tracing": traced}
            if traced:
                tracing.enable()
                try:
                    row.update(number(runner.window(seconds)))
                    row["report"] = tracing.report()
                finally:
                    tracing.disable()
            else:
                row.update(number(runner.window(seconds)))
            print(json.dumps(row), flush=True)
            rows.append(row)
    key = "frames_per_s" if "frames_per_s" in rows[0] else "view_p95_ms"
    off = statistics.median(r[key] for r in rows if not r["tracing"])
    on = statistics.median(r[key] for r in rows if r["tracing"])
    summary = {"cell": cell, "metric": key, "off": off, "on": on, "on_over_off": on / off,
               "pairs": [[r[key] for r in rows if r["seed"] == s] for s in seeds]}
    print(json.dumps({"summary": summary}), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    p.add_argument("--settle", type=float, default=45.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cpu_tsdf_tpu_torch import _build, tracing

    _build.build()
    print(json.dumps({"stamp": stamp_cost(torch, tracing)}), flush=True)
    from portbench import core

    for cell in args.workload:
        run_cell(torch, tracing, core.cell_files(cell), args.seeds, args.seconds,
                 settle_s=args.settle)
        from cpu_tsdf_tpu_torch import graph

        graph.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
