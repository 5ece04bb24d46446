#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process
finds, and print one JSON result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels built or loaded from ``build/torch_kernels/`` in the
checkout, the scene's frames made on the card, the set-up passes and every
CUDA graph capture), then a window of ``--seconds``, then with
``--trace 1`` a traced slice, then the comparison with the plain reference.
Work counts and other evidence go to standard error; the numbers compared,
each beside its limit, are its last lines and the result line's last key.
Without a CUDA card, with fewer cards than the cell asks for, with JAX or
the JAX package loaded, or without the port beside it, it exits non-zero
and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "cpu_tsdf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device: str,
             t0: float, control: bool = False):
    """One run of a cell on ``device`` (the card; the tests run it on the
    CPU at small sizes). Returns (the result line's object, without the
    checks main() makes of the process; every number of the comparison;
    with ``control``, every number of the control's comparison, which
    portbench/control.py reads and the benchmark's runs never compute)."""
    import torch

    from portbench import check, core, loops
    from portbench import trace as tracing
    from portbench.system import System, graph_stats, launch_counts

    cfg = core.tsdf_config(files["config"])
    traffic = files["traffic"]
    dev = torch.device(device)
    steps = {"imports": time.perf_counter() - t0}
    if dev.type == "cuda":
        from cpu_tsdf_tpu_torch import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        steps["cuda_init"] = time.perf_counter() - t0
        _build.build()
        steps["kernels_built"] = time.perf_counter() - t0
    scene = core.scene_module(traffic["scene"])
    frames = scene.frames(traffic["scene_params"], cfg, dev)
    loops.sync(dev)
    steps["frames"] = time.perf_counter() - t0
    F = frames["depths"].shape[0]
    start = seed % F
    order = (start + torch.arange(F, device=dev)) % F
    ordered = {k: v[order].contiguous() for k, v in frames.items()}
    system = System(files["config"], cfg, dev)
    loops.sync(dev)
    steps["volume"] = time.perf_counter() - t0
    runner = loops.RUNNERS[traffic["loop"]](system, ordered, traffic, seed)
    runner.setup()
    loops.sync(dev)
    setup_graphs = graph_stats()
    setup_s = time.perf_counter() - t0
    steps["setup_passes"] = setup_s
    wu = runner.warmup
    units = wu.get("pass_ms") or wu.get("render_ms") or [0.0]
    fifth = max(1, len(units) // 5)
    core.log(f"warm-up: {len(units)} units in {wu['seconds']:.3f} s, a unit's mean ms over "
             f"its first and last fifths {sum(units[:fifth]) / fifth:.4f} and "
             f"{sum(units[-fifth:]) / fifth:.4f}")
    core.log(f"set-up {setup_s:.3f} s: {F} distinct frames, start {start}, "
             f"{runner.n_fused} frames fused, {len(setup_graphs)} graphs captured; "
             f"seconds from the start at the end of each step: "
             + json.dumps({k: round(v, 3) for k, v in steps.items()}))

    launches0 = launch_counts()
    window = runner.window(seconds)
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    in_window = [s for s in graph_stats() if s not in setup_graphs]
    if in_window:
        raise RuntimeError(f"{len(in_window)} graph captures inside the window: {in_window}")

    tr, info = None, {}
    if trace:
        tr = tracing.traced(lambda: info.update(runner.trace_slice()))
    loops.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, window=window, setup_s=setup_s,
                          trace=tr, slice=info, system=system, frames=ordered,
                          setup_graphs=setup_graphs, cache={},
                          peaks=core.load_json(core.HERE / "peaks.json"))
    metrics = {}
    for m in files["per_layer"] if trace else files["end_to_end"]:
        value = core.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    overflowed = system.overflowed()
    attempted = window.get("frames") or len(window["render_ms"])
    lin = check.check_voxels(runner, scene)
    outputs = check.Outputs(runner, lin)
    evidence = dict(frames_fused=runner.n_fused, window_frames=window.get("frames"),
                    requests=attempted, live_bricks=system.live_bricks(),
                    observed_voxels_a_frame=_observed_a_frame(system, ordered, ctx.cache),
                    graph_captures_in_window=len(in_window), overflowed=overflowed,
                    launches_in_window=launches, compared_voxels=int(lin.numel()))
    for key in ("render_ms", "pass_ms"):
        if window.get(key):
            lat = window[key]
            evidence[key] = {q: core.percentile(lat, q) for q in (0.01, 50, 90, 95, 99, 100)}
            evidence[key]["mean"] = sum(lat) / len(lat)
    if outputs.renders:
        evidence["answers_compared"] = len(outputs.renders)
        evidence["hit_rays"] = sorted(int((~torch.isnan(r.depth)).sum())
                                      for _, r in outputs.renders)
    core.log(f"frames fused {runner.n_fused}; window {window['seconds']:.3f} s")
    del ctx, runner, system
    from cpu_tsdf_tpu_torch import graph

    graph.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nums = check.numbers(outputs, frames, start, lin)
    control_nums = check.numbers(outputs, frames, start, lin, control=True) if control else None
    core.log("work and evidence: " + json.dumps(evidence))
    core.log("all numbers of the comparison: " + json.dumps(nums))
    correct, checked = verdict(nums, files["limits"]["limits"], overflowed)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(attempted) if overflowed else 0,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"], device_info["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checked"] = checked
    return result, nums, control_nums


def verdict(nums: dict, limits: dict, overflowed: bool) -> tuple:
    """Whether a run is correct: every number that has a limit read and at
    or under it, and the volume not overflowed. Returns (correct, each
    number compared with its limit)."""
    checked = {name: {"value": nums.get(name), "limit": lim} for name, lim in limits.items()}
    checked["overflowed"] = {"value": int(overflowed), "limit": 0}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checked.values())
    return correct, checked


def _observed_a_frame(system, frames, cache: dict) -> float:
    """Voxels a frame observes, the mean over the scene's distinct frames:
    in the live bricks of a brick volume, in the whole grid of a dense one
    (the dense count taken from the metric readers' cache where a traced
    run has made it)."""
    from portbench.work.dense_fusion import dense_frame_work
    from portbench.work.fusion import brick_voxels, observed

    F = frames["depths"].shape[0]
    if system.kind == "bricks":
        lin = brick_voxels(system.cfg, system.live_rows(), system.vol.brick_size)
        return sum(observed(system.cfg, frames, f, lin) for f in range(F)) / F
    if "dense_frame_work" not in cache:
        cache["dense_frame_work"] = dense_frame_work(system.cfg, frames)
    return sum(w[2] for w in cache["dense_frame_work"]) / F


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)

    from portbench import core

    files = core.cell_files(args.workload)
    import torch

    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"no result: the cell needs {chips} CUDA card(s); torch.cuda.is_available() "
                 f"is {torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    core.log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(files, args.seed, args.seconds, bool(args.trace), "cuda", T0)[0]
    bad = forbidden_modules()
    if bad:
        core.log(f"no result: JAX or the JAX package was loaded: {bad}")
        return 3
    result["device"]["nvidia_smi"] = nvidia_smi()
    checked = result.pop("checked")
    for name, c in checked.items():
        core.log(f"checked {name}: {c['value']!r} (limit {c['limit']!r})")
    result["checked"] = checked
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
