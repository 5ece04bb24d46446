"""The readers of the port's own spans and stages (program_trace.py): each
reads its number from a synthetic tracing report and returns None without
one (an untraced run, or a port without the tracing module); the traced
slice itself, at a small size on the CPU, fuses into a copy of the volume
and reports every stage of every frame and render."""

from types import SimpleNamespace

import pytest
import torch
from small import small_files

from portbench import core, program_trace
from portbench.system import System

REPORT = {"stages": {"frame.activation": {"mean_ms": 0.41},
                     "frame.allocation": {"mean_ms": 0.22},
                     "render.pack": {"mean_ms": 0.17}},
          "spans": {"render_view": {"median_ms": 0.05}, "integrate": {"median_ms": 0.3}},
          "calls": {"idle_share": 0.125}}
WANT = {"frame_activation_device_ms": 0.41, "frame_allocation_device_ms": 0.22,
        "render_pack_device_ms": 0.17, "view_host_ms": 0.05, "dense_host_ms": 0.3,
        "scan_idle_pct": 12.5, "dense_idle_pct": 12.5, "view_idle_pct": 12.5}


def ctx(trace, cache):
    return SimpleNamespace(trace=trace, cache=cache)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_a_report_and_none_without_one(name):
    read = core.metric_reader(name).read
    assert read(ctx(object(), {"program_trace": REPORT})) == pytest.approx(WANT[name])
    assert read(ctx(object(), {"program_trace": None})) is None     # no tracing module
    assert read(ctx(None, {})) is None                               # an untraced run
    empty = dict(REPORT, stages={}, spans={}, calls={"idle_share": None})
    assert read(ctx(object(), {"program_trace": empty})) is None


def test_no_tracing_module_reads_nothing(monkeypatch):
    import sys

    import cpu_tsdf_tpu_torch

    monkeypatch.setitem(sys.modules, "cpu_tsdf_tpu_torch.tracing", None)
    monkeypatch.delattr(cpu_tsdf_tpu_torch, "tracing", raising=False)
    assert program_trace.measure(None, {}, {"loop": "fuse"}) is None


@pytest.mark.parametrize("cell", ["bricks8.scan", "bricks8.view"])
def test_traced_slice_on_the_cpu(cell, monkeypatch):
    from cpu_tsdf_tpu_torch import tracing

    files = small_files(cell)
    cfg = core.tsdf_config(files["config"])
    tr = files["traffic"]
    frames = core.scene_module(tr["scene"]).frames(tr["scene_params"], cfg, "cpu")
    system = System(files["config"], cfg, "cpu")
    system.fuse_pass(frames["depths"], frames["poses"], frames["rgbs"])
    weight = system.vol.weight.clone()
    monkeypatch.setattr(program_trace, "WARM", {"fuse": 1, "view": 1})
    monkeypatch.setattr(program_trace, "COUNT", {"fuse": 1, "view": 2})
    rep = program_trace.measure(system, frames, tr)
    assert not tracing.enabled()
    assert torch.equal(system.vol.weight, weight)                    # fused into a copy
    F = frames["depths"].shape[0]
    if tr["loop"] == "fuse":
        want = {f"frame.{s}": F for s in ("activation", "allocation", "batch")}
        calls = 1
    else:
        want = {f"render.{s}": 2 for s in ("rays", "pack", "march", "finish")}
        calls = 2
    assert {k: rep["stages"][k]["count"] for k in want} == want
    assert rep["calls"]["count"] == calls and rep["dropped"] == {"spans": 0, "stamps": 0}
