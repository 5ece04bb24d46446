"""The port's tracing module (cpu_tsdf_tpu_torch/tracing.py) on the CPU: off
by default and silent while off, span parents and request ids, self time,
the bounded span buffer, the stage and idle arithmetic on synthetic device
times, spans as profiler ranges, the counter registry, and the graph key's
tracing state."""

import itertools

import pytest
import torch

from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch import graph as tg
from cpu_tsdf_tpu_torch import tracing
from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk

import torch_common  # noqa: F401  (one intra-op thread)

CPU = torch.device("cpu")


@pytest.fixture
def on():
    tracing.enable()
    yield
    tracing.disable()


@pytest.fixture
def clock(monkeypatch):
    """The tracing clock ticks 0, 10, 20, ... ns, one tick a reading."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(tracing, "_now", lambda: next(ticks))


def test_off_by_default_and_silent_while_off():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")          # one shared null context
    assert tracing.call("c", CPU) is tracing.span("a")
    with tracing.span("a"), tracing.call("c", CPU):
        tracing.stage("s", CPU)
    with tracing.timed("t") as t:
        pass
    assert t.seconds >= 0                                    # timed measures while off
    tracing.enable()
    try:
        rep = tracing.report()
    finally:
        tracing.disable()
    assert rep["spans"] == {} and rep["stages"] == {} and rep["calls"]["count"] == 0


def test_parents_and_request_ids(on):
    with tracing.call("outer", CPU):
        with tracing.span("child"):
            with tracing.span("grandchild"):
                pass
        with tracing.call("nested_call", CPU):
            pass
    with tracing.span("second"):
        pass
    recs = {r[1]: r for r in tracing._tracer.spans}         # (id, name, t0, t1, parent, request)
    assert recs["child"][4] == recs["outer"][0] == recs["nested_call"][4]
    assert recs["grandchild"][4] == recs["child"][0] and recs["outer"][4] == -1
    assert len({recs[n][5] for n in ("outer", "child", "grandchild", "nested_call")}) == 1
    assert recs["second"][5] != recs["outer"][5] and recs["second"][4] == -1
    rep = tracing.report()
    assert rep["requests"] == 2 and rep["calls"]["count"] == 1   # the nested call stamps nothing


def test_self_time_is_duration_less_children(on, clock):
    with tracing.span("parent"):                 # 0
        with tracing.span("a"):                  # 10 .. 20
            pass
        with tracing.span("b"):                  # 30 .. 40
            pass
    rep = tracing.report()["spans"]              # parent ends at 50
    assert rep["parent"]["total_ms"] == pytest.approx(50e-6)
    assert rep["parent"]["self_ms"] == pytest.approx(30e-6)
    assert rep["a"]["self_ms"] == rep["a"]["total_ms"] == pytest.approx(10e-6)


def test_bounded_buffer_drops_the_oldest():
    tracing.enable(capacity=3)
    try:
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
        assert [r[1] for r in tracing._tracer.spans] == ["s2", "s3", "s4"]
        rep = tracing.report()
    finally:
        tracing.disable()
    assert rep["dropped"]["spans"] == 2 and set(rep["spans"]) == {"s2", "s3", "s4"}
    assert tracing.report()["spans"] == {}                   # report() starts a new window


def test_stage_and_idle_arithmetic_on_synthetic_times():
    stamps = [(100, "call.begin"), (110, "x"), (150, "y"), (170, ""), (180, "x"),
              (190, "call.end"), (250, "call.begin"), (260, "x"), (300, "call.end"),
              (400, "call.begin"), (420, "call.end")]
    s = tracing.stamp_summary(stamps)
    assert s["stages"] == {"x": [40, 10, 40], "y": [20]}
    assert s["calls"] == [(100, 190), (250, 300), (400, 420)]
    assert s["between"] == [(190, 250), (300, 400)]
    assert s["inside"] == [(100, 110), (170, 180), (250, 260), (400, 420)]


def test_report_groups_gaps_by_innermost_span(on, clock):
    """CPU stamps read the tracing clock: the report's idle share is the
    time between calls over the calls' window, and each interval inside a
    call outside its stages goes to the innermost span open when it
    began."""
    for _ in range(2):
        with tracing.call("c", CPU):              # span opens at t, begin stamp t+10
            with tracing.span("lookup"):          # t+20 .. t+30
                pass
            tracing.stage("work", CPU)            # t+40
            tracing.stage(None, CPU)              # t+50
        # end stamp t+60, span closes t+70; the next call opens at t+80
    calls = tracing.report()["calls"]
    assert calls["count"] == 2
    assert calls["window_ms"] == pytest.approx(130e-6)       # 10 .. 140
    assert calls["between_ms"] == pytest.approx(30e-6)       # 60 .. 90
    assert calls["idle_share"] == pytest.approx(30 / 130)
    assert calls["inside_ms"] == pytest.approx(80e-6)        # 2 x (30 + 10)
    assert calls["gaps_ms"] == pytest.approx({"c": 80e-6, "caller": 30e-6})


def test_spans_are_profiler_ranges_while_it_runs(on):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.call("traced_call", CPU), tracing.span("traced_child"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"traced_call", "traced_child"} <= names


def test_counters_are_the_wrappers_dicts(on):
    assert tracing._registry["fusion_kernel.launches"] is fk.launches
    assert tracing._registry["graph"] is tg.counts
    fk.launches["fusion"] += 3
    try:
        assert tracing.report()["counters"]["fusion_kernel.launches.fusion"] == 3
    finally:
        fk.launches["fusion"] -= 3


def test_graph_key_holds_the_tracing_state(small_cfg):
    vol = tb.make_brick_volume(small_cfg, 8, 64, device="cpu")
    off = tg.state_key(vol)
    tracing.enable()
    try:
        assert tg.state_key(vol) != off
    finally:
        tracing.disable()
    assert tg.state_key(vol) == off
