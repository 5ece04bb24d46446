"""frame_list_fill_pct reads the port's device counts ``activation.lists``
from a tracing report: the band and carve means over their budgets; None
where the report has no such counts (a port that records none), where the
run is not traced, and outside a brick fusion loop."""

from types import SimpleNamespace

import pytest

from portbench import core

COUNTERS = {"activation.lists.tiles": {"count": 4, "mean": 1500.0, "max": 1700, "budget": 6859},
            "activation.lists.band": {"count": 4, "mean": 35000.0, "max": 39000, "budget": 65536},
            "activation.lists.carve": {"count": 4, "mean": 13000.0, "max": 16000,
                                       "budget": 40832},
            "graph.replays": 4}


def ctx(counters, trace=object(), loop="fuse", kind="bricks"):
    report = None if counters is None else {"counters": counters}
    return SimpleNamespace(trace=trace, traffic={"loop": loop},
                           system=SimpleNamespace(kind=kind),
                           cache={"program_trace": report})


def test_reads_the_band_and_carve_fill():
    read = core.metric_reader("frame_list_fill_pct").read
    assert read(ctx(COUNTERS)) == pytest.approx(100.0 * 48000 / (65536 + 40832))


@pytest.mark.parametrize("case", ["no_counts", "no_tracing_module", "untraced", "view",
                                  "dense"])
def test_reads_nothing_without_the_counts(case):
    read = core.metric_reader("frame_list_fill_pct").read
    c = {"no_counts": ctx({"graph.replays": 4}), "no_tracing_module": ctx(None),
         "untraced": ctx(COUNTERS, trace=None), "view": ctx(COUNTERS, loop="view"),
         "dense": ctx(COUNTERS, kind="dense")}[case]
    assert read(c) is None
