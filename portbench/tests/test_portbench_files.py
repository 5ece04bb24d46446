"""Every file the harness finds by name loads, and BENCHMARK.json refers to
each of them and keeps to the limits of the benchmark's format."""

import json
import re

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    b = core.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_every_file_loads_and_is_referenced():
    b = core.benchmark()
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        cfg = core.load_json(core.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        core.tsdf_config(cfg)
    used_traffic = set()
    for w in b["workloads"]:
        files = core.cell_files(w["name"], b)
        assert w["config"] in configs and w["chips"] in (1, 4)
        used_traffic.add(w["traffic"])
        core.scene_module(files["traffic"]["scene"])
        assert set(files["limits"]["limits"]) <= {
            "sdf_gap", "color_gap", "count_mismatch", "depth_gap_mm", "hit_mismatch",
            "normal_gap", "rgb_gap"}
        e2e = [m["name"] for m in files["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and files["per_layer"], w["name"]
    on_disk = {p.stem for p in (core.HERE / "traffic").glob("*.json")}
    assert on_disk == used_traffic
    assert {p.stem for p in (core.HERE / "limits").glob("*.json")} == cells
    assert {p.stem for p in (core.HERE / "configs").glob("*.json")} == set(configs)
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    readers = {p.stem for p in (core.HERE / "metrics").glob("*.py") if p.stem != "_common"}
    assert readers == metrics
    for name in metrics:
        assert callable(core.metric_reader(name).read)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    b = core.benchmark()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
