"""What the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the scene
the mix names (``scenes/<scene>.py``) and the per-layer metric readers
(``metrics/<metric>.py``). Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module loaded from its file (metric names hold dots, so readers are
    not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(cell_name: str, bench: dict | None = None) -> dict:
    """The cell's entry and everything it names: config, traffic, limits,
    its end-to-end and per-layer metric entries."""
    bench = bench if bench is not None else benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"portbench: no workload {cell_name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell_name}.json")

    def mine(m):
        return "workloads" not in m or cell_name in m["workloads"]

    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def scene_module(name: str):
    return load_module(HERE / "scenes" / f"{name}.py", f"portbench_scene_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def tsdf_config(config: dict):
    """The port's TSDFConfig of a configuration file: the reference defaults
    with the file's ``tsdf`` entries over them."""
    from cpu_tsdf_tpu_torch.config import TSDFConfig

    return TSDFConfig().with_updates(**config["tsdf"])


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of values: the
    smallest value with at least q % of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    return float(s[max(0, math.ceil(q / 100.0 * len(s)) - 1)])
