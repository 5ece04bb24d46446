"""The scenes give the same frames every time, and every seed of a cell does
the same work: the seed only picks where the trajectory starts."""

import json

import pytest
import torch
from small import small_files

from portbench import core
from portbench.run import run_cell


@pytest.mark.parametrize("scene_cell", ["bricks8.scan", "dense512.scan"])
def test_frames_repeat(scene_cell):
    files = small_files(scene_cell)
    cfg = core.tsdf_config(files["config"])
    tr = files["traffic"]
    scene = core.scene_module(tr["scene"])
    a = scene.frames(tr["scene_params"], cfg, "cpu")
    b = scene.frames(tr["scene_params"], cfg, "cpu")
    for k in ("depths", "poses", "rgbs"):
        assert torch.equal(torch.nan_to_num(a[k], 7.0), torch.nan_to_num(b[k], 7.0)), k
    valid = ~torch.isnan(a["depths"])
    assert valid.float().mean() > 0.05
    assert float(a["depths"][valid].min()) > cfg.min_sensor_dist


def _evidence(err: str) -> dict:
    line = next(x for x in err.splitlines() if "work and evidence:" in x)
    return json.loads(line.split("work and evidence:", 1)[1])


@pytest.mark.parametrize("cell", ["bricks8.scan", "dense512.scan"])
def test_seeds_do_the_same_work(cell, capsys):
    counts = []
    for seed in (3, 2 ** 31 + 12345):
        run_cell(small_files(cell), seed, 0.2, False, "cpu", 0.0)
        ev = _evidence(capsys.readouterr().err)
        counts.append((ev["live_bricks"], ev["observed_voxels_a_frame"],
                       ev["compared_voxels"], ev["overflowed"]))
    assert counts[0] == counts[1]
    assert counts[0][3] is False
