"""A cell of each kind at a size the CPU runs in seconds: the harness's own
files with the volume, the image and the scenes scaled down, the widths of
nothing else changed."""

from __future__ import annotations

import copy

from portbench import core

SMALL_TSDF = dict(xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
                  max_dist_pos=0.05, max_dist_neg=0.05, focal_length_x=65.625,
                  focal_length_y=65.625, principal_point_x=40.0, principal_point_y=30.0,
                  image_width=80, image_height=60)


def small_files(cell: str) -> dict:
    files = copy.deepcopy(core.cell_files(cell))
    cfg, tr = files["config"], files["traffic"]
    cfg["tsdf"].update(SMALL_TSDF)
    if cfg["volume"] == "bricks":
        cfg["capacity"], cfg["update_budget"] = 1024, 256
    sp = tr["scene_params"]
    if tr["scene"] == "orbit":
        sp.update(poses=8, radius=0.4)
    else:
        sp["half_extent"] = 0.75
        sp["boxes"] = [{"lo": [-0.2, -0.75, 0.1], "hi": [0.3, -0.4, 0.5]}]
        sp["spheres"] = [{"center": [0.05, -0.28, 0.3], "radius": 0.12}]
        sp["path"].update(poses=8, x_amp=0.3, z=-0.55, z_bow=0.1, y_amp=0.1,
                          target=[0.0, -0.3, 0.5], target_x_amp=0.2)
    tr["check"]["band_m"] = 0.075
    tr["warmup"] = min(tr["warmup"], 2)
    if "within" in tr["check"]:
        tr["check"]["within"] = tr["check"]["sample"]
    return files
