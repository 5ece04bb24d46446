"""The port stands alone: it imports neither jax nor the JAX package (a
script fuses, meshes, writes a PLY and renders a view with both blocked),
and its entry points default to the CUDA device with no silent CPU
fallback."""

import os
import subprocess
import sys

import pytest
import torch

from cpu_tsdf_tpu_torch import TSDFConfig, make_brick_volume, make_volume

REPO = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["cpu_tsdf_tpu"] = None
import numpy as np
import cpu_tsdf_tpu_torch as T
from cpu_tsdf_tpu_torch.ops.marching_cubes import extract_mesh
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world
from cpu_tsdf_tpu_torch.io.ply import save_ply, load_ply
import cpu_tsdf_tpu_torch.convert, cpu_tsdf_tpu_torch._build  # noqa: F401

cfg = T.TSDFConfig(xres=32, yres=32, zres=32, xsize=1.6, ysize=1.6, zsize=1.6,
                   max_dist_pos=0.1, max_dist_neg=0.1, min_sensor_dist=0.1,
                   image_width=40, image_height=30, focal_length_x=35.0,
                   focal_length_y=35.0, principal_point_x=20.0,
                   principal_point_y=15.0)
vol = T.make_brick_volume(cfg, 8, 128, device="cpu")
for i in range(3):
    pose = orbit_pose(0.4 * i)
    T.integrate_bricks(vol, sphere_depth_world(cfg, pose, radius=0.5), pose)
v, f, _ = extract_mesh(vol, min_weight=0.5)
assert len(f) > 50 and not bool(vol.overflowed), len(f)
save_ply(sys.argv[1], v, f)
assert load_ply(sys.argv[1])[1].shape == f.shape
r = T.render_view(vol, orbit_pose(0.4), colored=False)
n = int((~r.depth.isnan()).sum())
assert r.depth.shape == (30, 40) and n > 300, n
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "cpu_tsdf_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("NO-JAX OK", len(f))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "m.ply")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO-JAX OK" in r.stdout, (r.stdout[-2000:],
                                                          r.stderr[-2000:])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    cfg = TSDFConfig(xres=16, yres=16, zres=16)
    with pytest.raises((RuntimeError, AssertionError)):
        make_brick_volume(cfg, 8, 16)
    with pytest.raises((RuntimeError, AssertionError)):
        make_volume(cfg)
