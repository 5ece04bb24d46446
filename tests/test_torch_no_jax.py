"""The port stands alone: it imports neither jax nor the JAX package (a
script fuses, meshes, writes a PLY, renders a view, takes a pose-refinement
step, imports the sharded paths and runs the three CLI programs with both
blocked), and its entry points default to the CUDA
device with no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpu_tsdf_tpu_torch import TSDFConfig, make_brick_volume, make_volume
from cpu_tsdf_tpu_torch.cli import integrate_main, tsdf2mesh_main
from cpu_tsdf_tpu_torch.io import pcd
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

import torch_common  # noqa: F401  (one intra-op thread)

REPO = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = r"""
import os
import sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["cpu_tsdf_tpu"] = None
import numpy as np
import cpu_tsdf_tpu_torch as T
from cpu_tsdf_tpu_torch.ops.marching_cubes import extract_mesh
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world
from cpu_tsdf_tpu_torch.io.ply import save_ply, load_ply
import cpu_tsdf_tpu_torch.convert, cpu_tsdf_tpu_torch._build  # noqa: F401
import cpu_tsdf_tpu_torch.pipeline  # noqa: F401
from cpu_tsdf_tpu_torch.io import checkpoint, image, pcd, poses, vol  # noqa: F401
from cpu_tsdf_tpu_torch.cli import get_intrinsics_main, integrate_main, tsdf2mesh_main
from cpu_tsdf_tpu_torch.refine import refine_pose_step
import cpu_tsdf_tpu_torch.parallel  # noqa: F401
from cpu_tsdf_tpu_torch.parallel import bricks, distributed, raycast, sharding  # noqa: F401

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
pose, loss = refine_pose_step(vol, orbit_pose(0.4), r.depth)
assert pose.shape == (4, 4) and float(loss) >= 0.0

# the CLI programs, from PCD and pose files to mesh.ply, on the CPU
os.environ["TSDF_DEVICE"] = "cpu"
seq, out = sys.argv[2], sys.argv[3]
args = CLI_ARGS + ["--in", seq, "--out", out]
assert integrate_main(args + ["--sparse", "--brick-capacity", "256", "--save-tsdf",
                              "--visualize-every", "3"]) == 0
assert os.path.exists(os.path.join(out, "viz_0002_depth.png"))
assert tsdf2mesh_main([os.path.join(out, "volume.npz"), os.path.join(out, "again.ply")]) == 0
assert integrate_main(args + ["--save-tsdf", "--tsdf-format", "vol"]) == 0
assert tsdf2mesh_main([os.path.join(out, "volume.tsdf"), os.path.join(out, "vol.ply")]) == 0
assert get_intrinsics_main([os.path.join(seq, "cloud_0000.pcd")]) == 0
assert len(load_ply(os.path.join(out, "vol.ply"))[1]) > 50
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "cpu_tsdf_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("NO-JAX OK", len(f))
"""

CLI_ARGS = ["--volume-size", "2", "--cell-size", "0.0625", "--width", "40",
            "--height", "30", "--fx", "35", "--fy", "35", "--cx", "20", "--cy", "15",
            "--trunc-dist-pos", "0.1", "--trunc-dist-neg", "0.1", "--min-sensor-dist", "0.1",
            "--max-cell-size", "0.125"]


def write_sequence(dirname, n=3):
    """PCD + pose .txt pairs of a radius-0.25 sphere seen from an orbit
    0.7 m away, 40x30 pixels at f=35 (the port's own writers)."""
    cfg = TSDFConfig(image_width=40, image_height=30, focal_length_x=35.0,
                     focal_length_y=35.0, principal_point_x=20.0, principal_point_y=15.0)
    os.makedirs(dirname, exist_ok=True)
    uu, vv = np.meshgrid(np.arange(40), np.arange(30))
    for i in range(n):
        pose = orbit_pose(0.3 * i, orbit_radius=0.7)
        z = sphere_depth_world(cfg, pose, radius=0.25)
        pts = np.stack([(uu - 20.0) / 35.0 * z, (vv - 15.0) / 35.0 * z, z], -1)
        pts = pts.reshape(-1, 3).astype(np.float32)
        cloud = pcd.PointCloud({"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}, 40, 30)
        pcd.save_pcd(os.path.join(dirname, f"cloud_{i:04d}.pcd"), cloud, "binary")
        with open(os.path.join(dirname, f"pose_{i:04d}.txt"), "w") as f:
            for row in pose[:3]:
                f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def test_port_imports_and_runs_without_jax(tmp_path):
    write_sequence(str(tmp_path / "seq"))
    script = SCRIPT.replace("CLI_ARGS", repr(CLI_ARGS))
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path / "m.ply"),
                        str(tmp_path / "seq"), str(tmp_path / "out")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO-JAX OK" in r.stdout, (r.stdout[-2000:],
                                                          r.stderr[-2000:])
    assert "fx: 35.0" in r.stdout


def test_entry_points_default_to_cuda(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    cfg = TSDFConfig(xres=16, yres=16, zres=16)
    with pytest.raises((RuntimeError, AssertionError)):
        make_brick_volume(cfg, 8, 16)
    with pytest.raises((RuntimeError, AssertionError)):
        make_volume(cfg)
    # the CLI without TSDF_DEVICE: exit 1, no mesh, no CPU fallback
    monkeypatch.delenv("TSDF_DEVICE", raising=False)
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    write_sequence(seq, 1)
    capsys.readouterr()
    assert integrate_main(CLI_ARGS + ["--in", seq, "--out", out]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(out, "mesh.ply"))
    with pytest.raises(ValueError, match="no CUDA device"):
        tsdf2mesh_main([os.path.join(seq, "cloud_0000.pcd"), str(tmp_path / "m.ply")])
