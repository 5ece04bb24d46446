"""Port parity: the three CLI programs against the JAX package's, on the CPU.

Both packages' ``integrate_main`` run on one synthetic PCD + pose directory
(the port with TSDF_DEVICE=cpu). The cameras are tilted, as in
tests/test_fusion.py::tilted_pose: XLA:CPU contracts multiply-adds into FMAs
under jit and the port evaluates op by op, so an axis-aligned camera puts
voxel centres within an ulp of pixel edges, where the two pick different
pixels. Held to the fusion tolerances: weight, nsample and RGB color exact,
sdf and M within 1e-5; meshes: the same triangles in the same order,
vertices within 1e-5; the aggregate cloud byte for byte.
"""

import os

import numpy as np
import pytest

from cpu_tsdf_tpu import cli as jcli
from cpu_tsdf_tpu.io import pcd as jpcd
from cpu_tsdf_tpu.io import ply as jply
from cpu_tsdf_tpu.synthetic import sphere_depth_world
from cpu_tsdf_tpu_torch import cli as tcli
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.io.checkpoint import checkpoint_meta, load_any, save_checkpoint

from test_fusion import tilted_pose
import torch_common  # noqa: F401  (one intra-op thread)

W, H = 64, 48
FX = FY = 60.0
CX, CY = W / 2.0 - 0.5, H / 2.0 - 0.5
CENTER = (0.02, -0.01, 0.05)      # the sphere, in the world frame
RADIUS = 0.35


def write_tilted_sequence(dirname, n_frames=3, color=False, world=False, zero_nans=False):
    """PCD + .txt pose pairs of a sphere seen by tilted cameras ~0.95 m
    away (camera-in-world poses), every pixel backprojected from its
    depth; with color, a per-pixel color pattern; with world, the points
    in the world frame; with zero_nans, missing points as (0, 0, 0)."""
    cfg = TSDFConfig(image_width=W, image_height=H, focal_length_x=FX,
                     focal_length_y=FY, principal_point_x=CX, principal_point_y=CY)
    os.makedirs(dirname, exist_ok=True)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    for i in range(n_frames):
        pose = tilted_pose(tx=0.013 + 0.03 * i, ty=0.021 - 0.01 * i, tz=-0.9 - 0.02 * i)
        depth = sphere_depth_world(cfg, pose, center=CENTER, radius=RADIUS)
        x = (uu - CX) / FX * depth
        y = (vv - CY) / FY * depth
        pts = np.stack([x, y, depth], -1).reshape(-1, 3)
        if world:
            pts = pts @ pose[:3, :3].T + pose[:3, 3]
        pts = pts.astype(np.float32)
        if zero_nans:
            pts[np.isnan(pts[:, 2])] = 0.0
        fields = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}
        if color:
            rgb = np.stack([uu * 4 % 256, vv * 5 % 256, (uu + vv + 40 * i) % 256],
                           -1).reshape(-1, 3).astype(np.float32)
            fields["rgb"] = jpcd.pack_rgb(rgb)
        jpcd.save_pcd(os.path.join(dirname, f"cloud_{i:04d}.pcd"),
                      jpcd.PointCloud(fields, W, H), "binary")
        with open(os.path.join(dirname, f"pose_{i:04d}.txt"), "w") as f:
            for row in pose[:3]:
                f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def common_args(in_dir, out_dir):
    return ["--in", in_dir, "--out", out_dir,
            "--volume-size", "1.6", "--cell-size", "0.025", "--max-cell-size", "0.4",
            "--width", str(W), "--height", str(H),
            "--fx", str(FX), "--fy", str(FY), "--cx", str(CX), "--cy", str(CY),
            "--trunc-dist-pos", "0.06", "--trunc-dist-neg", "0.06",
            "--min-sensor-dist", "0.1"]


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("TSDF_DEVICE", "cpu")


def assert_npz_match(a_path, b_path):
    """Two volume.npz files: the same keys and metadata; structure, weight,
    nsample and (RGB) color exact; sdf and M within 1e-5."""
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert bytes(a["__meta__"]) == bytes(b["__meta__"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k in ("sdf", "M"):
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
            elif k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["weight"] > 0).sum() > 1000


def assert_ply_match(a_path, b_path):
    va, fa, ca = jply.load_ply(a_path)
    vb, fb, cb = jply.load_ply(b_path)
    assert len(fa) > 200 and fa.shape == fb.shape
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(va, vb, atol=1e-5)
    assert (ca is None) == (cb is None)
    if ca is not None:
        np.testing.assert_array_equal(ca, cb)


def run_both(tmp_path, extra, n_frames=2, **scene):
    """integrate_main of both packages on one sequence; returns the two
    output directories."""
    in_dir = str(tmp_path / "in")
    write_tilted_sequence(in_dir, n_frames, **scene)
    outs = []
    for name, main in (("jax", jcli.integrate_main), ("port", tcli.integrate_main)):
        out = str(tmp_path / name)
        assert main(common_args(in_dir, out) + extra) == 0, name
        outs.append(out)
    return outs


SPARSE = ["--sparse", "--brick-capacity", "1024"]
CASES = {
    "dense": (["--flatten", "--cleanup", "--visualize-every", "1"], {}),
    "sparse": (SPARSE + ["--visualize-every", "2"], {}),
    "dense_color": (["--color"], {"color": True}),
    "sparse_color": (SPARSE + ["--color", "--flatten"], {"color": True}),
    "organized_world_zero_nans": (SPARSE + ["--organized", "--world", "--zero-nans", "--color"],
                                  {"color": True, "world": True, "zero_nans": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_matches_jax(tmp_path, cpu_env, case):
    extra, scene = CASES[case]
    jout, tout = run_both(tmp_path, extra + ["--save-tsdf"], **scene)
    assert_npz_match(os.path.join(jout, "volume.npz"), os.path.join(tout, "volume.npz"))
    assert_ply_match(os.path.join(jout, "mesh.ply"), os.path.join(tout, "mesh.ply"))
    # --visualize-every: the same PNG dumps (their pixels come from each
    # package's render and are held in tests/test_torch_render.py)
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))


def test_random_splits_match_jax(tmp_path, cpu_env, monkeypatch):
    """--num-random-splits 3 with the port's jitter fed the JAX package's
    draws (the two packages' generators differ)."""
    from cpu_tsdf_tpu_torch import bricks as tb

    from test_torch_bricks import _jax_draws

    monkeypatch.setattr(tb, "draw_split_noise", _jax_draws)
    jout, tout = run_both(tmp_path, SPARSE + ["--num-random-splits", "3", "--save-tsdf"])
    assert_npz_match(os.path.join(jout, "volume.npz"), os.path.join(tout, "volume.npz"))
    assert_ply_match(os.path.join(jout, "mesh.ply"), os.path.join(tout, "mesh.ply"))


def test_cloud_only_matches_jax(tmp_path, cpu_env):
    jout, tout = run_both(tmp_path, ["--cloud-only"], color=True)
    with open(os.path.join(jout, "cloud.pcd"), "rb") as a, \
            open(os.path.join(tout, "cloud.pcd"), "rb") as b:
        ja, tb = a.read(), b.read()
    assert len(ja) > 5000 and ja == tb


def test_vol_format_matches_jax(tmp_path, cpu_env):
    """--tsdf-format vol: both .vol files load to the same arrays (the
    codec's bytes are held equal in tests/test_torch_io.py)."""
    from cpu_tsdf_tpu.io.vol import load_vol

    jout, tout = run_both(tmp_path, SPARSE + ["--color", "--save-tsdf", "--tsdf-format", "vol"],
                          color=True)
    (jc, ja, jt), (tc, ta, tt) = (load_vol(os.path.join(o, "volume.tsdf"))
                                  for o in (jout, tout))
    assert jc == tc and set(ja) == set(ta)
    np.testing.assert_array_equal(jt, tt)
    for k in ja:
        if k in ("sdf", "M"):
            np.testing.assert_allclose(ja[k], ta[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_save_every_then_resume_matches_jax(tmp_path, cpu_env, sparse):
    """Two frames with a checkpoint after each, then --resume for the third:
    the checkpoint carries next_frame in the npz and in the json sidecar,
    and the resumed runs give the JAX package's volume and mesh."""
    extra = SPARSE if sparse else []
    jout, tout = run_both(tmp_path, extra + ["--num-frames", "2", "--save-every", "1"], 3)
    for out in (jout, tout):
        assert checkpoint_meta(os.path.join(out, "checkpoint.npz"))["next_frame"] == 2
    assert_npz_match(os.path.join(jout, "checkpoint.npz"), os.path.join(tout, "checkpoint.npz"))
    in_dir = str(tmp_path / "in")
    # each package resumes from its own checkpoint; --sparse is the opposite
    # of the checkpoint's kind, which wins
    flip = [] if sparse else ["--sparse"]
    assert jcli.integrate_main(common_args(in_dir, jout) + ["--resume", "--save-tsdf"] + flip) == 0
    assert tcli.integrate_main(common_args(in_dir, tout) + ["--resume", "--save-tsdf"] + flip) == 0
    assert_npz_match(os.path.join(jout, "volume.npz"), os.path.join(tout, "volume.npz"))
    assert_ply_match(os.path.join(jout, "mesh.ply"), os.path.join(tout, "mesh.ply"))


def test_resume_without_cursor_starts_fresh(tmp_path, cpu_env):
    """A checkpoint with no next_frame and no sidecar is ignored."""
    in_dir, fresh, out = (str(tmp_path / d) for d in ("in", "fresh", "out"))
    write_tilted_sequence(in_dir, 2)
    assert tcli.integrate_main(common_args(in_dir, fresh) + ["--save-tsdf"]) == 0
    os.makedirs(out)
    save_checkpoint(os.path.join(out, "checkpoint.npz"),
                         load_any(os.path.join(fresh, "volume.npz"), device="cpu"), {})
    assert tcli.integrate_main(common_args(in_dir, out) + ["--resume"]) == 0
    assert_ply_match(os.path.join(fresh, "mesh.ply"), os.path.join(out, "mesh.ply"))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_tsdf2mesh_matches_jax(tmp_path, cpu_env, capsys, monkeypatch, sparse):
    """Both tsdf2mesh programs on the JAX package's volume.npz: the same
    printed lines and the same mesh; the port's own volume.npz gives the
    port's integrate mesh again."""
    in_dir, out = str(tmp_path / "in"), str(tmp_path / "out")
    write_tilted_sequence(in_dir, 2)
    extra = SPARSE if sparse else []
    assert jcli.integrate_main(common_args(in_dir, out) + extra + ["--save-tsdf"]) == 0
    npz = os.path.join(out, "volume.npz")
    capsys.readouterr()
    lines = []
    for main, cwd in ((jcli.tsdf2mesh_main, tmp_path / "jax"),
                      (tcli.tsdf2mesh_main, tmp_path / "port")):
        os.makedirs(cwd)
        monkeypatch.chdir(cwd)
        assert main([npz, "mesh.ply"]) == 0
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and "Loaded!" in lines[0]
    assert_ply_match(str(tmp_path / "jax" / "mesh.ply"), str(tmp_path / "port" / "mesh.ply"))

    port_out = str(tmp_path / "port_out")
    assert tcli.integrate_main(common_args(in_dir, port_out) + extra + ["--save-tsdf"]) == 0
    assert tcli.tsdf2mesh_main([os.path.join(port_out, "volume.npz"),
                                str(tmp_path / "again.ply")]) == 0
    assert_ply_match(os.path.join(port_out, "mesh.ply"), str(tmp_path / "again.ply"))


def test_get_intrinsics_matches_jax(tmp_path, capsys):
    in_dir = str(tmp_path / "in")
    write_tilted_sequence(in_dir, 1)
    pcd = os.path.join(in_dir, "cloud_0000.pcd")
    capsys.readouterr()
    outs = []
    for main in (jcli.get_intrinsics_main, tcli.get_intrinsics_main):
        assert main([pcd]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    fx = float([ln for ln in outs[1].splitlines() if ln.startswith("fx:")][0].split()[1])
    assert abs(fx - FX) < 0.5


def _no_pcd(tmp_path):
    os.makedirs(tmp_path / "in")
    return []


def _orphan_cloud(tmp_path):
    write_tilted_sequence(str(tmp_path / "in"), 2)
    os.remove(tmp_path / "in" / "pose_0001.txt")
    return []


def _organized_size(tmp_path):
    write_tilted_sequence(str(tmp_path / "in"), 1)
    return ["--organized", "--width", "32"]


def _mixed_poses(tmp_path):
    write_tilted_sequence(str(tmp_path / "in"), 2)
    (tmp_path / "in" / "pose_0001.transform").write_bytes(b"\0" * 48)
    return []


@pytest.mark.parametrize("setup", [_no_pcd, _orphan_cloud, _organized_size, _mixed_poses],
                         ids=["no_pcd", "orphan_cloud", "organized_size", "mixed_poses"])
def test_error_paths_match_jax(tmp_path, cpu_env, capsys, setup):
    extra = setup(tmp_path)
    in_dir = str(tmp_path / "in")
    errs = []
    for name, main in (("jax", jcli.integrate_main), ("port", tcli.integrate_main)):
        out = str(tmp_path / name)
        capsys.readouterr()
        assert main(common_args(in_dir, out) + extra) == 1, name
        errs.append(capsys.readouterr().err.replace(out, "OUT"))
        assert not os.path.exists(os.path.join(out, "mesh.ply"))
    assert errs[0] == errs[1] and errs[0].startswith("Error: ")


def test_metrics_json_records_stages(tmp_path, cpu_env):
    """--metrics-json: each frame's read, organize and integrate seconds
    (the stages sum to the frame), the extraction and the npz write."""
    import json

    in_dir, out, path = str(tmp_path / "in"), str(tmp_path / "out"), str(tmp_path / "m.json")
    write_tilted_sequence(in_dir, 2)
    assert tcli.integrate_main(common_args(in_dir, out) + SPARSE + [
        "--save-tsdf", "--metrics-json", path]) == 0
    with open(path) as f:
        m = json.load(f)
    assert [r["frame"] for r in m["frames"]] == [0, 1] and m["resolution"] == 64
    for r in m["frames"]:
        stages = r["read_s"] + r["organize_s"] + r["integrate_s"]
        assert 0 < stages <= r["seconds"]
    assert m["extract_s"] > 0 and m["save_tsdf_s"] > 0 and m["device"] == "cpu"


def test_unknown_device_is_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TSDF_DEVICE", "tpu")
    assert tcli.integrate_main(common_args(str(tmp_path), str(tmp_path / "o"))) == 1
    assert "TSDF_DEVICE must be cuda or cpu" in capsys.readouterr().err


@pytest.mark.parametrize("extra,limits,flag", [
    (["--brick-capacity", "16"], {"capacity"}, "--brick-capacity"),
    (["--brick-capacity", "1024", "--update-budget", "16"], {"band", "rough"},
     "--update-budget")], ids=["capacity", "update_budget"])
def test_overflow_warning_names_the_limit(tmp_path, cpu_env, capsys, extra, limits, flag):
    """--sparse with a pool too small for the sphere's bricks, or an update
    budget too small for its band (--update-budget reaches the frame; its
    rough list U2, twice the budget, overflows with it): each frame's
    warning names the limits it exceeded, among those the flag raises, and
    the flag."""
    in_dir, out = str(tmp_path / "in"), str(tmp_path / "out")
    write_tilted_sequence(in_dir, 2)
    assert tcli.integrate_main(common_args(in_dir, out) + ["--sparse"] + extra) == 0
    warnings = [x for x in capsys.readouterr().err.splitlines() if x.startswith("Warning")]
    assert len(warnings) == 2, warnings
    for i, w in enumerate(warnings):
        head = f"Warning: frame {i + 1} overflowed its brick "
        assert w.startswith(head) and w.endswith(f" — increase {flag}"), w
        named = w[len(head):].split(" limit")[0].split(", ")
        assert named and set(named) <= limits, w
