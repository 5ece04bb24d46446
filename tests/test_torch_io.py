"""Port parity: the file formats against the JAX package's, on the CPU.

PCD, PNG and .vol files written by the two packages are equal byte for
byte; pose files and directories read the same; npz checkpoints written by
either package load in the other with every array equal.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu import integrate as jintegrate
from cpu_tsdf_tpu import make_volume as jmake_volume
from cpu_tsdf_tpu.io import checkpoint as jckpt
from cpu_tsdf_tpu.io import image as jimage
from cpu_tsdf_tpu.io import pcd as jpcd
from cpu_tsdf_tpu.io import poses as jposes
from cpu_tsdf_tpu.io import vol as jvol
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch import BrickVolume, TSDFVolume
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_to_arrays, tsdf_volume_to_arrays
from cpu_tsdf_tpu_torch.io import checkpoint as tckpt
from cpu_tsdf_tpu_torch.io import image as timage
from cpu_tsdf_tpu_torch.io import pcd as tpcd
from cpu_tsdf_tpu_torch.io import poses as tposes
from cpu_tsdf_tpu_torch.io import vol as tvol

from test_fusion import tilted_pose
from test_torch_bricks import JAX_FIELDS, jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)

DENSE_FIELDS = ("sdf", "weight", "M", "nsample", "color", "global_transform")


def _cloud(mod, with_rgb=True, n=120, w=12, h=10):
    rng = np.random.default_rng(1)
    fields = {"x": rng.normal(size=n).astype(np.float32),
              "y": rng.normal(size=n).astype(np.float32),
              "z": (rng.uniform(size=n) * 2 + 0.5).astype(np.float32)}
    fields["z"][::7] = np.nan
    if with_rgb:
        fields["rgb"] = mod.pack_rgb(rng.integers(0, 256, (n, 3)).astype(np.float32))
    fields["label"] = rng.integers(0, 9, n).astype(np.uint16)
    return mod.PointCloud(fields, w, h)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_pcd_bytes_and_loads_match(tmp_path, mode):
    paths = []
    for name, mod in (("jax", jpcd), ("port", tpcd)):
        p = str(tmp_path / f"{name}.pcd")
        mod.save_pcd(p, _cloud(mod), mode=mode)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    jc, tc = jpcd.load_pcd(paths[1]), tpcd.load_pcd(paths[0])
    assert (jc.width, jc.height) == (tc.width, tc.height) and list(jc.fields) == list(tc.fields)
    for k in jc.fields:
        np.testing.assert_array_equal(jc.fields[k], tc.fields[k], err_msg=k)
    np.testing.assert_array_equal(jc.rgb(), tc.rgb())
    np.testing.assert_array_equal(jc.xyz(), tc.xyz())


def test_lzf_matches_jax():
    """Both codecs: the literal-only encoder's output, its round trip, and
    hand-made streams with overlapping and length-extended back-references."""
    rng = np.random.default_rng(2)
    raw = rng.bytes(10000) + b"\x00" * 5000
    assert tpcd._lzf_compress(raw) == jpcd._lzf_compress(raw)
    assert tpcd._lzf_decompress(jpcd._lzf_compress(raw), len(raw)) == raw
    lit = bytes(range(32))
    for stream, n in ((bytes([1]) + b"ab" + bytes([(5 << 5) | 0, 1]), 9),
                      (bytes([31]) + lit + bytes([(7 << 5) | 0, 3, 31]), 44),
                      (bytes([0]) + b"z" + bytes([(7 << 5) | 0, 200, 0]), 205)):
        assert tpcd._lzf_decompress(stream, n) == jpcd._lzf_decompress(stream, n)
    assert tpcd._lzf_decompress(bytes([1]) + b"ab" + bytes([(5 << 5) | 0, 1]), 9) == b"ababababa"


def test_load_pcd_rejects_non_pcd(tmp_path):
    p = str(tmp_path / "junk.pcd")
    with open(p, "wb") as f:
        f.write(b"\x00\x01binary junk without DATA line")
    with pytest.raises(ValueError, match="DATA"):
        tpcd.load_pcd(p)


def _pose_dir(tmp_path, ext):
    rng = np.random.default_rng(3)
    d = tmp_path / ext.strip(".")
    os.makedirs(d)
    for i in (0, 1, 10):
        (d / f"scan_{i:04d}.pcd").write_bytes(b"")
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = rng.normal(size=3)
        if ext == ".txt":
            (d / f"pose_{i:04d}.txt").write_text(
                "\n".join(" ".join(f"{v:.17g}" for v in row) for row in m[:3]) + "\n")
        else:
            (d / f"pose_{i:04d}.transform").write_bytes(
                struct.pack("<12f", *m[:3].reshape(-1)))
    return str(d)


@pytest.mark.parametrize("ext", [".txt", ".transform"])
@pytest.mark.parametrize("invert,units", [(False, 1.0), (True, 0.001)])
def test_poses_match_jax(tmp_path, ext, invert, units):
    d = _pose_dir(tmp_path, ext)
    jfiles, tfiles = jposes.scrape_directory(d), tposes.scrape_directory(d)
    assert jfiles == tfiles and len(tfiles[1]) == 3 and tfiles[2] == (ext == ".transform")
    jp = jposes.load_poses(jfiles[1], invert=invert, pose_units=units)
    tp = tposes.load_poses(tfiles[1], invert=invert, pose_units=units)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    names = ["scan_0001.pcd", "scan_0002.pcd", "scan_0100.pcd"]
    assert tposes.shared_prefix(names) == jposes.shared_prefix(names) == "scan_"


def test_png_bytes_match(tmp_path):
    rng = np.random.default_rng(4)
    depth = (0.5 + rng.uniform(size=(30, 40))).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = np.nan
    normals = rng.normal(size=(30, 40, 3)).astype(np.float32)
    normals[5:9] = np.nan
    out = []
    for mod in (jimage, timage):
        blobs = []
        for name, img in (("d", mod.depth_to_u8(depth)), ("n", mod.normals_to_u8(normals))):
            p = str(tmp_path / f"{mod.__name__}_{name}.png")
            mod.save_png(p, img)
            with open(p, "rb") as f:
                blobs.append(f.read())
        out.append(blobs)
    assert out[0] == out[1] and out[0][0][:8] == b"\x89PNG\r\n\x1a\n"


def _fused(cfg, mode):
    """A JAX dense volume with two tilted frames fused, color in `mode`."""
    jcfg = cfg if mode is None else cfg.with_updates(integrate_color=True, color_mode=mode)
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = np.random.default_rng(5).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    v = jmake_volume(jcfg)
    for p in (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88)):
        v = jintegrate(v, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                       None if mode is None else jnp.asarray(rgb))
    return v


@pytest.mark.parametrize("mode", [None, "RGB", "RGBNormalized", "LAB"])
def test_vol_bytes_and_arrays_match(tmp_path, small_cfg, mode):
    """save_vol of the same arrays writes the same bytes (the low-byte
    truncation of RGBNormalized/LAB included); load_vol and load_any read
    them the same."""
    v = _fused(small_cfg, mode)
    cfg = TSDFConfig.from_json(v.config.to_json())
    arrays = [np.asarray(a) for a in (v.sdf, v.weight, v.M, v.nsample)]
    rgb = None if v.color is None else np.asarray(v.color)
    transform = np.eye(4)
    transform[:3, 3] = (0.1, -0.2, 0.3)
    paths = []
    for name, mod, c in (("jax", jvol, v.config), ("port", tvol, cfg)):
        p = str(tmp_path / f"{name}.tsdf")
        mod.save_vol(p, c, *arrays, rgb=rgb, global_transform=transform,
                     color_mode=c.color_mode)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        ja = a.read()
        assert ja == b.read() and len(ja) > 10000
    (jc, jarr, jt), (tc, tarr, tt) = jvol.load_vol(paths[0]), tvol.load_vol(paths[0])
    assert TSDFConfig.from_json(jc.to_json()) == tc and sorted(jarr) == sorted(tarr)
    np.testing.assert_array_equal(jt, tt)
    for k in jarr:
        np.testing.assert_array_equal(jarr[k], tarr[k], err_msg=k)
    jv, tv = jckpt.load_any(paths[0]), tckpt.load_any(paths[0], device="cpu")
    assert isinstance(tv, TSDFVolume) and tv.config == TSDFConfig.from_json(jv.config.to_json())
    for k, a in tsdf_volume_to_arrays(tv).items():
        b = getattr(jv, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


def _brick(cfg):
    jcfg = cfg.with_updates(integrate_color=True, color_mode="LAB")
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = np.random.default_rng(6).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    v = jb.make_brick_volume(jcfg, 8, 1024)
    for p in (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88)):
        v = jb.integrate_bricks(v, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                jnp.asarray(rgb), 1024)
    return v


@pytest.mark.parametrize("kind", ["dense", "brick"])
def test_npz_checkpoints_cross_load(tmp_path, small_cfg, kind):
    """JAX -> port and port -> JAX: every array equal, metadata (with the
    CLI's next_frame) carried over, the kind kept."""
    jv = _fused(small_cfg, "RGB") if kind == "dense" else _brick(small_cfg)
    fields = DENSE_FIELDS if kind == "dense" else JAX_FIELDS
    jfile, tfile = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(jfile, jv, {"next_frame": 7})
    tv = tckpt.load_checkpoint(jfile, device="cpu")
    assert isinstance(tv, BrickVolume if kind == "brick" else TSDFVolume)
    assert tv.device.type == "cpu" and tckpt.checkpoint_meta(jfile)["next_frame"] == 7
    to_arrays = brick_volume_to_arrays if kind == "brick" else tsdf_volume_to_arrays
    a, j = to_arrays(tv), jax_arrays(jv) if kind == "brick" else {
        k: np.asarray(getattr(jv, k)) for k in fields}
    for k in fields:
        assert a[k].dtype == j[k].dtype and a[k].shape == j[k].shape, k
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)

    tckpt.save_checkpoint(tfile, tv, {"next_frame": 7})
    assert not os.path.exists(tfile + ".tmp.npz")
    assert jckpt.checkpoint_meta(tfile) == jckpt.checkpoint_meta(jfile)
    back = jckpt.load_any(tfile)
    assert type(back) is type(jv) and back.config == jv.config
    for k in fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), j[k], err_msg=k)
    with np.load(tfile) as z, np.load(jfile) as y:
        assert z.files == y.files


def test_checkpoint_loaders_default_to_cuda(tmp_path, small_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    p = str(tmp_path / "v.npz")
    jckpt.save_checkpoint(p, _fused(small_cfg, None))
    with pytest.raises((RuntimeError, AssertionError)):
        tckpt.load_checkpoint(p)
    with pytest.raises((RuntimeError, AssertionError)):
        tckpt.load_any(p)
