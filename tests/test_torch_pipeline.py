"""Port parity: the pipeline stages against the JAX package's, on the CPU.

``organize_cloud`` (torch ops) must give the JAX package's depth image bit
for bit and its colors exactly, ties at a pixel's nearest depth included:
the port picks the tied point with the largest index, which is what XLA:CPU's
in-order scatter leaves in the JAX package. The numpy passes are copies and
must agree exactly.
"""

import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import pipeline as jp
from cpu_tsdf_tpu.config import TSDFConfig as JConfig
from cpu_tsdf_tpu_torch import pipeline as tp
from cpu_tsdf_tpu_torch.config import TSDFConfig

import torch_common  # noqa: F401  (one intra-op thread)


def _cfgs():
    j = JConfig(image_width=64, image_height=48, focal_length_x=52.5, focal_length_y=52.5,
                principal_point_x=31.5, principal_point_y=23.5)
    return j, TSDFConfig.from_json(j.to_json())


def _cloud(n=6000, seed=0):
    """Points in front of and behind the camera, outside the image, NaN
    points, NaN x with a valid z, and exact duplicates of depth at one
    pixel with different colors (ties)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(-0.2, 2.5, n)], -1).astype(np.float32)
    pts[::50] = np.nan
    pts[7::97, 0] = np.nan
    pts[3::101, 2] = 0.0
    pts[-40:] = (0.02, 0.01, 0.15)             # 40 ties at one pixel ...
    pts[-80:-40] = (-0.03, 0.02, 0.2)          # ... and 40 at another,
    pts[-60:-50] *= 1.3                        # 10 of them farther away
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    return pts, rgb


@pytest.mark.parametrize("seed", [0, 1])
def test_organize_cloud_matches_jax(seed):
    jcfg, cfg = _cfgs()
    pts, rgb = _cloud(seed=seed)
    jd, jr = jp.organize_cloud(jcfg, pts, rgb)
    td, tr = tp.organize_cloud(cfg, pts, rgb, device="cpu")
    assert td.dtype == torch.float32 and td.shape == (48, 64) and tr.shape == (48, 64, 3)
    jd = np.asarray(jd)
    assert np.isfinite(jd).sum() > 500
    np.testing.assert_array_equal(td.numpy().view(np.uint32), jd.view(np.uint32))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # the tied pixels took the color of the last of their nearest points
    for last, p in ((len(pts) - 1, pts[-1]), (len(pts) - 41, pts[-41])):
        u, v = (int(p[0] * 52.5 / p[2] + 31.5), int(p[1] * 52.5 / p[2] + 23.5))
        np.testing.assert_array_equal(tr[v, u].numpy(), rgb[last])
    td2, tr2 = tp.organize_cloud(cfg, torch.as_tensor(pts), None, device="cpu")
    assert tr2 is None and torch.equal(td2.nan_to_num(), td.nan_to_num())


def test_organize_cloud_backprojected_image():
    """Every pixel of a depth image backprojected and organized again comes
    back bit for bit, as in the JAX package (the 1e-3-pixel nudge)."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(9)
    depth = (1.0 + rng.uniform(size=(48, 64))).astype(np.float32)
    uu, vv = np.meshgrid(np.arange(64), np.arange(48))
    pts = np.stack([(uu - 31.5) / 52.5 * depth, (vv - 23.5) / 52.5 * depth, depth],
                   -1).reshape(-1, 3)
    td, _ = tp.organize_cloud(cfg, pts, device="cpu")
    jd, _ = jp.organize_cloud(jcfg, pts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(td.numpy(), depth, rtol=1e-6)


def test_organize_cloud_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    _, cfg = _cfgs()
    with pytest.raises((RuntimeError, AssertionError)):
        tp.organize_cloud(cfg, np.zeros((4, 3), np.float32))


def _mesh(seed=0, n=400):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.2, 0.2, (3 * n, 3)).astype(np.float32)
    verts[1::3] = verts[0::3] + 0.004 * rng.normal(size=(n, 3))
    verts[2::3] = verts[0::3] + 0.004 * rng.normal(size=(n, 3))
    verts[10:40] = verts[0]                    # welds and degenerate faces
    verts[300:330] = np.round(verts[300:330], 4)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    cols = rng.integers(0, 256, (3 * n, 3)).astype(np.float32)
    return verts, faces, cols


@pytest.mark.parametrize("min_dist", [0.0001, 0.01])
def test_flatten_vertices_matches_jax(min_dist):
    v, f, c = _mesh()
    out_j = jp.flatten_vertices(v, f, c, min_dist)
    out_t = tp.flatten_vertices(v, f, c, min_dist)
    assert len(out_t[1]) < len(f)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a, b)


def test_cleanup_mesh_matches_jax():
    v, f, c = _mesh(1)
    # a far-off small cluster that cleanup drops
    v[-9:] = v[-9:] * 0.01 + 3.0
    out_j = jp.cleanup_mesh(v, f, c, face_dist=0.05, min_neighbors=5)
    out_t = tp.cleanup_mesh(v, f, c, face_dist=0.05, min_neighbors=5)
    assert 0 < len(out_t[1]) < len(f)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a, b)


def test_estimate_intrinsics_matches_jax():
    rng = np.random.default_rng(2)
    z = (1.0 + rng.uniform(size=(30, 40))).astype(np.float32)
    uu, vv = np.meshgrid(np.arange(40), np.arange(30))
    xyz = np.stack([(uu - 19.25) / 47.0 * z, (vv - 15.5) / 46.0 * z, z], -1)
    xyz[rng.uniform(size=z.shape) < 0.1] = np.nan
    xyz = xyz + rng.normal(0, 1e-4, xyz.shape)
    a, b = jp.estimate_intrinsics(xyz, 40, 30), tp.estimate_intrinsics(xyz, 40, 30)
    assert a == b and abs(b[0] - 47.0) < 0.5
    with pytest.raises(ValueError):
        tp.estimate_intrinsics(xyz, 30, 40)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_voxel_downsample_matches_jax(with_rgb):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.3, 0.3, (5000, 3))
    rgb = rng.integers(0, 256, (5000, 3)).astype(np.float32) if with_rgb else None
    (jpts, jrgb), (tpts, trgb) = (jp.voxel_downsample(pts, rgb, 0.05),
                                  tp.voxel_downsample(pts, rgb, 0.05))
    np.testing.assert_array_equal(jpts, tpts)
    assert (jrgb is None) == (trgb is None) and len(tpts) < 5000
    if with_rgb:
        np.testing.assert_array_equal(jrgb, trgb)
