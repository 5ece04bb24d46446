"""The port's library path end to end against the JAX package: a colored
6-frame orbit with sensor noise and dropouts is fused into brick volumes by
both packages, meshed, and written to PLY.

Volumes match to the fusion tolerances (weight and nsample exact, sdf and M
within 1e-5, RGB color exact); the meshes — extracted from the same state,
carried across with ``convert`` — are the same triangles in the same order
within 1e-6; the port's PLY reads back through the JAX package's reader.
"""

import jax.numpy as jnp
import numpy as np

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.io.ply import load_ply as jax_load_ply
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import orbit_pose, sphere_depth_world
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.io.ply import save_ply
from cpu_tsdf_tpu_torch.ops.marching_cubes import extract_mesh

from test_fusion import tilted_pose
from test_torch_bricks import assert_volumes_match, jax_arrays


def _orbit(cfg, n_poses=6, seed=7):
    """Noisy colored orbit of a radius-0.5 sphere, made as the JAX package's
    trajectory benchmark makes it (1.5 mm gaussian noise, 5% dropouts), with
    each camera slightly tilted: an axis-aligned camera puts voxel centres
    exactly on pixel edges, where the JAX package's compiled graph (which
    contracts multiply-adds into FMAs on the CPU) and an op-by-op float32
    evaluation legitimately pick different pixels (tilted_pose does the
    same for the JAX package's own tests)."""
    rng = np.random.default_rng(seed)
    tilt = np.eye(4, dtype=np.float32)
    tilt[:3, :3] = tilted_pose()[:3, :3]
    uu, vv = np.meshgrid(np.arange(cfg.image_width), np.arange(cfg.image_height))
    rgb = np.stack([uu % 256, vv % 256, (uu + vv) % 256], -1).astype(np.float32)
    poses, depths = [], []
    for i in range(n_poses):
        m = orbit_pose(2.0 * np.pi * i / n_poses) @ tilt
        d = sphere_depth_world(cfg, m, radius=0.5)
        d = d + rng.normal(0.0, 0.0015, d.shape).astype(np.float32)
        d = np.where(rng.uniform(size=d.shape) < 0.05, np.nan, d)
        poses.append(m)
        depths.append(d.astype(np.float32))
    return np.stack(poses), np.stack(depths), rgb


def test_slice_orbit_fuse_mesh_ply(small_cfg, tmp_path):
    jcfg = small_cfg.with_updates(integrate_color=True, color_mode="RGB")
    cfg = TSDFConfig.from_json(jcfg.to_json())
    poses, depths, rgb = _orbit(jcfg)

    jv = jb.make_brick_volume(jcfg, 8, 1024)
    for p, d in zip(poses, depths):
        jv = jb.integrate_bricks(jv, jnp.asarray(d), jnp.asarray(p), jnp.asarray(rgb), 1024)
    tv = tb.integrate_bricks_sequence(tb.make_brick_volume(cfg, 8, 1024, device="cpu"),
                                      depths, poses, np.stack([rgb] * len(poses)), 1024)
    assert int(jv.n_active) > 100 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, "RGB")

    carried = brick_volume_from_arrays(cfg, jax_arrays(jv), device="cpu")
    sx = jmc.extract_soup_bricks(jv, 0.5, True, corner_engine="xla")
    n = int(sx.num_triangles)
    v, f, c = extract_mesh(carried, 0.5, color_by_rgb=True)
    assert len(f) == n > 500
    np.testing.assert_allclose(v, np.asarray(sx.vertices)[:n].reshape(-1, 3), atol=1e-6)
    np.testing.assert_array_equal(c, np.asarray(sx.colors)[:n].reshape(-1, 3))
    radius = np.linalg.norm(v, axis=1)
    assert np.median(np.abs(radius - 0.5)) < 0.5 * cfg.cell_size[0]

    path = str(tmp_path / "mesh.ply")
    save_ply(path, v, f, c)
    v2, f2, c2 = jax_load_ply(path)
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_array_equal(c2, c.astype(c2.dtype))
