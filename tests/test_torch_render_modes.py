"""Port parity for the render's and the mesh's other modes, on the CPU, on
the scene of tests/test_torch_render.py (128^3, 64x48, one tilted view):

* the nearest-voxel render (``use_trilinear_interpolation=False``) against
  the JAX package's render_view. Both packages refine a few pixels of this
  scene to depths up to ~4.6e17 m (the refinement divides by the difference
  of two nearest-voxel samples, which can be near zero: a property of the
  reference) and agree on them only relatively, so the gate is the render
  test's median depth error, not the maximum;
* colored renders and ``extract_mesh(color_by_rgb=True)`` of volumes fused
  in RGBNormalized and in LAB: RGBNormalized colors exact, LAB within 1
  (under jit, XLA:CPU contracts the multiply-adds of the JAX package's
  lab_to_rgb into FMAs, which moves a color truncated to 8 bits by 1 now
  and then; the port evaluates op by op).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu import render_view as jax_render_view
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch import render_view
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
from test_torch_render import _scene
import torch_common  # noqa: F401  (one intra-op thread)


def test_nearest_mode_render_matches_jax():
    jbv, tbv, pose, _ = _scene(colored=False)
    jbv = dataclasses.replace(jbv, config=jbv.config.with_updates(
        use_trilinear_interpolation=False))
    tbv = dataclasses.replace(tbv, config=tbv.config.with_updates(
        use_trilinear_interpolation=False))
    dj = np.asarray(jax_render_view(jbv, pose).depth)
    dt = render_view(tbv, pose).depth.numpy()
    vj, vt = ~np.isnan(dj), ~np.isnan(dt)
    both = vj & vt
    err = np.abs(dj[both] - dt[both])
    print(f"nearest: {vj.sum()} valid, validity agreement {(vj == vt).mean():.6f}, depth "
          f"error median {np.median(err):.3g}, largest depth {dt[vt].max():.3g}")
    assert vj.sum() > 800
    assert (vj == vt).mean() > 0.97
    assert np.median(err) < 1e-4


def _colored_scene(mode):
    """The scene fused in `mode` from a varied color image."""
    from conftest import TSDFConfig as JaxConfig

    jcfg = JaxConfig(
        xres=128, yres=128, zres=128, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=0.04, max_dist_neg=0.04, min_sensor_dist=0.1, max_sensor_dist=3.0,
        image_width=64, image_height=48, focal_length_x=56.0, focal_length_y=56.0,
        principal_point_x=32.0, principal_point_y=24.0,
        max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4,
        integrate_color=True, color_mode=mode)
    pose = tilted_pose()
    depth = np.asarray(sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3))
    rgb = np.random.default_rng(9).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    jbv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, 2048), jnp.asarray(depth),
                              jnp.asarray(pose, jnp.float32), jnp.asarray(rgb))
    tbv = brick_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()), jax_arrays(jbv),
                                   device="cpu")
    return jbv, tbv, pose


@pytest.mark.parametrize("mode,atol", [("RGBNormalized", 0), ("LAB", 1)])
def test_colored_render_and_mesh_match_jax(mode, atol):
    jbv, tbv, pose = _colored_scene(mode)
    cj = np.asarray(jax_render_view(jbv, pose, colored=True).rgb)
    ct = render_view(tbv, pose, colored=True).rgb.numpy()
    both = ~np.isnan(cj[..., 0]) & ~np.isnan(ct[..., 0])
    assert both.sum() > 800 and (np.isnan(cj[..., 0]) == np.isnan(ct[..., 0])).mean() > 0.97
    diff = np.abs(ct[both] - cj[both])
    sx = jmc.extract_soup_bricks(jbv, 0.5, True, False, corner_engine="xla")
    n = int(sx.num_triangles)
    _, faces, colors = tmc.extract_mesh(tbv, 0.5, color_by_rgb=True)
    mdiff = np.abs(colors.astype(np.float64) - np.asarray(sx.colors)[:3 * n].reshape(-1, 3))
    print(f"{mode}: render colors differ in {(diff > 0).sum()} of {diff.size} entries, "
          f"mesh colors in {(mdiff > 0).sum()} of {mdiff.size}")
    assert len(faces) == n > 100
    assert diff.max() <= atol and mdiff.max() <= atol
