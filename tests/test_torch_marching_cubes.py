"""Port parity: brick marching cubes and its two kernels' plain versions
against the JAX package.

pack-left and the corner-halo stacks are held EXACTLY against the Pallas
kernels in interpret mode; the extracted mesh (from the same volume state,
carried across with ``convert``) against the JAX XLA route: the same
triangles in the same order, vertices within 1e-6. The CUDA kernels against
these plain versions are tests/test_torch_kernels.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch import make_volume
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays

MIN_W = 0.5


@pytest.fixture(scope="module")
def volumes():
    """A two-frame colored JAX brick volume and its port copy (CPU)."""
    jcfg = J.TSDFConfig(
        xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
        max_sensor_dist=3.0, image_width=40, image_height=30,
        focal_length_x=35.0, focal_length_y=35.0, principal_point_x=20.0,
        principal_point_y=15.0, max_cell_size_x=0.4, max_cell_size_y=0.4,
        max_cell_size_z=0.4, integrate_color=True, color_mode="LAB")
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = np.random.default_rng(5).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    jv = jb.make_brick_volume(jcfg, 8, 1024)
    for p in (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88)):
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                 jnp.asarray(rgb), 1024)
    tv = brick_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()),
                                  jax_arrays(jv), device="cpu")
    return jv, tv


def test_pack_left_plain_matches_pallas():
    rng = np.random.default_rng(11)
    for density in (0.0, 0.03, 0.5, 1.0):
        mask = (rng.uniform(size=(70, 512)) < density).astype(np.int32)
        jloc = np.asarray(jmc._pack_left_rows(jnp.asarray(mask), True))
        tloc = tmc.pack_left_rows(torch.from_numpy(mask))
        np.testing.assert_array_equal(tloc.numpy(), jloc)


def test_corner_stacks_plain_match_pallas(volumes):
    jv, tv = volumes
    cand = tmc._candidate_slots(tv, MIN_W)
    assert 10 < cand.shape[0] < 128
    C = tv.capacity
    slots = np.full(128, C, np.int32)  # the Pallas grid wants 64-brick blocks
    slots[:cand.shape[0]] = cand.numpy()
    jd, jok, jloc, _, _ = jmc._corner_stacks_pallas(jv, jnp.asarray(slots), MIN_W, True)
    td, tok, tloc = tmc.corner_halo(tv, torch.from_numpy(slots), MIN_W)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tok.sum() > 100
    # and the JAX package's own XLA stacks agree with both
    xd, xok, _, _ = jmc._corner_stacks(jv, jnp.asarray(slots), MIN_W)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(xok))


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("coloring", ["none", "rgb", "confidence"])
def test_extract_mesh_matches_jax(volumes, kernel_route, coloring):
    """Both routes (plain; and the kernel route's glue, with the kernels'
    plain versions standing in on the CPU) give the JAX triangles in the
    JAX order."""
    jv, tv = volumes
    rgb, conf = coloring == "rgb", coloring == "confidence"
    sx = jmc.extract_soup_bricks(jv, MIN_W, rgb, conf, corner_engine="xla")
    n = int(sx.num_triangles)
    assert n > 100
    st = tmc._extract(tv, MIN_W, rgb, conf, kernel_route)
    assert st.num_triangles == n
    np.testing.assert_allclose(st.vertices.numpy(), np.asarray(sx.vertices)[:n], atol=1e-6)
    if coloring == "none":
        assert st.colors is None
    else:
        np.testing.assert_allclose(st.colors.numpy(), np.asarray(sx.colors)[:n], atol=1e-4)
    if conf:
        v, f, c = tmc.extract_mesh(tv, MIN_W, color_by_confidence=True)
        assert len(c) == len(v) == 3 * len(f)
        assert (c[:, 2] > 200).all()  # w <= 2 -> mostly blue


def test_dense_extract_mesh_not_ported(small_cfg):
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    with pytest.raises(NotImplementedError):
        tmc.extract_mesh(make_volume(cfg, device="cpu"))

