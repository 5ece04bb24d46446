"""Port parity at brick sizes other than 8: fusion through the kernel
wrapper, the kernel route's extraction and a JAX checkpoint, against the
JAX package.

On CPU tensors the kernel wrappers (``fusion_kernel.fuse_bricks``,
``marching_cubes.corner_halo`` and ``emit_triangles``) run their plain
versions, so these tests hold the wrappers' shapes and layouts at every
brick size against the JAX package: its Pallas fusion kernel in interpret
mode, and its XLA marching-cubes route (the only one it has for B != 8).
The CUDA kernels against the same plain versions at these sizes are
tests/test_torch_kernels.py, on the card. Bricks of 6 run on a 48^3 grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.io import checkpoint as jckpt
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.geometry import rigid_inverse
from cpu_tsdf_tpu_torch.io import checkpoint as tckpt
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

from test_torch_bricks import POSES, _scene, assert_volumes_match
import torch_common  # noqa: F401  (one intra-op thread)

MIN_W = 0.5
# brick size -> grid resolution
GRIDS = {4: 64, 6: 48, 16: 64}


def _brick_scene(small_cfg, B, mode="RGB"):
    res = GRIDS[B]
    return _scene(small_cfg.with_updates(xres=res, yres=res, zres=res), mode)


def _capacity(B):
    """2048 rows of 8^3 scaled to the same voxels, and half of it a frame,
    at most 2048 rows (the scenes take at most 540 rows at B = 4; the
    Pallas kernel's interpret-mode compile grows with the budget)."""
    C = 2048 * 512 // B ** 3
    return C, min(C // 2, 2048)


def _fuse_through_kernel_wrapper(vol, depth, pose, rgb, budget):
    """integrate_bricks with the update going through fuse_brick_batch's
    kernel route (the wrapper of csrc/fusion.cu, which takes the plain
    engine on CPU tensors): the call the card makes at this brick size."""
    depth = torch.as_tensor(depth)
    pose = torch.as_tensor(pose)
    pose_inv = rigid_inverse(pose)
    bx, by, bz, ok, slots, overflow = tb.frame_update_list(vol, depth, pose_inv, budget, pose)
    tb.fuse_brick_batch(vol.config, vol.brick_size, bx, by, bz, ok, slots, vol.sdf,
                        vol.weight, vol.M, vol.nsample, vol.color, depth, pose_inv,
                        None if rgb is None else torch.as_tensor(rgb), use_kernel=True)
    vol.overflowed |= overflow
    return vol


def _jax_pallas(jcfg, B, depth, rgb, poses, jv=None):
    C, budget = _capacity(B)
    jv = jb.make_brick_volume(jcfg, B, C) if jv is None else jv
    for p in poses:
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                 jnp.asarray(rgb), budget, True, True)
    return jv


def _assert_mesh_matches(soup, jax_mesh):
    """The port keeps the JAX package's triangle order, so its vertex set
    equals JAX's triangle by triangle, within 1e-6 (a sort would pair
    triangles whose vertices tie within that tolerance in either order),
    and the colors exactly."""
    jverts, jfaces, jcols = jax_mesh
    assert soup.num_triangles == len(jfaces) > 300
    np.testing.assert_allclose(soup.vertices.numpy().reshape(-1, 3), jverts, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(soup.colors.numpy().reshape(-1, 3), jcols)


@pytest.mark.parametrize("B", sorted(GRIDS))
def test_fusion_kernel_route_matches_jax_pallas(small_cfg, B):
    """fuse_brick_batch(use_kernel=True) at bricks of 4, 6 and 16 with RGB
    color: the JAX Pallas kernel's volume (interpret mode), weight, nsample
    and color exact, sdf and M within 1e-5."""
    jcfg, cfg, depth, rgb = _brick_scene(small_cfg, B)
    C, budget = _capacity(B)
    tv = tb.make_brick_volume(cfg, B, C, device="cpu")
    for p in POSES:
        _fuse_through_kernel_wrapper(tv, depth, p.astype(np.float32), rgb, budget)
    jv = _jax_pallas(jcfg, B, depth, rgb, POSES)
    assert int(jv.n_active) > 10 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, "RGB")


@pytest.mark.parametrize("B", sorted(GRIDS))
def test_kernel_route_mesh_matches_jax(small_cfg, B):
    """integrate_bricks, then the extraction's kernel route (corner_halo and
    emit_triangles, their plain versions on the CPU) at bricks of 4, 6 and
    16: JAX extract_mesh's triangles (its XLA route), vertices within 1e-6,
    colors exact."""
    jcfg, cfg, depth, rgb = _brick_scene(small_cfg, B)
    C, budget = _capacity(B)
    tv = tb.make_brick_volume(cfg, B, C, device="cpu")
    jv = jb.make_brick_volume(jcfg, B, C)
    for p in POSES:
        p = p.astype(np.float32)
        tb.integrate_bricks(tv, depth, p, rgb, budget)
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p), jnp.asarray(rgb),
                                 budget)
    _assert_mesh_matches(tmc._extract(tv, MIN_W, True, False, True),
                         jmc.extract_mesh(jv, MIN_W, color_by_rgb=True))


def test_jax_checkpoint_of_4_cubed_bricks_fuses_on(small_cfg, tmp_path):
    """A volume of 4^3 bricks fused by the JAX package (its Pallas kernel,
    interpret mode) and written as npz loads with load_any, fuses one more
    frame through the kernel wrapper and meshes through the kernel route as
    the JAX package fuses and meshes that frame."""
    B = 4
    jcfg, cfg, depth, rgb = _brick_scene(small_cfg, B)
    C, budget = _capacity(B)
    jv = _jax_pallas(jcfg, B, depth, rgb, POSES[:2])
    path = str(tmp_path / "bricks4.npz")
    jckpt.save_checkpoint(path, jv)
    tv = tckpt.load_any(path, device="cpu")
    assert isinstance(tv, tb.BrickVolume) and tv.brick_size == B and tv.capacity == C
    _fuse_through_kernel_wrapper(tv, depth, POSES[2].astype(np.float32), rgb, budget)
    jv = _jax_pallas(jcfg, B, depth, rgb, POSES[2:], jv)
    assert_volumes_match(tv, jv, "RGB")
    _assert_mesh_matches(tmc._extract(tv, MIN_W, True, False, True),
                         jmc.extract_mesh(jv, MIN_W, color_by_rgb=True))


def test_mc_kernel_brick_limits():
    """The MC kernels' brick sizes: every even size passes the wrappers'
    check, odd ones and a capacity * B^3 past the int32 cube references are
    refused before any launch (the corner halo's shared-memory limit is the
    kernel's, checked on the card)."""
    for B in range(2, 120, 2):
        assert tmc.check_kernel_brick("t", B, 2048 * 512 // B ** 3 + 1) == B ** 3
    for B in (0, 3, 33):
        with pytest.raises(ValueError, match="even brick sizes"):
            tmc.check_kernel_brick("t", B, 16)
    assert tmc.check_kernel_brick("t", 32, (1 << 31) // 32 ** 3 - 1) == 32 ** 3
    with pytest.raises(ValueError, match="int32"):
        tmc.check_kernel_brick("t", 32, (1 << 31) // 32 ** 3)
