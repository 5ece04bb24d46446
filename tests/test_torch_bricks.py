"""Port parity: the brick volume (activation, allocation, the plain fusion
engine, color, overflow flags, conversion) against the JAX package.

The port is held against JAX ``integrate_bricks(use_pallas=False)`` — the
contract of both the Pallas kernel and the CUDA kernel — and once against
the Pallas kernel in interpret mode. The CUDA kernel against this plain
engine is tests/test_torch_kernels.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.synthetic import sphere_depth, sphere_rgb
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import (brick_volume_from_arrays,
                                        brick_volume_to_arrays)

from test_fusion import tilted_pose

POSES = (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88),
         tilted_pose(tx=-0.05, ty=0.01, tz=-0.95))
JAX_FIELDS = ("brick_map", "n_active", "coords", "sdf", "weight", "M",
              "nsample", "color", "global_transform", "overflowed")


def jax_arrays(bv):
    return {k: (None if getattr(bv, k) is None else np.asarray(getattr(bv, k)))
            for k in JAX_FIELDS}


def assert_volumes_match(port, jax_vol, mode):
    """Exact structure, weight and nsample; sdf and M within 1e-5; color
    exact for RGB, within 1e-4 for the float color modes."""
    a = brick_volume_to_arrays(port)
    j = jax_arrays(jax_vol)
    for k in ("brick_map", "coords", "n_active", "overflowed", "weight", "nsample"):
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    for k in ("sdf", "M"):
        np.testing.assert_allclose(a[k], j[k], atol=1e-5, err_msg=k)
    if mode is None:
        assert a["color"] is None
    elif mode == "RGB":
        np.testing.assert_array_equal(a["color"], j["color"])
    else:
        np.testing.assert_allclose(a["color"], j["color"], atol=1e-4)


def _scene(small_cfg, mode):
    jcfg = small_cfg if mode is None else small_cfg.with_updates(
        integrate_color=True, color_mode=mode)
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = (None if mode is None else np.random.default_rng(7).integers(
        0, 256, depth.shape + (3,)).astype(np.float32))
    return jcfg, TSDFConfig.from_json(jcfg.to_json()), depth, rgb


@pytest.mark.parametrize("mode", [None, "RGB", "RGBNormalized", "LAB"])
def test_integrate_bricks_matches_jax(small_cfg, mode):
    jcfg, cfg, depth, rgb = _scene(small_cfg, mode)
    jv = jb.make_brick_volume(jcfg, 8, 2048)
    tv = tb.make_brick_volume(cfg, 8, 2048, device="cpu")
    for p in POSES:
        p = p.astype(np.float32)
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p),
                                 None if rgb is None else jnp.asarray(rgb), 1024)
        out = tb.integrate_bricks(tv, depth, p, rgb, 1024)
        assert out is tv  # in place
    assert int(jv.n_active) > 50 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, mode)


@pytest.mark.parametrize("options", [
    {"weight_by_depth": True}, {"frustum_culling": False},
    {"weight_by_depth": True, "weight_by_variance": True}],
    ids=["weight_by_depth", "no_frustum_culling", "weight_by_variance"])
def test_fusion_options_match_jax(small_cfg, options):
    """The plain engine's option branches against JAX. The variance gate
    needs more than 5 samples, so 7 frames with per-frame depth noise (which
    keeps M > 0 inside the band); its exp amplifies rounding, and the
    tolerance is the one the JAX package holds its own two engines to there
    (tests/test_pallas_fusion.py::test_pallas_weighting_options).

    Voxels clamped to +max_dist_pos in every frame keep M == 0, so their
    gate is exp(-0/0): NaN in the port, as in the C++ reference, while
    XLA's CPU exp turns a NaN argument into a finite value. The port's NaNs
    must lie on such voxels only; everything else is compared."""
    jcfg, cfg, depth, _ = _scene(small_cfg.with_updates(**options), None)
    rng = np.random.default_rng(3)
    variance = options.get("weight_by_variance", False)
    frames = ([(depth + rng.normal(0, 0.002, depth.shape)).astype(np.float32)
               for _ in range(7)] if variance else [depth] * 3)
    poses = [POSES[0]] * 7 if variance else POSES
    jv = jb.make_brick_volume(jcfg, 8, 2048)
    tv = tb.make_brick_volume(cfg, 8, 2048, device="cpu")
    for d, p in zip(frames, poses):
        p = p.astype(np.float32)
        jv = jb.integrate_bricks(jv, jnp.asarray(d), jnp.asarray(p), None, 1024)
        tb.integrate_bricks(tv, d, p, None, 1024)
    assert int(jv.n_active) > 50 and not bool(jv.overflowed)
    if not variance:
        assert_volumes_match(tv, jv, None)
        return
    a, j = brick_volume_to_arrays(tv), jax_arrays(jv)
    assert int((j["nsample"] > 6).sum()) > 500  # the gate ran
    for k in ("brick_map", "coords", "n_active", "nsample"):
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    knife = np.isnan(a["weight"])
    assert not (knife & ~((j["nsample"] > 6) & (j["M"] == 0) & (j["sdf"] == 1))).any()
    for k in ("sdf", "weight"):
        np.testing.assert_allclose(a[k][~knife], j[k][~knife], atol=1e-3, err_msg=k)


def test_one_frame_matches_jax_pallas_interpret(small_cfg):
    """Against the Pallas kernel itself (interpret mode, small budget: the
    interpreter runs the grid serially)."""
    jcfg, cfg, depth, _ = _scene(small_cfg, None)
    pose = POSES[0].astype(np.float32)
    jv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, 2048), jnp.asarray(depth),
                             jnp.asarray(pose), None, 512, True, True)
    tv = tb.integrate_bricks(tb.make_brick_volume(cfg, 8, 2048, device="cpu"),
                             depth, pose, None, 512)
    assert_volumes_match(tv, jv, None)


@pytest.mark.parametrize("capacity,budget", [(8, 1024), (2048, 4)])
def test_overflow_flags_match_jax(small_cfg, capacity, budget):
    jcfg, cfg, depth, _ = _scene(small_cfg, None)
    pose = POSES[0].astype(np.float32)
    jv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, capacity),
                             jnp.asarray(depth), jnp.asarray(pose), None, budget)
    tv = tb.integrate_bricks(tb.make_brick_volume(cfg, 8, capacity, device="cpu"),
                             depth, pose, None, budget)
    assert bool(tv.overflowed) and bool(jv.overflowed)
    assert_volumes_match(tv, jv, None)


def test_sequence_equals_per_frame(small_cfg):
    jcfg, cfg, depth, _ = _scene(small_cfg, "RGB")
    rgb = sphere_rgb(jcfg, depth)
    poses = np.stack(POSES).astype(np.float32)
    ref = tb.make_brick_volume(cfg, 8, 256, device="cpu")
    for p in poses:
        tb.integrate_bricks(ref, depth, p, rgb, 1024)
    seq = tb.integrate_bricks_sequence(
        tb.make_brick_volume(cfg, 8, 256, device="cpu"), np.stack([depth] * 3),
        poses, np.stack([rgb] * 3), 1024)
    for k in JAX_FIELDS:
        a, b = getattr(ref, k), getattr(seq, k)
        assert torch.equal(a, b), k


def test_convert_roundtrip_and_dense(small_cfg):
    """A JAX volume crosses into the port and back bit for bit; to_dense and
    from_dense agree with the JAX package's."""
    jcfg, cfg, depth, rgb = _scene(small_cfg, "RGBNormalized")
    jv = jb.make_brick_volume(jcfg, 8, 1024)
    for p in POSES[:2]:
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                 jnp.asarray(rgb), 1024)
    j = jax_arrays(jv)
    tv = brick_volume_from_arrays(cfg, j, device="cpu")
    back = brick_volume_to_arrays(tv)
    for k in JAX_FIELDS:
        assert back[k].dtype == j[k].dtype and back[k].shape == j[k].shape, k
        np.testing.assert_array_equal(back[k], j[k], err_msg=k)
    jd, td = jb.to_dense(jv), tb.to_dense(tv)
    for k in ("sdf", "weight", "M", "nsample", "color"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)))
    jf, tf = jb.from_dense(jd), tb.from_dense(td)
    a = brick_volume_to_arrays(tf)
    for k in ("brick_map", "coords", "n_active", "sdf", "weight", "color"):
        np.testing.assert_array_equal(a[k], np.asarray(getattr(jf, k)), err_msg=k)


def test_entry_points_refuse_what_is_not_ported(small_cfg):
    jcfg, cfg, depth, _ = _scene(small_cfg, None)
    tv = tb.make_brick_volume(cfg, 8, 256, device="cpu")
    with pytest.raises(ValueError):
        tb.integrate_bricks(tv, depth, POSES[0], use_kernel=True)
    split = tb.make_brick_volume(cfg.with_updates(num_random_splits=3), 8, 256,
                                 device="cpu")
    with pytest.raises(NotImplementedError):
        tb.integrate_bricks(split, depth, POSES[0])

