"""Port parity: the brick volume (activation, allocation, the plain fusion
engine, color, overflow flags, conversion) against the JAX package.

The port is held against JAX ``integrate_bricks(use_pallas=False)`` — the
contract of both the Pallas kernel and the CUDA kernel — and once against
the Pallas kernel in interpret mode. The CUDA kernel against this plain
engine is tests/test_torch_kernels.py, on the card.
"""

import jax
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
from cpu_tsdf_tpu_torch.geometry import rigid_inverse
from cpu_tsdf_tpu_torch.ops import color as color_ops
from cpu_tsdf_tpu_torch.ops import fusion as tf
from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk

from test_fusion import tilted_pose
import torch_common  # noqa: F401  (one intra-op thread)

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


def _fuse_then_color(cfg, rows, pose_inv, depth, state, color, rgb):
    """The color update as two steps, as it ran before it moved into the
    fusion engine: the engine fuses the state and gives its per-row
    observations (r, g, b, effective weight or -1, pre-update weight); the
    color transform then runs over those rows."""
    C = state[0].shape[0]
    slot_ok = rows[:, 3] >= 0
    dst = torch.where(slot_ok, rows[:, 3], C - 1).long()
    (vx, vy, vz), (cx, cy, cz) = fk._voxel_centers(cfg, rows, 8)
    d0, w0, M0, n0 = (t[dst] for t in state)
    d_obs, w_obs, valid, _, u, v = tf.compute_observation(cfg, depth, pose_inv, cx, cy, cz)
    if cfg.frustum_culling:
        valid = valid & tf.coarse_cell_frustum(cfg, pose_inv, vx, vy, vz)
    valid = valid & slot_ok[:, None]
    w_eff = tf.variance_weight(cfg, w_obs, d_obs, d0, w0, M0, n0)
    fk.fuse_bricks_plain(cfg, rows, pose_inv, depth, *state)
    zero = torch.zeros_like(w_eff)
    obs = [torch.where(valid, tf.gather_image(rgb[..., c], v, u), zero) for c in range(3)]
    weff = torch.where(valid, w_eff, zero - 1.0)
    c0 = color[dst]
    cvalid = slot_ok[:, None] & (weff >= 0)
    cu = color_ops.update_color(cfg.color_mode, c0, w0, *obs, torch.clamp(weff, min=0.0))
    color.index_copy_(0, dst, torch.where(cvalid[..., None], cu, c0))


@pytest.mark.parametrize("mode", ["RGB", "RGBNormalized", "LAB"])
def test_color_fused_in_engine(small_cfg, mode):
    """fuse_bricks_plain updates the color rows in place, equal bit for bit
    to the former two steps (the engine's observations, then update_color
    over the frame's rows); integrate_bricks through it still matches the
    JAX package's colored brick fusion."""
    jcfg, cfg, depth, rgb = _scene(small_cfg, mode)
    jv = jb.make_brick_volume(jcfg, 8, 2048)
    tv = tb.make_brick_volume(cfg, 8, 2048, device="cpu")
    for p in POSES[:2]:
        p = p.astype(np.float32)
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p), jnp.asarray(rgb), 1024)
        tb.integrate_bricks(tv, depth, p, rgb, 1024)
    assert_volumes_match(tv, jv, mode)

    depth_t = torch.as_tensor(depth)
    pose_inv = rigid_inverse(torch.as_tensor(POSES[2], dtype=torch.float32))
    bx, by, bz, ok, slots, _ = tb.frame_update_list(tv, depth_t, pose_inv, 1024)
    rows = torch.stack([bx, by, bz, torch.where(ok, slots, -1)], 1).to(torch.int32)
    rgb_t = torch.trunc(torch.as_tensor(rgb))
    fields = (tv.sdf, tv.weight, tv.M, tv.nsample, tv.color)
    one = [t.clone() for t in fields]
    two = [t.clone() for t in fields]
    fk.fuse_bricks_plain(cfg, rows, pose_inv, depth_t, *one, rgb_t)
    _fuse_then_color(cfg, rows, pose_inv, depth_t, two[:4], two[4], rgb_t)
    assert int(ok.sum()) > 50
    assert not torch.equal(one[4], tv.color)  # the frame changed colors
    for name, a, b in zip(("sdf", "weight", "M", "nsample", "color"), one, two):
        assert torch.equal(a.isnan(), b.isnan()), name
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), name


def test_one_frame_matches_jax_pallas_interpret(small_cfg):
    """Against the Pallas kernel itself (interpret mode, small budget: the
    interpreter runs the grid serially; the frame's 132 bricks fit in 256
    rows, which give the volume of 512 bit for bit in less time)."""
    jcfg, cfg, depth, _ = _scene(small_cfg, None)
    pose = POSES[0].astype(np.float32)
    jv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, 2048), jnp.asarray(depth),
                             jnp.asarray(pose), None, 256, True, True)
    tv = tb.integrate_bricks(tb.make_brick_volume(cfg, 8, 2048, device="cpu"),
                             depth, pose, None, 256)
    assert int(jv.n_active) > 100 and not bool(jv.overflowed)
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


def _jax_draws(H, W, n_extra, generator):
    """The JAX package's per-frame jitter draws (PRNGKey(0), split as its
    _jitter_split_bricks splits it), in the port's draw_split_noise form."""
    return _jax_key_draws(jax.random.PRNGKey(0), H, W, n_extra)


def _jax_key_draws(key, H, W, n_extra):
    """The jitter draws _jitter_split_bricks takes from `key`."""
    out = []
    for _ in range(n_extra):
        key, k1, k2 = jax.random.split(key, 3)
        out.append((torch.as_tensor(np.array(jax.random.uniform(k1, (H, W)) * 0.03)),
                    torch.as_tensor(np.array(jax.random.normal(k2, (H, W, 3))))))
    return out


@pytest.mark.parametrize("mode", [None, "RGB"])
def test_random_splits_match_jax(small_cfg, monkeypatch, mode):
    """integrate_bricks with num_random_splits=3, the jittered pre-split
    fed the JAX package's own random draws, gives the JAX volume (fusion
    tolerances)."""
    jcfg, cfg, depth, rgb = _scene(small_cfg.with_updates(num_random_splits=3), mode)
    monkeypatch.setattr(tb, "draw_split_noise", _jax_draws)
    jv = jb.make_brick_volume(jcfg, 8, 2048)
    tv = tb.make_brick_volume(cfg, 8, 2048, device="cpu")
    for p in POSES:
        p = p.astype(np.float32)
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p),
                                 None if rgb is None else jnp.asarray(rgb), 1024)
        tb.integrate_bricks(tv, depth, p, rgb, 1024)
    assert int(jv.n_active) > 50 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, mode)


def test_sequence_random_splits_match_jax(small_cfg, monkeypatch):
    """integrate_bricks_sequence with num_random_splits=3 and no generator
    draws other jitter in every frame: one generator seeded 0 serves the
    sequence. The JAX sequence splits PRNGKey(0) into one key a frame; the
    port's draw_split_noise is fed frame k's draws when its generator is at
    its k-th draw since the seed, so the two sequences give one volume. The
    scene is fine enough (3 mm voxels, 4^3 bricks, 4 mm truncation) that the
    jitter's up to 3 cm moves allocate bricks the band does not."""
    jcfg = small_cfg.with_updates(
        xsize=0.192, ysize=0.192, zsize=0.192, max_dist_pos=0.004, max_dist_neg=0.004,
        min_sensor_dist=0.05, max_cell_size_x=0.048, max_cell_size_y=0.048,
        max_cell_size_z=0.048, num_random_splits=3)
    cfg = TSDFConfig.from_json(jcfg.to_json())
    depth = sphere_depth(jcfg, center=(-0.002, -0.003, 0.16), radius=0.06)
    poses = np.stack([tilted_pose(tx=0.002, ty=0.003, tz=-0.16),
                      tilted_pose(tx=0.009, ty=0.006, tz=-0.155),
                      tilted_pose(tx=-0.007, ty=0.001, tz=-0.165)]).astype(np.float32)
    n = len(poses)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    probe = torch.Generator().manual_seed(0)
    marks = [int(torch.randint(1 << 30, (1,), generator=probe)) for _ in range(n)]

    def draws(H, W, n_extra, generator):
        k = marks.index(int(torch.randint(1 << 30, (1,), generator=generator)))
        return _jax_key_draws(keys[k], H, W, n_extra)

    monkeypatch.setattr(tb, "draw_split_noise", draws)
    jv = jb.integrate_bricks_sequence(jb.make_brick_volume(jcfg, 4, 4096),
                                      jnp.asarray(np.stack([depth] * n)),
                                      jnp.asarray(poses), None, 1024)
    tv = tb.integrate_bricks_sequence(tb.make_brick_volume(cfg, 4, 4096, device="cpu"),
                                      np.stack([depth] * n), poses, None, 1024)
    assert int(jv.n_active) > 500 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, None)
    # the same draws in every frame (the former default) allocate other bricks
    same = tb.make_brick_volume(cfg, 4, 4096, device="cpu")
    for p in poses:
        tb.integrate_bricks(same, depth, p, None, 1024,
                            split_generator=torch.Generator().manual_seed(0))
    assert not torch.equal(same.brick_map, tv.brick_map)


@pytest.mark.parametrize("budget", [1024, 16])
def test_jitter_split_bricks_match_jax(small_cfg, budget):
    """The jittered bricks alone (an empty band list) on the same draws:
    the same list, count and overflow flag as the JAX package's; unioned
    with a band list, the same ascending list."""
    jcfg, cfg, depth, _ = _scene(small_cfg.with_updates(num_random_splits=3), None)
    nb = (8, 8, 8)
    H, W = depth.shape
    pose = POSES[1].astype(np.float32)
    noise = _jax_draws(H, W, 2, None)
    band = np.full(1024, -1, np.int32)
    band[:5] = (400, 3, 77, 12, 5)
    for bids in (np.full(1024, -1, np.int32), band):
        j = jb._jitter_split_bricks(jcfg, nb, jnp.asarray(depth), jnp.asarray(pose),
                                    jnp.asarray(bids), budget, jax.random.PRNGKey(0))
        t = tb._jitter_split_bricks(cfg, nb, torch.as_tensor(depth), torch.as_tensor(pose),
                                    torch.as_tensor(bids), budget, noise)
        assert int(t[1]) == int(j[1]) > 20 and bool(t[2]) == bool(j[2]) == (budget == 16)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))


def test_random_splits_own_generator(small_cfg):
    """The port's own draws: a generator seeded 0 on the volume's device by
    default, the same jitter each time; another generator, other jitter.
    frame_update_list needs the pose for the jitter."""
    _, cfg, depth, _ = _scene(small_cfg.with_updates(num_random_splits=3), None)
    depth_t = torch.as_tensor(depth)
    pose = torch.as_tensor(POSES[1], dtype=torch.float32)
    empty = torch.full((1024,), -1, dtype=torch.int32)

    def jittered(gen):
        noise = tb.draw_split_noise(*depth.shape, 2, gen)
        assert noise[0][0].shape == depth.shape and noise[0][1].shape == depth.shape + (3,)
        assert float(noise[0][0].min()) >= 0.0 and float(noise[0][0].max()) < 0.03
        return tb._jitter_split_bricks(cfg, (8, 8, 8), depth_t, pose, empty, 1024, noise)[0]

    a, b = (jittered(torch.Generator().manual_seed(0)) for _ in range(2))
    c = jittered(torch.Generator().manual_seed(123))
    assert torch.equal(a, b) and not torch.equal(a, c)
    vols = [tb.make_brick_volume(cfg, 8, 2048, device="cpu") for _ in range(2)]
    for v in vols:
        tb.integrate_bricks(v, depth, pose, None, 1024)
    assert torch.equal(vols[0].brick_map, vols[1].brick_map)
    assert torch.equal(vols[0].weight, vols[1].weight)
    with pytest.raises(ValueError):
        tb.frame_update_list(vols[0], depth_t, torch.eye(4), 1024)
