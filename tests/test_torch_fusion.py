"""Port parity: dense projective fusion (the semantic reference of every
fusion engine) against the JAX package, with and without color, and its
gradient with respect to depth and pose; and the plain versions of the
dense kernel's column cull and of its bound's candidate count.

Tolerances are the JAX package's own between its engines: sdf and M within
1e-5, weight and nsample exact, color exact for RGB and within 1e-4 for the
float color modes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu.synthetic import plane_depth, sphere_depth
from cpu_tsdf_tpu_torch import TSDFConfig, integrate, make_volume
from cpu_tsdf_tpu_torch.convert import tsdf_volume_from_arrays, tsdf_volume_to_arrays
from test_fusion import tilted_pose
from torch_common import CULL_CASES, CULL_CFG, cull_frame

POSES = (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88))


@pytest.mark.parametrize("mode", [None, "RGB", "RGBNormalized", "LAB"])
def test_dense_integrate_matches_jax(small_cfg, mode):
    jcfg = small_cfg if mode is None else small_cfg.with_updates(
        integrate_color=True, color_mode=mode)
    cfg = TSDFConfig.from_json(jcfg.to_json())
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = (None if mode is None else np.random.default_rng(7).integers(
        0, 256, depth.shape + (3,)).astype(np.float32))
    jv = J.make_volume(jcfg)
    tv = make_volume(cfg, device="cpu")
    for p in POSES:
        p = p.astype(np.float32)
        jv = J.integrate(jv, jnp.asarray(depth), jnp.asarray(p),
                         None if rgb is None else jnp.asarray(rgb))
        tv = integrate(tv, torch.from_numpy(depth), torch.from_numpy(p),
                       None if rgb is None else torch.from_numpy(rgb))
    w = np.asarray(jv.weight)
    assert (w > 0).sum() > 1000
    np.testing.assert_array_equal(tv.weight.numpy(), w)
    np.testing.assert_array_equal(tv.nsample.numpy(), np.asarray(jv.nsample))
    np.testing.assert_allclose(tv.sdf.numpy(), np.asarray(jv.sdf), atol=1e-5)
    np.testing.assert_allclose(tv.M.numpy(), np.asarray(jv.M), atol=1e-5)
    # the JAX volume crosses into the port and back bit for bit
    j = {k: None if getattr(jv, k) is None else np.asarray(getattr(jv, k))
         for k in ("sdf", "weight", "M", "nsample", "color", "global_transform")}
    back = tsdf_volume_to_arrays(tsdf_volume_from_arrays(cfg, j, device="cpu"))
    for k, a in j.items():
        if a is None:
            assert back[k] is None
        else:
            assert back[k].dtype == a.dtype
            np.testing.assert_array_equal(back[k], a)
    if mode is None:
        assert tv.color is None
    elif mode == "RGB":
        np.testing.assert_array_equal(tv.color.numpy(), np.asarray(jv.color))
    else:
        np.testing.assert_allclose(tv.color.numpy(), np.asarray(jv.color), atol=1e-4)


def test_dense_integrate_gradient_matches_jax(small_cfg):
    """On a scene with no missing pixel, d(sum sdf)/d(depth) is finite and
    equal to jax.grad's; d/d(pose) is finite and close."""
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    depth = plane_depth(small_cfg, z0=0.95)
    pose = tilted_pose().astype(np.float32)

    def jloss(d, p):
        return jnp.sum(J.integrate(J.make_volume(small_cfg), d, p).sdf)

    jgd, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(pose))
    d = torch.from_numpy(depth).requires_grad_()
    p = torch.from_numpy(pose).requires_grad_()
    vol = make_volume(cfg, device="cpu")
    before = {k: getattr(vol, k).clone() for k in ("sdf", "weight", "M", "nsample")}
    loss = integrate(vol, d, p).sdf.sum()
    gd, gp = torch.autograd.grad(loss, (d, p))
    # under autograd the donated volume is left as it was
    for k, t in before.items():
        assert torch.equal(getattr(vol, k), t), k
    assert torch.isfinite(gd).all() and torch.isfinite(gp).all()
    assert np.abs(np.asarray(jgd)).sum() > 0
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-3, atol=1e-2)


def test_dense_weighting_matches_jax(small_cfg):
    """Depth and variance weighting through the dense integrate (the route
    of integrate_slab's autograd Function) against the JAX package at 48^3:
    8 noisy frames of nearby poses, so the variance gate (above 5 samples)
    runs, then d(sum sdf)/d(depth) of one more frame fused into the JAX
    volume's state against jax.grad.
    max_dist_pos is 2 m, so no voxel is clamped to it in every frame: such
    a voxel keeps M == 0 and a gate of exp(-0/0), NaN in the port (as in
    the reference) and finite in XLA's CPU exp
    (test_torch_bricks.py::test_fusion_options_match_jax). The gate's exp
    amplifies rounding: the tolerance there is the one the JAX package
    holds its own two engines to (tests/test_pallas_fusion.py::
    test_pallas_weighting_options), 1e-3, here also relative, since 8
    weighted frames take the weights to ~6; nsample exact."""
    jcfg = small_cfg.with_updates(xres=48, yres=48, zres=48, max_dist_pos=2.0,
                                  weight_by_depth=True, weight_by_variance=True)
    cfg = TSDFConfig.from_json(jcfg.to_json())
    rng = np.random.default_rng(3)
    base = plane_depth(jcfg, z0=0.95)
    jv, tv = J.make_volume(jcfg), make_volume(cfg, device="cpu")
    for i in range(8):
        depth = (base + rng.normal(0.0, 0.004, base.shape)).astype(np.float32)
        p = tilted_pose(tx=0.013 + 0.002 * i).astype(np.float32)
        jv = J.integrate(jv, jnp.asarray(depth), jnp.asarray(p))
        tv = integrate(tv, torch.from_numpy(depth), torch.from_numpy(p))
    assert (np.asarray(jv.nsample) > 6).sum() > 1000
    np.testing.assert_array_equal(tv.nsample.numpy(), np.asarray(jv.nsample))
    for name in ("sdf", "weight", "M"):
        np.testing.assert_allclose(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)

    # from the JAX volume's state, so that only this frame's arithmetic
    # differs (J.integrate donates jv: its arrays are copied out first)
    tj = tsdf_volume_from_arrays(cfg, {k: np.asarray(getattr(jv, k)) for k in (
        "sdf", "weight", "M", "nsample", "global_transform")} | {"color": None}, device="cpu")
    pose = tilted_pose().astype(np.float32)
    jgd = jax.grad(lambda d: jnp.sum(J.integrate(jv, d, jnp.asarray(pose)).sdf))(
        jnp.asarray(base))
    d = torch.from_numpy(base).requires_grad_()
    (gd,) = torch.autograd.grad(integrate(tj, d, torch.from_numpy(pose)).sdf.sum(), d)
    assert torch.isfinite(gd).all() and np.abs(np.asarray(jgd)).sum() > 0
    # within 1e-4 of the largest entry (~30): a pixel's gradient sums some
    # 40 voxels' terms, each through the gate's exp of a 1/var-scaled square
    assert np.abs(gd.numpy() - np.asarray(jgd)).max() <= 1e-4 * np.abs(np.asarray(jgd)).max()


def test_dense_use_kernel_switch_on_the_cpu(small_cfg):
    """use_kernel=True raises on CPU tensors (the kernel runs only on the
    card); False and None take the plain version, bit for bit, and the
    slab route on planes [16, 40) gives the whole grid's planes."""
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab, integrate_slab_plain

    cfg = TSDFConfig.from_json(small_cfg.to_json())
    depth = torch.from_numpy(sphere_depth(small_cfg, center=(-0.013, -0.021, 0.9), radius=0.3))
    pose = torch.from_numpy(tilted_pose().astype(np.float32))
    vol = make_volume(cfg, device="cpu")
    with pytest.raises(ValueError):
        integrate(vol, depth, pose, use_kernel=True)
    a, b = integrate(vol, depth, pose), integrate(vol, depth, pose, use_kernel=False)
    c = integrate_slab_plain(vol, depth, pose)
    for name in ("sdf", "weight", "M", "nsample"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert torch.equal(getattr(a, name), getattr(c, name))
    slab = dataclasses.replace(vol, **{k: getattr(vol, k)[16:40].clone()
                                       for k in ("sdf", "weight", "M", "nsample")})
    s = integrate_slab(slab, depth, pose, x0=16)
    for name in ("sdf", "weight", "M", "nsample"):
        assert torch.equal(getattr(s, name), getattr(a, name)[16:40])
    assert int((a.weight > 0).sum()) > 1000


def _observed_and_intervals(case):
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab_plain

    cfg, pose, depth, x0, nx = cull_frame(case)
    depth, pose = torch.from_numpy(depth), torch.from_numpy(pose)
    vol = make_volume(cfg, device="cpu")
    slab = dataclasses.replace(vol, **{k: getattr(vol, k)[x0:x0 + nx].clone()
                                       for k in ("sdf", "weight", "M", "nsample")})
    observed = integrate_slab_plain(slab, depth, pose, None, x0).nsample > 0
    pose_inv = rigid_inverse(pose)
    lo, hi = fk.dense_column_intervals(cfg, pose_inv, depth, x0, nx)
    # fuse_dense hands out the same intervals on the CPU
    iv = torch.empty((nx * cfg.yres, 2), dtype=torch.int32)
    fk.fuse_dense(slab, depth, pose, None, x0, intervals=iv)
    assert torch.equal(iv.long(), torch.stack([lo.reshape(-1), hi.reshape(-1)], 1))
    z = torch.arange(cfg.zres)
    inside = (z >= lo[..., None]) & (z <= hi[..., None])
    return observed, inside, fk.dense_candidates(cfg, pose_inv, depth, x0, nx), pose_inv, depth


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_dense_column_intervals_hold_every_observed_voxel(case):
    """The plain version of the dense kernel's column cull
    (fusion_kernel.dense_column_intervals, also what fuse_dense's
    `intervals` receives on the CPU) holds every voxel that
    integrate_slab_plain observes, and every candidate of the kernel's
    bound (fusion_kernel.dense_candidates), while culling at least half
    of the grid; an all-NaN frame empties every column, and a +inf reading
    (which observes every voxel in front of it) lifts the far limit."""
    observed, inside, n_cand, _, _ = _observed_and_intervals(case)
    n_obs, n_in = int(observed.sum()), int(inside.sum())
    assert not (observed & ~inside).any()
    assert n_obs <= int(n_cand) <= n_in
    if case == "all_nan":
        assert n_in == 0
    else:
        assert n_obs > 50
        assert n_in < observed.numel() // 2
    if case == "inf_reading":
        n_finite = int(_observed_and_intervals("tilted")[1].sum())
        assert n_in > n_finite


def test_dense_candidate_count():
    """fusion_kernel.dense_candidates (the voxels the dense kernel's bound
    counts as projected and tested) from a fixed pose against a numpy
    recount in float32: inside the pinhole frustum, within the sensor range,
    camera z at most the deepest reading plus max_dist_neg."""
    cfg = CULL_CFG
    _, inside, n_cand, pose_inv, depth = _observed_and_intervals("tilted")
    m = pose_inv.numpy()
    f = np.float32
    idx = np.arange(48, dtype=f)
    c = [(idx + f(0.5)) * f(s / 48) - f(s / 2) for s in (cfg.xsize, cfg.ysize, cfg.zsize)]
    cx, cy, cz = np.meshgrid(*c, indexing="ij")
    vx, vy, vz = (m[i, 0] * cx + m[i, 1] * cy + m[i, 2] * cz + m[i, 3] for i in range(3))
    u = np.trunc(np.clip(vx * f(cfg.focal_length_x) / vz + f(cfg.principal_point_x), -2, 41))
    v = np.trunc(np.clip(vy * f(cfg.focal_length_y) / vz + f(cfg.principal_point_y), -2, 31))
    far = np.nanmax(depth.numpy()) + f(cfg.max_dist_neg)
    want = ((vz > 0) & (u >= 0) & (u < 40) & (v >= 0) & (v < 30) & (vz >= f(0.1))
            & (vz <= f(3.0)) & (vz <= far))
    assert int(n_cand) == int(want.sum()) > 100
    assert not (torch.from_numpy(want) & ~inside).any()
