"""Port parity: dense projective fusion (the semantic reference of every
fusion engine) against the JAX package, with and without color, and its
gradient with respect to depth and pose.

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
    loss = integrate(make_volume(cfg, device="cpu"), d, p).sdf.sum()
    gd, gp = torch.autograd.grad(loss, (d, p))
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
