"""Port parity: dense projective fusion (the semantic reference of every
fusion engine) against the JAX package, with and without color, and its
gradient with respect to depth and pose.

Tolerances are the JAX package's own between its engines: sdf and M within
1e-5, weight and nsample exact, color exact for RGB and within 1e-4 for the
float color modes.
"""

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
