"""Port parity: raycast rendering and the differentiable depth render
against the JAX package, on the CPU.

The port's render_view (the plain march: the lockstep loop that the CUDA
kernel reproduces on the card) is held against the JAX package's
render_view, the XLA march that the JAX package's own kernel test uses as
its reference (tests/test_pallas_raycast.py), on that test's scene (128^3,
64x48, colored) and its variants: a dense volume, downsample_by=2,
asymmetric truncation. The gates are that test's
tolerances: validity agreement > 0.97, median depth error < 1e-4, normals
within a median of 0.5 degrees, colors exact where both are valid. The two
run the same recurrence on the same global grid, so they agree far more
tightly (each test prints what it measured); what remains is XLA:CPU
contracting multiply-adds into FMAs under jit (ROADMAP faults), which
moves a sample across a voxel edge now and then.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu import render_view as jax_render_view
from cpu_tsdf_tpu.ops.raycast import render_rays as jax_render_rays
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch import render_view
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays, tsdf_volume_from_arrays
from cpu_tsdf_tpu_torch.ops.raycast import camera_rays, render_rays
from cpu_tsdf_tpu_torch.ops.raycast_kernel import render_depth_diff

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)


def _scene(mdp=0.04, mdn=0.04, colored=True):
    """tests/test_pallas_raycast.py's scene: a radius-0.3 sphere fused from
    one tilted view into a 128^3 brick volume over 1.6 m."""
    from conftest import TSDFConfig as JaxConfig

    jcfg = JaxConfig(
        xres=128, yres=128, zres=128, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=mdp, max_dist_neg=mdn, min_sensor_dist=0.1, max_sensor_dist=3.0,
        image_width=64, image_height=48, focal_length_x=56.0, focal_length_y=56.0,
        principal_point_x=32.0, principal_point_y=24.0,
        max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4,
        integrate_color=colored, color_mode="RGB")
    pose = tilted_pose()
    depth = np.asarray(sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3))
    rgb = np.broadcast_to(np.array([200.0, 64.0, 32.0], np.float32),
                          depth.shape + (3,)).copy()
    jbv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, 2048), jnp.asarray(depth),
                              jnp.asarray(pose, jnp.float32),
                              jnp.asarray(rgb) if colored else None)
    cfg = TSDFConfig.from_json(jcfg.to_json())
    tbv = brick_volume_from_arrays(cfg, jax_arrays(jbv), device="cpu")
    return jbv, tbv, pose, depth


@pytest.fixture(scope="module")
def scene():
    return _scene()


def assert_renders_match(rj, rt, what, min_valid=800):
    dj, dt = np.asarray(rj.depth), rt.depth.numpy()
    vj, vt = ~np.isnan(dj), ~np.isnan(dt)
    agree = (vj == vt).mean()
    both = vj & vt
    err = np.abs(dj[both] - dt[both])
    nj, nt = np.asarray(rj.normals), rt.normals.numpy()
    bn = ~np.isnan(nj[..., 0]) & ~np.isnan(nt[..., 0])
    dots = np.clip((nj[bn] * nt[bn]).sum(-1), -1, 1)
    angle = np.degrees(np.arccos(dots))
    print(f"{what}: {vj.sum()} valid, validity agreement {agree:.6f}, depth error "
          f"median {np.median(err):.3g} max {err.max():.3g}, normal angle median "
          f"{np.median(angle):.3g} max {angle.max():.3g} deg over {bn.sum()} normals")
    assert vj.sum() > min_valid and bn.sum() > 0.5 * min_valid
    assert agree > 0.97
    assert np.median(err) < 1e-4
    assert np.median(angle) < 0.5
    if rj.rgb is not None:
        cj, ct = np.asarray(rj.rgb), rt.rgb.numpy()
        bc = ~np.isnan(cj[..., 0]) & ~np.isnan(ct[..., 0])
        assert bc.sum() > 0.5 * min_valid
        np.testing.assert_array_equal(ct[bc], cj[bc])
    else:
        assert rt.rgb is None


def test_render_view_matches_jax(scene):
    jbv, tbv, pose, _ = scene
    rj = jax_render_view(jbv, pose, colored=True)
    rt = render_view(tbv, pose, colored=True)
    assert rt.depth.shape == (48, 64) and rt.points.shape == (48, 64, 3)
    assert_renders_match(rj, rt, "bricks, colored")
    c = rt.rgb.numpy()
    np.testing.assert_allclose(c[~np.isnan(c[..., 0])].mean(0), [200, 64, 32], atol=2.0)


def test_render_dense_volume_matches_jax(scene):
    jbv, _, pose, _ = scene
    jd, td = _dense_pair(jbv)
    assert_renders_match(jax_render_view(jd, pose, colored=True),
                         render_view(td, pose, colored=True), "dense, colored")


def _dense_pair(jbv):
    jd = jb.to_dense(jbv)
    arrays = {k: None if getattr(jd, k) is None else np.asarray(getattr(jd, k))
              for k in ("sdf", "weight", "M", "nsample", "color", "global_transform")}
    return jd, tsdf_volume_from_arrays(TSDFConfig.from_json(jd.config.to_json()), arrays,
                                       device="cpu")


@pytest.mark.parametrize("kind", ["bricks", "dense"])
def test_render_rays_matches_jax(scene, kind):
    """render_rays takes a dense or brick volume as the JAX render_rays
    does (packed here) and resolves its route like every entry point
    (volume.resolve_use_kernel: the kernel on the card, the plain march on
    the CPU, and use_kernel=True on the CPU raises). The render's
    tolerances on the rays of one view, colors exact."""
    jbv, tbv, pose, _ = scene
    jv, tv = (jbv, tbv) if kind == "bricks" else _dense_pair(jbv)
    origins, dirs = camera_rays(tbv.config, torch.tensor(pose, dtype=torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        render_rays(tv, origins, dirs, use_kernel=True)
    rt = render_rays(tv, origins, dirs, colored=True)
    rj = jax_render_rays(jv, jnp.asarray(origins.numpy()), jnp.asarray(dirs.numpy()),
                         colored=True)
    vj, vt = np.asarray(rj["valid"]), rt["valid"].numpy()
    both = vj & vt
    err = np.abs(np.asarray(rj["t_star"])[both] - rt["t_star"].numpy()[both])
    nj = np.stack([np.asarray(rj[f"normal_{a}"]) for a in "xyz"], -1)
    nt = np.stack([rt[f"normal_{a}"].numpy() for a in "xyz"], -1)
    bn = np.asarray(rj["normal_valid"]) & rt["normal_valid"].numpy()
    angle = np.degrees(np.arccos(np.clip((nj[bn] * nt[bn]).sum(-1), -1, 1)))
    print(f"{kind}: {vj.sum()} valid, agreement {(vj == vt).mean():.6f}, t* error median "
          f"{np.median(err):.3g}, normal angle median {np.median(angle):.3g} deg")
    assert vj.sum() > 800 and (vj == vt).mean() > 0.97
    assert np.median(err) < 1e-4 and np.median(angle) < 0.5
    bc = np.asarray(rj["rgb_valid"]) & rt["rgb_valid"].numpy()
    assert bc.sum() > 400
    for c in ("rgb_r", "rgb_g", "rgb_b"):
        np.testing.assert_array_equal(rt[c].numpy()[bc], np.asarray(rj[c])[bc])


def test_render_downsample_matches_jax(scene):
    jbv, tbv, pose, _ = scene
    rt = render_view(tbv, pose, downsample_by=2)
    assert rt.depth.shape == (24, 32)
    assert_renders_match(jax_render_view(jbv, pose, downsample_by=2), rt,
                         "downsample_by=2", min_valid=150)


def test_render_asymmetric_truncation_matches_jax():
    """max_dist_pos > max_dist_neg (tests/test_pallas_raycast.py:211-241):
    the backtrack must cover the larger truncation bound."""
    jbv, tbv, pose, _ = _scene(mdp=0.08, mdn=0.03, colored=False)
    assert_renders_match(jax_render_view(jbv, pose), render_view(tbv, pose),
                         "asymmetric truncation")


def _mean_depth_torch(vol, sdf, pose, downsample_by=1):
    d, valid, ok = render_depth_diff(dataclasses.replace(vol, sdf=sdf), pose,
                                     downsample_by)
    assert ok is True
    return torch.where(valid, d, 0.0).sum() / valid.sum().clamp(min=1)


def test_depth_gradients_match_jax(scene):
    """render_depth_diff's gradients (march forward, refinement recomputed
    under autograd) against jax.grad through the JAX package's render_view
    depth, which differentiates its XLA march directly: the sdf gradient
    within 1e-3 of its largest entry, the pose-translation gradient within
    1e-3 of its largest component (measured: 4e-4 and 3e-5 of them)."""
    jbv, tbv, pose, _ = scene

    def jax_mean_depth(sdf, p):
        d = jax_render_view(dataclasses.replace(jbv, sdf=sdf), p).depth
        valid = ~jnp.isnan(d)
        return jnp.sum(jnp.where(valid, d, 0.0)) / jnp.maximum(jnp.sum(valid), 1)

    gj_sdf, gj_pose = jax.grad(jax_mean_depth, argnums=(0, 1))(
        jbv.sdf, jnp.asarray(pose, jnp.float32))
    gj_sdf = np.asarray(gj_sdf).reshape(tbv.sdf.shape)
    gj_t = np.asarray(gj_pose)[:3, 3]

    sdf = tbv.sdf.clone().requires_grad_(True)
    p = torch.tensor(pose, dtype=torch.float32, requires_grad=True)
    _mean_depth_torch(tbv, sdf, p).backward()
    gt_sdf, gt_t = sdf.grad.numpy(), p.grad[:3, 3].numpy()
    scale = np.abs(gj_sdf).max()
    err = np.abs(gt_sdf - gj_sdf).max()
    print(f"sdf gradient: {(gj_sdf != 0).sum()} nonzero, max |g| {scale:.4g}, max err "
          f"{err:.3g}; pose translation gradient jax {gj_t} port {gt_t}")
    assert np.isfinite(gt_sdf).all() and (gt_sdf != 0).sum() > 50
    assert err <= 1e-3 * scale
    np.testing.assert_allclose(gt_t, gj_t, rtol=0, atol=1e-3 * np.abs(gj_t).max())


def test_depth_gradient_pose_z_finite_difference(scene):
    """The pose-z derivative against a central difference
    (tests/test_pallas_raycast.py:156-162): within 25 %."""
    _, tbv, pose, _ = scene
    base = torch.tensor(pose, dtype=torch.float32)

    def f(tz):
        p = base.clone()
        p[2, 3] += tz
        return _mean_depth_torch(tbv, tbv.sdf, p)

    tz = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(f(tz), tz)
    eps = 1e-4
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps))) - float(f(torch.tensor(-eps)))) / (2 * eps)
    print(f"pose z: autograd {float(g):.6f}, central difference {fd:.6f}")
    assert np.isfinite(float(g)) and float(g) != 0.0
    assert abs(fd - float(g)) < 0.25 * max(abs(fd), abs(float(g)), 1e-3)


def test_no_budget_to_overflow(scene):
    """The JAX package's Pallas render with r_budget=16 drops live bricks
    and returns ok=False (tests/test_pallas_raycast.py:200-208). The port
    has no budgets: the same downsampled render returns ok=True and
    exactly the depth of render_view (held against the JAX package's
    render_view above)."""
    _, tbv, pose, _ = scene
    d, valid, ok = render_depth_diff(tbv, pose, 4)
    assert ok is True
    rt = render_view(tbv, pose, downsample_by=4)
    assert int(valid.sum()) > 40
    np.testing.assert_array_equal(d.numpy(), rt.depth.numpy())
    np.testing.assert_array_equal(valid.numpy(), ~np.isnan(rt.depth.numpy()))
