"""Port parity: pose refinement (``refine.py``) and the occupied-voxel query
against the JAX package, on the CPU.

The scene is the 64^3 tilted sphere of tests/test_fusion.py, fused by the
JAX package (dense and brick) and carried into the port bit for bit, so
both packages refine against the same volume. The JAX Gauss-Newton step
takes its Jacobian at the zero twist, where exp_se3 selects its small
branch: the rotation columns are exactly 0 and a step moves the
translation only. The port keeps that (reference semantics, ROADMAP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu import refine as jr
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu.volume import occupied_voxel_indices as jax_occupied
from cpu_tsdf_tpu_torch import refine as tr
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays, tsdf_volume_from_arrays
from cpu_tsdf_tpu_torch.volume import occupied_voxel_indices

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)

# tests/test_refine.py's perturbation: ~2.5 cm and ~2 degrees
TWIST = np.array([0.024, -0.018, 0.015, 0.03, -0.024, 0.018], np.float32)


@pytest.fixture(scope="module")
def scene():
    """(jax dense, port dense, jax bricks, port bricks, true pose, perturbed
    pose, depth) of one tilted view of a radius-0.3 sphere."""
    from conftest import TSDFConfig as JaxConfig

    jcfg = JaxConfig(xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
                     max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
                     max_sensor_dist=3.0, image_width=40, image_height=30,
                     focal_length_x=35.0, focal_length_y=35.0,
                     principal_point_x=20.0, principal_point_y=15.0,
                     max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4)
    cfg = TSDFConfig.from_json(jcfg.to_json())
    pose = tilted_pose().astype(np.float32)
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    jd = J.integrate(J.make_volume(jcfg), jnp.asarray(depth), jnp.asarray(pose))
    td = tsdf_volume_from_arrays(cfg, {
        k: None if getattr(jd, k) is None else np.asarray(getattr(jd, k))
        for k in ("sdf", "weight", "M", "nsample", "color", "global_transform")},
        device="cpu")
    jbv = jb.integrate_bricks(jb.make_brick_volume(jcfg, 8, 1024), jnp.asarray(depth),
                              jnp.asarray(pose))
    tbv = brick_volume_from_arrays(cfg, jax_arrays(jbv), device="cpu")
    bad = (np.asarray(jr.exp_se3(jnp.asarray(TWIST))) @ pose).astype(np.float32)
    return dict(dense=(jd, td), bricks=(jbv, tbv), pose=pose, bad=bad, depth=depth)


@pytest.mark.parametrize("twist", [np.zeros(6), np.full(6, 1e-8), TWIST, -TWIST],
                         ids=["zero", "tiny", "twist", "inverse"])
def test_exp_se3_matches_jax(twist):
    tw = twist.astype(np.float32)
    got = tr.exp_se3(torch.from_numpy(tw)).numpy()
    np.testing.assert_allclose(got, np.asarray(jr.exp_se3(jnp.asarray(tw))), atol=1e-6)
    R = got[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_exp_se3_jacobian_at_zero_has_no_rotation_columns():
    """jacfwd(exp_se3) at the zero twist equals JAX's: the translation
    columns are the identity, the rotation columns exactly 0."""
    jt = torch.func.jacfwd(tr.exp_se3)(torch.zeros(6)).numpy()
    np.testing.assert_array_equal(jt, np.asarray(jax.jacfwd(jr.exp_se3)(jnp.zeros(6))))
    assert (jt[..., 3:] == 0).all()
    np.testing.assert_array_equal(jt[:3, 3, :3], np.eye(3))


@pytest.mark.parametrize("kind", ["dense", "bricks"])
def test_depth_residual_matches_jax(scene, kind):
    jv, tv = scene[kind]
    for pose in (scene["pose"], scene["bad"]):
        want = float(jr.depth_residual(jv, jnp.asarray(pose), jnp.asarray(scene["depth"])))
        got = float(tr.depth_residual(tv, pose, scene["depth"]))
        assert want > 0
        assert abs(got - want) <= 1e-6 * want, (got, want)


@pytest.mark.parametrize("kind", ["dense", "bricks"])
def test_refine_pose_step_matches_jax(scene, kind):
    """One Gauss-Newton step: pose within 1e-5, loss within 1e-5 relative;
    the rotation does not move (the Jacobian's rotation columns are 0)."""
    jv, tv = scene[kind]
    bad, depth = scene["bad"], scene["depth"]
    pj, lj = jr.refine_pose_step(jv, jnp.asarray(bad), jnp.asarray(depth))
    pt, lt = tr.refine_pose_step(tv, bad, depth)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    assert abs(float(lt) - float(lj)) <= 1e-5 * float(lj)
    np.testing.assert_array_equal(pt.numpy()[:3, :3], bad[:3, :3])
    assert np.abs(pt.numpy()[:3, 3] - bad[:3, 3]).max() > 1e-4


def test_refine_pose_matches_jax(scene):
    """Three iterations of the accept/reject loop: losses and pose within
    1e-5 of the JAX package's."""
    jv, tv = scene["dense"]
    bad, depth = scene["bad"], scene["depth"]
    pj, lj = jr.refine_pose(jv, bad, depth, iters=3, downsample_by=1)
    pt, lt = tr.refine_pose(tv, bad, depth, iters=3, downsample_by=1)
    assert len(lt) == len(lj) == 4
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)


def test_refine_pose_recovers_translation(scene):
    """The port alone on the brick volume: a 3.4 cm translation error falls
    and the loss drops at least 2x in 10 iterations."""
    _, tv = scene["bricks"]
    pose = scene["pose"]
    bad = pose.copy()
    bad[:3, 3] += TWIST[:3]
    refined, losses = tr.refine_pose(tv, bad, scene["depth"], iters=10, downsample_by=1)
    e0 = np.linalg.norm(bad[:3, 3] - pose[:3, 3])
    e1 = np.linalg.norm(refined.numpy()[:3, 3] - pose[:3, 3])
    print(f"translation error {e0:.5f} -> {e1:.5f} m; losses {losses}")
    assert losses[-1] < 0.5 * losses[0] and e1 < e0
    assert losses == sorted(losses, reverse=True)


def test_occupied_voxel_indices_match_jax(scene):
    jv, tv = scene["dense"]
    got = occupied_voxel_indices(tv)
    want = jax_occupied(jv)
    assert got.dtype == np.int32 and got.shape[1] == 3 and len(got) > 500
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "bricks"])
def test_refine_step_without_valid_point_matches_jax(scene, kind):
    """An observation with no valid point (all NaN): JtJ and Jtr are 0 and
    the damped system is singular. JAX's LU solve divides 0 by 0, so its
    step gives a pose whose top three rows are NaN and a loss of 0; the
    port's solve_ex reports the singular system and gives the same. The
    residual is 0 in both, and refine_pose rejects the step and keeps the
    start pose."""
    jv, tv = scene[kind]
    bad = scene["bad"]
    depth = np.full_like(scene["depth"], np.nan)
    pj, lj = jr.refine_pose_step(jv, jnp.asarray(bad), jnp.asarray(depth))
    pt, lt = tr.refine_pose_step(tv, bad, depth)
    pj = np.asarray(pj)
    assert np.isnan(pj[:3]).all() and np.isnan(pt.numpy()[:3]).all()
    np.testing.assert_array_equal(pt.numpy()[3], pj[3])
    assert float(lt) == float(lj) == 0.0
    assert float(tr.depth_residual(tv, bad, depth)) == float(
        jr.depth_residual(jv, jnp.asarray(bad), jnp.asarray(depth))) == 0.0
    pose, losses = tr.refine_pose(tv, bad, depth, iters=2, downsample_by=1)
    np.testing.assert_array_equal(pose.numpy(), bad)
    assert losses == [0.0] * len(losses)
