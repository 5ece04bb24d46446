"""Port parity: hierarchical brick activation against the JAX package.

The band candidate list, the carve mask and the budgeted compactions must
come out EXACTLY as in cpu_tsdf_tpu.activation — same ids in the same
(tile-major) order, same counts, same overflow flags — on the sphere scene,
the wide-FOV off-centre scene and the disocclusion (carve) scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import activation as ja
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.config import TSDFConfig as JaxConfig
from cpu_tsdf_tpu.geometry import rigid_inverse as j_rigid_inverse
from cpu_tsdf_tpu.synthetic import plane_depth, sphere_depth
from cpu_tsdf_tpu_torch import activation as ta
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.geometry import rigid_inverse

from test_fusion import tilted_pose
import torch_common  # noqa: F401  (one intra-op thread)

WIDE_FOV = dict(xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
                max_dist_pos=0.06, max_dist_neg=0.06,
                min_sensor_dist=0.05, max_sensor_dist=3.0,
                image_width=640, image_height=480,
                focal_length_x=200.0, focal_length_y=200.0,
                principal_point_x=100.0, principal_point_y=240.0,
                max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4)


def _both(jcfg, depth, pose, B=8):
    """(jax mips, port mips, jax pose_inv, port pose_inv, port cfg)."""
    cfg = TSDFConfig.from_json(jcfg.to_json())
    jm = ja.depth_mips(jnp.asarray(depth), ja.mip_base_level(jcfg, B))
    tm = ta.depth_mips(torch.from_numpy(depth), ta.mip_base_level(cfg, B))
    pose = np.asarray(pose, np.float32)
    return jm, tm, j_rigid_inverse(jnp.asarray(pose)), rigid_inverse(torch.from_numpy(pose)), cfg


def _assert_band_equal(jcfg, depth, pose, budget):
    B = 8
    nb = (jcfg.xres // B, jcfg.yres // B, jcfg.zres // B)
    jm, tm, jinv, tinv, cfg = _both(jcfg, depth, pose, B)
    np.testing.assert_array_equal(tm.flat_min.numpy(), np.asarray(jm.flat_min))
    np.testing.assert_array_equal(tm.flat_max_d.numpy(), np.asarray(jm.flat_max_d))
    jc, jn, jo = ja.band_candidate_bricks(jcfg, B, nb, jm, jinv, budget)
    tc, tn, to = ta.band_candidate_bricks(cfg, B, nb, tm, tinv, budget)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn) and bool(to) == bool(jo)
    return int(jn), bool(jo)


@pytest.mark.parametrize("budget", [1024, 32])
def test_band_candidates_sphere(small_cfg, budget):
    depth = sphere_depth(small_cfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    n, overflow = _assert_band_equal(small_cfg, depth, tilted_pose(), budget)
    # the small budget overflows, identically in both packages
    assert (n > 32 and not overflow) if budget > 32 else overflow


def test_band_candidates_wide_fov():
    jcfg = JaxConfig(**WIDE_FOV)
    depth = np.full((480, 640), 0.1, np.float32)
    depth[100:300, 50:400] = np.nan
    assert _assert_band_equal(jcfg, depth, tilted_pose(tz=-0.6), 4096)[0] > 0
    # the crafted camera-plane-straddling sphere of the JAX package's test
    _, tm, _, _, cfg = _both(jcfg, np.full((480, 640), 0.1, np.float32), np.eye(4))
    ok = ta._band_test(cfg, tm, torch.tensor([0.4975]), torch.tensor([0.0]),
                       torch.tensor([0.05]), torch.tensor([0.1]))
    assert bool(ok[0])


def test_carve_and_compaction_disocclusion(small_cfg):
    """Frame 1 (near sphere) allocates bricks; frame 2 (far plane) must list
    them all as carve candidates, identically in both packages."""
    pose = np.asarray(tilted_pose(), np.float32)
    near = sphere_depth(small_cfg, center=(-0.013, -0.021, 0.6), radius=0.2)
    far = plane_depth(small_cfg, z0=1.4)
    bv = jb.integrate_bricks(jb.make_brick_volume(small_cfg, 8, 2048),
                             jnp.asarray(near), jnp.asarray(pose), None, 1024)
    coords = np.array(bv.coords)
    live = coords[:, 0] >= 0
    assert live.sum() > 20
    jm, tm, jinv, tinv, cfg = _both(small_cfg, far, pose)
    jmask = ja.carve_candidate_slots(small_cfg, 8, jm, jinv, jnp.asarray(coords),
                                     jnp.asarray(live))
    tmask = ta.carve_candidate_slots(cfg, 8, tm, tinv, torch.from_numpy(coords),
                                     torch.from_numpy(live))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert np.asarray(jmask).sum() > live.sum() // 2
    ids = np.arange(coords.shape[0], dtype=np.int32)
    for budget in (256, 16):
        js, jn = ja._compact_chunked(jmask, jnp.asarray(ids), budget)
        ts, tn = ta._compact_chunked(tmask, torch.from_numpy(ids), budget)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(tn) == int(jn)


def test_compact_chunked_random_masks():
    rng = np.random.default_rng(3)
    for C in (1000, 9000):
        for mask in (np.zeros(C, bool), rng.uniform(size=C) < 0.01,
                     rng.uniform(size=C) < 0.5):
            ids = np.arange(C, dtype=np.int32) * 3 + 1
            for budget in (64, 512):
                js, jn = ja._compact_chunked(jnp.asarray(mask), jnp.asarray(ids), budget)
                ts, tn = ta._compact_chunked(torch.from_numpy(mask), torch.from_numpy(ids),
                                             budget)
                np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
                assert int(tn) == int(jn)
