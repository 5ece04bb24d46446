"""Port parity: TSDFConfig and the geometry helpers against the JAX package.

The same seeded numpy inputs go through cpu_tsdf_tpu.geometry and
cpu_tsdf_tpu_torch.geometry (on the CPU): integer pixel/voxel indices and
masks must be equal, floats within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import geometry as jg
from cpu_tsdf_tpu.config import TSDFConfig as JaxConfig
from cpu_tsdf_tpu_torch import geometry as tg
from cpu_tsdf_tpu_torch.config import TSDFConfig, snap_resolution_pow2

from test_fusion import tilted_pose


@pytest.mark.parametrize("updates", [
    {},
    dict(xres=64, yres=32, zres=128, xsize=1.6, integrate_color=True,
         color_mode="LAB", weight_by_depth=True, frustum_culling=False),
])
def test_config_json_matches(updates):
    jc = JaxConfig().with_updates(**updates)
    tc = TSDFConfig().with_updates(**updates)
    assert tc.to_json() == jc.to_json()
    assert TSDFConfig.from_json(jc.to_json()) == tc
    assert (tc.cell_size, tc.num_coarse_levels, tc.num_levels) == \
        (jc.cell_size, jc.num_coarse_levels, jc.num_levels)
    assert snap_resolution_pow2(3.0, 0.007) == 512


def _points(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (3, n)).astype(np.float32)


def test_voxel_index_and_center(small_cfg):
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    x, y, z = _points()
    ji = jg.voxel_index(small_cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    ti = tg.voxel_index(cfg, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z))
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    idx = np.asarray(ji[0]).astype(np.float32)
    jc = jg.voxel_center(small_cfg, jnp.asarray(idx), jnp.asarray(idx), jnp.asarray(idx))
    tc = tg.voxel_center(cfg, torch.from_numpy(idx), torch.from_numpy(idx),
                         torch.from_numpy(idx))
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_transform_project_frustum(small_cfg):
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    pose = tilted_pose().astype(np.float32)
    jinv = jg.rigid_inverse(jnp.asarray(pose))
    tinv = tg.rigid_inverse(torch.from_numpy(pose))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), atol=1e-6)
    x, y, z = _points(seed=1)
    jp = jg.transform_points(jinv, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    tp = tg.transform_points(tinv, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(z))
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    # camera-frame points, some behind the camera and near its plane
    cam = [np.array(a) for a in jp]
    cam[2][:50] = np.linspace(-0.2, 1e-4, 50, dtype=np.float32)
    ju, jv, jok = jg.reproject_point(small_cfg, *map(jnp.asarray, cam))
    tu, tv, tok = tg.reproject_point(cfg, *map(torch.from_numpy, cam))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert ok.sum() > 500
    np.testing.assert_array_equal(tu.numpy()[ok], np.asarray(ju)[ok])
    np.testing.assert_array_equal(tv.numpy()[ok], np.asarray(jv)[ok])
    jf = jg.frustum_contains(small_cfg, jinv, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    tf = tg.frustum_contains(cfg, tinv, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(z))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert 0 < np.asarray(jf).sum() < x.size
