"""Port parity: field queries (ops/interpolate), the uniform voxel gathers
and the packed render view against the JAX package, on the CPU.

The same seeded numpy field (random SDF, weights zero over whole bricks and
on scattered voxels) and points go through cpu_tsdf_tpu and
cpu_tsdf_tpu_torch, on a dense volume, the brick volume made from it, and
the packed render view of each. Validity masks and gathers are exact;
values, gradients and Hessians agree within 1e-6 (JAX evaluates these
eagerly, op by op, as the port does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.config import TSDFConfig as JaxConfig
from cpu_tsdf_tpu.ops import interpolate as ji
from cpu_tsdf_tpu.ops import raycast as jr
from cpu_tsdf_tpu.volume import TSDFVolume as JaxDense
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays, tsdf_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import interpolate as ti
from cpu_tsdf_tpu_torch.ops import raycast as tr

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)

ATOL = 1e-6


def _field(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = cfg.resolution
    sdf = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    w = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.05] = 0.0
    w[:8, :8, 8:16] = 0.0          # a whole unobserved brick: unallocated
    color = rng.integers(0, 256, shape + (3,)).astype(np.float32)
    return sdf, w, color


@pytest.fixture(scope="module")
def volumes():
    """(jax cfg, port cfg, {kind: (jax volume, port volume)}) for the dense
    volume, its 8^3 and 4^3 brick volumes and the packed views."""
    jcfg = JaxConfig(xres=32, yres=32, zres=32, xsize=1.6, ysize=1.6, zsize=1.6,
                     integrate_color=True, color_mode="RGB")
    cfg = TSDFConfig.from_json(jcfg.to_json())
    sdf, w, color = _field(jcfg)
    arrays = dict(sdf=sdf, weight=w, M=np.zeros_like(w), nsample=(w > 0).astype(np.int32),
                  color=color, global_transform=np.eye(4, dtype=np.float32))
    jd = JaxDense(**{k: jnp.asarray(v) for k, v in arrays.items()}, config=jcfg)
    vols = {"dense": (jd, tsdf_volume_from_arrays(cfg, arrays, device="cpu"))}
    for B in (8, 4):
        jbv = jb.from_dense(jd, brick_size=B)
        vols[f"brick{B}"] = (jbv, brick_volume_from_arrays(cfg, jax_arrays(jbv), device="cpu"))
    for kind in list(vols):
        jv, tv = vols[kind]
        vols[f"packed_{kind}"] = (jb.pack_render(jv), tb.pack_render(tv))
    return jcfg, cfg, vols


def _points(n=3000, seed=1, lo=-0.85, hi=0.85):
    """Query points over the whole volume and a margin outside it, plus
    points on voxel centres and faces (the floor and step-back edges)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    grid = ((rng.integers(0, 32, (200, 3)) + rng.choice([0.0, 0.5], (200, 3)))
            * 0.05 - 0.8).astype(np.float32)
    return np.concatenate([p, grid])


def _pair(pts):
    return [jnp.asarray(pts[:, i]) for i in range(3)], \
        [torch.from_numpy(pts[:, i].copy()) for i in range(3)]


def _close(t, j, scale=1.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=ATOL * scale)


def test_gathers_and_pack_match_jax(volumes):
    """gather_dw, gather_color and pack_render are exact on every layout."""
    _, _, vols = volumes
    rng = np.random.default_rng(2)
    idx = rng.integers(-3, 35, (3, 4000)).astype(np.int32)   # clipped by both
    jidx, tidx = [jnp.asarray(a) for a in idx], [torch.from_numpy(a) for a in idx]
    for kind, (jv, tv) in vols.items():
        for a, b in zip(jb.gather_dw(jv, *jidx), tb.gather_dw(tv, *tidx)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=kind)
        np.testing.assert_array_equal(tb.gather_color(tv, *tidx).numpy(),
                                      np.asarray(jb.gather_color(jv, *jidx)), err_msg=kind)
        if kind.startswith("packed"):
            rd = np.asarray(jv.rd).reshape(tv.rd.shape)
            np.testing.assert_array_equal(tv.rd.numpy(), rd, err_msg=kind)


@pytest.mark.parametrize("trilinear", [True, False], ids=["trilinear", "nearest"])
def test_vol_queries_match_jax(volumes, trilinear):
    """tsdf_value_vol, trilinear_vol, nearest_vol and the tent kernel's
    _vol wrapper on all five volume kinds."""
    import dataclasses

    jcfg, cfg, vols = volumes
    jp, tp = _pair(_points())
    for kind, (jv, tv) in vols.items():
        jv = dataclasses.replace(jv, config=jcfg.with_updates(
            use_trilinear_interpolation=trilinear))
        tv = dataclasses.replace(tv, config=cfg.with_updates(
            use_trilinear_interpolation=trilinear))
        for name in ("tsdf_value_vol", "trilinear_vol", "nearest_vol"):
            jval, jok = getattr(ji, name)(jv, *jp)
            tval, tok = getattr(ti, name)(tv, *tp)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=kind)
            assert np.asarray(jok).mean() > 0.3, (kind, name)
            _close(tval, jval)
        if trilinear:
            for a, b in zip(ji.fxn_gradient_hessian_vol(jv, *jp),
                            ti.fxn_gradient_hessian_vol(tv, *tp)):
                if b.dtype == torch.bool:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=kind)
                else:
                    _close(b, a)


def test_dense_field_functions_match_jax(volumes):
    """trilinear, nearest, tsdf_value, fxn_gradient_hessian, fxn, gradient
    and hessian on the raw dense arrays."""
    jcfg, cfg, vols = volumes
    jd, td = vols["dense"]
    jp, tp = _pair(_points(seed=3))
    for name in ("trilinear", "nearest", "tsdf_value"):
        jval, jok = getattr(ji, name)(jcfg, jd.sdf, jd.weight, *jp)
        tval, tok = getattr(ti, name)(cfg, td.sdf, td.weight, *tp)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=name)
        _close(tval, jval)
    for name in ("fxn", "gradient", "hessian"):
        ja, jok = getattr(ji, name)(jcfg, jd.sdf, *jp)
        ta, tok = getattr(ti, name)(cfg, td.sdf, *tp)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=name)
        assert 0.5 < np.asarray(jok).mean() < 1.0
        _close(ta, ja)
    for a, b in zip(ji.fxn_gradient_hessian(jcfg, jd.sdf, *jp),
                    ti.fxn_gradient_hessian(cfg, td.sdf, *tp)):
        if b.dtype == torch.bool:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)


def test_analytic_gradient_matches_autograd(volumes):
    """The tent kernel's closed-form gradient equals torch.autograd's, and
    the JAX package's jax.grad, within 1e-6 relative to the gradient's
    scale (1e2 at c = 5 cm: autograd sums the 8 corners in another order);
    points keep 1 mm from voxel centres, where |.| has a kink."""
    jcfg, cfg, vols = volumes
    jd, td = vols["dense"]
    pts = _points(n=500, seed=4, lo=-0.7, hi=0.7)[:500]
    centres = (np.floor((pts + 0.8) / 0.05) + 0.5) * 0.05 - 0.8
    pts = np.where(np.abs(pts - centres) < 1e-3, pts + 3e-3, pts).astype(np.float32)
    jp, tp = _pair(pts)
    grad, ok = ti.gradient(cfg, td.sdf, *tp)
    auto = ti.fxn_autodiff_gradient(cfg, td.sdf, *tp)
    assert ok.all()
    _close(auto, grad.numpy(), 1e2)
    _close(auto, ji.fxn_autodiff_gradient(jcfg, jd.sdf, *jp), 1e2)
    # and autograd reaches the sdf tensor: the 8 trilinear weights sum to 1
    sdf = td.sdf.clone().requires_grad_(True)
    val, _ = ti.trilinear(cfg, sdf, td.weight, *[c[:1] for c in tp])
    val.sum().backward()
    assert int((sdf.grad != 0).sum()) == 8
    assert float(sdf.grad.sum()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("downsample_by", [1, 2])
def test_camera_rays_match_jax(small_cfg, downsample_by):
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    pose = tilted_pose().astype(np.float32)
    jo, jd = jr.camera_rays(small_cfg, jnp.asarray(pose), downsample_by)
    to, td = tr.camera_rays(cfg, torch.from_numpy(pose), downsample_by)
    assert tuple(td.shape) == jd.shape
    _close(to, jo)
    _close(td, jd)
