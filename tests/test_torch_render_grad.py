"""Port parity: the gradients of the differentiable render against the JAX
package, on the CPU.

The port's render_view and render_rays march without autograd (the CUDA
kernel on the card, the plain march here) and recompute the refinement t*
and the normals under autograd in the backward
(``raycast_kernel.march_rays``); the JAX package differentiates its XLA
render_view and render_rays with the bracket under stop_gradient, and its
Pallas route recomputes t* and the normals in ``_phase3_xla``. On the scene
of tests/test_torch_render.py (128^3 bricks, 64x48): each gradient within
1e-3 of its largest entry, finite. The normals are held against
``_phase3_xla`` (guarded: the norm at least 1e-6), not against render_view,
whose unguarded sqrt gives NaN wherever a normal's norm is 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import render_view as jax_render_view
from cpu_tsdf_tpu.ops.pallas_raycast import _phase3_xla
from cpu_tsdf_tpu.ops.raycast import render_rays as jax_render_rays
from cpu_tsdf_tpu_torch import pack_render, render_view
from cpu_tsdf_tpu_torch.ops.raycast import camera_rays, render_rays
from cpu_tsdf_tpu_torch.ops.raycast_kernel import march_plain

from test_torch_render import _dense_pair, _scene
import torch_common  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def assert_grad_close(gt, gj, what):
    """Finite, nonzero, and within 1e-3 of the largest entry of JAX's."""
    gt = gt.detach().numpy()
    gj = np.asarray(gj).reshape(gt.shape)
    scale = np.abs(gj).max()
    err = np.abs(gt - gj).max()
    print(f"{what}: {(gj != 0).sum()} nonzero, max |g| {scale:.4g}, max err {err:.3g}")
    assert np.isfinite(gt).all() and scale > 0 and (gt != 0).any()
    assert err <= 1e-3 * scale


def _jax_grads(f, args, n_out):
    """The gradient of each of f's n_out scalar outputs with respect to
    args, from one vjp. Not under jit: XLA:CPU would contract the
    refinement's multiply-adds into FMAs, which moves the gradient of an
    ill-conditioned bracket by ~1e-3 (JAX's render_view is jitted inside)."""
    _, vjp = jax.vjp(f, *args)
    return [vjp(tuple(jnp.float32(i == k) for i in range(n_out))) for k in range(n_out)]


def _torch_grads(outs, args):
    return [torch.autograd.grad(o, args, retain_graph=True) for o in outs]


@pytest.mark.parametrize("case", ["bricks", "dense", "downsample_by_2"])
def test_render_view_gradients_match_jax(scene, case):
    """The gradients of nansum(depth) and nansum(points) with respect to
    the sdf and the whole 4x4 pose against jax.grad of JAX render_view."""
    jbv, tbv, pose, _ = scene
    jv, tv = _dense_pair(jbv) if case == "dense" else (jbv, tbv)
    ds = 2 if case == "downsample_by_2" else 1

    def jax_losses(sdf, p):
        r = jax_render_view(dataclasses.replace(jv, sdf=sdf), p, downsample_by=ds)
        return jnp.nansum(r.depth), jnp.nansum(r.points)

    gj = _jax_grads(jax_losses, (jv.sdf, jnp.asarray(pose, jnp.float32)), 2)
    sdf = tv.sdf.clone().requires_grad_(True)
    p = torch.tensor(pose, dtype=torch.float32, requires_grad=True)
    r = render_view(dataclasses.replace(tv, sdf=sdf), p, ds)
    gt = _torch_grads([torch.nansum(r.depth), torch.nansum(r.points)], [sdf, p])
    for loss, (gt_sdf, gt_pose), (gj_sdf, gj_pose) in zip(("depth", "points"), gt, gj):
        assert_grad_close(gt_sdf, gj_sdf, f"{case}, {loss}: sdf")
        assert_grad_close(gt_pose, gj_pose, f"{case}, {loss}: pose")


def test_render_rays_gradients_match_jax(scene):
    """The gradients of t_star and of a seeded weighting of the hits, over
    the rays valid in both, with respect to the origins and the dirs
    against jax.grad of JAX render_rays."""
    jbv, tbv, pose, _ = scene
    origins, dirs = camera_rays(tbv.config, torch.tensor(pose, dtype=torch.float32))
    w = np.random.default_rng(0).normal(size=(origins.shape[0], 3)).astype(np.float32)
    with torch.no_grad():
        valid_t = render_rays(tbv, origins, dirs)["valid"].numpy()
    valid_j = np.asarray(jax_render_rays(jbv, jnp.asarray(origins.numpy()),
                                         jnp.asarray(dirs.numpy()))["valid"])
    m = valid_t & valid_j
    assert m.sum() > 800

    def losses(r, xp, mask, weight):
        hits = xp.stack([r["hit_x"], r["hit_y"], r["hit_z"]], -1)
        return ((r["t_star"] * mask).sum(), (hits * weight * mask[:, None]).sum())

    gj = _jax_grads(lambda o, d: losses(jax_render_rays(jbv, o, d), jnp, jnp.asarray(m), w),
                    (jnp.asarray(origins.numpy()), jnp.asarray(dirs.numpy())), 2)
    o, d = (x.clone().requires_grad_(True) for x in (origins, dirs))
    gt = _torch_grads(losses(render_rays(tbv, o, d), torch, torch.from_numpy(m),
                             torch.from_numpy(w)), [o, d])
    for loss, g_t, g_j in zip(("t_star", "hits"), gt, gj):
        for name, a, b in zip(("origins", "dirs"), g_t, g_j):
            assert_grad_close(a, b, f"{loss}: {name}")


def test_normal_gradients_match_phase3(scene):
    """A seeded weighting of the normals (volume frame, on the rays with a
    valid normal) through render_rays of the pose's camera rays, with
    respect to the sdf and the pose, against jax.vjp of the JAX package's
    _phase3_xla fed the same brackets."""
    jbv, tbv, pose, _ = scene
    jpose = jnp.asarray(pose, jnp.float32)
    p = torch.tensor(pose, dtype=torch.float32, requires_grad=True)
    sdf = tbv.sdf.clone().requires_grad_(True)
    origins, dirs = camera_rays(tbv.config, p)
    r = render_rays(dataclasses.replace(tbv, sdf=sdf), origins, dirs)
    with torch.no_grad():
        ch = march_plain(pack_render(tbv), origins.contiguous(), dirs.contiguous())
    nvalid = r["normal_valid"]
    assert int(nvalid.sum()) > 800
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(3,) + nvalid.shape)
                         .astype(np.float32)) * nvalid
    loss = sum((w[i] * r[f"normal_{a}"]).sum() for i, a in enumerate("xyz"))
    gt_sdf, gt_pose = torch.autograd.grad(loss, [sdf, p])

    t_bt, found = jnp.asarray(ch[0].numpy()), jnp.asarray(ch[1].numpy() > 0)
    _, vjp = jax.vjp(lambda s, q: _phase3_xla(dataclasses.replace(jbv, sdf=s), q, 1, t_bt,
                                              found), jbv.sdf, jpose)
    wj = jnp.asarray(w.numpy())
    gj_sdf, gj_pose = vjp(dict(t_star=jnp.zeros_like(t_bt), nx=wj[0], ny=wj[1], nz=wj[2]))
    assert_grad_close(gt_sdf, gj_sdf, "normals: sdf")
    assert_grad_close(gt_pose, gj_pose, "normals: pose")


def test_packed_volume_gets_its_gradient(scene):
    """A PackedRenderVolume's field takes the gradient: equal to the sdf's
    on the observed voxels (the packed channel is the sdf there), 0 on the
    unobserved ones (NaN in the channel)."""
    _, tbv, pose, _ = scene
    p = torch.tensor(pose, dtype=torch.float32)
    sdf = tbv.sdf.clone().requires_grad_(True)
    packed = pack_render(tbv)
    rd = packed.rd.clone().requires_grad_(True)
    grads = []
    for vol, field in ((dataclasses.replace(tbv, sdf=sdf), sdf),
                       (dataclasses.replace(packed, rd=rd), rd)):
        r = render_view(vol, p)
        (g,) = torch.autograd.grad(torch.nansum(r.points) + torch.nansum(r.normals), [field])
        grads.append(g)
    g_sdf, g_rd = grads
    assert torch.isfinite(g_rd).all() and int((g_rd != 0).sum()) > 50
    torch.testing.assert_close(g_rd, g_sdf, rtol=1e-6, atol=1e-6 * float(g_sdf.abs().max()))
    assert not bool((g_rd[tbv.weight == 0] != 0).any())


def test_forward_unchanged_under_autograd(scene):
    """With gradients required, render_view's outputs are those without."""
    _, tbv, pose, _ = scene
    with torch.no_grad():
        plain = render_view(tbv, pose, colored=True)
    sdf = tbv.sdf.clone().requires_grad_(True)
    p = torch.tensor(pose, dtype=torch.float32, requires_grad=True)
    diff = render_view(dataclasses.replace(tbv, sdf=sdf), p, colored=True)
    assert diff.points.requires_grad and diff.normals.requires_grad
    for name in ("points", "normals", "depth", "rgb"):
        assert torch.equal(getattr(diff, name).detach().nan_to_num(7.0),
                           getattr(plain, name).nan_to_num(7.0)), name
