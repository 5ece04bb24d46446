"""Projective TSDF integration on the dense grid: the semantic reference
of every fusion engine.

Port of ``cpu_tsdf_tpu.ops.fusion`` (TSDFVolumeOctree::integrateCloud /
updateVoxel, cpu_tsdf/include/cpu_tsdf/impl/tsdf_volume_octree.hpp:48-218).
Per finest voxel:
  * sensor-bound and projection gating       hpp:146-153
  * d_new = depth(u,v) - z_cam               hpp:159 (projective)
  * clamp +max_dist_pos; DROP beyond -max_dist_neg
                                             hpp:189-196
  * normalize by max_dist_neg only           hpp:198
  * optional depth / variance weighting      hpp:200-204
  * weighted average, weight cap AFTER the average
                                             octree.cpp:153-163
  * Welford variance accumulator M, nsample  octree.cpp:160-161

Dense :func:`integrate` consumes its volume, as the JAX package's jitted
``integrate`` donates it (``donate_argnums=(0,)``): the caller uses the
returned volume. On the card it runs the dense fusion kernel
(``csrc/fusion.cu``), which updates the volume's tensors in place; where
an input requires grad it runs the kernel on a copy instead, so that torch
autograd flows through it with respect to depth, pose, rgb and the old
volume. On the CPU it runs the plain version :func:`integrate_slab_plain`,
which returns new tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing
from ..config import TSDFConfig
from ..geometry import (div_const, frustum_contains, reproject_point, rigid_inverse,
                        transform_points)
from ..volume import TSDFVolume, resolve_use_kernel, voxel_centers_grid
from . import color as color_ops


def coarse_cell_frustum(cfg: TSDFConfig, trans_inv, vx, vy, vz):
    """Frustum test of the COARSE CELL containing voxel indices (vx, vy, vz)
    (tsdf_volume_octree.cpp:619-652): octree cells at the max_cell level are
    tested by their centers against a 1.1x-FOV frustum; every fine voxel in a
    culled cell is skipped for the frame."""
    n = 1 << cfg.num_coarse_levels
    gx = torch.div(vx * n, cfg.xres, rounding_mode="floor")
    gy = torch.div(vy * n, cfg.yres, rounding_mode="floor")
    gz = torch.div(vz * n, cfg.zres, rounding_mode="floor")
    ccx = (gx.to(torch.float32) + 0.5) * (cfg.xsize / n) - cfg.xsize / 2
    ccy = (gy.to(torch.float32) + 0.5) * (cfg.ysize / n) - cfg.ysize / 2
    ccz = (gz.to(torch.float32) + 0.5) * (cfg.zsize / n) - cfg.zsize / 2
    return frustum_contains(cfg, trans_inv, ccx, ccy, ccz)


def coarse_frustum_mask(cfg: TSDFConfig, trans_inv, *, x_slab=None):
    """Dense [xres,yres,zres] version of :func:`coarse_cell_frustum`; with
    x_slab = (x0, nx), that of the X-slab [x0, x0 + nx) only."""
    dev = trans_inv.device
    x0, nx = (0, cfg.xres) if x_slab is None else x_slab
    vx = torch.arange(x0, x0 + nx, dtype=torch.int32, device=dev)[:, None, None]
    vy = torch.arange(cfg.yres, dtype=torch.int32, device=dev)[None, :, None]
    vz = torch.arange(cfg.zres, dtype=torch.int32, device=dev)[None, None, :]
    return coarse_cell_frustum(cfg, trans_inv, vx, vy, vz)


def gather_image(img, v, u):
    """img[v, u] with clipped indices (callers mask validity separately)."""
    H, W = img.shape[:2]
    return img[torch.clamp(v, 0, H - 1).long(), torch.clamp(u, 0, W - 1).long()]


def fuse_observation(d, w, M, nsample, d_new, w_new, max_weight):
    """One weighted-average fusion step (OctreeNode::addObservation,
    octree.cpp:153-163): cap applied after the average; wsum == 0 keeps the
    old d."""
    wsum = w + w_new
    pos = wsum > 0
    d_upd = torch.where(pos, (d * w + d_new * w_new)
                        / torch.where(pos, wsum, torch.ones_like(wsum)), d)
    w_upd = torch.clamp(wsum, max=max_weight)
    M_upd = M + w_new * (d_new - d_upd) * (d_new - d)
    return d_upd, w_upd, M_upd, nsample + 1


def voxel_variance(M, w, nsample):
    """OctreeNode::getVariance (octree.cpp:281-287); inf below 5 samples.
    The reference's n/(n-1) factor is integer division, i.e. 1: var = M/w."""
    var = M / torch.where(w > 0, w, torch.ones_like(w))
    return torch.where(nsample < 5, torch.full_like(var, float("inf")), var)


def compute_observation(cfg: TSDFConfig, depth, pose_inv, cx, cy, cz):
    """Per-voxel projective observation for voxel centers (cx, cy, cz).

    Returns (d_normalized, w_new, valid, z_img, u, v); differentiable with
    respect to depth and pose_inv."""
    vx, vy, vz = transform_points(pose_inv, cx, cy, cz)
    in_range = (vz >= cfg.min_sensor_dist) & (vz <= cfg.max_sensor_dist)
    u, v, proj_ok = reproject_point(cfg, vx, vy, vz)
    z_img = gather_image(depth, v, u)
    valid = in_range & proj_ok & ~torch.isnan(z_img)
    d_new = z_img - vz
    # beyond -max_dist_neg the observation is dropped (no space carving)
    valid = valid & (d_new >= -cfg.max_dist_neg)
    d_new = div_const(torch.clamp(d_new, max=cfg.max_dist_pos), cfg.max_dist_neg)
    w_new = torch.ones_like(d_new)
    if cfg.weight_by_depth:
        # a 10 m reading is worthless (hpp:200-202)
        w_new = w_new * (1.0 - torch.clamp(div_const(z_img, 10.0), max=1.0))
    return d_new, w_new, valid, z_img, u, v


def variance_weight(cfg: TSDFConfig, w_obs, d_obs, d0, w0, M0, n0):
    """exp(logNormal(d_new, d_old, var)) gate above 5 samples (hpp:203-204)."""
    if not cfg.weight_by_variance:
        return w_obs
    var = voxel_variance(M0, w0, n0)
    scale = torch.exp(-((d_obs - d0) ** 2) / (2.0 * var))
    return w_obs * torch.where(n0 > 5, scale, torch.ones_like(scale))


def integrate(vol: TSDFVolume, depth, pose, rgb: Optional[torch.Tensor] = None, *,
              use_kernel: Optional[bool] = None) -> TSDFVolume:
    """Fuse one registered depth frame into the dense volume.

    Args:
      vol: current volume state, donated: use the returned volume. On the
        card without autograd its tensors are updated in place and
        returned; the plain route and the autograd route return new
        tensors and leave vol as it was.
      depth: [H, W] float32 depth in meters, NaN where missing.
      pose: [4, 4] camera-to-volume transform.
      rgb: optional [H, W, 3] float32 (0..255) color image.
      use_kernel: None = the dense fusion kernel (csrc/fusion.cu) on the
        card and the plain version on the CPU; False = the plain version
        anywhere; True on the CPU raises.

    The tracing call ``integrate``.
    """
    with tracing.call("integrate", vol.device):
        return integrate_slab(vol, depth, pose, rgb, use_kernel=use_kernel)


def integrate_slab(vol: TSDFVolume, depth, pose, rgb: Optional[torch.Tensor] = None,
                   x0: int = 0, *, use_kernel: Optional[bool] = None) -> TSDFVolume:
    """:func:`integrate` on the X-slab [x0, x0 + n) of the grid, where vol's
    tensors hold that slab's n x-planes (the slab-sharded volume of
    ``parallel.sharding``); voxel centres and the coarse frustum cells are
    those of the slab's global indices.

    vol is donated, as in :func:`integrate`. On the kernel route with grad
    mode off or no input requiring grad, ``fusion_kernel.fuse_dense``
    updates vol's tensors in place and returns them. Otherwise the frame is
    differentiable with respect to depth, pose, rgb and the volume's float
    tensors through :class:`_IntegrateSlab`: the forward runs the kernel on
    a copy of the state or runs :func:`integrate_slab_plain`, the backward
    recomputes the plain version under autograd, and vol stays as it was.
    use_kernel: as in :func:`integrate`."""
    dev = vol.device
    kernel = resolve_use_kernel(use_kernel, dev)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    with_color = vol.color is not None and rgb is not None
    rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev) if with_color else None
    color = vol.color if with_color else None
    if kernel and not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (depth, pose, rgb, vol.sdf, vol.weight, vol.M, color))):
        from .fusion_kernel import fuse_dense

        return fuse_dense(vol, depth, pose, rgb, x0)
    sdf, weight, M, nsample, color = _IntegrateSlab.apply(
        depth, pose, rgb, vol.sdf, vol.weight, vol.M, vol.nsample, color, vol.config,
        vol.global_transform, x0, kernel)
    return TSDFVolume(sdf=sdf, weight=weight, M=M, nsample=nsample,
                      color=color if with_color else vol.color,
                      global_transform=vol.global_transform, config=vol.config)


class _IntegrateSlab(torch.autograd.Function):
    """The dense fusion of one frame, (sdf, weight, M, nsample, color or
    None) of the slab, differentiable with respect to depth, pose, rgb and
    the volume's float tensors.

    Forward: the dense fusion kernel (``fusion_kernel.fuse_dense``) on
    copies of the state, since it updates in place and the backward needs
    the inputs as they were, or the plain version, without autograd.
    Backward: :func:`integrate_slab_plain` recomputed from the saved inputs
    under autograd, as ``raycast_kernel._MarchRays`` recomputes the
    refinement: the plain version is the function the kernel computes, so
    its gradient is the kernel's."""

    @staticmethod
    def forward(ctx, depth, pose, rgb, sdf, weight, M, nsample, color, cfg, global_transform,
                x0, kernel):
        from .fusion_kernel import fuse_dense

        state = (sdf, weight, M, nsample, color)
        if kernel:
            state = tuple(None if t is None else t.clone() for t in state)
        vol = TSDFVolume(*state, global_transform=global_transform, config=cfg)
        out = (fuse_dense if kernel else integrate_slab_plain)(vol, depth, pose, rgb, x0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(depth, pose, rgb, sdf, weight, M, nsample, color)
        ctx.cfg, ctx.global_transform, ctx.x0 = cfg, global_transform, x0
        ctx.mark_non_differentiable(out.nsample)
        return out.sdf, out.weight, out.M, out.nsample, out.color

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:8]
        none = (None,) * 12
        if not any(need):
            return none
        with torch.enable_grad():
            inputs = [None if x is None else x.detach().requires_grad_(n)
                      for x, n in zip(saved, need)]
            depth, pose, rgb, sdf, weight, M, nsample, color = inputs
            out = integrate_slab_plain(
                TSDFVolume(sdf=sdf, weight=weight, M=M, nsample=nsample, color=color,
                           global_transform=ctx.global_transform, config=ctx.cfg),
                depth, pose, rgb, ctx.x0)
            pairs = [(o, g) for o, g in zip((out.sdf, out.weight, out.M, out.nsample,
                                             out.color), grads)
                     if g is not None and o is not None and o.requires_grad]
            if not pairs:
                return none
            wanted = [x for x, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if n else None for n in need) + (None,) * 4


def integrate_slab_plain(vol: TSDFVolume, depth, pose, rgb: Optional[torch.Tensor] = None,
                         x0: int = 0) -> TSDFVolume:
    """Plain PyTorch version of the dense fusion kernel: :func:`integrate_slab`
    as ~50 full-volume tensor passes, differentiable. The CPU route, the
    backward of :class:`_IntegrateSlab`, and the yardstick the kernel is
    held against on the card."""
    cfg = vol.config
    dev = vol.device
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose_inv = rigid_inverse(torch.as_tensor(pose, dtype=torch.float32, device=dev))
    x_slab = (x0, vol.sdf.shape[0])
    cx, cy, cz = voxel_centers_grid(cfg, device=dev, x_slab=x_slab)
    d_obs, w_obs, valid, _, u, v = compute_observation(cfg, depth, pose_inv, cx, cy, cz)
    if cfg.frustum_culling:
        valid = valid & coarse_frustum_mask(cfg, pose_inv, x_slab=x_slab)
    w_obs = variance_weight(cfg, w_obs, d_obs, vol.sdf, vol.weight, vol.M, vol.nsample)
    d_upd, w_upd, M_upd, n_upd = fuse_observation(
        vol.sdf, vol.weight, vol.M, vol.nsample, d_obs, w_obs, cfg.max_weight)

    new_color = vol.color
    if vol.color is not None and rgb is not None:
        # trunc mirrors the reference's uint8 color observations
        rgb = torch.trunc(torch.as_tensor(rgb, dtype=torch.float32, device=dev))
        r = gather_image(rgb[..., 0], v, u)
        g = gather_image(rgb[..., 1], v, u)
        b = gather_image(rgb[..., 2], v, u)
        upd = color_ops.update_color(cfg.color_mode, vol.color, vol.weight, r, g, b, w_obs)
        new_color = torch.where(valid[..., None], upd, vol.color)

    return TSDFVolume(
        sdf=torch.where(valid, d_upd, vol.sdf),
        weight=torch.where(valid, w_upd, vol.weight),
        M=torch.where(valid, M_upd, vol.M),
        nsample=torch.where(valid, n_upd, vol.nsample),
        color=new_color,
        global_transform=vol.global_transform,
        config=cfg,
    )
