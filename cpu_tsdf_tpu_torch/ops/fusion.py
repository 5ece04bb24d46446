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

Dense :func:`integrate` is functional (it returns new tensors) so that
torch autograd flows through it with respect to depth and pose.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import TSDFConfig
from ..geometry import frustum_contains, reproject_point, rigid_inverse, transform_points
from ..volume import TSDFVolume, voxel_centers_grid
from . import color as color_ops


def div_const(x, c: float):
    """x / c with c rounded to x's dtype and a true division on every
    device (a Python scalar divisor becomes a reciprocal multiply in
    PyTorch's CUDA kernels, one ulp off the JAX package and the fusion
    kernel)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


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


def coarse_frustum_mask(cfg: TSDFConfig, trans_inv):
    """Dense [xres,yres,zres] version of :func:`coarse_cell_frustum`."""
    dev = trans_inv.device
    vx = torch.arange(cfg.xres, dtype=torch.int32, device=dev)[:, None, None]
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


def integrate(vol: TSDFVolume, depth, pose, rgb: Optional[torch.Tensor] = None) -> TSDFVolume:
    """Fuse one registered depth frame into the dense volume.

    Args:
      vol: current volume state (not modified; a new volume is returned).
      depth: [H, W] float32 depth in meters, NaN where missing.
      pose: [4, 4] camera-to-volume transform.
      rgb: optional [H, W, 3] float32 (0..255) color image.
    """
    cfg = vol.config
    dev = vol.device
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose_inv = rigid_inverse(torch.as_tensor(pose, dtype=torch.float32, device=dev))
    cx, cy, cz = voxel_centers_grid(cfg, dev)
    d_obs, w_obs, valid, _, u, v = compute_observation(cfg, depth, pose_inv, cx, cy, cz)
    if cfg.frustum_culling:
        valid = valid & coarse_frustum_mask(cfg, pose_inv)
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
