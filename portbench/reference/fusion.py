"""Plain reference of projective TSDF fusion, in plain PyTorch, independent of
the port: the reference C++ semantics (cpu_tsdf's
``TSDFVolumeOctree::integrateCloud`` / ``updateVoxel``,
tsdf_volume_octree.hpp:48-218, octree.cpp:153-163, 328-337) written out op
by op in the order the port's plain engines evaluate them, so that float32
results agree to rounding.

Per voxel and frame: the voxel centre into the camera frame, sensor range
[min, max], the pixel (C++ truncation), the reading, d = reading - z,
dropped below -max_dist_neg, clamped at +max_dist_pos and normalised by
max_dist_neg; the coarse-cell frustum test (1.1 x FOV) where configured;
the weighted average with weight 1, the weight capped after the average,
nsample counted, the RGB color averaged with the pre-update weight and
truncated as uint8.

The reference fuses a fixed set of voxels (linear indices ``lin`` into the
grid) over a sequence of frames drawn from F distinct frames: frame k of
the sequence is distinct frame (start + k) mod F. Each distinct frame's
observation of the voxels is computed once, then the per-voxel recurrence
runs step by step. The geometry is float32; the state is kept and updated
in ``dtype``: float32 is the reference, bfloat16 its control (the step a
later change would be tempted by: half the state's bytes). It reads
nothing the program made."""

from __future__ import annotations

import math

import torch


def rigid_inverse(m):
    rt = m[:3, :3].T
    t = -(rt @ m[:3, 3])
    bottom = torch.eye(4, dtype=m.dtype, device=m.device)[3:]
    return torch.cat([torch.cat([rt, t[:, None]], 1), bottom], 0)


def transform(m, x, y, z):
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3])


def div(x, c: float):
    """x / c with c rounded to x's dtype, a true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def voxel_indices(cfg, lin):
    Y, Z = cfg.yres, cfg.zres
    return lin // (Y * Z), (lin // Z) % Y, lin % Z


def centers(cfg, ix, iy, iz, dtype):
    return ((ix.to(dtype) + 0.5) * (cfg.xsize / cfg.xres) - cfg.xsize / 2,
            (iy.to(dtype) + 0.5) * (cfg.ysize / cfg.yres) - cfg.ysize / 2,
            (iz.to(dtype) + 0.5) * (cfg.zsize / cfg.zres) - cfg.zsize / 2)


def pixel(f, hi: int):
    return torch.trunc(torch.clamp(f, -2.0, hi + 1.0)).to(torch.int32)


def coarse_levels(cfg) -> int:
    desired = max(cfg.xsize / cfg.max_cell_size_x, cfg.ysize / cfg.max_cell_size_y,
                  cfg.zsize / cfg.max_cell_size_z)
    return 0 if int(desired) <= 1 else int(math.ceil(math.log(int(desired)) / math.log(2)))


def frustum_ok(cfg, pose_inv, ix, iy, iz):
    """The coarse cell of each voxel has its centre inside the padded
    frustum (tsdf_volume_octree.cpp:619-652)."""
    n = 1 << coarse_levels(cfg)
    g = [torch.div(i * n, r, rounding_mode="floor") for i, r in
         ((ix, cfg.xres), (iy, cfg.yres), (iz, cfg.zres))]
    ccx = (g[0].to(torch.float32) + 0.5) * (cfg.xsize / n) - cfg.xsize / 2
    ccy = (g[1].to(torch.float32) + 0.5) * (cfg.ysize / n) - cfg.ysize / 2
    ccz = (g[2].to(torch.float32) + 0.5) * (cfg.zsize / n) - cfg.zsize / 2
    cx, cy, cz = transform(pose_inv, ccx, ccy, ccz)
    tan_h = math.tan(1.1 * math.atan(0.5 * cfg.image_width / cfg.focal_length_x))
    tan_v = math.tan(1.1 * math.atan(0.5 * cfg.image_height / cfg.focal_length_y))
    return ((cz >= cfg.min_sensor_dist) & (cz <= cfg.max_sensor_dist)
            & (torch.abs(cx) <= tan_h * cz) & (torch.abs(cy) <= tan_v * cz))


def observe(cfg, depth, pose, rgb, lin):
    """One frame's observation of the voxels ``lin``: (d_new [V], valid [V]
    bool, rgb [V, 3] truncated), float32."""
    dtype = torch.float32
    depth, pose = depth.to(dtype), pose.to(dtype)
    pose_inv = rigid_inverse(pose)
    ix, iy, iz = voxel_indices(cfg, lin)
    x, y, z = transform(pose_inv, *centers(cfg, ix, iy, iz, dtype))
    in_range = (z >= cfg.min_sensor_dist) & (z <= cfg.max_sensor_dist)
    u = pixel(x * cfg.focal_length_x / z + cfg.principal_point_x, cfg.image_width)
    v = pixel(y * cfg.focal_length_y / z + cfg.principal_point_y, cfg.image_height)
    proj = (z > 0) & (u >= 0) & (u < cfg.image_width) & (v >= 0) & (v < cfg.image_height)
    H, W = depth.shape
    vi = torch.clamp(v, 0, H - 1).long()
    ui = torch.clamp(u, 0, W - 1).long()
    reading = depth[vi, ui]
    valid = in_range & proj & ~torch.isnan(reading)
    d_new = reading - z
    valid = valid & (d_new >= -cfg.max_dist_neg)
    d_new = div(torch.clamp(d_new, max=cfg.max_dist_pos), cfg.max_dist_neg)
    if cfg.frustum_culling:
        valid = valid & frustum_ok(cfg, pose_inv, ix, iy, iz)
    color = torch.trunc(rgb.to(dtype))[vi, ui]
    return d_new, valid, color


def check_supported(cfg) -> None:
    if cfg.weight_by_depth or cfg.weight_by_variance or cfg.num_random_splits != 1:
        raise ValueError("the reference fuses with unit weights and no random splits")
    if cfg.integrate_color and cfg.color_mode != "RGB":
        raise ValueError("the reference fuses RGB color only")


class Fused:
    """The reference state of the voxels ``lin``: sdf, weight, nsample and
    (with color) color [V, 3]."""

    def __init__(self, sdf, weight, nsample, color):
        self.sdf, self.weight, self.nsample, self.color = sdf, weight, nsample, color


def fuse(cfg, frames: dict, start: int, n_frames: int, lin,
         dtype=torch.float32) -> Fused:
    """Fuse frames k = 0 .. n_frames-1 (distinct frame (start + k) mod F)
    into the voxels ``lin``, from the empty state (sdf -1, weight 0)."""
    check_supported(cfg)
    color_on = cfg.integrate_color
    depths, poses, rgbs = frames["depths"], frames["poses"], frames["rgbs"]
    F, V, dev = depths.shape[0], lin.shape[0], lin.device
    obs = [observe(cfg, depths[f], poses[f], rgbs[f], lin) for f in range(F)]
    D = torch.stack([o[0] for o in obs]).to(dtype)
    OK = torch.stack([o[1] for o in obs])
    C = torch.stack([o[2] for o in obs]).to(dtype) if color_on else None
    del obs
    sdf = torch.full((V,), -1.0, dtype=dtype, device=dev)
    weight = torch.zeros((V,), dtype=dtype, device=dev)
    nsample = torch.zeros((V,), dtype=torch.int32, device=dev)
    color = torch.zeros((V, 3), dtype=dtype, device=dev) if color_on else None
    one = torch.ones((), dtype=dtype, device=dev)
    for k in range(n_frames):
        f = (start + k) % F
        ok, dn = OK[f], D[f]
        wsum = weight + one
        d_upd = (sdf * weight + dn) / wsum
        if color_on:
            c_upd = torch.trunc((weight[:, None] * color + C[f]) / wsum[:, None])
            color = torch.where(ok[:, None], c_upd, color)
        sdf = torch.where(ok, d_upd, sdf)
        weight = torch.where(ok, torch.clamp(wsum, max=cfg.max_weight), weight)
        nsample = nsample + ok.to(torch.int32)
    return Fused(sdf, weight, nsample, color)
