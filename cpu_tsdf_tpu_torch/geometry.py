"""Grid geometry on torch tensors: world <-> voxel index math, projection,
frustum tests.

Port of ``cpu_tsdf_tpu.geometry``. Every function is elementwise over
leading batch dims and runs on the device of its tensor arguments.
Conventions (cpu_tsdf/src/lib/tsdf_volume_octree.cpp:553-617):
  * the volume is centered at the world origin; voxel (i,j,k) has center
    ((i+0.5)*cell - size/2) per axis;
  * pixel coordinates: u = x*fx/z + cx truncated toward zero (C++ int cast).

Float constants are computed as Python doubles and rounded to float32 once,
as the JAX package does, so pixel indices match it bit for bit.
"""

from __future__ import annotations

import math

import torch

from .config import TSDFConfig


def div_const(x, c: float):
    """x / c with c rounded to x's dtype and a true division on every
    device (a Python scalar divisor becomes a reciprocal multiply in
    PyTorch's CUDA kernels, one ulp off the JAX package and the CUDA
    kernels of this package)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def voxel_center(cfg: TSDFConfig, ix, iy, iz):
    """Center of voxel (ix,iy,iz) in the volume frame (float tensors in)."""
    cx, cy, cz = cfg.cell_size
    x = (ix + 0.5) * cx - cfg.xsize / 2.0
    y = (iy + 0.5) * cy - cfg.ysize / 2.0
    z = (iz + 0.5) * cz - cfg.zsize / 2.0
    return x, y, z


def voxel_index(cfg: TSDFConfig, x, y, z):
    """floor() voxel index of a point, plus the in-bounds mask.
    ``floor((x + size/2) / size * res)``, op by op, as the ray-march kernel
    computes it."""
    ix = torch.floor(div_const(x + cfg.xsize / 2.0, cfg.xsize) * cfg.xres).to(torch.int32)
    iy = torch.floor(div_const(y + cfg.ysize / 2.0, cfg.ysize) * cfg.yres).to(torch.int32)
    iz = torch.floor(div_const(z + cfg.zsize / 2.0, cfg.zsize) * cfg.zres).to(torch.int32)
    valid = ((ix >= 0) & (iy >= 0) & (iz >= 0)
             & (ix < cfg.xres) & (iy < cfg.yres) & (iz < cfg.zres))
    return ix, iy, iz, valid


def in_volume(cfg: TSDFConfig, x, y, z):
    """Bounds test of Octree::getContainingVoxel (octree.cpp:627-643): NaN z
    is rejected; |coord| > size/2 is outside."""
    return (~torch.isnan(z)
            & (torch.abs(x) <= cfg.xsize / 2.0)
            & (torch.abs(y) <= cfg.ysize / 2.0)
            & (torch.abs(z) <= cfg.zsize / 2.0))


def pixel_index(f, hi: int):
    """trunc(f) as int32, with f first clamped to [-2, hi + 1].

    The clamp keeps the float -> int conversion in range (a voxel near the
    camera plane projects to a huge coordinate, and an out-of-range
    conversion is undefined on the CPU and saturates in CUDA); the
    validity test ``0 <= u < hi`` gives the same answer on the clamped
    value, including u in (-1, 0) -> pixel 0. The fusion kernel applies the
    same clamp."""
    return torch.trunc(torch.clamp(f, -2.0, hi + 1.0)).to(torch.int32)


def reproject_point(cfg: TSDFConfig, x, y, z):
    """Project a camera-frame point to integer pixel coords.

    Replicates tsdf_volume_octree.cpp:611-617 including the C++ float->int
    cast, which truncates toward zero (so u in (-1, 0) maps to pixel 0 and
    still counts as in-bounds)."""
    uf = x * cfg.focal_length_x / z + cfg.principal_point_x
    vf = y * cfg.focal_length_y / z + cfg.principal_point_y
    u = pixel_index(uf, cfg.image_width)
    v = pixel_index(vf, cfg.image_height)
    valid = (z > 0) & (u >= 0) & (u < cfg.image_width) & (v >= 0) & (v < cfg.image_height)
    return u, v, valid


def transform_points(mat4, x, y, z):
    """Apply a 4x4 (or 3x4) rigid transform to xyz coordinate tensors,
    summed left to right as ``m0*x + m1*y + m2*z + m3``."""
    nx = mat4[0, 0] * x + mat4[0, 1] * y + mat4[0, 2] * z + mat4[0, 3]
    ny = mat4[1, 0] * x + mat4[1, 1] * y + mat4[1, 2] * z + mat4[1, 3]
    nz = mat4[2, 0] * x + mat4[2, 1] * y + mat4[2, 2] * z + mat4[2, 3]
    return nx, ny, nz


def rotate_vectors(mat4, x, y, z):
    """Apply only the rotation part of a 4x4 transform, summed left to
    right as ``m0*x + m1*y + m2*z``."""
    nx = mat4[0, 0] * x + mat4[0, 1] * y + mat4[0, 2] * z
    ny = mat4[1, 0] * x + mat4[1, 1] * y + mat4[1, 2] * z
    nz = mat4[2, 0] * x + mat4[2, 1] * y + mat4[2, 2] * z
    return nx, ny, nz


def rigid_inverse(mat4):
    """Analytic inverse of a rigid 4x4 transform: [R^T, -R^T t]
    (differentiable)."""
    Rt = mat4[:3, :3].T
    t = -(Rt @ mat4[:3, 3])
    # made on the device: a row copied from the host would be a host sync
    bottom = torch.eye(4, dtype=mat4.dtype, device=mat4.device)[3:]
    return torch.cat([torch.cat([Rt, t[:, None]], 1), bottom], 0)


def frustum_tans(cfg: TSDFConfig, fov_pad: float = 1.1):
    """(tan_h, tan_v) of the padded field of view. PCL pads the ANGLE:
    fov = fov_pad * 2*atan(0.5*w/f) (tsdf_volume_octree.cpp:641-642)."""
    tan_h = math.tan(fov_pad * math.atan(0.5 * cfg.image_width / cfg.focal_length_x))
    tan_v = math.tan(fov_pad * math.atan(0.5 * cfg.image_height / cfg.focal_length_y))
    return tan_h, tan_v


def frustum_contains(cfg: TSDFConfig, trans_inv, x, y, z, fov_pad: float = 1.1):
    """Frustum test on volume-frame points (pcl::FrustumCulling as set up at
    tsdf_volume_octree.cpp:619-652): FOV = fov_pad * image FOV, near/far =
    sensor bounds. `trans_inv` maps volume frame -> camera frame."""
    cx, cy, cz = transform_points(trans_inv, x, y, z)
    tan_h, tan_v = frustum_tans(cfg, fov_pad)
    return ((cz >= cfg.min_sensor_dist)
            & (cz <= cfg.max_sensor_dist)
            & (torch.abs(cx) <= tan_h * cz)
            & (torch.abs(cy) <= tan_v * cz))
