"""Field queries: trilinear sampling and analytic value/gradient/Hessian.

Port of ``cpu_tsdf_tpu.ops.interpolate`` (the reference's per-point octree
descents):
  * ``interpolateTrilinearly``        tsdf_volume_octree.cpp:486-541
  * ``getFxn/getGradient/getHessian`` tsdf_volume_octree.cpp:654-794 (tent kernel)
  * ``getNeighbors``                  tsdf_volume_octree.cpp:796-828

Every function is elementwise over the query points and differentiable under
torch autograd with respect to the SDF tensor and the points. The
``*_vol`` wrappers take any volume (dense, brick or packed-render) through
``bricks.gather_dw``. Divisions by constants use ``div_const`` so that a
query evaluates the same, op by op, on the CPU, in PyTorch's CUDA kernels and
in the ray-march kernel (csrc/raycast.cu).
"""

from __future__ import annotations

import torch

from ..config import TSDFConfig
from ..geometry import div_const, voxel_center, voxel_index

_CORNERS = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]


def _corner_base(cfg: TSDFConfig, x, y, z, adjusted_bounds: bool = False):
    """The lower corner voxel of the 8-cell interpolation neighbourhood:
    floor index, then one step back along axes where the point lies below
    the voxel centre (cpp:489-501).

    The two reference entry points bound DIFFERENT indices:
      * interpolateTrilinearly (cpp:491) checks the UN-adjusted index
        strictly inside [1, res-2] (adjusted_bounds=False);
      * getNeighbors (cpp:809-811, behind getFxn/getGradient/getHessian)
        checks the ADJUSTED corner base in [0, res-2] (adjusted_bounds=True).
    """
    ix, iy, iz, exists = voxel_index(cfg, x, y, z)
    valid = (exists & (ix > 0) & (ix < cfg.xres - 1) & (iy > 0) & (iy < cfg.yres - 1)
             & (iz > 0) & (iz < cfg.zres - 1))
    cx, cy, cz = voxel_center(cfg, ix, iy, iz)
    ix = torch.where(x < cx, ix - 1, ix)
    iy = torch.where(y < cy, iy - 1, iy)
    iz = torch.where(z < cz, iz - 1, iz)
    if adjusted_bounds:
        valid = (exists & (ix >= 0) & (ix < cfg.xres - 1) & (iy >= 0)
                 & (iy < cfg.yres - 1) & (iz >= 0) & (iz < cfg.zres - 1))
    return ix, iy, iz, valid


def _clipped_base(cfg: TSDFConfig, ix, iy, iz):
    return (torch.clamp(ix, 0, cfg.xres - 2), torch.clamp(iy, 0, cfg.yres - 2),
            torch.clamp(iz, 0, cfg.zres - 2))


def _fractions(cfg: TSDFConfig, x, y, z, ixc, iyc, izc):
    """Position of the point inside the cube, in cells: (x - vx) * res / size."""
    vx, vy, vz = voxel_center(cfg, ixc, iyc, izc)
    return (div_const((x - vx) * cfg.xres, cfg.xsize),
            div_const((y - vy) * cfg.yres, cfg.ysize),
            div_const((z - vz) * cfg.zres, cfg.zsize))


def _gather8(grid, ix, iy, iz, Y: int, Z: int):
    """The 8 cube corners [d000..d111] of a dense [X, Y, Z] grid (flat
    indices clipped to the grid, as jnp.take(mode="clip"))."""
    lin = (ix.long() * Y + iy) * Z + iz
    flat = grid.reshape(-1)
    n = flat.shape[0]
    return [flat[torch.clamp(lin + (dx * Y * Z + dy * Z + dz), 0, n - 1)]
            for dx, dy, dz in _CORNERS]


def _blend(corners, a, b, c):
    """Trilinear sum of the 8 corners in the reference's order:
    d000(1-a)(1-b)(1-c) + d001(1-a)(1-b)c + ... + d111 abc, each term
    ((d * wx) * wy) * wz, summed left to right."""
    val = None
    for d, (dx, dy, dz) in zip(corners, _CORNERS):
        term = d * (a if dx else 1 - a) * (b if dy else 1 - b) * (c if dz else 1 - c)
        val = term if val is None else val + term
    return val


def trilinear(cfg: TSDFConfig, sdf, weight, x, y, z):
    """Trilinearly interpolated TSDF at world points. Returns (value, valid).

    Parity with interpolateTrilinearly (cpp:486-541): the value is computed
    regardless of weight validity; `valid` requires all 8 corner weights > 0
    and interior indices."""
    ix, iy, iz, valid = _corner_base(cfg, x, y, z)
    ixc, iyc, izc = _clipped_base(cfg, ix, iy, iz)
    a, b, c = _fractions(cfg, x, y, z, ixc, iyc, izc)
    ds = _gather8(sdf, ixc, iyc, izc, cfg.yres, cfg.zres)
    for w in _gather8(weight, ixc, iyc, izc, cfg.yres, cfg.zres):
        valid = valid & (w > 0)
    return _blend(ds, a, b, c), valid


def nearest(cfg: TSDFConfig, sdf, weight, x, y, z):
    """Nearest-voxel TSDF lookup (use_trilinear_interpolation=False,
    cpp:466-477). Returns (value, valid) with valid = in bounds and w > 0."""
    ix, iy, iz, exists = voxel_index(cfg, x, y, z)
    lin = ((torch.clamp(ix, 0, cfg.xres - 1).long() * cfg.yres
            + torch.clamp(iy, 0, cfg.yres - 1)) * cfg.zres
           + torch.clamp(iz, 0, cfg.zres - 1))
    d = sdf.reshape(-1)[lin]
    w = weight.reshape(-1)[lin]
    return d, exists & (w > 0)


def tsdf_value(cfg: TSDFConfig, sdf, weight, x, y, z):
    """getTSDFValue dispatch (cpp:453-478)."""
    if cfg.use_trilinear_interpolation:
        return trilinear(cfg, sdf, weight, x, y, z)
    return nearest(cfg, sdf, weight, x, y, z)


def _sgn(v):
    """Reference sgn: x > 0 ? 1 : -1 (cpp:674-678; zero maps to -1)."""
    return torch.where(v > 0, 1.0, -1.0).to(v.dtype)


def _tent(cfg: TSDFConfig, x, y, z, corner_values):
    """Tent-kernel value, gradient and Hessian from the 8 corner values of
    the clipped adjusted base (cpp:756-794)."""
    ix, iy, iz, valid = _corner_base(cfg, x, y, z, adjusted_bounds=True)
    ixc, iyc, izc = _clipped_base(cfg, ix, iy, iz)
    c = cfg.xsize / cfg.xres
    val = gx = gy = gz = hxy = hxz = hyz = torch.zeros_like(x)
    for (dx, dy, dz), d in zip(_CORNERS, corner_values(ixc, iyc, izc)):
        ctr_x, ctr_y, ctr_z = voxel_center(cfg, ixc + dx, iyc + dy, izc + dz)
        rx, ry, rz = x - ctr_x, y - ctr_y, z - ctr_z
        tx, ty, tz = c - torch.abs(rx), c - torch.abs(ry), c - torch.abs(rz)
        val = val + tx * ty * tz * d
        gx = gx + -_sgn(rx) * ty * tz * d
        gy = gy + tx * -_sgn(ry) * tz * d
        gz = gz + tx * ty * -_sgn(rz) * d
        hxy = hxy + _sgn(rx) * _sgn(ry) * tz * d
        hxz = hxz + _sgn(rx) * ty * _sgn(rz) * d
        hyz = hyz + tx * _sgn(ry) * _sgn(rz) * d
    c3 = c ** 3
    zeros = torch.zeros_like(hxy)
    hess = torch.stack([
        torch.stack([zeros, hxy, hxz], -1),
        torch.stack([hxy, zeros, hyz], -1),
        torch.stack([hxz, hyz, zeros], -1),
    ], -2)
    return (div_const(val, c3), div_const(torch.stack([gx, gy, gz], -1), c3),
            div_const(hess, c3), valid)


def fxn_gradient_hessian(cfg: TSDFConfig, sdf, x, y, z):
    """Analytic tent-kernel value, gradient and Hessian of the TSDF field
    (getFxnGradientAndHessian, cpp:756-794): a linear B-spline over the 8
    surrounding voxel centres; the Hessian has only mixed partials. Uses
    the cell size c = xsize/xres on every axis, as the reference does.

    Returns (val, grad [..., 3], hess [..., 3, 3], valid). Weights are not
    consulted, and the bounds check is on the ADJUSTED corner base."""
    return _tent(cfg, x, y, z,
                 lambda ixc, iyc, izc: _gather8(sdf, ixc, iyc, izc, cfg.yres, cfg.zres))


def fxn(cfg: TSDFConfig, sdf, x, y, z):
    """getFxn (cpp:654-672)."""
    val, _, _, valid = fxn_gradient_hessian(cfg, sdf, x, y, z)
    return val, valid


def gradient(cfg: TSDFConfig, sdf, x, y, z):
    """getGradient (cpp:680-700)."""
    _, grad, _, valid = fxn_gradient_hessian(cfg, sdf, x, y, z)
    return grad, valid


def hessian(cfg: TSDFConfig, sdf, x, y, z):
    """getHessian (cpp:702-725)."""
    _, _, hess, valid = fxn_gradient_hessian(cfg, sdf, x, y, z)
    return hess, valid


# ---------------------------------------------------------------------------
# volume-level API: dense TSDFVolume, BrickVolume and PackedRenderVolume
# through the uniform gather in bricks.gather_dw
# ---------------------------------------------------------------------------

def trilinear_vol(vol, x, y, z):
    """Trilinear interpolation over any volume representation; the sum
    runs over dx, dy, dz in that loop order (the ray-march kernel keeps it)."""
    from ..bricks import gather_dw

    cfg = vol.config
    ix, iy, iz, valid = _corner_base(cfg, x, y, z)
    ixc, iyc, izc = _clipped_base(cfg, ix, iy, iz)
    a, b, c = _fractions(cfg, x, y, z, ixc, iyc, izc)
    corners = []
    for dx, dy, dz in _CORNERS:
        d, w = gather_dw(vol, ixc + dx, iyc + dy, izc + dz)
        valid = valid & (w > 0)
        corners.append(d)
    return _blend(corners, a, b, c), valid


def nearest_vol(vol, x, y, z):
    from ..bricks import gather_dw

    ix, iy, iz, exists = voxel_index(vol.config, x, y, z)
    d, w = gather_dw(vol, ix, iy, iz)
    return d, exists & (w > 0)


def tsdf_value_vol(vol, x, y, z):
    """getTSDFValue dispatch (cpp:453-478) over any volume type."""
    if vol.config.use_trilinear_interpolation:
        return trilinear_vol(vol, x, y, z)
    return nearest_vol(vol, x, y, z)


def fxn_gradient_hessian_vol(vol, x, y, z):
    """Tent-kernel value/gradient/Hessian over any volume representation."""
    from ..bricks import gather_dw

    return _tent(vol.config, x, y, z, lambda ixc, iyc, izc: [
        gather_dw(vol, ixc + dx, iyc + dy, izc + dz)[0] for dx, dy, dz in _CORNERS])


def fxn_autodiff_gradient(cfg: TSDFConfig, sdf, x, y, z):
    """Gradient of the tent-kernel value by torch.autograd, to cross-check
    the analytic form (SURVEY §3.5)."""
    pts = torch.stack([x, y, z], -1).detach().requires_grad_(True)
    with torch.enable_grad():
        v, *_ = fxn_gradient_hessian(cfg, sdf.detach(), pts[..., 0], pts[..., 1],
                                     pts[..., 2])
        (g,) = torch.autograd.grad(v.sum(), pts)
    return g
