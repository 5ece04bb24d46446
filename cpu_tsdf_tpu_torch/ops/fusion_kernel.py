"""Brick fusion: the CUDA kernel (``csrc/fusion.cu``) and its plain version.

:func:`fuse_bricks` fuses one depth frame into the rows of a brick volume
named by an update list, IN PLACE (the JAX package donated the volume's
buffers; here the tensors themselves are updated). It replaces the TPU
kernel ``cpu_tsdf_tpu/ops/pallas_fusion.py::_kernel_inplace``. On a CPU
tensor it runs :func:`fuse_bricks_plain`, the plain engine that is the
contract of the kernel (the JAX package's ``xla_update`` branch of
``bricks.fuse_brick_batch``); on a CUDA tensor it launches the kernel.

The update list ``rows`` is int32 [K, 4]: the brick coordinates (bx, by,
bz) and the slot of each row, with slot -1 for a row that names no brick.
State rows are [C, 512] (8^3 bricks, the voxel order (lx*8+ly)*8+lz).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import TSDFConfig
from ..geometry import frustum_tans
from .fusion import (coarse_cell_frustum, compute_observation, fuse_observation,
                     gather_image, variance_weight)

# Aux channels written per row and voxel when color is fused:
# observed r, g, b; the effective weight (-1 = no observation); the
# pre-update weight, which the color transform averages against.
AUX_CHANNELS = 5

# Kernel launches since the last reset (plain runs not counted).
launches = {"fusion": 0}


class FusionParams(ctypes.Structure):
    """Mirror of ``struct FusionParams`` in csrc/fusion.cu."""

    _fields_ = ([(n, ctypes.c_float) for n in (
        "cell_x", "cell_y", "cell_z", "half_x", "half_y", "half_z",
        "coarse_x", "coarse_y", "coarse_z", "fx", "fy", "pcx", "pcy",
        "min_dist", "max_dist", "max_dist_pos", "max_dist_neg", "max_weight",
        "tan_h", "tan_v")]
        + [(n, ctypes.c_int) for n in (
            "xres", "yres", "zres", "n_coarse", "width", "height",
            "frustum_culling", "weight_by_depth", "weight_by_variance")])


def fusion_params(cfg: TSDFConfig) -> FusionParams:
    """The kernel's constants, each the float32 rounding (done by ctypes) of
    the Python double the plain engine computes."""
    n = 1 << cfg.num_coarse_levels
    tan_h, tan_v = frustum_tans(cfg)
    return FusionParams(
        cfg.xsize / cfg.xres, cfg.ysize / cfg.yres, cfg.zsize / cfg.zres,
        cfg.xsize / 2, cfg.ysize / 2, cfg.zsize / 2,
        cfg.xsize / n, cfg.ysize / n, cfg.zsize / n,
        cfg.focal_length_x, cfg.focal_length_y,
        cfg.principal_point_x, cfg.principal_point_y,
        cfg.min_sensor_dist, cfg.max_sensor_dist,
        cfg.max_dist_pos, cfg.max_dist_neg, cfg.max_weight, tan_h, tan_v,
        cfg.xres, cfg.yres, cfg.zres, n, cfg.image_width, cfg.image_height,
        int(cfg.frustum_culling), int(cfg.weight_by_depth),
        int(cfg.weight_by_variance))


def _voxel_centers(cfg: TSDFConfig, rows, B: int):
    """Voxel indices and centers [K, B^3] of the update list's bricks."""
    lid = torch.arange(B ** 3, dtype=torch.int32, device=rows.device)
    vx = rows[:, 0:1] * B + (lid // (B * B))[None]
    vy = rows[:, 1:2] * B + ((lid // B) % B)[None]
    vz = rows[:, 2:3] * B + (lid % B)[None]
    cx = (vx.to(torch.float32) + 0.5) * (cfg.xsize / cfg.xres) - cfg.xsize / 2
    cy = (vy.to(torch.float32) + 0.5) * (cfg.ysize / cfg.yres) - cfg.ysize / 2
    cz = (vz.to(torch.float32) + 0.5) * (cfg.zsize / cfg.zres) - cfg.zsize / 2
    return (vx, vy, vz), (cx, cy, cz)


def fuse_bricks_plain(cfg: TSDFConfig, rows, pose_inv, depth, sdf, weight, M,
                      nsample, rgb=None) -> Optional[torch.Tensor]:
    """Plain PyTorch version of the fusion kernel; same arguments, same
    in-place effect, same aux output ([K, 5, V] with color, else None).

    Rows without a slot read and rewrite the dump row C-1 unchanged (their
    voxels are all invalid), which keeps the scatter free of a host sync."""
    C, V = sdf.shape
    B = round(V ** (1 / 3))
    slot_ok = rows[:, 3] >= 0
    dst = torch.where(slot_ok, rows[:, 3], C - 1).long()
    (vx, vy, vz), (cx, cy, cz) = _voxel_centers(cfg, rows, B)
    d0, w0, M0, n0 = sdf[dst], weight[dst], M[dst], nsample[dst]
    d_obs, w_obs, valid, _, u, v = compute_observation(cfg, depth, pose_inv, cx, cy, cz)
    if cfg.frustum_culling:
        valid = valid & coarse_cell_frustum(cfg, pose_inv, vx, vy, vz)
    valid = valid & slot_ok[:, None]
    w_eff = variance_weight(cfg, w_obs, d_obs, d0, w0, M0, n0)
    du, wu, Mu, nu = fuse_observation(d0, w0, M0, n0, d_obs, w_eff, cfg.max_weight)
    sdf.index_copy_(0, dst, torch.where(valid, du, d0))
    weight.index_copy_(0, dst, torch.where(valid, wu, w0))
    M.index_copy_(0, dst, torch.where(valid, Mu, M0))
    nsample.index_copy_(0, dst, torch.where(valid, nu, n0))
    if rgb is None:
        return None
    zero = torch.zeros_like(w_eff)
    obs = [torch.where(valid, gather_image(rgb[..., c], v, u), zero) for c in range(3)]
    return torch.stack(obs + [torch.where(valid, w_eff, zero - 1.0), w0], 1)


def fuse_bricks(cfg: TSDFConfig, rows, pose_inv, depth, sdf, weight, M, nsample,
                rgb=None) -> Optional[torch.Tensor]:
    """Fuse one frame into the rows of the update list, in place.

    rows int32 [K, 4] (bx, by, bz, slot or -1); pose_inv float32 [4, 4]
    (volume -> camera); depth float32 [H, W] (NaN = missing); rgb float32
    [H, W, 3], already truncated, or None; sdf/weight/M float32 and nsample
    int32, all [C, 512]. Returns the aux tensor [K, 5, 512] when rgb is
    given (rows without a slot leave theirs unwritten), else None.

    On CPU tensors this is :func:`fuse_bricks_plain`; on CUDA tensors it
    launches csrc/fusion.cu and raises on anything the kernel does not
    take."""
    if sdf.device.type == "cpu":
        return fuse_bricks_plain(cfg, rows, pose_inv, depth, sdf, weight, M,
                                 nsample, rgb)
    from .._build import check, check_tensor, function, stream_ptr

    dev = sdf.device
    C = sdf.shape[0]
    H, W = cfg.image_height, cfg.image_width
    for what, t, dt, shape in (
            ("rows", rows, torch.int32, (rows.shape[0], 4)),
            ("pose_inv", pose_inv, torch.float32, (4, 4)),
            ("depth", depth, torch.float32, (H, W)),
            ("sdf", sdf, torch.float32, (C, 512)),
            ("weight", weight, torch.float32, (C, 512)),
            ("M", M, torch.float32, (C, 512)),
            ("nsample", nsample, torch.int32, (C, 512)),
            ("rgb", rgb, torch.float32, (H, W, 3))):
        if t is not None:
            check_tensor(f"fuse_bricks: {what}", t, dt, shape, dev)
    if rows.data_ptr() % 16:
        raise ValueError("fuse_bricks: rows must be 16-byte aligned (read as int4)")
    K = rows.shape[0]
    pose12 = pose_inv[:3].contiguous()
    aux = (torch.empty((K, AUX_CHANNELS, 512), dtype=torch.float32, device=dev)
           if rgb is not None else None)
    fn = function("fusion", "tsdf_fuse_bricks",
                  [ctypes.POINTER(FusionParams), ctypes.c_void_p, ctypes.c_int]
                  + [ctypes.c_void_p] * 9)
    params = fusion_params(cfg)
    err = fn(ctypes.byref(params), rows.data_ptr(), K, pose12.data_ptr(),
             depth.data_ptr(), None if rgb is None else rgb.data_ptr(),
             sdf.data_ptr(), weight.data_ptr(), M.data_ptr(), nsample.data_ptr(),
             None if aux is None else aux.data_ptr(), stream_ptr(dev))
    check(err, "fuse_bricks")
    launches["fusion"] += 1
    return aux


# Aux words per voxel that the color update needs at the least: the
# observation packed into one word and the effective weight, as the TPU
# kernel wrote them (its pre-update weights came from the old buffer). This
# kernel writes AUX_CHANNELS words instead.
LEAST_AUX_WORDS = 2


def bytes_moved(n_live_rows: int, H: int, W: int, color: bool,
                aux_words: int = LEAST_AUX_WORDS) -> int:
    """Device-memory traffic of one fuse_bricks call: each live row's 4
    state fields read and written once (16 KiB), the depth image read once,
    and with color the rgb image read once and `aux_words` words written per
    voxel of each live row. The default counts the least the color update
    needs; aux_words=0 is the state-and-images count alone, AUX_CHANNELS
    what this kernel writes."""
    b = n_live_rows * 512 * 4 * 4 * 2 + H * W * 4
    if color:
        b += H * W * 3 * 4 + n_live_rows * 512 * aux_words * 4
    return b


# Float32 operations per voxel of a live row (projection, frustum test,
# observation, weighted average, Welford update), counted from the kernel.
OPS_PER_VOXEL = 60

