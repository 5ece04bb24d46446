"""Brick activation on the card: the CUDA kernels of ``csrc/activation.cu``.

The same three functions as the plain code of ``activation`` (the depth
mips, the band candidate list, the carve list), each a few kernel launches
on the current stream with no host sync, so that the frame's CUDA graph
captures the stage as a handful of nodes. They give the plain version's
tables, lists, counts and overflow flags bit for bit; ``activation``'s
entry points dispatch here with ``kernel=True``, and raise there on CPU
tensors (the kernels have no CPU mode).

The constants are computed here from the config as the plain version
computes them, in Python doubles, and rounded to float32 once by ctypes, as
PyTorch rounds a Python scalar for a float32 tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import tracing
from ..activation import (DepthMips, _band_margins, _cone_tans, _tile_grid,
                          mip_shapes)
from ..config import TSDFConfig

# Kernel launches since the last reset (plain runs not counted), one
# counter a kernel of csrc/activation.cu.
launches = tracing.counters("activation_kernel.launches", {
    "mip_base": 0, "mip_levels": 0, "tiles": 0, "bricks": 0, "band_list": 0,
    "carve": 0, "carve_list": 0})

MAX_LEVELS = 32


class MipLayout(ctypes.Structure):
    """Mirror of ``struct MipLayout`` in csrc/activation.cu."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "width", "height", "base_level", "n_levels", "n_texels", "cell_h_shift",
        "cell_w_shift")]
        + [(n, ctypes.c_int * MAX_LEVELS) for n in ("offsets", "widths", "heights")])


class ActParams(ctypes.Structure):
    """Mirror of ``struct ActParams`` in csrc/activation.cu."""

    _fields_ = ([(n, ctypes.c_float) for n in (
        "fx", "fy", "pcx", "pcy", "width_f", "height_f", "u_clip", "v_clip",
        "tan_h", "tan_v", "m_lo", "m_hi", "min_dist", "max_dist", "z_eps_lo",
        "z_eps_hi", "half_x", "half_y", "half_z", "size_x", "size_y", "size_z",
        "tile_x", "tile_y", "tile_z", "brick_x", "brick_y", "brick_z",
        "carve_half_x", "carve_half_y", "carve_half_z", "carve_r")]
        + [(n, ctypes.c_int) for n in (
            "nbx", "nby", "nbz", "tb_shift", "ntx", "nty", "ntz", "tile_first",
            "n_tiles", "tile_budget", "slab_lo", "slab_hi", "rough_budget",
            "update_budget")])


def mip_layout(H: int, W: int, base_level: int) -> MipLayout:
    """The packed pyramid of ``activation.depth_mips`` over an [H, W] image
    from ``base_level`` up: each level's offset, width and height."""
    shapes = mip_shapes(H, W)
    base = min(base_level, len(shapes) - 1)
    Hp, Wp = shapes[0]
    levels = shapes[base:]
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"depth_mips: {len(levels)} levels, the kernels take {MAX_LEVELS}")
    L = MipLayout(width=W, height=H, base_level=base, n_levels=len(levels),
                  cell_h_shift=(Hp // levels[0][0]).bit_length() - 1,
                  cell_w_shift=(Wp // levels[0][1]).bit_length() - 1)
    off = 0
    for k, (h, w) in enumerate(levels):
        L.offsets[k], L.widths[k], L.heights[k] = off, w, h
        off += h * w
    L.n_texels = off
    return L


def act_params(cfg: TSDFConfig, B: int, nb, update_budget: int = 0, tile_budget: int = 0,
               x_slab=None) -> ActParams:
    """The kernels' constants for bricks of B^3 on a grid of nb bricks: the
    float32 rounding of each Python double the plain version computes, and
    the tile grid and budgets of ``activation._tile_grid``."""
    csx, csy, csz = cfg.cell_size
    m_lo, m_hi = _band_margins(cfg)
    tan_h, tan_v = _cone_tans(cfg)
    W, H = cfg.image_width, cfg.image_height
    nbx, nby, nbz = nb
    TB, (ntx, nty, ntz), tile_first, n_tiles, tile_budget, U2 = _tile_grid(
        nb, update_budget, tile_budget, x_slab)
    slab_lo, slab_hi = (0, nbx) if x_slab is None else (x_slab[0], x_slab[0] + x_slab[1])
    return ActParams(
        cfg.focal_length_x, cfg.focal_length_y, cfg.principal_point_x, cfg.principal_point_y,
        W, H, W + 4.0, H + 4.0, tan_h, tan_v, m_lo, m_hi,
        cfg.min_sensor_dist, cfg.max_sensor_dist, 1e-3, 2e-3,
        cfg.xsize / 2, cfg.ysize / 2, cfg.zsize / 2, cfg.xsize, cfg.ysize, cfg.zsize,
        TB * B * csx, TB * B * csy, TB * B * csz, B * csx, B * csy, B * csz,
        0.5 * B * csx, 0.5 * B * csy, 0.5 * B * csz,
        0.5 * float(np.sqrt((B * csx) ** 2 + (B * csy) ** 2 + (B * csz) ** 2)),
        nbx, nby, nbz, TB.bit_length() - 1, ntx, nty, ntz, tile_first, n_tiles,
        tile_budget, slab_lo, slab_hi, U2, update_budget)


def _require_cuda(what: str, t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the activation kernels need tensors on a CUDA device "
                         f"(got {t.device}); the plain route is kernel=False")


def _tables(what: str, cfg: TSDFConfig, mips: DepthMips):
    """The mips' layout and its four tables' pointers, checked."""
    from .._build import check_tensor

    L = mip_layout(cfg.image_height, cfg.image_width, mips.base_level)
    dev = mips.flat_min.device
    for name in ("flat_min", "flat_max", "flat_min_d", "flat_max_d"):
        check_tensor(f"{what}: mips.{name}", getattr(mips, name), torch.float32,
                     (L.n_texels,), dev)
    if mips.n_levels != L.n_levels:
        raise ValueError(f"{what}: mips of {mips.n_levels} levels, the config's image "
                         f"gives {L.n_levels}")
    return L, [getattr(mips, n).data_ptr()
               for n in ("flat_min", "flat_max", "flat_min_d", "flat_max_d")]


def depth_mips(depth, base_level: int = 0) -> DepthMips:
    """``activation.depth_mips`` in two launches (the base level, then one
    block for the levels above, the dilated tables and the level table)."""
    from .._build import check, check_tensor, function, stream_ptr

    _require_cuda("depth_mips", depth)
    dev = depth.device
    H, W = depth.shape
    depth = depth.contiguous()
    check_tensor("depth_mips: depth", depth, torch.float32, (H, W), dev)
    L = mip_layout(H, W, base_level)
    tables = torch.empty((4, L.n_texels), dtype=torch.float32, device=dev)
    levels = torch.empty((2, L.n_levels), dtype=torch.int32, device=dev)
    fn = function("activation", "tsdf_depth_mips",
                  [ctypes.POINTER(MipLayout)] + [ctypes.c_void_p] * 4)
    check(fn(ctypes.byref(L), depth.data_ptr(), tables.data_ptr(), levels.data_ptr(),
             stream_ptr(dev)), "depth_mips")
    launches["mip_base"] += 1
    launches["mip_levels"] += 1
    return DepthMips(flat_min=tables[0], flat_max=tables[1], flat_min_d=tables[2],
                     flat_max_d=tables[3], offsets=levels[0], widths=levels[1],
                     n_levels=L.n_levels, global_min=tables[0, -1], global_max=tables[1, -1],
                     base_level=L.base_level)


def band_candidate_bricks(cfg: TSDFConfig, B: int, nb, mips: DepthMips, pose_inv,
                          update_budget: int, tile_budget: int = 1024, x_slab=None):
    """``activation.band_candidate_bricks`` in three launches (the tile
    bits, the brick bits, the list): (cand [update_budget] int32, counts
    [3] int32, overflow)."""
    from .._build import check, check_tensor, function, stream_ptr

    what = "band_candidate_bricks"
    _require_cuda(what, pose_inv)
    dev = pose_inv.device
    pose_inv = pose_inv.contiguous()
    check_tensor(f"{what}: pose_inv", pose_inv, torch.float32, (4, 4), dev)
    L, tables = _tables(what, cfg, mips)
    p = act_params(cfg, B, nb, update_budget, tile_budget, x_slab)
    n_tile_words = -(-p.n_tiles // 32)
    n_items = p.tile_budget << (3 * p.tb_shift)
    n_item_words = n_items // 32
    scratch = torch.empty((n_tile_words + p.tile_budget + 2 * n_item_words,),
                          dtype=torch.int32, device=dev)
    out = torch.empty((update_budget + 3,), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    fn = function("activation", "tsdf_band_candidates",
                  [ctypes.POINTER(MipLayout), ctypes.POINTER(ActParams)] + [ctypes.c_void_p] * 9)
    err = fn(ctypes.byref(L), ctypes.byref(p), *tables, pose_inv.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), overflow.data_ptr(), stream_ptr(dev))
    if err == -1:
        raise ValueError(f"{what}: {p.n_tiles} tiles, more than the kernels' tile bits hold "
                         "(kMaxTileWords in csrc/activation.cu)")
    check(err, what)
    # the launcher skips a kernel with nothing to test
    launches["tiles"] += p.n_tiles > 0
    launches["bricks"] += n_items > 0
    launches["band_list"] += 1
    return out[:update_budget], out[update_budget:], overflow


def carve_slots(cfg: TSDFConfig, B: int, mips: DepthMips, pose_inv, coords,
                carve_budget: int):
    """``activation.carve_slots`` in two launches (the slot bits, the
    list): (slots [carve_budget] int32, n_carve)."""
    from .._build import check, check_tensor, function, stream_ptr

    what = "carve_slots"
    _require_cuda(what, pose_inv)
    dev = pose_inv.device
    pose_inv = pose_inv.contiguous()
    C = coords.shape[0]
    check_tensor(f"{what}: pose_inv", pose_inv, torch.float32, (4, 4), dev)
    check_tensor(f"{what}: coords", coords, torch.int32, (C, 3), dev)
    L, tables = _tables(what, cfg, mips)
    p = act_params(cfg, B, (cfg.xres // B, cfg.yres // B, cfg.zres // B))
    words = torch.empty((-(-C // 32),), dtype=torch.int32, device=dev)
    out = torch.empty((carve_budget + 1,), dtype=torch.int32, device=dev)
    fn = function("activation", "tsdf_carve_slots",
                  [ctypes.POINTER(MipLayout), ctypes.POINTER(ActParams)]
                  + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    check(fn(ctypes.byref(L), ctypes.byref(p), *tables, pose_inv.data_ptr(), coords.data_ptr(),
             C, carve_budget, words.data_ptr(), out.data_ptr(), stream_ptr(dev)), what)
    launches["carve"] += C > 0     # the launcher skips it for no slots
    launches["carve_list"] += 1
    return out[:carve_budget], out[carve_budget]
