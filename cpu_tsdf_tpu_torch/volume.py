"""The dense TSDF volume: a struct of [xres, yres, zres] tensors.

Port of ``cpu_tsdf_tpu.volume``. Channel semantics per voxel
(cpu_tsdf/include/cpu_tsdf/octree.h:163-170):
  * ``sdf``     normalized TSDF, init -1 ("unseen")
  * ``weight``  accumulated fusion weight, init 0
  * ``M``       Welford-style M2 accumulator
  * ``nsample`` observation count
  * ``color``   mode-dependent channels: RGB -> 3 (uint8 values as f32),
    RGBNormalized -> 4 (r_n, g_n, b_n, intensity), LAB -> 3
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import (
    COLOR_MODE_LAB,
    COLOR_MODE_NONE,
    COLOR_MODE_RGB,
    COLOR_MODE_RGB_NORMALIZED,
    TSDFConfig,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point allocates on: CUDA unless the caller names
    another. There is no fallback: without a card, the default raises when
    the first tensor is made."""
    return torch.device("cuda" if device is None else device)


def resolve_use_kernel(use_kernel: Optional[bool], device: torch.device) -> bool:
    """The route an entry point takes on tensors of `device`: None -> the
    CUDA kernels on the card and the plain versions on the CPU; True on
    the CPU raises (the kernels run only on the card)."""
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError("use_kernel=True needs tensors on a CUDA device")
    return bool(use_kernel)


def color_channels(cfg: TSDFConfig) -> int:
    if not cfg.integrate_color or cfg.color_mode == COLOR_MODE_NONE:
        return 0
    return {COLOR_MODE_RGB: 3, COLOR_MODE_RGB_NORMALIZED: 4, COLOR_MODE_LAB: 3}[cfg.color_mode]


@dataclasses.dataclass
class TSDFVolume:
    """Dense TSDF volume state. Tensors are [xres, yres, zres(, C)]."""

    sdf: torch.Tensor
    weight: torch.Tensor
    M: torch.Tensor
    nsample: torch.Tensor
    color: Optional[torch.Tensor]
    # 4x4 volume->world transform (tsdf_interface.h global transform).
    global_transform: torch.Tensor
    config: TSDFConfig

    @property
    def shape(self):
        return tuple(self.sdf.shape)

    @property
    def device(self) -> torch.device:
        return self.sdf.device

    def is_empty(self) -> bool:
        """True iff nothing was ever integrated."""
        return bool(self.nsample.sum() == 0)


def make_volume(cfg: TSDFConfig, dtype=torch.float32, device=None) -> TSDFVolume:
    """Allocate + reset a volume: d=-1, w=0 everywhere
    (TSDFVolumeOctree::reset, tsdf_volume_octree.cpp:200-219)."""
    dev = resolve_device(device)
    shape = (cfg.xres, cfg.yres, cfg.zres)
    nc = color_channels(cfg)
    return TSDFVolume(
        sdf=torch.full(shape, -1.0, dtype=dtype, device=dev),
        weight=torch.zeros(shape, dtype=dtype, device=dev),
        M=torch.zeros(shape, dtype=dtype, device=dev),
        nsample=torch.zeros(shape, dtype=torch.int32, device=dev),
        color=(torch.zeros(shape + (nc,), dtype=dtype, device=dev) if nc else None),
        global_transform=torch.eye(4, dtype=torch.float32, device=dev),
        config=cfg,
    )


def reset(vol: TSDFVolume) -> TSDFVolume:
    """Reinitialize the fields; the global transform survives, as in
    TSDFVolumeOctree::reset."""
    fresh = make_volume(vol.config, dtype=vol.sdf.dtype, device=vol.device)
    return dataclasses.replace(fresh, global_transform=vol.global_transform)


def voxel_centers_grid(cfg: TSDFConfig, device=None):
    """All voxel centers, [xres, yres, zres] per axis."""
    from .geometry import voxel_center

    dev = resolve_device(device)
    ix = torch.arange(cfg.xres, dtype=torch.float32, device=dev)[:, None, None]
    iy = torch.arange(cfg.yres, dtype=torch.float32, device=dev)[None, :, None]
    iz = torch.arange(cfg.zres, dtype=torch.float32, device=dev)[None, None, :]
    x, y, z = voxel_center(cfg, ix, iy, iz)
    shape = (cfg.xres, cfg.yres, cfg.zres)
    return x.expand(shape), y.expand(shape), z.expand(shape)
