"""The least work of one fusion of a frame, counted from the inputs (the
depth image, the pose, and which voxels the volume holds), whatever fuses
it: every voxel the frame observes is read and written once (its sdf,
weight, M and nsample, 32 B; with color its channels, 8 B each), the depth
image (and the rgb image) read once; each voxel that must be tested is
projected, and each observed one updated.

Rewritten from ``cpu_tsdf_tpu_torch/ops/fusion_kernel.py`` (``voxel_bytes``,
``ops_needed``); the operation counts per voxel were counted there from
``csrc/fusion.cu``."""

from __future__ import annotations

import torch

from portbench.reference.fusion import observe

PROJECT_OPS = 42       # the voxel centre, the pose, the pixel, the range tests
FRUSTUM_OPS = 35       # the coarse cell's frustum test
UPDATE_OPS = 19        # the observation, weighted average, Welford update
COLOR_OPS = {"RGB": 15, "RGBNormalized": 25, "LAB": 72}


def frame_bytes(n_observed: int, H: int, W: int, nc: int) -> int:
    b = n_observed * 4 * 4 * 2 + H * W * 4
    if nc:
        b += n_observed * nc * 4 * 2 + H * W * 3 * 4
    return b


def frame_ops(cfg, n_tested: int, n_observed: int) -> int:
    per_test = PROJECT_OPS + (FRUSTUM_OPS if cfg.frustum_culling else 0)
    per_obs = UPDATE_OPS + (COLOR_OPS.get(cfg.color_mode, 0) if cfg.integrate_color else 0)
    return n_tested * per_test + n_observed * per_obs


def observed(cfg, frames: dict, f: int, lin) -> int:
    """Voxels among ``lin`` that distinct frame f observes."""
    return int(observe(cfg, frames["depths"][f], frames["poses"][f], frames["rgbs"][f],
                       lin)[1].sum())


def brick_voxels(cfg, coords, B: int):
    """Linear grid indices of every voxel of the bricks at ``coords`` [L, 3]."""
    l = torch.arange(B ** 3, device=coords.device)
    x = coords[:, 0:1].long() * B + (l // (B * B))[None]
    y = coords[:, 1:2].long() * B + ((l // B) % B)[None]
    z = coords[:, 2:3].long() * B + (l % B)[None]
    return ((x * cfg.yres + y) * cfg.zres + z).reshape(-1)


def brick_frame_work(cfg, frames: dict, coords, B: int) -> list:
    """(bytes, operations) of each distinct frame's brick fusion: the
    voxels of the volume's live bricks that the frame observes, each
    projected and updated."""
    lin = brick_voxels(cfg, coords, B)
    nc = 3 if cfg.integrate_color else 0
    H, W = cfg.image_height, cfg.image_width
    out = []
    for f in range(frames["depths"].shape[0]):
        n = observed(cfg, frames, f, lin)
        out.append((frame_bytes(n, H, W, nc), frame_ops(cfg, n, n)))
    return out
