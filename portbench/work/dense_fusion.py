"""The least work of one dense fusion of a frame over the whole grid, counted
from the depth image and the pose: the observed voxels' bytes
(``work/fusion.py``), and the operations of projecting and testing every
candidate voxel (inside the pinhole frustum, within the sensor range, no
deeper than the frame's deepest reading plus max_dist_neg) and updating the
observed ones. Rewritten from ``cpu_tsdf_tpu_torch/ops/fusion_kernel.py``
(``dense_candidates``)."""

from __future__ import annotations

import torch

from portbench.reference.fusion import centers, rigid_inverse, transform, voxel_indices, observe
from portbench.work.fusion import frame_bytes, frame_ops

PLANES = 16


def frame_counts(cfg, depth, pose, rgb) -> tuple:
    """(observed, candidates) voxels of the grid for one frame."""
    dev = depth.device
    pose_inv = rigid_inverse(pose.to(torch.float32))
    far = torch.where(torch.isnan(depth), float("-inf"), depth).amax() + cfg.max_dist_neg
    plane = cfg.yres * cfg.zres
    n_obs = torch.zeros((), dtype=torch.int64, device=dev)
    n_cand = torch.zeros((), dtype=torch.int64, device=dev)
    for x0 in range(0, cfg.xres, PLANES):
        lin = torch.arange(x0 * plane, min(cfg.xres, x0 + PLANES) * plane, device=dev)
        n_obs += observe(cfg, depth, pose, rgb, lin)[1].sum()
        x, y, z = transform(pose_inv, *centers(cfg, *voxel_indices(cfg, lin), torch.float32))
        u = torch.trunc(torch.clamp(x * cfg.focal_length_x / z + cfg.principal_point_x,
                                    -2.0, cfg.image_width + 1.0))
        v = torch.trunc(torch.clamp(y * cfg.focal_length_y / z + cfg.principal_point_y,
                                    -2.0, cfg.image_height + 1.0))
        inside = ((z > 0) & (u >= 0) & (u < cfg.image_width) & (v >= 0)
                  & (v < cfg.image_height))
        n_cand += (inside & (z >= cfg.min_sensor_dist) & (z <= cfg.max_sensor_dist)
                   & (z <= far)).sum()
    return int(n_obs), int(n_cand)


def dense_frame_work(cfg, frames: dict) -> list:
    """(bytes, operations, observed voxels) of each distinct frame."""
    nc = 3 if cfg.integrate_color else 0
    H, W = cfg.image_height, cfg.image_width
    out = []
    for f in range(frames["depths"].shape[0]):
        n_obs, n_cand = frame_counts(cfg, frames["depths"][f], frames["poses"][f],
                                     frames["rgbs"][f])
        out.append((frame_bytes(n_obs, H, W, nc), frame_ops(cfg, n_cand, n_obs), n_obs))
    return out
