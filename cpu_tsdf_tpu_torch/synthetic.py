"""Synthetic depth-frame generators for tests and benchmarks.

The reference has no test suite (SURVEY.md §4); our golden gates use
analytically-known scenes (spheres, planes) rendered to organized depth
images, playing the role of the Augmented ICL-NUIM sample the reference README
points at (cpu_tsdf/README.md:84-87).
"""

from __future__ import annotations

import numpy as np

from .config import TSDFConfig


def _pixel_rays(cfg: TSDFConfig):
    u = np.arange(cfg.image_width, dtype=np.float64)
    v = np.arange(cfg.image_height, dtype=np.float64)
    uu, vv = np.meshgrid(u, v)  # [H, W]
    x = (uu - cfg.principal_point_x) / cfg.focal_length_x
    y = (vv - cfg.principal_point_y) / cfg.focal_length_y
    return x, y  # direction = (x, y, 1) per unit z


def sphere_depth(cfg: TSDFConfig, center=(0.0, 0.0, 1.5), radius=0.5) -> np.ndarray:
    """Depth image (z-channel) of a sphere in the CAMERA frame. NaN = miss."""
    dx, dy = _pixel_rays(cfg)
    dz = np.ones_like(dx)
    # Solve |o + t*d - c|^2 = r^2 with o = 0, d unnormalized (t = z).
    cx, cy, cz = center
    a = dx * dx + dy * dy + dz * dz
    b = -2.0 * (dx * cx + dy * cy + dz * cz)
    c = cx * cx + cy * cy + cz * cz - radius * radius
    disc = b * b - 4 * a * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    depth = np.where((disc > 0) & (t > 0), t * dz, np.nan)
    return depth.astype(np.float32)


def sphere_depth_world(cfg: TSDFConfig, pose, center=(0.0, 0.0, 0.0),
                       radius: float = 0.5) -> np.ndarray:
    """Depth image of a WORLD-frame sphere seen from camera-to-world `pose`
    (trajectory scenes: the sphere stays put while the camera orbits)."""
    pose = np.asarray(pose, np.float64)
    dx, dy = _pixel_rays(cfg)
    dirs = np.stack([dx, dy, np.ones_like(dx)], -1)
    n = np.linalg.norm(dirs, axis=-1, keepdims=True)
    d_w = (dirs / n) @ pose[:3, :3].T
    o = pose[:3, 3] - np.asarray(center, np.float64)
    b = 2.0 * d_w @ o
    c = o @ o - radius * radius
    disc = b * b - 4.0 * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit = (disc > 0) & (t > 1e-3)
    # depth = z in the CAMERA frame = t * unit_dir_z
    depth = np.where(hit, t * (dirs[..., 2] / n[..., 0]), np.nan)
    return depth.astype(np.float32)


def orbit_pose(theta: float, orbit_radius: float = 1.0,
               bob: float = 0.08) -> np.ndarray:
    """Camera on a circle in the x-z plane looking at the origin (y up),
    with a small vertical bob for pose variety."""
    c = np.array([orbit_radius * np.sin(theta),
                  bob * np.sin(2.0 * theta),
                  -orbit_radius * np.cos(theta)])
    zax = -c / np.linalg.norm(c)
    xax = np.cross([0.0, 1.0, 0.0], zax)
    xax /= np.linalg.norm(xax)
    yax = np.cross(zax, xax)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = xax, yax, zax, c
    return m.astype(np.float32)


def plane_depth(cfg: TSDFConfig, z0: float = 1.5) -> np.ndarray:
    """Depth image of a fronto-parallel plane at z = z0."""
    dx, _ = _pixel_rays(cfg)
    return np.full(dx.shape, z0, dtype=np.float32)


def sphere_rgb(cfg: TSDFConfig, depth: np.ndarray) -> np.ndarray:
    """A deterministic color pattern over valid depth pixels (0..255 floats)."""
    H, W = depth.shape
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    r = (uu * 255.0 / max(W - 1, 1))
    g = (vv * 255.0 / max(H - 1, 1))
    b = np.where(np.isnan(depth), 0.0, 128.0)
    return np.stack([r, g, b], -1).astype(np.float32)


def sphere_sdf_exact(cfg: TSDFConfig, center, radius, x, y, z):
    """Exact signed distance to the sphere (negative inside), for gates."""
    cx, cy, cz = center
    return np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) - radius
