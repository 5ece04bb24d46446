"""The object scan of ``chip_smoke.py`` (and the JAX package's bench.py): a
camera orbiting a sphere of ``radius`` at ``orbit_radius`` with a vertical
bob of ``bob``, ``poses`` poses evenly spaced, the fixed pixel color
pattern (u mod 256, v mod 256, (u + v) mod 256)."""

from __future__ import annotations

import math

import torch

from portbench.scenes.common import F64, hit_sphere, look_at, pixel_dirs, sensor_frames, \
    sphere_distance, world_rays


def poses(params, device):
    n = int(params["poses"])
    th = torch.arange(n, dtype=F64, device=device) * (2.0 * math.pi / n)
    eye = torch.stack([params["orbit_radius"] * torch.sin(th),
                       params["bob"] * torch.sin(2.0 * th),
                       -params["orbit_radius"] * torch.cos(th)], -1)
    return look_at(eye, torch.zeros_like(eye))


def frames(params, cfg, device):
    m = poses(params, device)
    dirs = pixel_dirs(cfg, device)
    o, d = world_rays(m, dirs)
    t = hit_sphere(o, d, (0.0, 0.0, 0.0), params["radius"])
    H, W = cfg.image_height, cfg.image_width
    v, u = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                          indexing="ij")
    rgb = torch.stack([u % 256, v % 256, (u + v) % 256], -1).to(torch.float32)
    return dict(depths=sensor_frames(t, dirs, params, device), poses=m.to(torch.float32),
                rgbs=rgb.expand(m.shape[0], H, W, 3))


def surface_distance(params, x, y, z):
    return sphere_distance((0.0, 0.0, 0.0), params["radius"], x, y, z)
