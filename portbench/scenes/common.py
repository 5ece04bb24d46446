"""Analytic scenes rendered to depth frames on the device, in float64, in a
few large calls: the pixels' rays, look-at poses, ray hits of spheres and
boxes, sensor noise and dropouts drawn from a generator on the device.

A scene module (``scenes/<name>.py``) defines ``frames(params, cfg, device)``
-> dict(depths [F, H, W], poses [F, 4, 4], rgbs [F, H, W, 3], all float32,
rgb 0..255) and ``surface_distance(params, x, y, z)``, the distance of
volume-frame points to the nearest surface (the reference fuses the voxels
near it)."""

from __future__ import annotations

import torch

F64 = torch.float64


def pixel_dirs(cfg, device):
    """Camera-frame unit ray directions [H, W, 3] (float64), pixel centres
    at integer (u, v) as the port's synthetic frames have them."""
    u = torch.arange(cfg.image_width, dtype=F64, device=device)
    v = torch.arange(cfg.image_height, dtype=F64, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - cfg.principal_point_x) / cfg.focal_length_x,
                     (vv - cfg.principal_point_y) / cfg.focal_length_y,
                     torch.ones_like(uu)], -1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def look_at(eye, target):
    """Camera-to-volume poses [F, 4, 4] (float64) at eye [F, 3] looking at
    target [F, 3], world y up (the construction of the port's orbit_pose)."""
    z = target - eye
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[:, 1] = 1.0
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    m = torch.zeros((eye.shape[0], 4, 4), dtype=F64, device=eye.device)
    m[:, :3, 0], m[:, :3, 1], m[:, :3, 2], m[:, :3, 3] = x, y, z, eye
    m[:, 3, 3] = 1.0
    return m


def world_rays(poses, dirs):
    """Origins [F, 1, 1, 3] and world directions [F, H, W, 3] of each pose's
    pixel rays."""
    d = torch.einsum("fij,hwj->fhwi", poses[:, :3, :3], dirs)
    return poses[:, None, None, :3, 3], d


def hit_sphere(o, d, center, radius):
    """Ray parameter of the first hit of a sphere (inf where missed), as the
    port's sphere_depth_world solves it."""
    oc = o - torch.tensor(center, dtype=F64, device=d.device)
    b = 2.0 * (d * oc).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - 4.0 * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    return torch.where((disc > 0) & (t > 1e-3), t, torch.full_like(t, float("inf")))


def _slabs(o, d, lo, hi):
    lo = torch.tensor(lo, dtype=F64, device=d.device)
    hi = torch.tensor(hi, dtype=F64, device=d.device)
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-300), d)
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def hit_box(o, d, lo, hi):
    """First hit of a solid axis-aligned box seen from outside (inf where
    missed)."""
    t_in, t_out = _slabs(o, d, lo, hi)
    return torch.where((t_in <= t_out) & (t_in > 1e-3), t_in, torch.full_like(t_in, float("inf")))


def hit_room(o, d, lo, hi):
    """Where a ray from inside an axis-aligned room meets its walls."""
    return _slabs(o, d, lo, hi)[1]


def box_distance(lo, hi, x, y, z):
    """Distance of points to the surface of an axis-aligned box (inside or
    outside)."""
    c = [(a + b) / 2 for a, b in zip(lo, hi)]
    h = [(b - a) / 2 for a, b in zip(lo, hi)]
    q = [torch.abs(p - ci) - hi_ for p, ci, hi_ in zip((x, y, z), c, h)]
    outside = torch.sqrt(sum(torch.clamp(qi, min=0.0) ** 2 for qi in q))
    inside = torch.clamp(torch.maximum(torch.maximum(q[0], q[1]), q[2]), max=0.0)
    return torch.abs(outside + inside)


def sphere_distance(center, radius, x, y, z):
    cx, cy, cz = center
    return torch.abs(torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) - radius)


def sensor_frames(t, dirs, params, device):
    """Depth images [F, H, W] (float32, camera z) of ray parameters t: NaN
    where no surface was hit, Gaussian noise of ``noise_m`` metres and
    ``dropout`` of the pixels lost, drawn from a generator seeded with the
    scene's ``noise_seed`` on the device."""
    gen = torch.Generator(device=device).manual_seed(int(params["noise_seed"]))
    depth = torch.where(torch.isfinite(t), t * dirs[..., 2], torch.full_like(t, float("nan")))
    noise = torch.randn(t.shape, generator=gen, dtype=F64, device=device)
    lost = torch.rand(t.shape, generator=gen, dtype=F64, device=device) < params["dropout"]
    depth = depth + noise * params["noise_m"]
    return torch.where(lost, torch.full_like(depth, float("nan")), depth).to(torch.float32)
