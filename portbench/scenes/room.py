"""A room scan: an axis-aligned room (walls, floor and ceiling at
``half_extent`` from the centre of the volume), solid boxes and spheres in
it, seen by a handheld camera that sweeps an arc near one wall and back,
looking across the room; each surface point colored by a smooth pattern of
its position, so every view sees the same colors."""

from __future__ import annotations

import math

import torch

from portbench.scenes.common import F64, box_distance, hit_box, hit_room, hit_sphere, \
    look_at, pixel_dirs, sensor_frames, sphere_distance, world_rays


def poses(params, device):
    p = params["path"]
    n = int(p["poses"])
    th = torch.arange(n, dtype=F64, device=device) * (2.0 * math.pi / n)
    eye = torch.stack([p["x_amp"] * torch.sin(th),
                       p["y_mid"] + p["y_amp"] * torch.sin(2.0 * th),
                       p["z"] + p["z_bow"] * torch.sin(th) ** 2], -1)
    tx, ty, tz = p["target"]
    target = torch.stack([tx + p["target_x_amp"] * torch.sin(th + p["target_phase"]),
                          torch.full_like(th, ty), torch.full_like(th, tz)], -1)
    return look_at(eye, target)


def frames(params, cfg, device):
    m = poses(params, device)
    dirs = pixel_dirs(cfg, device)
    o, d = world_rays(m, dirs)
    h = params["half_extent"]
    t = hit_room(o, d, (-h, -h, -h), (h, h, h))
    for b in params["boxes"]:
        t = torch.minimum(t, hit_box(o, d, b["lo"], b["hi"]))
    for s in params["spheres"]:
        t = torch.minimum(t, hit_sphere(o, d, s["center"], s["radius"]))
    hit = o + t[..., None] * d
    k = params["color_freq"]
    rgb = 127.5 + 127.0 * torch.sin(hit * torch.tensor(k, dtype=F64, device=device)
                                    + torch.tensor([0.0, 1.0, 2.0], dtype=F64, device=device))
    return dict(depths=sensor_frames(t, dirs, params, device), poses=m.to(torch.float32),
                rgbs=rgb.to(torch.float32))


def surface_distance(params, x, y, z):
    h = params["half_extent"]
    dist = box_distance((-h, -h, -h), (h, h, h), x, y, z)
    for b in params["boxes"]:
        dist = torch.minimum(dist, box_distance(b["lo"], b["hi"], x, y, z))
    for s in params["spheres"]:
        dist = torch.minimum(dist, sphere_distance(s["center"], s["radius"], x, y, z))
    return dist
