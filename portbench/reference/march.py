"""Plain reference of the raycast render, in plain PyTorch, independent of the
port: the reference's renderView / renderColoredView
(tsdf_volume_octree.cpp:278-450) over a dense field, as a lockstep loop
over all rays, op by op in the order of the port's plain march:

  * t from min_sensor_dist, first step 3/4 max_dist_neg, nearest-voxel
    samples, the step max(cell/4, |d| max_dist_neg)           (cpp:311-371)
  * stop on a sign change with both weights nonzero, on leaving the volume
    after having been inside, at max_sensor_dist or max_steps
  * half-voxel backtrack to bracket the crossing               (cpp:329-354)
  * t* from two trilinear samples, normals by central differences at
    +-1 cell, the hits and normals back into the camera frame  (cpp:378-422)
  * the color of the voxel at the hit                          (cpp:427-450)

The field is the packed render view of a volume: ``rd`` [X, Y, Z] float
(NaN = unobserved) and its colors [X, Y, Z, 3]. ``counts`` tallies what
the march does (samples, refined and normal-bearing rays), for the ray
march's operation count in ``portbench/work/march.py``."""

from __future__ import annotations

import torch

from portbench.reference.fusion import div, rigid_inverse, transform

CORNERS = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]


def rotate(m, x, y, z):
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def voxel_index(cfg, x, y, z):
    ix = torch.floor(div(x + cfg.xsize / 2.0, cfg.xsize) * cfg.xres).to(torch.int32)
    iy = torch.floor(div(y + cfg.ysize / 2.0, cfg.ysize) * cfg.yres).to(torch.int32)
    iz = torch.floor(div(z + cfg.zsize / 2.0, cfg.zsize) * cfg.zres).to(torch.int32)
    ok = ((ix >= 0) & (iy >= 0) & (iz >= 0)
          & (ix < cfg.xres) & (iy < cfg.yres) & (iz < cfg.zres))
    return ix, iy, iz, ok


def in_volume(cfg, x, y, z):
    return (~torch.isnan(z) & (torch.abs(x) <= cfg.xsize / 2.0)
            & (torch.abs(y) <= cfg.ysize / 2.0) & (torch.abs(z) <= cfg.zsize / 2.0))


def center(cfg, ix, iy, iz):
    cx, cy, cz = cfg.cell_size
    return ((ix + 0.5) * cx - cfg.xsize / 2.0, (iy + 0.5) * cy - cfg.ysize / 2.0,
            (iz + 0.5) * cz - cfg.zsize / 2.0)


class Field:
    """A packed dense field: (d, w) at clipped indices, unobserved as
    (-1, 0)."""

    def __init__(self, cfg, rd, color):
        self.cfg, self.rd, self.color = cfg, rd.reshape(-1), color

    def lin(self, ix, iy, iz):
        c = self.cfg
        ix = torch.clamp(ix, 0, c.xres - 1)
        iy = torch.clamp(iy, 0, c.yres - 1)
        iz = torch.clamp(iz, 0, c.zres - 1)
        return (ix.long() * c.yres + iy) * c.zres + iz

    def dw(self, ix, iy, iz):
        rd = self.rd[self.lin(ix, iy, iz)]
        un = torch.isnan(rd)
        return (torch.where(un, torch.full_like(rd, -1.0), rd),
                torch.where(un, torch.zeros_like(rd), torch.ones_like(rd)))

    def trilinear(self, x, y, z):
        cfg = self.cfg
        ix, iy, iz, ok = voxel_index(cfg, x, y, z)
        valid = (ok & (ix > 0) & (ix < cfg.xres - 1) & (iy > 0) & (iy < cfg.yres - 1)
                 & (iz > 0) & (iz < cfg.zres - 1))
        cx, cy, cz = center(cfg, ix, iy, iz)
        ix = torch.where(x < cx, ix - 1, ix)
        iy = torch.where(y < cy, iy - 1, iy)
        iz = torch.where(z < cz, iz - 1, iz)
        ix = torch.clamp(ix, 0, cfg.xres - 2)
        iy = torch.clamp(iy, 0, cfg.yres - 2)
        iz = torch.clamp(iz, 0, cfg.zres - 2)
        vx, vy, vz = center(cfg, ix, iy, iz)
        a = div((x - vx) * cfg.xres, cfg.xsize)
        b = div((y - vy) * cfg.yres, cfg.ysize)
        c = div((z - vz) * cfg.zres, cfg.zsize)
        val = None
        for dx, dy, dz in CORNERS:
            d, w = self.dw(ix + dx, iy + dy, iz + dz)
            valid = valid & (w > 0)
            term = d * (a if dx else 1 - a) * (b if dy else 1 - b) * (c if dz else 1 - c)
            val = term if val is None else val + term
        return val, valid


def camera_rays(cfg, pose):
    W, H = cfg.image_width, cfg.image_height
    dev = pose.device
    px = div(torch.arange(W, dtype=torch.float32, device=dev)[None, :]
             - cfg.principal_point_x, cfg.focal_length_x)
    py = div(torch.arange(H, dtype=torch.float32, device=dev)[:, None]
             - cfg.principal_point_y, cfg.focal_length_y)
    dx = px.expand(H, W).reshape(-1)
    dy = py.expand(H, W).reshape(-1)
    dz = torch.ones_like(dx)
    n = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return pose[:3, 3], rotate(pose, dx / n, dy / n, dz / n)


def render(cfg, field: Field, pose, max_steps: int = 512, counts=None) -> dict:
    """The reference render of one pose: points, normals [H, W, 3] (camera
    frame, NaN where none), depth [H, W], rgb [H, W, 3] (NaN where none)."""
    o, (dx, dy, dz) = camera_rays(cfg, pose)
    N, dev = dx.shape[0], dx.device
    ox, oy, oz = (o[i].expand(N) for i in range(3))
    min_adaptive = min(cfg.cell_size) / 4.0
    half_cell = (cfg.zsize / cfg.zres) / 2.0

    def full(v):
        return torch.full((N,), v, dtype=torch.float32, device=dev)

    def point(t):
        return ox + t * dx, oy + t * dy, oz + t * dz

    def sample(t, active):
        x, y, z = point(t)
        ix, iy, iz, _ = voxel_index(cfg, x, y, z)
        d, w = field.dw(ix, iy, iz)
        if counts is not None:
            counts["samples"] += active.sum()
        return d, w, in_volume(cfg, x, y, z)

    t, step = full(cfg.min_sensor_dist), full(cfg.max_dist_neg * 3.0 / 4.0)
    last_d, last_w = full(0.0), full(0.0)
    entered = torch.zeros(N, dtype=torch.bool, device=dev)
    found = torch.zeros_like(entered)
    iters = torch.zeros(N, dtype=torch.int32, device=dev)
    done = iters >= max_steps
    for it in range(max_steps):
        if it % 4 == 0 and bool(done.all()):
            break
        active = ~done
        d, w, inside = sample(t, active)
        sign = ((d < 0) & (last_d > 0)) | ((d > 0) & (last_d < 0))
        crossing = inside & sign & (last_w != 0) & (w != 0) & active
        leave = ~inside & entered & active
        new_step = torch.clamp(torch.abs(d) * cfg.max_dist_neg, min=min_adaptive)
        upd = active & inside & ~crossing
        last_d = torch.where(upd, d, last_d)
        last_w = torch.where(upd, w, last_w)
        step = torch.where(upd, new_step, step)
        entered = entered | (inside & active)
        found = found | crossing
        t = torch.where(active & ~crossing & ~leave, t + step, t)
        iters = iters + active.to(torch.int32)
        done = done | crossing | leave | (t >= cfg.max_sensor_dist) | (iters >= max_steps)

    old_t = t - step
    t_bt = t
    bdone = ~found
    bt_steps = int(max(cfg.max_dist_pos, cfg.max_dist_neg) / half_cell) + 4
    for it in range(bt_steps):
        if it % 4 == 0 and bool(bdone.all()):
            break
        active = ~bdone
        leave_loop = active & (t_bt < old_t)
        stepping = active & ~leave_loop
        t_new = t_bt - half_cell
        d, _, inside = sample(t_new, stepping)
        same = ((last_d > 0) & (d > 0)) | ((last_d < 0) & (d < 0))
        hit = stepping & inside & same
        out = stepping & ~inside
        last_d = torch.where(hit, d, last_d)
        t_bt = torch.where(stepping & ~hit, t_new, t_bt)
        bdone = bdone | leave_loop | hit | out

    step_r = torch.where(found, full(half_cell), step)
    t_prev = t_bt - step_r
    d_prev, ok_prev = field.trilinear(*point(t_prev))
    d_cur, ok_cur = field.trilinear(*point(t_bt))
    valid = found & ok_prev & ok_cur & ~torch.isnan(d_cur) & ~torch.isnan(d_prev)
    den = d_prev - d_cur
    den = torch.where(den == 0, full(1e-20), den)
    t_star = t_bt + step_r * (-1.0 + torch.abs(d_prev / den))
    t_star = torch.where(found, t_star, full(0.0))
    hx, hy, hz = point(t_star)

    csx, csy, csz = cfg.cell_size
    nvalid = valid & in_volume(cfg, hx, hy, hz)
    vals = []
    for q in ((hx - csx, hy, hz), (hx + csx, hy, hz), (hx, hy - csy, hz),
              (hx, hy + csy, hz), (hx, hy, hz - csz), (hx, hy, hz + csz)):
        v, ok = field.trilinear(*q)
        nvalid = nvalid & ok
        vals.append(v)
    nx = div((vals[1] - vals[0]) * cfg.max_dist_neg, 2 * csx)
    ny = div((vals[3] - vals[2]) * cfg.max_dist_neg, 2 * csy)
    nz = div((vals[5] - vals[4]) * cfg.max_dist_neg, 2 * csz)
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nn = torch.where(nn == 0, torch.ones_like(nn), nn)
    zero = torch.zeros_like(nn)
    nx, ny, nz = (torch.where(valid, c / nn, zero) for c in (nx, ny, nz))
    if counts is not None:
        counts["refined"] += found.sum()
        counts["normals"] += valid.sum()

    H, W = cfg.image_height, cfg.image_width
    pose_inv = rigid_inverse(pose)
    pts = transform(pose_inv, hx, hy, hz)
    nrm = rotate(pose_inv, nx, ny, nz)

    def organized(chans, mask):
        x = torch.stack(chans, -1)
        return torch.where(mask[:, None], x, torch.full_like(x, float("nan"))).reshape(H, W, 3)

    points = organized(pts, valid)
    out = dict(points=points, normals=organized(nrm, nvalid), depth=points[..., 2])
    if field.color is not None:
        ix, iy, iz, okc = voxel_index(cfg, hx, hy, hz)
        rgb = field.color.reshape(-1, field.color.shape[-1])[field.lin(ix, iy, iz)]
        out["rgb"] = organized(tuple(rgb.unbind(-1)), okc & valid)
    return out
