"""Marching cubes over brick and dense volumes.

Port of ``cpu_tsdf_tpu.ops.marching_cubes`` (MarchingCubesTSDFOctree,
cpu_tsdf/src/lib/marching_cubes_tsdf_octree.cpp:43-236). A brick
extraction is:

  1. candidate bricks: per-brick (min, max) of the valid d, combined over
     the brick and its seven +1 neighbours, must straddle 0 — a superset of
     the bricks holding a crossing cube;
  2. the reference's cube filter over the candidates' cubes, then table
     lookup, edge interpolation (PCL's interpolateEdge on the voxel-centre
     lattice) and triangle emission.

The kernel route runs step 2 as two kernels: the corner halo
(``csrc/mc_corner_halo.cu``) compacts each brick's crossing cubes with
their corner values and triangle counts, and the emission kernel
(``csrc/mc_emit.cu``) writes each brick's triangles at its offset in the
mesh; their plain versions are :func:`_corner_halo_plain` and
:func:`_emit_plain`. The plain route (:func:`_corner_stacks`, a global
``nonzero``, :func:`_emit_soup`) builds every corner stack and triangle
slot and compacts them.

Budgets are sized from exact counts, so nothing overflows and there is no
retry: the kernel route syncs with the host twice (the candidate list, the
triangle total). The triangle order is the JAX package's: ascending slot
of the candidate brick, then voxel, then triangle slot of the case table.

A dense volume on the card goes through the same kernels after
``bricks.from_dense``, as the JAX package does on an accelerator; on the
CPU it takes the dense route (:func:`marching_cubes`: the cube filter over
every cube, one ``nonzero``, the plain emission), whose triangles come in
cube-major order. Both are sized from the exact count.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import TSDFConfig
from ..geometry import div_const, transform_points, voxel_center
from ..volume import resolve_use_kernel
from . import color as color_ops
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, MAX_TRIS_PER_CUBE, TRI_COUNT, TRI_TABLE

# Default minimum weight to mesh a voxel (marching_cubes_tsdf_octree.h:58).
DEFAULT_MIN_WEIGHT = 2.5

# What csrc/mc_corner_halo.cu returns, launching nothing, for a brick size
# whose block would need more shared memory than the card has (B > 118 on
# an H100: two (B+1)^2 halo layers of sdf and weight).
_BRICK_TOO_LARGE = -1

# Kernel launches since the last reset (plain runs not counted).
launches = {"corner_halo": 0, "emit": 0}

# +1-neighbour directions; index (bx<<2)|(by<<1)|bz, as in the halo kernel.
_NBR_BITS = tuple(((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8))


@dataclasses.dataclass
class MeshSoup:
    """Compact triangle soup: ``num_triangles`` rows, in extraction order."""

    vertices: torch.Tensor          # [N, 3, 3] f32 (triangle, corner, xyz)
    colors: Optional[torch.Tensor]  # [N, 3, 3] f32 (0..255) or None
    num_triangles: int

    def to_numpy(self):
        """(V [N*3, 3], F [N, 3], C [N*3, 3] or None) as numpy arrays."""
        verts = self.vertices.detach().cpu().numpy().reshape(-1, 3)
        faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
        cols = (None if self.colors is None
                else self.colors.detach().cpu().numpy().reshape(-1, 3))
        return verts, faces, cols


# ---------------------------------------------------------------------------
# step 1: candidate bricks
# ---------------------------------------------------------------------------

def _brick_stats(bv, min_weight: float):
    """Per-slot (min, max) of d over VALID voxels (w >= min_weight, |d| < 1),
    +inf/-inf where there is none; index C (the missing-neighbour sentinel)
    is +inf/-inf too. Returns ([C+1], [C+1])."""
    valid = (bv.weight >= min_weight) & (torch.abs(bv.sdf) < 1.0)
    inf = torch.full((1,), float("inf"), device=bv.device)
    dmin = torch.where(valid, bv.sdf, inf).amin(1)
    dmax = torch.where(valid, bv.sdf, -inf).amax(1)
    return torch.cat([dmin, inf]), torch.cat([dmax, -inf])


def _neighbor_slots(bv, coords, live):
    """[K, 8] slots of each brick's +1 neighbours in _NBR_BITS order (own
    slot first); C where the brick is dead, the neighbour is outside the
    grid or unallocated."""
    nbx, nby, nbz = bv.bricks_per_axis
    C = bv.capacity
    bits = torch.tensor(_NBR_BITS, dtype=torch.int32, device=coords.device)
    nc = coords[:, None, :] + bits[None]                            # [K, 8, 3]
    inside = live[:, None] & (nc[..., 0] < nbx) & (nc[..., 1] < nby) & (nc[..., 2] < nbz)
    blin = (nc[..., 0] * nby + nc[..., 1]) * nbz + nc[..., 2]
    ns = bv.brick_map.view(-1)[torch.clamp(blin, 0, nbx * nby * nbz - 1).long()]
    return torch.where(inside & (ns >= 0), ns, C)


def _candidate_slots(bv, min_weight: float):
    """Ascending int32 slots of the bricks that may hold a crossing cube."""
    dmin, dmax = _brick_stats(bv, min_weight)
    live = bv.coords[:, 0] >= 0
    ns = _neighbor_slots(bv, bv.coords, live).long()
    has_own = dmin[:-1] < float("inf")  # a cube's lower corner is in the brick
    cand = live & has_own & (dmin[ns].amin(1) < 0.0) & (dmax[ns].amax(1) >= 0.0)
    return torch.nonzero(cand).squeeze(1).to(torch.int32)  # host sync


# ---------------------------------------------------------------------------
# step 2a: cube filter, corner stacks and compaction (the corner-halo kernel)
# ---------------------------------------------------------------------------

def _interior_mask(cfg: TSDFConfig, coords, B: int, nv: int):
    """[K, nv] mask of cubes whose lower corner is an interior voxel,
    1 <= v < res-1 per axis (marching_cubes_tsdf_octree.cpp:199-202)."""
    vid = torch.arange(nv, dtype=torch.int32, device=coords.device)[None, :]
    vx = coords[:, 0:1] * B + vid // (B * B)
    vy = coords[:, 1:2] * B + (vid // B) % B
    vz = coords[:, 2:3] * B + vid % B
    return ((vx >= 1) & (vx < cfg.xres - 1) & (vy >= 1) & (vy < cfg.yres - 1)
            & (vz >= 1) & (vz < cfg.zres - 1))


def _corner_stacks(bv, slots, min_weight: float):
    """Plain version of the corner-halo kernel's stacks and filter.

    slots [K] int32 (dead = negative, >= C, or a slot with coords -1).
    Returns (dstack [K*B^3, 8] normalized d in PCL corner order, ok [K, B^3]
    bool): every corner w >= min_weight and |d| < 1, a sign change (some
    d < 0, some d >= 0), the lower corner interior, the slot live."""
    cfg, B, C = bv.config, bv.brick_size, bv.capacity
    nv = B ** 3
    K = slots.shape[0]
    in_range = (slots >= 0) & (slots < C)
    coords = bv.coords[torch.clamp(slots, 0, C - 1).long()]
    live = in_range & (coords[:, 0] >= 0)
    ns = _neighbor_slots(bv, coords, live).long()                   # [K, 8]

    def halo(field, fill):
        rows = torch.cat([field, torch.full((1, nv), fill, dtype=field.dtype,
                                            device=field.device)])
        nb = rows[ns].reshape(K, 2, 2, 2, B, B, B)
        h = torch.full((K, B + 1, B + 1, B + 1), fill, dtype=field.dtype,
                       device=field.device)
        for bx, by, bz in _NBR_BITS:
            # the neighbour's first layer along each bit that is set
            src = nb[:, bx, by, bz,
                     0 if bx else slice(None), 0 if by else slice(None),
                     0 if bz else slice(None)]
            h[:, B if bx else slice(0, B), B if by else slice(0, B),
              B if bz else slice(0, B)] = src
        return h

    hd, hw = halo(bv.sdf, -1.0), halo(bv.weight, 0.0)
    dcs, ok = [], live[:, None] & _interior_mask(cfg, coords, B, nv)
    neg = torch.zeros((K, nv), dtype=torch.bool, device=slots.device)
    pos = torch.zeros_like(neg)
    for ox, oy, oz in CORNER_OFFSETS.tolist():
        dc = hd[:, ox:ox + B, oy:oy + B, oz:oz + B].reshape(K, nv)
        wc = hw[:, ox:ox + B, oy:oy + B, oz:oz + B].reshape(K, nv)
        ok = ok & (wc >= min_weight) & (torch.abs(dc) < 1.0)
        neg = neg | (dc < 0)
        pos = pos | (dc >= 0)
        dcs.append(dc)
    return torch.stack(dcs, -1).reshape(K * nv, 8), ok & neg & pos


def _pack_left_plain(mask):
    """Stable per-row compaction (the JAX package's pack-left): loc[k, r] =
    lane of the r-th lane of row k with mask > 0, -1 padded. [NB, L] ->
    int32 [NB, L]. The corner halo's plain version ranks cubes with it."""
    on = mask > 0
    NB, L = on.shape
    rank = torch.cumsum(on, 1) - 1
    loc = torch.full((NB, L + 1), -1, dtype=torch.int32, device=mask.device)
    lane = torch.arange(L, dtype=torch.int32, device=mask.device).expand(NB, L)
    loc.scatter_(1, torch.where(on, rank, L), lane)  # column L takes the rest
    return loc[:, :L].contiguous()


def _cube_index(vals):
    """PCL cubeindex [N] int64 of corner values [N, 8] in meters: bit i set
    iff corner i's value < 0."""
    return ((vals < 0.0).long() << torch.arange(8, device=vals.device)).sum(1)


def _corner_halo_plain(bv, slots, min_weight: float):
    """Plain version of the corner-halo kernel: :func:`_corner_stacks` and
    :func:`_pack_left_plain`, then a gather of the crossing cubes' stacks.
    See :func:`corner_halo` for the outputs; here the corner rows from
    count[k] on are 0."""
    nv = bv.brick_size ** 3
    dstack, ok = _corner_stacks(bv, slots, min_weight)
    loc = _pack_left_plain(ok)
    on = loc >= 0
    rows = torch.arange(ok.shape[0], device=ok.device)[:, None] * nv
    corners = torch.where(on[..., None], dstack[torch.where(on, rows + loc, 0)], 0.0)
    cubeindex = _cube_index(corners.reshape(-1, 8) * bv.config.max_dist_neg).reshape(on.shape)
    cube = torch.where(on, cubeindex * nv + loc, -1).to(torch.int32)
    tri_count = torch.as_tensor(TRI_COUNT, dtype=torch.int32, device=ok.device)
    ntri = torch.where(on, tri_count[cubeindex], 0).sum(1, dtype=torch.int32)
    return on.sum(1, dtype=torch.int32), cube, corners, ntri


def check_kernel_brick(what: str, B: int, C: int) -> int:
    """B^3, after the checks of the MC kernels' brick size: even, and
    capacity * B^3 below 2^31, so that every cube reference slot * B^3 +
    voxel fits the kernels' int32 (2^24 at the default 2^15 rows of 8^3,
    and at 2^9 rows of 32^3). The corner-halo kernel's own limit, its
    shared memory, is checked at launch."""
    if B % 2 or B < 2:
        raise ValueError(f"{what}: the MC kernels take even brick sizes, got {B}")
    if C * B ** 3 >= 1 << 31:
        raise ValueError(f"{what}: capacity * B^3 = {C * B ** 3} does not fit the "
                         "kernels' int32 cube references (at most 2^31 - 1)")
    return B ** 3


def corner_halo(bv, slots, min_weight: float):
    """Cube filter, per-brick compaction and corner stacks of the crossing
    cubes of the bricks at ``slots`` (int32 [K]; dead = negative, >= C, or
    a slot with coords -1). Returns, with nv = B^3:

      count   int32 [K]        crossing cubes of each brick;
      cube    int32 [K, nv]    cubeindex * nv + voxel of the r-th crossing
                               cube (voxel order), -1 from count[k] on;
      corners f32 [K, nv, 8]   its normalized d in PCL corner order; rows
                               from count[k] on are not part of the result;
      ntri    int32 [K]        triangles of the brick's crossing cubes.

    The cubeindex is PCL's over the values in meters (d * max_dist_neg).
    On CPU tensors: :func:`_corner_halo_plain`. On CUDA tensors:
    csrc/mc_corner_halo.cu, for every even brick size whose two (B+1)^2
    halo layers fit a block's shared memory (B <= 118 on an H100); a larger
    one raises a ValueError."""
    if bv.device.type == "cpu":
        return _corner_halo_plain(bv, slots, min_weight)
    from .._build import check, check_tensor, function, stream_ptr

    dev = bv.device
    C, K, B = bv.capacity, slots.shape[0], bv.brick_size
    V = check_kernel_brick("corner_halo", B, C)
    nb = bv.bricks_per_axis
    for what, t, dt, shape in (("slots", slots, torch.int32, (K,)),
                               ("sdf", bv.sdf, torch.float32, (C, V)),
                               ("weight", bv.weight, torch.float32, (C, V)),
                               ("brick_map", bv.brick_map, torch.int32, nb),
                               ("coords", bv.coords, torch.int32, (C, 3))):
        check_tensor(f"corner_halo: {what}", t, dt, shape, dev)
    if bv.sdf.data_ptr() % 16 or bv.weight.data_ptr() % 16:
        raise ValueError("corner_halo: sdf and weight must be 16-byte aligned")
    count = torch.empty((K,), dtype=torch.int32, device=dev)
    cube = torch.empty((K, V), dtype=torch.int32, device=dev)
    corners = torch.empty((K, V, 8), dtype=torch.float32, device=dev)
    ntri = torch.empty((K,), dtype=torch.int32, device=dev)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = function("mc_corner_halo", "tsdf_corner_halo", [p] * 5 + [i] * 9 + [f, f] + [p] * 5)
    cfg = bv.config
    err = fn(bv.sdf.data_ptr(), bv.weight.data_ptr(), bv.brick_map.data_ptr(),
             bv.coords.data_ptr(), slots.data_ptr(), K, B, C, *nb,
             cfg.xres, cfg.yres, cfg.zres, float(min_weight), cfg.max_dist_neg,
             count.data_ptr(), cube.data_ptr(), corners.data_ptr(), ntri.data_ptr(),
             stream_ptr(dev))
    if err == _BRICK_TOO_LARGE:
        raise ValueError(f"corner_halo: two {B + 1}^2 halo layers of bricks of {B}^3 do "
                         "not fit a block's shared memory")
    check(err, "corner_halo")
    launches["corner_halo"] += 1
    return count, cube, corners, ntri


# ---------------------------------------------------------------------------
# step 2b: triangle emission (the emission kernel)
# ---------------------------------------------------------------------------

def _edge_points(cfg: TSDFConfig, ci, cj, ck, vals):
    """Interpolated vertex on each of the 12 cube edges, [N, 12, 3]:
    p1 + (0 - v1)/(v2 - v1) * (p2 - p1) (PCL interpolateEdge; 0.5 where
    v1 == v2). ci/cj/ck [N] lower-corner voxels, vals [N, 8] in meters."""
    cx, cy, cz = voxel_center(cfg, ci.to(torch.float32), cj.to(torch.float32),
                              ck.to(torch.float32))
    cell = np.asarray(cfg.cell_size, np.float32)
    offs = CORNER_OFFSETS

    def corner_xyz(c):
        return torch.stack([cx + float(offs[c, 0] * cell[0]),
                            cy + float(offs[c, 1] * cell[1]),
                            cz + float(offs[c, 2] * cell[2])], -1)

    e_a, e_b = EDGE_CORNERS[:, 0].tolist(), EDGE_CORNERS[:, 1].tolist()
    v1 = vals[:, e_a]
    v2 = vals[:, e_b]
    p1 = torch.stack([corner_xyz(a) for a in e_a], 1)
    p2 = torch.stack([corner_xyz(b) for b in e_b], 1)
    denom = v2 - v1
    flat = denom == 0
    mu = torch.where(flat, torch.full_like(denom, 0.5),
                     (0.0 - v1) / torch.where(flat, torch.ones_like(denom), denom))
    return p1 + mu[..., None] * (p2 - p1)


def _case_rows(cubeindex):
    """Case-table rows of PCL cubeindices [N]: (edge ids [N, MAX, 3] int64,
    triangle counts [N])."""
    dev = cubeindex.device
    table = torch.as_tensor(TRI_TABLE, dtype=torch.int64, device=dev)
    count = torch.as_tensor(TRI_COUNT, dtype=torch.int64, device=dev)
    entries = torch.clamp(table[cubeindex], min=0).reshape(-1, MAX_TRIS_PER_CUBE, 3)
    return entries, count[cubeindex]


def _triangles(cfg, global_transform, ci, cj, ck, vals, cubeindex):
    """Every triangle of N cubes, in (cube, table slot) order: vertices
    [T, 3, 3] after the global transform (cpp:122,128), and each triangle's
    cube [T] int64. Every triangle slot of every cube is built, then the
    valid ones are kept."""
    M = MAX_TRIS_PER_CUBE
    N = vals.shape[0]
    pts = _edge_points(cfg, ci, cj, ck, vals)
    entries, ntris = _case_rows(cubeindex)
    verts = pts[torch.arange(N, device=vals.device)[:, None, None], entries]  # [N,M,3,3]
    valid = torch.arange(M, device=vals.device)[None, :] < ntris[:, None]
    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    verts = verts.reshape(N * M, 3, 3)[sel]
    x, y, z = transform_points(global_transform, verts[..., 0], verts[..., 1],
                               verts[..., 2])
    return torch.stack([x, y, z], -1), sel // M


def _expand_colors(rgb):
    """Per-triangle colors [T, 3] -> the soup's [T, 3, 3] (or None)."""
    return None if rgb is None else rgb[:, None, :].expand(-1, 3, 3).contiguous()


def _emit_soup(cfg, global_transform, ci, cj, ck, vals, center_rgb) -> MeshSoup:
    """Plain route: the triangles of the N crossing cubes, colored by their
    cube's center_rgb [N, 3] (or None)."""
    verts, cube = _triangles(cfg, global_transform, ci, cj, ck, vals, _cube_index(vals))
    rgb = None if center_rgb is None else center_rgb[cube]
    return MeshSoup(vertices=verts, colors=_expand_colors(rgb),
                    num_triangles=int(verts.shape[0]))


def _emit_plain(bv, slots, count, cube, corners):
    """Plain version of the emission kernel, on corner_halo's outputs:
    (vertices [T, 3, 3] f32 after the global transform, tri_cube [T] int32
    = slot * nv + voxel of each triangle's cube), in candidate order, then
    rank, then case-table slot."""
    cfg, B = bv.config, bv.brick_size
    nv = B ** 3
    live = torch.arange(nv, device=cube.device)[None, :] < count[:, None]
    k, r = torch.nonzero(live, as_tuple=True)
    code = cube[k, r].long()
    within, cubeindex = code % nv, code // nv
    brick = slots[k].long()
    cs = bv.coords[brick]
    verts, of = _triangles(cfg, bv.global_transform, cs[:, 0] * B + within // (B * B),
                           cs[:, 1] * B + (within // B) % B, cs[:, 2] * B + within % B,
                           corners[k, r] * cfg.max_dist_neg, cubeindex)
    return verts, (brick * nv + within)[of].to(torch.int32)


def emit_triangles(bv, slots, count, cube, corners, tri_off, n_tri: int):
    """The triangles of corner_halo's crossing cubes: (vertices [n_tri, 3, 3]
    f32 after the global transform, tri_cube [n_tri] int32 = slot * B^3 +
    voxel of each triangle's cube), in candidate order, then rank, then
    case-table slot. tri_off int32 [K] is each brick's first triangle (the
    exclusive prefix sum of corner_halo's ntri) and n_tri the total.

    On CPU tensors: :func:`_emit_plain`. On CUDA tensors: csrc/mc_emit.cu,
    for every even brick size."""
    if bv.device.type == "cpu":
        return _emit_plain(bv, slots, count, cube, corners)
    from .._build import check, check_tensor, function, stream_ptr

    dev = bv.device
    C, K, B = bv.capacity, slots.shape[0], bv.brick_size
    V = check_kernel_brick("emit_triangles", B, C)
    for what, t, dt, shape in (("slots", slots, torch.int32, (K,)),
                               ("coords", bv.coords, torch.int32, (C, 3)),
                               ("count", count, torch.int32, (K,)),
                               ("cube", cube, torch.int32, (K, V)),
                               ("corners", corners, torch.float32, (K, V, 8)),
                               ("tri_off", tri_off, torch.int32, (K,)),
                               ("global_transform", bv.global_transform,
                                torch.float32, (4, 4))):
        check_tensor(f"emit_triangles: {what}", t, dt, shape, dev)
    if corners.data_ptr() % 16:
        raise ValueError("emit_triangles: corners must be 16-byte aligned")
    verts = torch.empty((n_tri, 3, 3), dtype=torch.float32, device=dev)
    tri_cube = torch.empty((n_tri,), dtype=torch.int32, device=dev)
    if K == 0 or n_tri == 0:
        return verts, tri_cube
    cfg = bv.config
    grid = (ctypes.c_float * 7)(*cfg.cell_size, cfg.xsize / 2.0, cfg.ysize / 2.0,
                                cfg.zsize / 2.0, cfg.max_dist_neg)
    p = ctypes.c_void_p
    fn = function("mc_emit", "tsdf_mc_emit",
                  [p] * 7 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_float), p, p, p])
    err = fn(slots.data_ptr(), bv.coords.data_ptr(), count.data_ptr(), cube.data_ptr(),
             corners.data_ptr(), tri_off.data_ptr(), bv.global_transform.data_ptr(), K,
             B, grid, verts.data_ptr(), tri_cube.data_ptr(), stream_ptr(dev))
    check(err, "emit_triangles")
    launches["emit"] += 1
    return verts, tri_cube


def _voxel_rgb(bv, flat, color_by_rgb: bool, color_by_confidence: bool):
    """Colors [N, 3] of the voxels at flat indices ``flat`` into the
    volume's fields (slot * nv + voxel of a brick volume, the linear index
    of a dense one; a cube's color is its lower-corner voxel's,
    cpp:216-230), or None when the mesh is not colored."""
    cfg = bv.config
    if color_by_rgb and bv.color is not None:
        r, g, b = color_ops.color_to_rgb(
            cfg.color_mode, bv.color.reshape(-1, bv.color.shape[-1])[flat.long()])
        return torch.stack([r, g, b], -1)
    if color_by_confidence:
        std_dev = div_const(100.0 - bv.weight.reshape(-1)[flat.long()], 100.0)
        r = torch.clamp((1.0 - std_dev) * 255.0, 0.0, 255.0)
        b = torch.clamp(std_dev * 255.0, 0.0, 255.0)
        return torch.stack([r, torch.zeros_like(r), b], -1)
    return None


def _empty_soup(device, colored: bool) -> MeshSoup:
    z = torch.zeros((0, 3, 3), dtype=torch.float32, device=device)
    return MeshSoup(vertices=z, colors=z.clone() if colored else None, num_triangles=0)


# ---------------------------------------------------------------------------
# extraction entry points
# ---------------------------------------------------------------------------

def extract_soup_bricks(bv, min_weight: float = DEFAULT_MIN_WEIGHT,
                        color_by_rgb: bool = False,
                        color_by_confidence: bool = False,
                        use_kernel: Optional[bool] = None) -> MeshSoup:
    """Brick-native extraction on the volume's device.

    use_kernel: None = the corner-halo and emission kernels on the card, the
    plain route on the CPU; False = the plain route anywhere; True on the
    CPU raises."""
    return _extract(bv, min_weight, color_by_rgb, color_by_confidence,
                    resolve_use_kernel(use_kernel, bv.device))


def _extract(bv, min_weight, color_by_rgb, color_by_confidence, kernel: bool):
    """extract_soup_bricks with the route chosen: ``kernel`` goes through the
    kernel wrappers (which run their plain versions on CPU tensors)."""
    cfg, B = bv.config, bv.brick_size
    nv = B ** 3
    colored = color_by_confidence or (color_by_rgb and bv.color is not None)
    cand = _candidate_slots(bv, min_weight)               # host sync 1
    if cand.shape[0] == 0:
        return _empty_soup(bv.device, colored)
    if kernel:
        count, cube, corners, ntri = corner_halo(bv, cand, min_weight)
        ends = torch.cumsum(ntri, 0, dtype=torch.int32)
        n_tri = int(ends[-1])                               # host sync 2
        if n_tri == 0:
            return _empty_soup(bv.device, colored)
        verts, tri_cube = emit_triangles(bv, cand, count, cube, corners, ends - ntri, n_tri)
        rgb = _voxel_rgb(bv, tri_cube, color_by_rgb, color_by_confidence)
        return MeshSoup(vertices=verts, colors=_expand_colors(rgb), num_triangles=n_tri)

    dstack, ok = _corner_stacks(bv, cand, min_weight)
    ids = torch.nonzero(ok.reshape(-1)).squeeze(1)          # host sync 2
    if ids.shape[0] == 0:
        return _empty_soup(bv.device, colored)
    brick = cand[ids // nv].long()                 # slot of each crossing cube
    within = ids % nv
    vals = dstack[ids] * cfg.max_dist_neg          # [N, 8] meters (cpp:105)
    cs = bv.coords[brick]
    ci = cs[:, 0] * B + within // (B * B)
    cj = cs[:, 1] * B + (within // B) % B
    ck = cs[:, 2] * B + within % B
    center_rgb = _voxel_rgb(bv, brick * nv + within, color_by_rgb, color_by_confidence)
    return _emit_soup(cfg, bv.global_transform, ci, cj, ck, vals, center_rgb)


def extract_mesh_bricks(bv, min_weight: float = DEFAULT_MIN_WEIGHT,
                        color_by_rgb: bool = False,
                        color_by_confidence: bool = False,
                        use_kernel: Optional[bool] = None):
    """Brick-native extraction returning numpy (V, F, C | None)."""
    return extract_soup_bricks(bv, min_weight, color_by_rgb, color_by_confidence,
                               use_kernel).to_numpy()


# ---------------------------------------------------------------------------
# the dense route
# ---------------------------------------------------------------------------

def active_cube_mask(vol, min_weight: float):
    """The reference cube filter over every cube of a dense volume, bool
    [X-1, Y-1, Z-1]: all 8 corners w >= min_weight and |d| < 1 (the centre
    voxel, corner 0, among them: cpp:190-193), a sign change, the lower
    corner interior, 1 <= index <= res-2 per axis (cpp:199-202)."""
    d, w = vol.sdf, vol.weight
    X, Y, Z = d.shape
    dev = d.device
    ii = torch.arange(X - 1, device=dev)[:, None, None]
    jj = torch.arange(Y - 1, device=dev)[None, :, None]
    kk = torch.arange(Z - 1, device=dev)[None, None, :]
    ok = (ii >= 1) & (jj >= 1) & (kk >= 1)
    neg = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.bool, device=dev)
    pos = torch.zeros_like(neg)
    for ox, oy, oz in CORNER_OFFSETS.tolist():
        sl = (slice(ox, X - 1 + ox), slice(oy, Y - 1 + oy), slice(oz, Z - 1 + oz))
        dc, wc = d[sl], w[sl]
        ok = ok & (wc >= min_weight) & (torch.abs(dc) < 1.0)
        neg = neg | (dc < 0)
        pos = pos | (dc >= 0)
    return ok & neg & pos


def count_active_cubes(vol, min_weight: float = DEFAULT_MIN_WEIGHT) -> int:
    """Crossing cubes of a dense volume (one host sync)."""
    return int(active_cube_mask(vol, min_weight).sum())


def marching_cubes(vol, min_weight: float = DEFAULT_MIN_WEIGHT,
                   color_by_rgb: bool = False,
                   color_by_confidence: bool = False) -> MeshSoup:
    """The dense route: every crossing cube of a dense TSDFVolume, in
    cube-major order (the JAX package's ``marching_cubes``), sized from the
    exact count (one ``nonzero``), so there is no cube budget to overflow.
    Plain torch ops on the volume's device."""
    cfg = vol.config
    X, Y, Z = cfg.xres, cfg.yres, cfg.zres
    ids = torch.nonzero(active_cube_mask(vol, min_weight).reshape(-1)).squeeze(1)
    colored = color_by_confidence or (color_by_rgb and vol.color is not None)
    if ids.shape[0] == 0:
        return _empty_soup(vol.device, colored)
    ci = ids // ((Y - 1) * (Z - 1))
    cj = (ids // (Z - 1)) % (Y - 1)
    ck = ids % (Z - 1)
    offs = torch.as_tensor(CORNER_OFFSETS, dtype=torch.int64, device=ids.device)
    corner = (((ci[:, None] + offs[:, 0]) * Y + (cj[:, None] + offs[:, 1])) * Z
              + (ck[:, None] + offs[:, 2]))
    vals = vol.sdf.reshape(-1)[corner] * cfg.max_dist_neg     # [N, 8] meters (cpp:105)
    center_rgb = _voxel_rgb(vol, corner[:, 0], color_by_rgb, color_by_confidence)
    return _emit_soup(cfg, vol.global_transform, ci, cj, ck, vals, center_rgb)


def extract_mesh(vol, min_weight: float = DEFAULT_MIN_WEIGHT,
                 color_by_rgb: bool = False, color_by_confidence: bool = False,
                 use_kernel: Optional[bool] = None):
    """Extract the isosurface as numpy (vertices [N*3, 3], faces [N, 3],
    colors [N*3, 3] | None).

    A brick volume takes the brick route. A dense volume takes it too when
    the kernels run (``bricks.from_dense(vol, 8)``, then the corner-halo and
    emission kernels), else the dense route :func:`marching_cubes`; the two
    give the same triangles in another order. use_kernel: None = the
    kernels on the card and the plain routes on the CPU; False = the plain
    routes anywhere; True on the CPU raises."""
    from ..bricks import BrickVolume, from_dense

    if isinstance(vol, BrickVolume):
        return extract_mesh_bricks(vol, min_weight, color_by_rgb, color_by_confidence,
                                   use_kernel)
    if resolve_use_kernel(use_kernel, vol.device):
        # from_dense sizes its capacity from the observed bricks: no overflow
        return extract_mesh_bricks(from_dense(vol, 8), min_weight, color_by_rgb,
                                   color_by_confidence, True)
    return marching_cubes(vol, min_weight, color_by_rgb, color_by_confidence).to_numpy()


def bytes_moved_corner_halo(n_bricks: int, n_cubes: int, B: int = 8) -> int:
    """Least traffic of one corner_halo call on bricks of B^3 voxels: each
    candidate's (B+1)^3 halo of d and w read once; its cube table (B^3
    entries: the crossing cubes' codes and the -1 after them), count and
    triangle count written once, and 32 B of corners for each of the
    n_cubes crossing cubes."""
    return n_bricks * ((B + 1) ** 3 * 2 * 4 + B ** 3 * 4 + 8) + n_cubes * 8 * 4


def bytes_moved_dense_stack(n_bricks: int, B: int = 8) -> int:
    """Least traffic of the former dense corner-halo contract, kept as a
    yardstick: the (B+1)^3 halo read, every voxel's 8 corner values, ok and
    loc written."""
    return n_bricks * ((B + 1) ** 3 * 2 * 4 + B ** 3 * (8 + 2) * 4)


def bytes_moved_emit(n_bricks: int, n_cubes: int, n_tris: int) -> int:
    """Least traffic of one emit_triangles call: per candidate its slot,
    coords, count and first triangle (24 B); per crossing cube its code and
    8 corners (36 B); the transform's 3 rows (48 B); per triangle its 3
    vertices and cube reference written (40 B)."""
    return n_bricks * 24 + n_cubes * 36 + 48 + n_tris * 40
