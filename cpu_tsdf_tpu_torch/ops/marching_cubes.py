"""Marching cubes over the brick volume: the brick route of the JAX package.

Port of ``cpu_tsdf_tpu.ops.marching_cubes`` (MarchingCubesTSDFOctree,
cpu_tsdf/src/lib/marching_cubes_tsdf_octree.cpp:43-236), brick route only.
One extraction is:

  1. candidate bricks: per-brick (min, max) of the valid d, combined over
     the brick and its seven +1 neighbours, must straddle 0 — a superset of
     the bricks holding a crossing cube;
  2. corner stacks, the reference's cube filter and a per-brick compaction
     for the candidates (kernel 2, ``csrc/mc_corner_halo.cu``; its plain
     version :func:`_corner_stacks` + :func:`_pack_left_plain`);
  3. global compaction of the crossing cubes, table lookup, edge
     interpolation (PCL's interpolateEdge on the voxel-centre lattice) and
     triangle emission; on the kernel route the triangles are compacted
     first with the pack-left kernel (kernel 3, ``csrc/pack_left.cu``).

Budgets are sized from exact counts (host syncs: the candidate list, the
cube count, the triangle count), so nothing overflows and there is no
retry. The triangle order is the JAX package's: ascending slot of the
candidate brick, then voxel, then triangle slot of the case table.
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

V = 512  # voxels of an 8^3 brick: the lane width of both kernels

# Kernel launches since the last reset (plain runs not counted).
launches = {"corner_halo": 0, "pack_left": 0}

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
# step 2: corner stacks + cube filter (kernel 2) and pack-left (kernel 3)
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
    """Plain version of the pack-left kernel: loc[k, r] = lane of the r-th
    lane of row k with mask > 0, -1 padded. [NB, L] -> int32 [NB, L]."""
    on = mask > 0
    NB, L = on.shape
    rank = torch.cumsum(on, 1) - 1
    loc = torch.full((NB, L + 1), -1, dtype=torch.int32, device=mask.device)
    lane = torch.arange(L, dtype=torch.int32, device=mask.device).expand(NB, L)
    loc.scatter_(1, torch.where(on, rank, L), lane)  # column L takes the rest
    return loc[:, :L].contiguous()


def corner_halo(bv, slots, min_weight: float):
    """Corner stacks, cube filter and per-brick compaction for the bricks at
    ``slots`` (int32 [K]): returns (dstack [K*512, 8] f32, ok [K, 512]
    bool, loc [K, 512] int32).

    On CPU tensors: :func:`_corner_stacks` + :func:`_pack_left_plain`. On
    CUDA tensors: csrc/mc_corner_halo.cu (8^3 bricks only)."""
    if bv.device.type == "cpu":
        dstack, ok = _corner_stacks(bv, slots, min_weight)
        return dstack, ok, _pack_left_plain(ok)
    from .._build import check, check_tensor, function, stream_ptr

    dev = bv.device
    C, K = bv.capacity, slots.shape[0]
    nb = bv.bricks_per_axis
    if bv.brick_size != 8:
        raise ValueError("the corner-halo kernel takes 8^3 bricks only")
    for what, t, dt, shape in (("slots", slots, torch.int32, (K,)),
                               ("sdf", bv.sdf, torch.float32, (C, V)),
                               ("weight", bv.weight, torch.float32, (C, V)),
                               ("brick_map", bv.brick_map, torch.int32, nb),
                               ("coords", bv.coords, torch.int32, (C, 3))):
        check_tensor(f"corner_halo: {what}", t, dt, shape, dev)
    dstack = torch.empty((K * V, 8), dtype=torch.float32, device=dev)
    ok = torch.empty((K, V), dtype=torch.int32, device=dev)
    loc = torch.empty((K, V), dtype=torch.int32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = function("mc_corner_halo", "tsdf_corner_halo",
                  [p] * 5 + [i] * 8 + [ctypes.c_float] + [p] * 4)
    cfg = bv.config
    err = fn(bv.sdf.data_ptr(), bv.weight.data_ptr(), bv.brick_map.data_ptr(),
             bv.coords.data_ptr(), slots.data_ptr(), K, C, *nb,
             cfg.xres, cfg.yres, cfg.zres, float(min_weight),
             dstack.data_ptr(), ok.data_ptr(), loc.data_ptr(), stream_ptr(dev))
    check(err, "corner_halo")
    launches["corner_halo"] += 1
    return dstack, ok > 0, loc


def pack_left_rows(mask2d):
    """Per-row pack-left table of an int32 [NB, 512] mask (set = > 0).

    On CPU tensors: :func:`_pack_left_plain`. On CUDA tensors:
    csrc/pack_left.cu."""
    if mask2d.device.type == "cpu":
        return _pack_left_plain(mask2d)
    from .._build import check, check_tensor, function, stream_ptr

    NB = mask2d.shape[0]
    check_tensor("pack_left_rows: mask", mask2d, torch.int32, (NB, V), mask2d.device)
    loc = torch.empty((NB, V), dtype=torch.int32, device=mask2d.device)
    p = ctypes.c_void_p
    fn = function("pack_left", "tsdf_pack_left", [p, p, ctypes.c_int, p])
    check(fn(mask2d.data_ptr(), loc.data_ptr(), NB, stream_ptr(mask2d.device)),
          "pack_left_rows")
    launches["pack_left"] += 1
    return loc


def _compact_from_loc(mask2d, loc):
    """Flat indices (ascending, int64) of the set entries of mask2d [NB, L],
    from its per-row pack-left table: row offsets plus one gather instead
    of a global scan of every element. One host sync (the count)."""
    NB, L = mask2d.shape
    cnt = (mask2d > 0).sum(1)
    off = torch.cumsum(cnt, 0) - cnt                                  # exclusive
    n = int(cnt.sum())
    r = torch.arange(n, device=mask2d.device)
    # the last row whose offset is <= r holds the r-th entry (an empty row
    # shares its offset with the next one, which wins)
    blk = torch.searchsorted(off, r, right=True) - 1
    return blk * L + loc[blk, r - off[blk]].long()


# ---------------------------------------------------------------------------
# step 3: triangle emission
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


def _case_rows(vals):
    """Case-table rows: (edge ids [N, MAX, 3] int64, triangle counts [N])
    from the PCL cubeindex (bit i set iff corner i's value < 0)."""
    dev = vals.device
    cubeindex = ((vals < 0.0).long() << torch.arange(8, device=dev)).sum(1)
    table = torch.as_tensor(TRI_TABLE, dtype=torch.int64, device=dev)
    count = torch.as_tensor(TRI_COUNT, dtype=torch.int64, device=dev)
    entries = torch.clamp(table[cubeindex], min=0).reshape(-1, MAX_TRIS_PER_CUBE, 3)
    return entries, count[cubeindex]


def _finish(global_transform, verts, center_rgb, cube):
    """Apply the global transform (cpp:122,128) and the per-cube colors."""
    x, y, z = transform_points(global_transform, verts[..., 0], verts[..., 1],
                               verts[..., 2])
    verts = torch.stack([x, y, z], -1)
    colors = None
    if center_rgb is not None:
        colors = center_rgb[cube][:, None, :].expand(-1, 3, 3).contiguous()
    return MeshSoup(vertices=verts, colors=colors, num_triangles=int(verts.shape[0]))


def _emit_soup(cfg, global_transform, ci, cj, ck, vals, center_rgb) -> MeshSoup:
    """Plain route: every triangle slot of every cube, then a compaction to
    the valid ones (flat order = cube, then triangle slot)."""
    M = MAX_TRIS_PER_CUBE
    N = vals.shape[0]
    pts = _edge_points(cfg, ci, cj, ck, vals)
    entries, ntris = _case_rows(vals)
    verts = pts[torch.arange(N, device=vals.device)[:, None, None], entries]  # [N,M,3,3]
    valid = torch.arange(M, device=vals.device)[None, :] < ntris[:, None]
    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    return _finish(global_transform, verts.reshape(N * M, 3, 3)[sel], center_rgb,
                   sel // M)


def _emit_soup_compacted(cfg, global_transform, ci, cj, ck, vals,
                         center_rgb) -> MeshSoup:
    """Kernel route: compact the triangle slots FIRST (pack-left over the
    [cube, slot] mask viewed as 512-lane rows, then _compact_from_loc) and
    interpolate vertices only for the survivors. Same triangles, same order
    as :func:`_emit_soup`."""
    M = MAX_TRIS_PER_CUBE
    N = vals.shape[0]
    dev = vals.device
    entries, ntris = _case_rows(vals)
    valid = (torch.arange(M, device=dev)[None, :] < ntris[:, None]).reshape(-1)
    pad = (-valid.shape[0]) % V
    mask2d = torch.cat([valid, valid.new_zeros(pad)]).to(torch.int32).reshape(-1, V)
    sel = _compact_from_loc(mask2d, pack_left_rows(mask2d))
    cube, slot = sel // M, sel % M
    pts = _edge_points(cfg, ci, cj, ck, vals)
    verts = pts[cube[:, None], entries[cube, slot]]                   # [T, 3, 3]
    return _finish(global_transform, verts, center_rgb, cube)


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

    use_kernel: None = kernels 2 and 3 on the card, the plain route on the
    CPU; False = the plain route anywhere; True on the CPU raises."""
    return _extract(bv, min_weight, color_by_rgb, color_by_confidence,
                    resolve_use_kernel(use_kernel, bv.device))


def _extract(bv, min_weight, color_by_rgb, color_by_confidence, kernel: bool):
    """extract_soup_bricks with the route chosen: ``kernel`` goes through the
    kernel wrappers (which run their plain versions on CPU tensors)."""
    cfg, B = bv.config, bv.brick_size
    nv = B ** 3
    colored = color_by_confidence or (color_by_rgb and bv.color is not None)
    cand = _candidate_slots(bv, min_weight)
    if cand.shape[0] == 0:
        return _empty_soup(bv.device, colored)
    if kernel:
        dstack, ok, loc = corner_halo(bv, cand, min_weight)
        ids = _compact_from_loc(ok, loc)
    else:
        dstack, ok = _corner_stacks(bv, cand, min_weight)
        ids = torch.nonzero(ok.reshape(-1)).squeeze(1)
    if ids.shape[0] == 0:
        return _empty_soup(bv.device, colored)
    brick = cand[ids // nv].long()                 # slot of each crossing cube
    within = ids % nv
    vals = dstack[ids] * cfg.max_dist_neg          # [N, 8] meters (cpp:105)
    cs = bv.coords[brick]
    ci = cs[:, 0] * B + within // (B * B)
    cj = cs[:, 1] * B + (within // B) % B
    ck = cs[:, 2] * B + within % B

    center_rgb = None  # per-cube color from the lower-corner voxel (cpp:216-230)
    if color_by_rgb and bv.color is not None:
        r, g, b = color_ops.color_to_rgb(cfg.color_mode, bv.color[brick, within])
        center_rgb = torch.stack([r, g, b], -1)
    elif color_by_confidence:
        std_dev = div_const(100.0 - bv.weight[brick, within], 100.0)
        r = torch.clamp((1.0 - std_dev) * 255.0, 0.0, 255.0)
        b = torch.clamp(std_dev * 255.0, 0.0, 255.0)
        center_rgb = torch.stack([r, torch.zeros_like(r), b], -1)

    emit = _emit_soup_compacted if kernel else _emit_soup
    return emit(cfg, bv.global_transform, ci, cj, ck, vals, center_rgb)


def extract_mesh_bricks(bv, min_weight: float = DEFAULT_MIN_WEIGHT,
                        color_by_rgb: bool = False,
                        color_by_confidence: bool = False,
                        use_kernel: Optional[bool] = None):
    """Brick-native extraction returning numpy (V, F, C | None)."""
    return extract_soup_bricks(bv, min_weight, color_by_rgb, color_by_confidence,
                               use_kernel).to_numpy()


def extract_mesh(vol, min_weight: float = DEFAULT_MIN_WEIGHT,
                 color_by_rgb: bool = False, color_by_confidence: bool = False,
                 use_kernel: Optional[bool] = None):
    """Extract the isosurface as numpy (vertices [N*3, 3], faces [N, 3],
    colors [N*3, 3] | None). Brick volumes only in this version of the
    port: the dense route (``marching_cubes``) is not ported yet."""
    from ..bricks import BrickVolume

    if not isinstance(vol, BrickVolume):
        raise NotImplementedError(
            "extract_mesh on a dense TSDFVolume is not ported yet; convert "
            "with bricks.from_dense first")
    return extract_mesh_bricks(vol, min_weight, color_by_rgb, color_by_confidence,
                               use_kernel)


def bytes_moved_corner_halo(n_bricks: int) -> int:
    """Least traffic of one corner_halo call: each candidate's 9^3 halo of
    d and w read once, its 8 corner values, ok and loc written once."""
    return n_bricks * (9 ** 3 * 2 * 4 + V * (8 + 2) * 4)


def bytes_moved_pack_left(n_rows: int) -> int:
    """Least traffic of one pack_left_rows call: the mask read, loc written."""
    return 2 * n_rows * V * 4
