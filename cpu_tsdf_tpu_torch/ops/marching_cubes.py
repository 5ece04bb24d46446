"""Marching cubes over brick and dense volumes.

Port of ``cpu_tsdf_tpu.ops.marching_cubes`` (MarchingCubesTSDFOctree,
cpu_tsdf/src/lib/marching_cubes_tsdf_octree.cpp:43-236). A brick
extraction runs over chunks of ``chunk_slots`` slots, the live ones only;
each chunk is one program of fixed shapes with no host sync
(:func:`_extract_chunk`, the counterpart of the JAX package's
``_extract_chunk_compact``):

  1. per-slot (min, max) of the valid d over the live chunks
     (:func:`_brick_stats`);
  2. candidate bricks of the chunk: the (min, max) combined over the brick
     and its seven +1 neighbours straddles 0, a superset of the bricks
     holding a crossing cube; compacted to a brick budget, the pads at the
     sentinel row C;
  3. the reference's cube filter over the candidates' cubes, their corner
     values and triangle counts (the corner-halo kernel,
     ``csrc/mc_corner_halo.cu``; plain version :func:`_corner_halo_plain`);
  4. the triangle offsets (an exclusive scan on the device) and the
     emission into a fixed ``[tri_budget, 3, 3]`` buffer, no triangle at or
     past the budget stored (``csrc/mc_emit.cu``; plain version
     :func:`_emit_plain`): table lookup, edge interpolation (PCL's
     interpolateEdge on the voxel-centre lattice), the global transform;
  5. the colors, and the chunk's counts and overflow flags.

``check=True`` reads each batch of chunks' counts in one host sync and runs
a chunk whose brick, cube or triangle budget overflowed again with that
budget doubled, as the JAX package does; the result is compact and carries
budget hints. On the card the brick stats replay a CUDA graph a live chunk
and each chunk program one a budget triple, the chunk's start in a device
buffer (``graph.checked_extraction``: the JAX package's shape, one
compiled program a budget triple). ``check=False`` issues no host sync:
fixed per-chunk buffers, ``tri_valid``, ``num_triangles`` and
``overflowed`` on the device; on the card it replays a CUDA graph
(``graph.extract_graphed``).

The triangle order is the JAX package's: ascending slot of the candidate
brick, then voxel, then triangle slot of the case table. The halo keeps
each brick's crossing cubes, so no cube list is compacted: the cube budget
only sets the reported count's overflow flag, which the retries and hints
read as the JAX package's do.

A dense volume on the card goes through the same kernels after
``bricks.from_dense``, as the JAX package does on an accelerator; on the
CPU it takes the dense route (:func:`marching_cubes`: the cube filter over
every cube, a budgeted compaction, every triangle slot), whose triangles
come in cube-major order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
from typing import Optional

import numpy as np
import torch

from .. import tracing
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
launches = tracing.counters("marching_cubes.launches", {"corner_halo": 0, "emit": 0})

# +1-neighbour directions; index (bx<<2)|(by<<1)|bz, as in the halo kernel.
_NBR_BITS = tuple(((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8))

# corner_engine values of the JAX package and the route each takes here
_ENGINES = {"xla": False, "interpret": False, "pallas": True}


@dataclasses.dataclass
class MeshSoup:
    """Fixed-budget triangle soup: triangle i is real iff tri_valid[i]. The
    checked brick route returns it compact (the first num_triangles rows)."""

    vertices: torch.Tensor          # [T, 3, 3] f32 (triangle, corner, xyz)
    colors: Optional[torch.Tensor]  # [T, 3, 3] f32 (0..255) or None
    tri_valid: torch.Tensor         # [T] bool
    num_triangles: torch.Tensor     # 0-dim int32
    overflowed: torch.Tensor        # 0-dim bool: a budget was exceeded
    # brick-route reuse hints (extract_soup_bricks), tuples of host ints
    live_chunks: Optional[tuple] = None   # chunk start slots
    budget_hint: Optional[tuple] = None   # per chunk (cube, brick, tri)

    def to_numpy(self):
        """(V [N*3, 3], F [N, 3], C [N*3, 3] or None) as numpy arrays, N =
        num_triangles. A soup that is not compact is compacted on the
        device first (:func:`_compact_soup`), so only the real triangles
        are copied to the host."""
        n = int(self.num_triangles)
        if n == 0:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                    None if self.colors is None else np.zeros((0, 3), np.float32))
        if self.vertices.shape[0] == n:
            v, c = self.vertices, self.colors
        else:
            v, c = _compact_soup(self, 1 << (n - 1).bit_length())
        verts = v[:n].detach().cpu().numpy().reshape(-1, 3)
        faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
        cols = None if c is None else c[:n].detach().cpu().numpy().reshape(-1, 3)
        return verts, faces, cols


def _compact_soup(soup: MeshSoup, budget: int):
    """The valid triangles' rows in order, [budget, 3, 3] vertices (and
    colors): a cumsum rank of tri_valid and a row gather, as the JAX
    package's ``_compact_soup``; rows past the valid count are
    unspecified."""
    from ..activation import _compact

    T = soup.tri_valid.shape[0]
    ids, _ = _compact(soup.tri_valid, torch.arange(T, dtype=torch.int32,
                                                   device=soup.tri_valid.device), budget)
    sel = torch.clamp(ids, min=0).long()
    return soup.vertices[sel], None if soup.colors is None else soup.colors[sel]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The case tables on a device (TRI_TABLE [256, 3 * MAX] and TRI_COUNT
    [256], int64), copied there once: a copy from the host inside an
    extraction would be a host sync."""
    return (torch.as_tensor(TRI_TABLE, dtype=torch.int64, device=device),
            torch.as_tensor(TRI_COUNT, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# step 1: brick stats and candidate bricks
# ---------------------------------------------------------------------------

def _brick_stats(bv, live_chunks: tuple, chunk_slots: int, min_weight: float):
    """Per-slot (min, max) of d over VALID voxels (w >= min_weight, |d| < 1)
    of the chunks starting at `live_chunks`; +inf/-inf where there is none,
    outside those chunks and at index C (the missing-neighbour sentinel).
    Returns ([C+1], [C+1])."""
    C = bv.capacity
    inf = float("inf")
    dmin = torch.full((C + 1,), inf, dtype=torch.float32, device=bv.device)
    dmax = torch.full((C + 1,), -inf, dtype=torch.float32, device=bv.device)
    for s0 in live_chunks:
        _chunk_stats(bv, dmin, dmax, s0, chunk_slots, min_weight)
    return dmin, dmax


def _chunk_slots_of(bv, slot0, chunk_slots: int):
    """int32 [chunk_slots] slots of the chunk from slot0 (a Python int, or
    a 0-dim int32 tensor on the device: the graphs' static start)."""
    return torch.arange(chunk_slots, dtype=torch.int32, device=bv.device) + slot0


def _chunk_stats(bv, dmin, dmax, slot0, chunk_slots: int, min_weight: float) -> None:
    """:func:`_brick_stats` of the chunk from slot0, written into dmin and
    dmax in place: the body of the JAX package's ``_brick_stats_scan``
    (fixed shapes, no host sync; on the card a graph replayed a live
    chunk, ``graph.checked_extraction``)."""
    slots = _chunk_slots_of(bv, slot0, chunk_slots)
    d = bv.sdf.index_select(0, slots)
    valid = (bv.weight.index_select(0, slots) >= min_weight) & (torch.abs(d) < 1.0)
    inf = float("inf")
    dmin.index_copy_(0, slots.long(), torch.where(valid, d, inf).amin(1))
    dmax.index_copy_(0, slots.long(), torch.where(valid, d, -inf).amax(1))


def _neighbor_slots(bv, coords, live):
    """[K, 8] slots of each brick's +1 neighbours in _NBR_BITS order (own
    slot first); C where the brick is dead, the neighbour is outside the
    grid or unallocated."""
    nbx, nby, nbz = bv.bricks_per_axis
    C = bv.capacity
    i = torch.arange(8, dtype=torch.int32, device=coords.device)
    bits = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], 1)       # _NBR_BITS
    nc = coords[:, None, :] + bits[None]                            # [K, 8, 3]
    inside = live[:, None] & (nc[..., 0] < nbx) & (nc[..., 1] < nby) & (nc[..., 2] < nbz)
    blin = (nc[..., 0] * nby + nc[..., 1]) * nbz + nc[..., 2]
    ns = bv.brick_map.view(-1)[torch.clamp(blin, 0, nbx * nby * nbz - 1).long()]
    return torch.where(inside & (ns >= 0), ns, C)


def _candidate_mask(bv, stats, coords):
    """Whether each brick of `coords` [K, 3] (-1 rows dead) may hold a
    crossing cube: a valid voxel of its own (a cube's lower corner is in the
    brick) and the valid d over it and its +1 neighbours straddling 0."""
    dmin, dmax = stats
    live = coords[:, 0] >= 0
    ns = _neighbor_slots(bv, coords, live).long()
    return (live & (dmin[ns[:, 0]] < float("inf")) & (dmin[ns].amin(1) < 0.0)
            & (dmax[ns].amax(1) >= 0.0))


def _candidate_slots(bv, min_weight: float):
    """Ascending int32 slots of every candidate brick of the volume (one
    host sync: the list's length). The extraction itself compacts each
    chunk's candidates to a budget instead."""
    stats = _brick_stats(bv, (0,), bv.capacity, min_weight)
    return torch.nonzero(_candidate_mask(bv, stats, bv.coords)).squeeze(1).to(torch.int32)


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
    tri_count = _tables(ok.device)[1]
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
    v1 = torch.stack([vals[:, a] for a in e_a], 1)   # an index list would be a host copy
    v2 = torch.stack([vals[:, b] for b in e_b], 1)
    p1 = torch.stack([corner_xyz(a) for a in e_a], 1)
    p2 = torch.stack([corner_xyz(b) for b in e_b], 1)
    denom = v2 - v1
    flat = denom == 0
    mu = torch.where(flat, torch.full_like(denom, 0.5),
                     (0.0 - v1) / torch.where(flat, torch.ones_like(denom), denom))
    return p1 + mu[..., None] * (p2 - p1)


def _triangle_slots(cfg, global_transform, ci, cj, ck, vals, cubeindex):
    """Every triangle slot of N cubes, in (cube, table slot) order:
    vertices [N * MAX, 3, 3] after the global transform (cpp:122,128; a
    slot past its cube's count holds edge 0's triangle) and each cube's
    triangle count [N] int64."""
    M = MAX_TRIS_PER_CUBE
    N = vals.shape[0]
    table, count = _tables(vals.device)
    entries = torch.clamp(table[cubeindex], min=0).reshape(N, M, 3)
    pts = _edge_points(cfg, ci, cj, ck, vals)
    verts = pts[torch.arange(N, device=vals.device)[:, None, None], entries]  # [N,M,3,3]
    verts = verts.reshape(N * M, 3, 3)
    x, y, z = transform_points(global_transform, verts[..., 0], verts[..., 1],
                               verts[..., 2])
    return torch.stack([x, y, z], -1), count[cubeindex]


def _emit_plain(bv, slots, count, cube, corners, tri_off, tri_budget: int):
    """Plain version of the emission kernel, on corner_halo's outputs:
    fixed shapes, no host sync. The crossing cubes whose first triangle
    falls below tri_budget are compacted (a crossing cube has at least one
    triangle, so at most tri_budget of them), their triangle slots built and
    each triangle placed at its rank. See :func:`emit_triangles`; rows
    from the total on are unspecified."""
    from ..activation import _compact

    cfg, B, C = bv.config, bv.brick_size, bv.capacity
    nv = B ** 3
    K = slots.shape[0]
    M = MAX_TRIS_PER_CUBE
    dev = cube.device
    live = torch.arange(nv, device=dev)[None, :] < count[:, None]           # [K, nv]
    code = torch.where(live, cube, 0).long()
    ntri = torch.where(live, _tables(dev)[1][code // nv], 0)
    first = tri_off[:, None] + torch.cumsum(ntri, 1) - ntri                 # [K, nv]
    ids, _ = _compact((live & (first < tri_budget)).reshape(-1),
                      torch.arange(K * nv, dtype=torch.int32, device=dev),
                      min(tri_budget, K * nv))
    ok = ids >= 0
    i = torch.clamp(ids, min=0).long()
    code, k = code.reshape(-1)[i], i // nv
    within, cubeindex = code % nv, code // nv
    brick = torch.clamp(slots[k], 0, C - 1).long()
    cs = bv.coords[brick]
    verts, nt = _triangle_slots(cfg, bv.global_transform, cs[:, 0] * B + within // (B * B),
                                cs[:, 1] * B + (within // B) % B, cs[:, 2] * B + within % B,
                                corners.reshape(-1, 8)[i] * cfg.max_dist_neg, cubeindex)
    slot = torch.arange(M, device=dev)[None, :]
    dest = first.reshape(-1)[i][:, None] + slot                              # [N, M]
    keep = ok[:, None] & (slot < nt[:, None]) & (dest < tri_budget)
    sel = torch.zeros((tri_budget + 1,), dtype=torch.int64, device=dev)
    sel.scatter_(0, torch.where(keep, dest, tri_budget).reshape(-1).long(),
                 torch.arange(keep.numel(), device=dev))       # index tri_budget takes the rest
    sel = sel[:tri_budget]
    return verts[sel], (brick * nv + within)[sel // M].to(torch.int32)


def emit_triangles(bv, slots, count, cube, corners, tri_off, tri_budget: int):
    """The triangles of corner_halo's crossing cubes: (vertices
    [tri_budget, 3, 3] f32 after the global transform, tri_cube
    [tri_budget] int32 = slot * B^3 + voxel of each triangle's cube), in
    candidate order, then rank, then case-table slot. tri_off int32 [K] is
    each brick's first triangle (the exclusive prefix sum of corner_halo's
    ntri); a triangle at or past tri_budget is not stored, and the rows
    from the total on are unspecified.

    On CPU tensors: :func:`_emit_plain`. On CUDA tensors: csrc/mc_emit.cu,
    for every even brick size."""
    if bv.device.type == "cpu":
        return _emit_plain(bv, slots, count, cube, corners, tri_off, tri_budget)
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
    verts = torch.empty((tri_budget, 3, 3), dtype=torch.float32, device=dev)
    tri_cube = torch.empty((tri_budget,), dtype=torch.int32, device=dev)
    if K == 0 or tri_budget == 0:
        return verts, tri_cube
    cfg = bv.config
    grid = (ctypes.c_float * 7)(*cfg.cell_size, cfg.xsize / 2.0, cfg.ysize / 2.0,
                                cfg.zsize / 2.0, cfg.max_dist_neg)
    p = ctypes.c_void_p
    fn = function("mc_emit", "tsdf_mc_emit",
                  [p] * 7 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_float), p, p, p])
    err = fn(slots.data_ptr(), bv.coords.data_ptr(), count.data_ptr(), cube.data_ptr(),
             corners.data_ptr(), tri_off.data_ptr(), bv.global_transform.data_ptr(), K,
             B, tri_budget, grid, verts.data_ptr(), tri_cube.data_ptr(), stream_ptr(dev))
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


def _expand_colors(rgb):
    """Per-triangle colors [T, 3] -> the soup's [T, 3, 3] (or None)."""
    return None if rgb is None else rgb[:, None, :].expand(-1, 3, 3).contiguous()


# ---------------------------------------------------------------------------
# the chunk program and the extraction entry points
# ---------------------------------------------------------------------------

def _extract_chunk(bv, stats, slot0, chunk_slots: int, cube_budget: int,
                   brick_budget: int, tri_budget: int, min_weight: float,
                   color_by_rgb: bool, color_by_confidence: bool, kernel: bool):
    """Triangles of the cubes whose lower corner lies in bricks [slot0,
    slot0 + chunk_slots): fixed shapes, no host sync. slot0 is a Python int
    or a 0-dim int32 device tensor (one graph then serves every chunk, as
    the JAX package's ``_extract_chunk_compact`` traces it). `stats` is
    :func:`_brick_stats`' pair; ``kernel`` takes the kernel wrappers (which
    run their plain versions on CPU tensors), else the plain versions.
    Returns (vertices [tri_budget, 3, 3], colors [tri_budget, 3, 3] or None,
    tri_valid [tri_budget] bool, out int32 [6]: n_tris, cube_ovf, brick_ovf,
    tri_ovf, n_cubes, n_bricks), the JAX package's ``out``."""
    from ..activation import _compact

    C, dev = bv.capacity, bv.device
    slots = _chunk_slots_of(bv, slot0, chunk_slots)
    cand = _candidate_mask(bv, stats, bv.coords.index_select(0, slots))
    bidx, n_bricks = _compact(cand, slots, brick_budget)
    cand_slots = torch.where(bidx >= 0, bidx, C)
    halo, emit = (corner_halo, emit_triangles) if kernel else (_corner_halo_plain, _emit_plain)
    count, cube, corners, ntri = halo(bv, cand_slots, min_weight)
    n_cubes = count.sum(dtype=torch.int32)
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n_tri = ends[-1]
    verts, tri_cube = emit(bv, cand_slots, count, cube, corners, ends - ntri, tri_budget)
    tri_valid = torch.arange(tri_budget, device=dev) < n_tri
    rgb = _voxel_rgb(bv, torch.where(tri_valid, tri_cube, 0), color_by_rgb,
                     color_by_confidence)
    out = torch.stack([n_tri, (n_cubes > cube_budget).to(torch.int32),
                       (n_bricks > brick_budget).to(torch.int32),
                       (n_tri > tri_budget).to(torch.int32), n_cubes, n_bricks])
    return verts, _expand_colors(rgb), tri_valid, out


def _live_chunks(bv, chunk_slots: int) -> tuple:
    """Start slots of the chunks holding a live brick (one host sync when
    there is more than one chunk)."""
    nchunks = bv.capacity // chunk_slots
    if nchunks == 1:
        return (0,)
    live = (bv.coords[:, 0] >= 0).reshape(nchunks, -1).any(1).tolist()
    return tuple(i * chunk_slots for i in range(nchunks) if live[i]) or (0,)


def _resolve_engine(corner_engine: Optional[str], use_kernel: Optional[bool], device) -> bool:
    """The route of an extraction: corner_engine "pallas" takes the
    kernels, "xla" and "interpret" the plain route, None leaves it to
    use_kernel (None = the kernels on the card, the plain route on the
    CPU). The kernels on the CPU, or two switches that disagree, raise."""
    if corner_engine is None:
        return resolve_use_kernel(use_kernel, device)
    if corner_engine not in _ENGINES:
        raise ValueError(f"corner_engine must be one of {sorted(_ENGINES)} or None, "
                         f"got {corner_engine!r}")
    kernel = _ENGINES[corner_engine]
    if use_kernel is not None and bool(use_kernel) != kernel:
        raise ValueError(f"corner_engine={corner_engine!r} and use_kernel={use_kernel} "
                         "name different routes")
    return resolve_use_kernel(kernel, device)


def _roundup(n: int, step: int, lo: int) -> int:
    """n rounded up to a multiple of step, at least lo: the JAX package's
    grid of budget hints."""
    return max(lo, (int(n) + step - 1) // step * step)


def extract_soup_bricks(bv, min_weight: float = DEFAULT_MIN_WEIGHT,
                        color_by_rgb: bool = False,
                        color_by_confidence: bool = False,
                        chunk_slots: int = 2048,
                        cube_budget: int = 1 << 15,
                        tri_budget: Optional[int] = None,
                        live_chunks: Optional[tuple] = None,
                        budget_hint: Optional[tuple] = None,
                        check: bool = True,
                        corner_engine: Optional[str] = None, *,
                        use_kernel: Optional[bool] = None,
                        graph: Optional[bool] = None) -> MeshSoup:
    """Brick-native extraction on the volume's device, chunk by chunk over
    the live chunks (see the module docstring).

    The budgets are the JAX package's: ``chunk_slots`` slots a chunk
    (clamped to the capacity and halved until it divides it), per chunk a
    cube, brick (min(chunk_slots, max(256, cube_budget // 64))) and
    triangle (2 * cube_budget) budget. ``live_chunks`` (chunk start slots)
    skips the liveness readback; ``budget_hint`` (a soup's, aligned with its
    live_chunks) sizes each chunk's (cube, brick, tri) budgets.

    check=True: one host sync a batch of chunks; a chunk that overflowed a
    budget runs again with it doubled; the soup is compact, in live-chunk
    order, with tight hints (25 % headroom). check=False: no host sync; the
    soup keeps the per-chunk buffers, tri_valid is a (non-prefix) mask and
    num_triangles / overflowed stay on the device: callers check
    overflowed before trusting it.

    corner_engine: "pallas" = the corner-halo and emission kernels (the
    CPU raises); "xla" or "interpret" = the plain route; None = use_kernel
    (None: the kernels on the card, the plain route on the CPU; False: the
    plain route; True on the CPU raises). graph: None = on the card the
    CUDA graphs of the chunk programs (check=False: ``graph.
    extract_graphed``, one graph of every live chunk at their budgets;
    check=True: ``graph.checked_extraction``, the brick stats' graph
    replayed a live chunk and one chunk graph a budget triple replayed a
    chunk, the counts read in the batch's one host sync), each captured at
    its first run on this volume and settings, which runs as its warm-up;
    the soup's tensors are fresh. Eager on the CPU and on the
    plain route; False = eager; True raises where the graphs cannot run
    (the CPU, the plain route). The tracing call ``extract_soup_bricks``."""
    kernel = _resolve_engine(corner_engine, use_kernel, bv.device)
    with tracing.call("extract_soup_bricks", bv.device):
        return _extract(bv, min_weight, color_by_rgb, color_by_confidence, kernel,
                        chunk_slots, cube_budget, tri_budget, live_chunks, budget_hint, check,
                        graph)


def _extract(bv, min_weight, color_by_rgb, color_by_confidence, kernel: bool,
             chunk_slots: int = 2048, cube_budget: int = 1 << 15,
             tri_budget: Optional[int] = None, live_chunks=None, budget_hint=None,
             check: bool = True, graph: Optional[bool] = None) -> MeshSoup:
    """extract_soup_bricks with the route chosen."""
    from ..graph import checked_extraction, extract_graphed, resolve_graph

    dev = bv.device
    chunk_slots = min(chunk_slots, bv.capacity)
    while bv.capacity % chunk_slots:  # chunks must tile the slot range exactly
        chunk_slots //= 2
    if tri_budget is None:
        tri_budget = cube_budget * 2
    live_chunks = (_live_chunks(bv, chunk_slots) if live_chunks is None
                   else tuple(int(s) for s in live_chunks))
    kb0 = min(chunk_slots, max(256, cube_budget // 64))
    if budget_hint is not None and len(budget_hint) != len(live_chunks):
        raise ValueError(
            f"budget_hint has {len(budget_hint)} entries for "
            f"{len(live_chunks)} live chunks; pass the live_chunks the hint "
            f"was measured on alongside it")
    budgets = (tuple(tuple(int(b) for b in h) for h in budget_hint) if budget_hint is not None
               else ((cube_budget, kb0, tri_budget),) * len(live_chunks))
    args = (min_weight, color_by_rgb, color_by_confidence, kernel, chunk_slots, live_chunks)
    use_graph = resolve_graph(graph, dev)
    if use_graph and not kernel:
        if graph:
            raise ValueError("extract_soup_bricks: the extraction graphs are of the kernel "
                             "route")
        use_graph = False
    if not check:
        return (extract_graphed(bv, *args, budgets) if use_graph
                else _extract_unchecked(bv, *args, budgets))

    if use_graph:
        run = checked_extraction(bv, *args)
    else:
        stats = _brick_stats(bv, live_chunks, chunk_slots, min_weight)

        def run(s0, cb, kb, tb):
            return _extract_chunk(bv, stats, s0, chunk_slots, cb, kb, tb, min_weight,
                                  color_by_rgb, color_by_confidence, kernel)

    pending = [(s0, *b) for s0, b in zip(live_chunks, budgets)]
    done, hints = {}, {}
    while pending:
        runs = [(s0, cb, kb, tb, run(s0, cb, kb, tb)) for s0, cb, kb, tb in pending]
        counts = torch.stack([r[4][3] for r in runs]).tolist()    # one host sync a batch
        logging.getLogger("cpu_tsdf_tpu_torch").debug(
            "extract_soup_bricks: batch of %d chunks, (slot, cube, brick, tri) budgets %s, "
            "(n_tri, cube_ovf, brick_ovf, tri_ovf, n_cubes, n_bricks) %s",
            len(runs), [r[:4] for r in runs], counts)
        pending = []
        for (s0, cb, kb, tb, (v, c, _, _)), st in zip(runs, counts):
            n, cube_ovf, brick_ovf, tri_ovf, n_cubes, n_bricks = st
            if brick_ovf:
                pending.append((s0, cb, min(chunk_slots, kb * 2), tb))
            elif cube_ovf:
                pending.append((s0, cb * 2, kb, tb))
            elif tri_ovf:
                pending.append((s0, cb, kb, tb * 2))
            else:
                # tight budgets (25% headroom) for later unchecked calls
                hints[s0] = (_roundup(n_cubes * 5 // 4, 1 << 12, 1 << 10),
                             min(chunk_slots, _roundup(n_bricks * 5 // 4, 128, 256)),
                             _roundup(n * 5 // 4, 1 << 12, 1 << 11))
                done[s0] = (v[:n], None if c is None else c[:n])
    parts = [done[s0] for s0 in live_chunks if done[s0][0].shape[0]]
    verts = (torch.cat([p[0] for p in parts]) if parts
             else torch.zeros((0, 3, 3), dtype=torch.float32, device=dev))
    colors = None
    if color_by_confidence or (color_by_rgb and bv.color is not None):
        colors = torch.cat([p[1] for p in parts]) if parts else verts.clone()
    total = verts.shape[0]
    return MeshSoup(vertices=verts, colors=colors,
                    tri_valid=torch.ones((total,), dtype=torch.bool, device=dev),
                    num_triangles=torch.full((), total, dtype=torch.int32, device=dev),
                    overflowed=torch.zeros((), dtype=torch.bool, device=dev),
                    live_chunks=live_chunks,
                    budget_hint=tuple(hints[s0] for s0 in live_chunks))


def _extract_unchecked(bv, min_weight, color_by_rgb, color_by_confidence, kernel: bool,
                       chunk_slots: int, live_chunks: tuple, budgets: tuple) -> MeshSoup:
    """The check=False extraction: every live chunk's program at its
    budgets, concatenated; fixed shapes, no host sync (the graph of
    ``graph.extract_graphed`` captures it)."""
    stats = _brick_stats(bv, live_chunks, chunk_slots, min_weight)
    outs = [_extract_chunk(bv, stats, s0, chunk_slots, cb, kb, tb, min_weight, color_by_rgb,
                           color_by_confidence, kernel)
            for s0, (cb, kb, tb) in zip(live_chunks, budgets)]

    def cat(i):
        return outs[0][i] if len(outs) == 1 else torch.cat([o[i] for o in outs])

    counts = torch.stack([o[3] for o in outs])                       # [chunks, 6]
    return MeshSoup(vertices=cat(0), colors=None if outs[0][1] is None else cat(1),
                    tri_valid=cat(2), num_triangles=counts[:, 0].sum(dtype=torch.int32),
                    overflowed=(counts[:, 1:4] > 0).any(),
                    live_chunks=live_chunks, budget_hint=budgets)


def extract_mesh_bricks(bv, min_weight: float = DEFAULT_MIN_WEIGHT,
                        color_by_rgb: bool = False,
                        color_by_confidence: bool = False,
                        chunk_slots: int = 2048, cube_budget: int = 1 << 15, *,
                        use_kernel: Optional[bool] = None, graph: Optional[bool] = None):
    """Brick-native extraction (the checked route) returning numpy
    (V, F, C | None); use_kernel and graph as in :func:`extract_soup_bricks`."""
    return extract_soup_bricks(bv, min_weight, color_by_rgb, color_by_confidence,
                               chunk_slots, cube_budget, use_kernel=use_kernel,
                               graph=graph).to_numpy()


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
                   max_cubes: int = 1 << 18, color_by_rgb: bool = False,
                   color_by_confidence: bool = False) -> MeshSoup:
    """The dense route, the JAX package's fixed-budget program: the
    crossing cubes of a dense TSDFVolume compacted to max_cubes in
    cube-major order (no host sync), every triangle slot of each (vertices
    [max_cubes * MAX, 3, 3], tri_valid), num_triangles, and overflowed =
    more crossing cubes than max_cubes (those past it are dropped). Plain
    torch ops on the volume's device."""
    from ..activation import _compact

    cfg = vol.config
    Y, Z = cfg.yres, cfg.zres
    mask = active_cube_mask(vol, min_weight).reshape(-1)
    ids, n_active = _compact(mask, torch.arange(mask.shape[0], dtype=torch.int32,
                                                device=mask.device), max_cubes)
    cube_ok = ids >= 0
    ids = torch.clamp(ids, min=0).long()
    ci = ids // ((Y - 1) * (Z - 1))
    cj = (ids // (Z - 1)) % (Y - 1)
    ck = ids % (Z - 1)
    corner = torch.stack([((ci + ox) * Y + (cj + oy)) * Z + (ck + oz)
                          for ox, oy, oz in CORNER_OFFSETS.tolist()], 1)
    vals = vol.sdf.reshape(-1)[corner] * cfg.max_dist_neg     # [N, 8] meters (cpp:105)
    verts, ntris = _triangle_slots(cfg, vol.global_transform, ci, cj, ck, vals,
                                   _cube_index(vals))
    ntris = torch.where(cube_ok, ntris, 0)
    M = MAX_TRIS_PER_CUBE
    tri_valid = (torch.arange(M, device=ids.device)[None, :] < ntris[:, None]).reshape(-1)
    rgb = _voxel_rgb(vol, corner[:, 0], color_by_rgb, color_by_confidence)
    colors = None if rgb is None else _expand_colors(rgb.repeat_interleave(M, 0))
    return MeshSoup(vertices=verts, colors=colors, tri_valid=tri_valid,
                    num_triangles=ntris.sum(dtype=torch.int32),
                    overflowed=n_active > max_cubes)


def extract_mesh(vol, min_weight: float = DEFAULT_MIN_WEIGHT,
                 color_by_rgb: bool = False, color_by_confidence: bool = False,
                 max_cubes: Optional[int] = None, *, use_kernel: Optional[bool] = None,
                 graph: Optional[bool] = None):
    """Extract the isosurface as numpy (vertices [N*3, 3], faces [N, 3],
    colors [N*3, 3] | None).

    A brick volume takes the brick route (checked). A dense volume takes it
    too when the kernels run (``bricks.from_dense(vol, 8)``, then the
    corner-halo and emission kernels), else the dense route
    :func:`marching_cubes`; the two give the same triangles in another
    order. max_cubes: on the dense route the exact cube budget (None: the
    next power of two of the crossing cubes, at least 1024; an overflow
    raises); on the brick route the per-chunk cube budget it starts from.
    use_kernel: None = the kernels on the card and the plain routes on the
    CPU; False = the plain routes anywhere; True on the CPU raises. graph:
    the brick route's graphs (:func:`extract_soup_bricks`); None takes them
    on the card for a brick volume but not for a dense one, whose brick
    copy is new each call, so its graphs would never replay. A caller that
    extracts a volume once (the CLIs) passes False: the captures of a first
    call cost more than its eager run."""
    from ..bricks import BrickVolume, from_dense

    bargs = {} if max_cubes is None else {"cube_budget": int(max_cubes)}
    if isinstance(vol, BrickVolume):
        return extract_mesh_bricks(vol, min_weight, color_by_rgb, color_by_confidence,
                                   use_kernel=use_kernel, graph=graph, **bargs)
    if resolve_use_kernel(use_kernel, vol.device):
        # from_dense sizes its capacity from the observed bricks: no overflow
        return extract_mesh_bricks(from_dense(vol, 8), min_weight, color_by_rgb,
                                   color_by_confidence, use_kernel=True, graph=bool(graph),
                                   **bargs)
    if graph:
        raise ValueError("extract_mesh: the extraction graphs are of the kernel route")
    if max_cubes is None:
        n = count_active_cubes(vol, min_weight)
        max_cubes = max(1024, 1 << int(np.ceil(np.log2(max(n, 1)))))
    soup = marching_cubes(vol, min_weight, max_cubes, color_by_rgb, color_by_confidence)
    if bool(soup.overflowed):
        raise RuntimeError(
            f"marching_cubes budget {max_cubes} overflowed; pass a larger max_cubes")
    return soup.to_numpy()


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
    8 corners (36 B); the transform's 3 rows (48 B); per triangle stored
    (below the budget) its 3 vertices and cube reference written (40 B)."""
    return n_bricks * 24 + n_cubes * 36 + 48 + n_tris * 40
