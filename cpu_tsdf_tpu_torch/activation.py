"""Hierarchical brick activation: which bricks a depth frame may update.

Port of ``cpu_tsdf_tpu.activation`` (its post-round-5 form), in plain
tensor code on the volume's device. The entry points ``depth_mips``,
``band_candidate_bricks`` and ``carve_slots`` take ``kernel=True`` to run
as the CUDA kernels of ``csrc/activation.cu`` instead
(``ops.activation_kernel``; CUDA tensors only), which give the plain
code's results bit for bit. The stages:

  1. depth min/max mip pyramids (NaN-aware);
  2. TILE pass: every tile (TB^3 bricks) projects its bounding sphere into
     the image; a texel lookup at the matching mip level bounds the depth
     under its footprint; the tile is band-active iff its camera-z range
     overlaps [dmin - margin, dmax + margin];
  3. BRICK pass: bricks of the active tiles are tested against their tile's
     depth bounds;
  4. TIGHTEN pass: surviving bricks re-test with their OWN footprint.

Every stage is conservative (a superset of the bricks whose voxels receive
in-band updates). The candidate list comes out in the JAX package's order:
tile-major (ascending tile id, then local brick id within the tile).

The JAX package gates some of these passes chunk by chunk behind
``lax.cond`` to skip work on dead chunks; the results are bit-identical to
the ungated computation, which is what runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .config import TSDFConfig
from .geometry import transform_points


def _pow2_ceil(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


class DepthMips(NamedTuple):
    """NaN-aware min/max depth pyramids, levels >= ``base_level`` packed
    flat, plus 2x2-dilated variants (texel t holds the min/max over texels
    {t, t+1} per axis, edge-clamped) for the coarse pre-filters."""

    flat_min: torch.Tensor
    flat_max: torch.Tensor
    flat_min_d: torch.Tensor
    flat_max_d: torch.Tensor
    offsets: torch.Tensor    # int32 [L-base]
    widths: torch.Tensor     # int32 [L-base]
    n_levels: int            # levels materialized (after base_level)
    global_min: torch.Tensor  # 0-dim
    global_max: torch.Tensor
    base_level: int = 0


def mip_shapes(H: int, W: int) -> Sequence[Tuple[int, int]]:
    Hp, Wp = _pow2_ceil(H), _pow2_ceil(W)
    shapes = []
    h, w = Hp, Wp
    while True:
        shapes.append((h, w))
        if h == 1 and w == 1:
            break
        h, w = max(h // 2, 1), max(w // 2, 1)
    return shapes


def mip_base_level(cfg: TSDFConfig, brick_size: int) -> int:
    """Finest mip level any activation lookup can request: the footprint of
    a brick-radius sphere at the far sensor plane, padded by >= 3 px."""
    r = 0.5 * brick_size * min(cfg.cell_size)
    z_far = cfg.max_sensor_dist + 2.0 * r
    span = 2.0 * r * min(cfg.focal_length_x, cfg.focal_length_y) / z_far + 3.0
    return max(0, int(np.ceil(np.log2(span))))


def _reduce_to(a, h: int, w: int, red):
    """Block-reduce [H, W] -> [h, w] (both divide)."""
    H, W = a.shape
    return red(a.reshape(h, H // h, w, W // w), (1, 3))


def depth_mips(depth, base_level: int = 0, *, kernel: bool = False) -> DepthMips:
    """Min/max mip pyramids over a depth image (NaN = no data), starting at
    ``base_level`` (min/max are exact, so the levels equal the JAX ones
    whatever the reduction order). kernel: csrc/activation.cu's kernels."""
    if kernel:
        from .ops import activation_kernel

        return activation_kernel.depth_mips(depth, base_level)
    H, W = depth.shape
    shapes = mip_shapes(H, W)
    base_level = min(base_level, len(shapes) - 1)
    Hp, Wp = shapes[0]
    inf = float("inf")
    dp = depth
    if (Hp, Wp) != (H, W):
        dp = torch.full((Hp, Wp), float("nan"), dtype=depth.dtype, device=depth.device)
        dp[:H, :W] = depth
    nan = torch.isnan(dp)
    mins = [torch.where(nan, torch.full_like(dp, inf), dp)]
    maxs = [torch.where(nan, torch.full_like(dp, -inf), dp)]
    shapes = shapes[base_level:]
    mins[0] = _reduce_to(mins[0], *shapes[0], torch.amin)
    maxs[0] = _reduce_to(maxs[0], *shapes[0], torch.amax)
    for (h, w) in shapes[1:]:
        mins.append(_reduce_to(mins[-1], h, w, torch.amin))
        maxs.append(_reduce_to(maxs[-1], h, w, torch.amax))

    def dilate(a, red):
        a = red(a, torch.cat([a[1:], a[-1:]], 0))
        return red(a, torch.cat([a[:, 1:], a[:, -1:]], 1))

    # the level tables from the level index on the device (a table copied
    # from the host would be a host sync, and cannot be captured in a graph)
    lv = torch.arange(base_level, base_level + len(shapes), dtype=torch.int32,
                      device=depth.device)
    widths = torch.clamp(Wp >> lv, min=1)
    sizes = torch.clamp(Hp >> lv, min=1) * widths
    return DepthMips(
        flat_min=torch.cat([m.reshape(-1) for m in mins]),
        flat_max=torch.cat([m.reshape(-1) for m in maxs]),
        flat_min_d=torch.cat([dilate(m, torch.minimum).reshape(-1) for m in mins]),
        flat_max_d=torch.cat([dilate(m, torch.maximum).reshape(-1) for m in maxs]),
        offsets=torch.cumsum(sizes, 0, dtype=torch.int32) - sizes,
        widths=widths,
        n_levels=len(shapes),
        global_min=mins[-1].reshape(()),
        global_max=maxs[-1].reshape(()),
        base_level=base_level,
    )


def _take_clip(flat, idx):
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1).long()]


def _footprint_depth_bounds(mips: DepthMips, u0, u1, v0, v1, need_max=True,
                            dilated=False):
    """Conservative (dmin, dmax) over pixel rect [u0,u1]x[v0,v1] (inclusive,
    clamped to the image): a 2x2 texel lookup at the smallest level whose
    texels cover the rect in <= 2 per axis, or ONE texel of the dilated
    tables (coarse pre-filters only)."""
    span = torch.clamp(torch.maximum(u1 - u0, v1 - v0), min=0) + 1
    lvl = torch.ceil(torch.log2(span.to(torch.float32))).to(torch.int32)
    lvl = torch.clamp(lvl, mips.base_level, mips.base_level + mips.n_levels - 1)
    li = (lvl - mips.base_level).long()
    off = mips.offsets[li]
    wl = mips.widths[li]
    tu0, tu1 = u0 >> lvl, u1 >> lvl
    tv0, tv1 = v0 >> lvl, v1 >> lvl

    if dilated:
        idx = off + tv0 * wl + tu0
        dmin = _take_clip(mips.flat_min_d, idx)
        if not need_max:
            return dmin, None
        return dmin, _take_clip(mips.flat_max_d, idx)

    def tex(flat, tv, tu):
        return _take_clip(flat, off + tv * wl + tu)

    dmin = torch.minimum(
        torch.minimum(tex(mips.flat_min, tv0, tu0), tex(mips.flat_min, tv0, tu1)),
        torch.minimum(tex(mips.flat_min, tv1, tu0), tex(mips.flat_min, tv1, tu1)))
    if not need_max:
        return dmin, None
    dmax = torch.maximum(
        torch.maximum(tex(mips.flat_max, tv0, tu0), tex(mips.flat_max, tv0, tu1)),
        torch.maximum(tex(mips.flat_max, tv1, tu0), tex(mips.flat_max, tv1, tu1)))
    return dmin, dmax


def _band_margins(cfg: TSDFConfig):
    """(m_lo, m_hi): a voxel at camera depth vz receives an in-band update
    only if z_img - m_hi <= vz <= z_img + m_lo (hpp:189-198, +-cell slack)."""
    cell = min(cfg.cell_size)
    return (cfg.max_dist_neg + cell,
            max(cfg.max_dist_neg, cfg.max_dist_pos) + cell)


def _cone_tans(cfg: TSDFConfig):
    """(tan_h, tan_v) of the cone around the optical axis that a sphere
    straddling the camera plane is tested against (the WIDER side of an
    off-center principal point)."""
    W, H = cfg.image_width, cfg.image_height
    return (max(cfg.principal_point_x + 1.0, W - cfg.principal_point_x) / cfg.focal_length_x + 1.0,
            max(cfg.principal_point_y + 1.0, H - cfg.principal_point_y) / cfg.focal_length_y + 1.0)


def _sphere_footprint(cfg: TSDFConfig, mips: DepthMips, ccx, ccy, ccz, r,
                      need_max=True, dilated=False):
    """Depth bounds under a sphere's conservative image footprint.

    Returns (usable, dmin, dmax): `usable` is False when the sphere straddles
    the camera plane; dmin/dmax are +-inf when the footprint misses the
    image entirely."""
    fx, fy = cfg.focal_length_x, cfg.focal_length_y
    pcx, pcy = cfg.principal_point_x, cfg.principal_point_y
    W, H = cfg.image_width, cfg.image_height
    z_lo, z_hi = ccz - r, ccz + r
    usable = z_lo > 1e-3
    zl = torch.clamp(z_lo, min=1e-3)
    zh = torch.clamp(z_hi, min=2e-3)
    x_lo, x_hi = ccx - r, ccx + r
    y_lo, y_hi = ccy - r, ccy + r
    # exact image-space bounds of the box [x_lo,x_hi]x[y_lo,y_hi]x[zl,zh]
    u_min = fx * torch.where(x_lo >= 0, x_lo / zh, x_lo / zl) + pcx
    u_max = fx * torch.where(x_hi >= 0, x_hi / zl, x_hi / zh) + pcx
    v_min = fy * torch.where(y_lo >= 0, y_lo / zh, y_lo / zl) + pcy
    v_max = fy * torch.where(y_hi >= 0, y_hi / zl, y_hi / zh) + pcy
    # pixel coords truncate toward zero (geometry.reproject_point): pad 1 px
    empty = (u_min > W) | (u_max < -1.0) | (v_min > H) | (v_max < -1.0)

    def px(f, rnd, pad, hi):
        # clamp before the int conversion (an out-of-range one is undefined)
        return torch.clamp(rnd(torch.clamp(f, -4.0, hi + 4.0)).to(torch.int32) + pad, 0, hi - 1)

    u0 = px(u_min, torch.floor, -1, W)
    u1 = px(u_max, torch.ceil, 1, W)
    v0 = px(v_min, torch.floor, -1, H)
    v1 = px(v_max, torch.ceil, 1, H)
    dmin, dmax = _footprint_depth_bounds(mips, u0, u1, v0, v1, need_max, dilated)
    inf = torch.full_like(dmin, float("inf"))
    return (usable, torch.where(empty, inf, dmin),
            None if dmax is None else torch.where(empty, -inf, dmax))


def _band_test(cfg: TSDFConfig, mips: DepthMips, ccx, ccy, ccz, r,
               dilated=False):
    """Conservative band-intersection test for spheres (camera-frame center,
    radius r): True iff the sphere MAY contain voxels receiving in-band
    updates from this frame."""
    m_lo, m_hi = _band_margins(cfg)
    z_lo, z_hi = ccz - r, ccz + r
    in_sensor = (z_hi >= cfg.min_sensor_dist) & (z_lo <= cfg.max_sensor_dist)

    usable, dmin, dmax = _sphere_footprint(cfg, mips, ccx, ccy, ccz, r,
                                           dilated=dilated)
    bounded_act = (z_lo <= dmax + m_lo) & (z_hi >= dmin - m_hi)

    # Sphere straddles the camera plane: a cone test around the optical axis
    # (covering the WIDER side of an off-center principal point) plus the
    # whole-image depth bounds.
    tan_h, tan_v = _cone_tans(cfg)
    zc = torch.clamp(z_hi, min=0.0)
    cone = (torch.abs(ccx) - r <= tan_h * zc) & (torch.abs(ccy) - r <= tan_v * zc)
    glob = (z_lo <= mips.global_max + m_lo) & (z_hi >= mips.global_min - m_hi)
    return in_sensor & torch.where(usable, bounded_act, cone & glob)


def carve_candidate_slots(cfg: TSDFConfig, B: int, mips: DepthMips,
                          pose_inv, coords, live):
    """[C] bool mask of LIVE brick slots strictly in FRONT of every depth
    under their footprint: the band test's near-side reject.

    These bricks get the reference's clamped free-space updates
    (hpp:189-198). The mask is mutually exclusive with the band test, so
    callers append carve slots to the band list without dedup. Spheres
    straddling the camera plane are left out."""
    csx, csy, csz = cfg.cell_size
    x0 = coords[:, 0].to(torch.float32) * (B * csx)
    y0 = coords[:, 1].to(torch.float32) * (B * csy)
    z0 = coords[:, 2].to(torch.float32) * (B * csz)
    cx = x0 + 0.5 * B * csx - cfg.xsize / 2
    cy = y0 + 0.5 * B * csy - cfg.ysize / 2
    cz = z0 + 0.5 * B * csz - cfg.zsize / 2
    r = 0.5 * float(np.sqrt((B * csx) ** 2 + (B * csy) ** 2 + (B * csz) ** 2))
    ccx, ccy, ccz = transform_points(pose_inv, cx, cy, cz)
    _, m_hi = _band_margins(cfg)
    in_sensor = (ccz + r >= cfg.min_sensor_dist) & (ccz - r <= cfg.max_sensor_dist)
    usable, dmin, _ = _sphere_footprint(cfg, mips, ccx, ccy, ccz, r, need_max=False)
    # empty/NaN-only footprints give dmin = +inf: no pixel can update the
    # brick, so it is not a carve candidate
    infront = usable & torch.isfinite(dmin) & (ccz + r < dmin - m_hi)
    return live & in_sensor & infront


def _compact(mask_flat, ids, budget: int):
    """Budgeted stream compaction: ids where mask, in order, -1 padded.
    Returns (list [budget] int32, count as a 0-dim int32 tensor)."""
    flat = mask_flat.to(torch.int32)
    rank = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    n = flat.sum(dtype=torch.int32)
    tgt = torch.where((flat > 0) & (rank < budget), rank,
                      torch.full_like(rank, budget + 1))
    out = torch.full((budget + 2,), -1, dtype=torch.int32, device=flat.device)
    out[tgt.long()] = ids.to(torch.int32)
    return out[:budget], n


def _compact_chunked(mask_flat, ids, budget: int, chunk: int = 4096):
    """:func:`_compact` under the JAX package's chunk-gated name. Its
    gating skipped work on dead chunks inside one XLA program; the output
    is bit-identical to the plain compaction, which is what runs here."""
    return _compact(mask_flat, ids, budget)


def carve_slots(cfg: TSDFConfig, B: int, mips: DepthMips, pose_inv, coords,
                carve_budget: int, *, kernel: bool = False):
    """Budgeted list of the carve candidates (:func:`carve_candidate_slots`)
    among the live slots of ``coords`` (coords[:, 0] >= 0): (slots
    [carve_budget] int32 in ascending order, -1 padded; n_carve, the full
    count). kernel: csrc/activation.cu's kernels, which give the same list."""
    if kernel:
        from .ops import activation_kernel

        return activation_kernel.carve_slots(cfg, B, mips, pose_inv, coords, carve_budget)
    mask = carve_candidate_slots(cfg, B, mips, pose_inv, coords, coords[:, 0] >= 0)
    ids = torch.arange(coords.shape[0], dtype=torch.int32, device=coords.device)
    return _compact_chunked(mask, ids, carve_budget)


def pick_tile_bricks(nb: Tuple[int, int, int]) -> int:
    """Tile size (bricks/axis) keeping the tile grid <= ~32^3."""
    tb = 4
    while max(nb) // tb > 32:
        tb *= 2
    return tb


def _tile_grid(nb: Tuple[int, int, int], update_budget: int, tile_budget: int, x_slab=None):
    """The band pass's tiles and budgets: (TB, tiles an axis, the first
    tested tile id, the number of tested tiles, the tile budget, U2 — the
    rough list's length). With x_slab = (bx_lo, nbw) only the tile columns
    that overlap the slab are tested: a slab nbw bricks wide overlaps at
    most ceil(nbw / TB) + 1 of them."""
    nbx, nby, nbz = nb
    TB = pick_tile_bricks(nb)
    ntx, nty, ntz = -(-nbx // TB), -(-nby // TB), -(-nbz // TB)
    if x_slab is None:
        n_tiles, tx_off = ntx * nty * ntz, 0
    else:
        bx_lo, nbw = x_slab
        ncols = min(ntx, -(-nbw // TB) + 1)
        tx_off = min(bx_lo // TB, ntx - ncols)
        n_tiles = ncols * nty * ntz
    tile_budget = min(tile_budget, n_tiles)
    U2 = min(2 * update_budget, tile_budget * TB ** 3)
    return TB, (ntx, nty, ntz), tx_off * (nty * ntz), n_tiles, tile_budget, U2


def band_candidate_bricks(cfg: TSDFConfig, B: int, nb: Tuple[int, int, int],
                          mips: DepthMips, pose_inv, update_budget: int,
                          tile_budget: int = 1024, x_slab=None, *, kernel: bool = False):
    """Budgeted list of bricks intersecting this frame's truncation band.

    Returns (cand [update_budget] int32 brick linear ids (-1 pad), counts,
    overflow) as tensors, in TILE-MAJOR order (ascending tile id, then
    local brick id within the tile). counts int32 [3]: the band bricks
    (the JAX package's n_band), the band-active tiles and the rough
    bricks, each in full (not clamped to its budget: the update budget,
    the tile budget and U2 of :func:`_tile_grid`). `pose_inv` maps volume
    frame -> camera frame.

    x_slab = (bx_lo, nbw) restricts the list to bricks with bx in
    [bx_lo, bx_lo + nbw), the slab of one rank of the sharded integrate
    (``parallel.bricks``). Only the tile columns that overlap the slab are
    tested, so the cost scales with the slab, and the per-brick tests are
    unchanged: the list is the global one filtered to the slab, in the
    same order.

    kernel: csrc/activation.cu's kernels, which give the same list."""
    if kernel:
        from .ops import activation_kernel

        return activation_kernel.band_candidate_bricks(cfg, B, nb, mips, pose_inv,
                                                       update_budget, tile_budget, x_slab)
    dev = pose_inv.device
    f32 = torch.float32
    nbx, nby, nbz = nb
    TB, (_, nty, ntz), tile_first, NT_iter, tile_budget, U2 = _tile_grid(
        nb, update_budget, tile_budget, x_slab)
    if x_slab is not None:
        bx_lo, nbw = x_slab
    csx, csy, csz = cfg.cell_size

    def cam_center_radius(x0, y0, z0, x1, y1, z1):
        """World AABB -> camera-frame center + bounding radius."""
        cx = (x0 + x1) * 0.5 - cfg.xsize / 2
        cy = (y0 + y1) * 0.5 - cfg.ysize / 2
        cz = (z0 + z1) * 0.5 - cfg.zsize / 2
        r = 0.5 * torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2 + (z1 - z0) ** 2)
        ccx, ccy, ccz = transform_points(pose_inv, cx, cy, cz)
        return ccx, ccy, ccz, r

    def tile_sphere(tx, ty, tz):
        x0 = tx.to(f32) * (TB * B * csx)
        y0 = ty.to(f32) * (TB * B * csy)
        z0 = tz.to(f32) * (TB * B * csz)
        return cam_center_radius(
            x0, y0, z0,
            torch.clamp(x0 + TB * B * csx, max=cfg.xsize),
            torch.clamp(y0 + TB * B * csy, max=cfg.ysize),
            torch.clamp(z0 + TB * B * csz, max=cfg.zsize))

    # ---- tile pass -------------------------------------------------------
    ti = torch.arange(NT_iter, dtype=torch.int32, device=dev) + tile_first
    tile_act = _band_test(cfg, mips, *tile_sphere(ti // (nty * ntz), (ti // ntz) % nty,
                                                  ti % ntz), dilated=True)
    tiles, n_tiles = _compact(tile_act, ti, tile_budget)
    overflow = n_tiles > tile_budget
    tile_ok = tiles >= 0
    tsafe = torch.clamp(tiles, min=0)
    ttx = tsafe // (nty * ntz)
    tty = (tsafe // ntz) % nty
    ttz = tsafe % ntz

    # ---- brick pass (arithmetic, tile-level depth bounds) ----------------
    TB3 = TB * TB * TB
    li = torch.arange(TB3, dtype=torch.int32, device=dev)
    lx, ly, lz = li // (TB * TB), (li // TB) % TB, li % TB
    bx = ttx[:, None] * TB + lx[None, :]
    by = tty[:, None] * TB + ly[None, :]
    bz = ttz[:, None] * TB + lz[None, :]
    in_grid = (bx < nbx) & (by < nby) & (bz < nbz) & tile_ok[:, None]
    if x_slab is not None:
        # the boundary tile columns may straddle the slab's edges
        in_grid = in_grid & (bx >= bx_lo) & (bx < bx_lo + nbw)
    bx0 = bx.to(f32) * (B * csx)
    by0 = by.to(f32) * (B * csy)
    bz0 = bz.to(f32) * (B * csz)
    bcx, bcy, bcz, br = cam_center_radius(bx0, by0, bz0,
                                          bx0 + B * csx, by0 + B * csy, bz0 + B * csz)
    m_lo, m_hi = _band_margins(cfg)
    tccx, tccy, tccz, tr = tile_sphere(ttx, tty, ttz)
    t_usable, t_dmin, t_dmax = _sphere_footprint(cfg, mips, tccx, tccy, tccz, tr,
                                                 dilated=True)
    zb_lo, zb_hi = bcz - br, bcz + br
    z_refine = (((zb_lo <= t_dmax[:, None] + m_lo) & (zb_hi >= t_dmin[:, None] - m_hi))
                | ~t_usable[:, None])
    brick_rough = (in_grid & z_refine
                   & (zb_lo <= cfg.max_sensor_dist) & (zb_hi >= cfg.min_sensor_dist))

    blin = (bx * nby + by) * nbz + bz
    rough, n_rough = _compact_chunked(brick_rough.reshape(-1), blin.reshape(-1), U2)
    overflow = overflow | (n_rough > U2)

    # ---- tighten pass (per-brick footprint mip lookup) -------------------
    rok = rough >= 0
    rsafe = torch.clamp(rough, min=0)
    rbx = rsafe // (nby * nbz)
    rby = (rsafe // nbz) % nby
    rbz = rsafe % nbz
    rx0 = rbx.to(f32) * (B * csx)
    ry0 = rby.to(f32) * (B * csy)
    rz0 = rbz.to(f32) * (B * csz)
    rsph = cam_center_radius(rx0, ry0, rz0, rx0 + B * csx, ry0 + B * csy, rz0 + B * csz)
    tight = rok & _band_test(cfg, mips, *rsph)
    cand, n_band = _compact(tight, rsafe, update_budget)
    overflow = overflow | (n_band > update_budget)
    return cand, torch.stack([n_band, n_tiles, n_rough]), overflow

