"""Block-sparse brick volume: fusion into allocated B^3 bricks.

Port of ``cpu_tsdf_tpu.bricks`` (the TPU package's octree replacement,
SURVEY §7):

  * the volume is divided into B^3-voxel bricks (default B=8; the CUDA
    kernels take every even B);
  * ``brick_map`` int32 [Bx,By,Bz]: brick coord -> slot id, -1 = unallocated
    (unallocated == the reference's unobserved coarse leaf: d=-1, w=0);
  * ``sdf/weight/M/nsample`` [C, B^3]: one row per slot, voxel order
    (lx*B+ly)*B+lz (the JAX package stores the same order vreg-tiled as
    [C, 4, B^3/4]; ``convert`` moves between the two); ``color``
    [C, B^3, nc];
  * each frame, hierarchical band activation (``activation``) lists the
    bricks the frame may update (with ``num_random_splits > 1`` also the
    bricks of jittered surface samples), new ones get slots, a carve pass
    adds live bricks in front of the depth, and the per-voxel update runs
    over that list: activation and the update in the CUDA kernels
    (``ops.activation_kernel``, ``ops.fusion_kernel``) on the card, or in
    the plain versions that are their contract.

Row C-1 is reserved and never allocated (the dump row). Capacity and budget
overflow set ``overflowed``; nothing is dropped silently.

State is updated IN PLACE where the JAX package donated its buffers:
``integrate_bricks`` modifies the volume it is given and returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import tracing
from .config import TSDFConfig
from .geometry import rigid_inverse
from .volume import TSDFVolume, color_channels, resolve_device, resolve_use_kernel


@dataclasses.dataclass
class BrickVolume:
    """Block-sparse TSDF volume; tensors on one device."""

    brick_map: torch.Tensor     # int32 [Bx, By, Bz], slot or -1
    n_active: torch.Tensor      # int32 0-dim
    coords: torch.Tensor        # int32 [C, 3] brick coords (or -1)
    sdf: torch.Tensor           # float32 [C, B^3]
    weight: torch.Tensor        # float32 [C, B^3]
    M: torch.Tensor             # float32 [C, B^3]
    nsample: torch.Tensor       # int32 [C, B^3]
    color: Optional[torch.Tensor]  # float32 [C, B^3, nc] or None
    global_transform: torch.Tensor
    overflowed: torch.Tensor    # bool 0-dim: capacity or a budget exceeded
    config: TSDFConfig
    brick_size: int
    capacity: int

    @property
    def bricks_per_axis(self):
        cfg, B = self.config, self.brick_size
        return (cfg.xres // B, cfg.yres // B, cfg.zres // B)

    @property
    def device(self) -> torch.device:
        return self.sdf.device


def make_brick_volume(cfg: TSDFConfig, brick_size: int = 8,
                      capacity: int = 1 << 15, dtype=torch.float32, *,
                      device=None) -> BrickVolume:
    """An empty brick volume on ``device`` (default CUDA; pass "cpu" for the
    CPU — there is no silent fallback)."""
    if cfg.xres % brick_size or cfg.yres % brick_size or cfg.zres % brick_size:
        raise ValueError("resolution must be divisible by brick_size")
    dev = resolve_device(device)
    B = brick_size
    nb = (cfg.xres // B, cfg.yres // B, cfg.zres // B)
    nc = color_channels(cfg)
    shape = (capacity, B ** 3)
    return BrickVolume(
        brick_map=torch.full(nb, -1, dtype=torch.int32, device=dev),
        n_active=torch.zeros((), dtype=torch.int32, device=dev),
        coords=torch.full((capacity, 3), -1, dtype=torch.int32, device=dev),
        sdf=torch.full(shape, -1.0, dtype=dtype, device=dev),
        weight=torch.zeros(shape, dtype=dtype, device=dev),
        M=torch.zeros(shape, dtype=dtype, device=dev),
        nsample=torch.zeros(shape, dtype=torch.int32, device=dev),
        color=(torch.zeros(shape + (nc,), dtype=dtype, device=dev) if nc else None),
        global_transform=torch.eye(4, dtype=torch.float32, device=dev),
        overflowed=torch.zeros((), dtype=torch.bool, device=dev),
        config=cfg, brick_size=B, capacity=capacity,
    )


def _brick_coords(bids, nb):
    """[N, 3] int32 brick coordinates of linear brick ids."""
    _, nby, nbz = nb
    return torch.stack([bids // (nby * nbz), (bids // nbz) % nby, bids % nbz], -1)


# ---------------------------------------------------------------------------
# uniform voxel gather (dense, brick and packed-render volumes)
# ---------------------------------------------------------------------------

def _brick_lookup(vol, ix, iy, iz):
    """(slot, row-major flat index) of clipped voxel indices in a brick
    layout; slot < 0 = unallocated (the flat index then points at row 0)."""
    B = vol.brick_size
    nbx, nby, nbz = (vol.config.xres // B, vol.config.yres // B, vol.config.zres // B)
    blin = ((ix // B) * nby + (iy // B)) * nbz + (iz // B)
    slot = vol.brick_map.reshape(-1)[blin.long()]
    inner = ((ix % B) * B + (iy % B)) * B + (iz % B)
    lin = torch.clamp(slot, 0, vol.capacity - 1).long() * (B ** 3) + inner
    return slot, lin


def _clip_index(cfg: TSDFConfig, ix, iy, iz):
    return (torch.clamp(ix, 0, cfg.xres - 1), torch.clamp(iy, 0, cfg.yres - 1),
            torch.clamp(iz, 0, cfg.zres - 1))


def _dense_lin(cfg: TSDFConfig, ix, iy, iz):
    return ((ix.long() * cfg.yres + iy) * cfg.zres + iz)


def gather_dw(vol, ix, iy, iz):
    """(d, w) at clipped integer voxel indices, for any volume
    representation (dense, brick, or packed-render). An unallocated brick
    reads as an unobserved voxel (d = -1, w = 0). Differentiable with
    respect to the volume's sdf."""
    cfg = vol.config
    ix, iy, iz = _clip_index(cfg, ix, iy, iz)
    if isinstance(vol, PackedRenderVolume):
        return _gather_packed(vol, ix, iy, iz)
    if isinstance(vol, TSDFVolume):
        lin = _dense_lin(cfg, ix, iy, iz)
        return vol.sdf.reshape(-1)[lin], vol.weight.reshape(-1)[lin]
    slot, lin = _brick_lookup(vol, ix, iy, iz)
    d = vol.sdf.reshape(-1)[lin]
    w = vol.weight.reshape(-1)[lin]
    empty = slot < 0
    return (torch.where(empty, torch.full_like(d, -1.0), d),
            torch.where(empty, torch.zeros_like(w), w))


def gather_color(vol, ix, iy, iz):
    """Fused color channels [..., nc] at clipped voxel indices (any volume
    type); an unallocated brick reads as 0."""
    cfg = vol.config
    ix, iy, iz = _clip_index(cfg, ix, iy, iz)
    nc = vol.color.shape[-1]
    flat = vol.color.reshape(-1, nc)
    if getattr(vol, "brick_map", None) is None:
        return flat[_dense_lin(cfg, ix, iy, iz)]
    slot, lin = _brick_lookup(vol, ix, iy, iz)
    c = flat[lin]
    return torch.where((slot < 0)[..., None], torch.zeros_like(c), c)


@dataclasses.dataclass
class PackedRenderVolume:
    """Render-only view of a volume with SDF and weight-validity packed into
    one float32 channel: NaN = unobserved (w == 0), else the SDF value.

    The ray march reads one word per voxel lookup instead of two. Not usable
    for marching cubes or fusion (the weights are gone): render paths only.
    ``rd`` is dense [X, Y, Z] (``brick_map`` None) or brick rows [C, B^3]."""

    rd: torch.Tensor
    brick_map: Optional[torch.Tensor]
    color: Optional[torch.Tensor]
    global_transform: torch.Tensor
    config: TSDFConfig
    brick_size: int = 0
    capacity: int = 0

    @property
    def device(self) -> torch.device:
        return self.rd.device


def pack_render(vol) -> PackedRenderVolume:
    """The packed render view of a dense or brick volume (a new tensor;
    the volume is not modified)."""
    rd = torch.where(vol.weight > 0, vol.sdf, torch.full_like(vol.sdf, float("nan")))
    if isinstance(vol, TSDFVolume):
        return PackedRenderVolume(rd=rd, brick_map=None, color=vol.color,
                                  global_transform=vol.global_transform,
                                  config=vol.config)
    return PackedRenderVolume(rd=rd, brick_map=vol.brick_map, color=vol.color,
                              global_transform=vol.global_transform,
                              config=vol.config, brick_size=vol.brick_size,
                              capacity=vol.capacity)


def _gather_packed(vol: PackedRenderVolume, ix, iy, iz):
    if vol.brick_map is None:
        rd = vol.rd.reshape(-1)[_dense_lin(vol.config, ix, iy, iz)]
    else:
        slot, lin = _brick_lookup(vol, ix, iy, iz)
        rd = vol.rd.reshape(-1)[lin]
        rd = torch.where(slot < 0, torch.full_like(rd, float("nan")), rd)
    unobserved = torch.isnan(rd)
    return (torch.where(unobserved, torch.full_like(rd, -1.0), rd),
            torch.where(unobserved, torch.zeros_like(rd), torch.ones_like(rd)))


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def carve_budget_for(update_budget: int) -> int:
    """Size of the carve batch appended to each frame's update list: an
    eighth of the band budget (128-aligned), at least 256; denser carve sets
    raise `overflowed`, never drop silently."""
    return max(256, (update_budget // 8 + 127) // 128 * 128)


def _allocate(vol: BrickVolume, want_mask) -> None:
    """Allocate slots, in place, for every brick of ``want_mask``
    ([Bx,By,Bz] bool) not allocated yet: prefix-sum order over the brick
    grid, starting at n_active. Row C-1 is the dump row, so C-1 slots are
    usable."""
    usable = vol.capacity - 1
    new = (want_mask & (vol.brick_map < 0)).reshape(-1)
    rank = torch.cumsum(new, 0, dtype=torch.int32) - 1
    n_new = new.sum(dtype=torch.int32)
    slots = vol.n_active + rank
    ok = new & (slots < usable)
    sel = torch.nonzero(ok).squeeze(1)
    # bricks over capacity stay unallocated and set the flag
    vol.brick_map.view(-1)[sel] = slots[sel]
    vol.coords[slots[sel].long()] = _brick_coords(sel.to(torch.int32), vol.bricks_per_axis)
    vol.overflowed |= (vol.n_active + n_new) > usable
    vol.n_active.copy_(torch.clamp(vol.n_active + n_new, max=usable))


def _allocate_from_list(vol: BrickVolume, cand) -> None:
    """Allocate slots, in place, for the new bricks of a candidate list
    (linear brick ids, -1 = padding; valid ids are unique).

    Gap-aware, like the JAX package: the k-th new brick takes the k-th FREE
    row (coords[:, 0] < 0, dump row excluded), so volumes with slot gaps
    never map two bricks onto one row. On contiguous volumes the free rows
    are [n_active, C-1), in order.

    Free of host syncs, as the JAX package writes it: the entries that
    allocate nothing scatter onto one pad entry past the end of the brick
    map and of the coords (its ``mode="drop"``), which is sliced off; the
    state tensors are written in place, so a captured frame keeps their
    addresses."""
    C = vol.capacity
    dev = cand.device
    bm = vol.brick_map.view(-1)
    nbtot = bm.shape[0]
    ok_c = cand >= 0
    safe = torch.clamp(cand, min=0).long()
    is_new = ok_c & (bm[safe] < 0)
    rank = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    n_new = is_new.sum(dtype=torch.int32)

    live = vol.coords[:, 0] >= 0
    free = (~live) & (torch.arange(C, device=dev) < C - 1)
    n_free = free.sum(dtype=torch.int32)
    frank = torch.cumsum(free, 0, dtype=torch.int32) - 1
    # free_rows[r] = the r-th free row; index C+1 takes the non-free rows
    free_rows = torch.full((C + 2,), C, dtype=torch.int32, device=dev)
    free_rows[torch.where(free, frank, C + 1).long()] = torch.arange(
        C, dtype=torch.int32, device=dev)
    slots = free_rows[torch.clamp(rank, 0, C).long()]
    ok = is_new & (rank < n_free)
    bm_pad = torch.cat([bm, bm.new_zeros(1)])
    bm_pad[torch.where(ok, safe, nbtot)] = torch.where(ok, slots, 0)
    bm.copy_(bm_pad[:nbtot])
    coords_pad = torch.cat([vol.coords, vol.coords.new_zeros((1, 3))])
    bc = _brick_coords(safe, vol.bricks_per_axis).to(torch.int32)
    coords_pad[torch.where(ok, slots, C).long()] = torch.where(ok[:, None], bc, 0)
    vol.coords.copy_(coords_pad[:C])
    vol.overflowed |= n_new > n_free
    vol.n_active.copy_(live.sum(dtype=torch.int32) + torch.minimum(n_new, n_free))


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def draw_split_noise(H: int, W: int, n_extra: int, generator: torch.Generator):
    """The jitter's random draws, one pair per extra split: (scale [H, W],
    uniform in [0, 0.03) m; nvec [H, W, 3], standard normal), on the
    generator's device. The JAX package draws the same distributions from
    ``jax.random``; the two generators differ."""
    dev = generator.device
    out = []
    for _ in range(n_extra):
        scale = torch.rand((H, W), generator=generator, device=dev) * 0.03
        nvec = torch.randn((H, W, 3), generator=generator, device=dev)
        out.append((scale, nvec))
    return out


def _jitter_split_bricks(cfg: TSDFConfig, nb, depth, pose, bids, update_budget: int,
                         noise):
    """Extra brick activation from jittered surface samples, the reference's
    ``num_random_splits`` pre-split (cpu_tsdf/include/cpu_tsdf/impl/
    tsdf_volume_octree.hpp:69-88): for every valid pixel and each draw of
    ``noise`` (see :func:`draw_split_noise`), the surface point (camera
    frame) moves by scale along the normalized nvec, and the brick holding
    it is activated. The band list ``bids`` and the jittered bricks are
    unioned in a mask over the brick grid and compacted again, in ascending
    brick id. Returns (bids [update_budget], count, overflow)."""
    from .activation import _compact
    from .geometry import div_const, transform_points, voxel_index

    B = cfg.xres // nb[0]
    nbx, nby, nbz = nb
    nbtot = nbx * nby * nbz
    dev = depth.device
    mask = torch.zeros((nbtot + 1,), dtype=torch.bool, device=dev)
    # index_fill_ takes its value as a kernel argument (a Python value
    # assigned through an index is copied to the device: a host sync)
    mask.index_fill_(0, torch.where(bids >= 0, bids, nbtot).long(), True)
    H, W = depth.shape
    rx = div_const(torch.arange(W, dtype=torch.float32, device=dev)[None, :]
                   - cfg.principal_point_x, cfg.focal_length_x)
    ry = div_const(torch.arange(H, dtype=torch.float32, device=dev)[:, None]
                   - cfg.principal_point_y, cfg.focal_length_y)
    valid = ~torch.isnan(depth)
    z = torch.where(valid, depth, 1.0)
    for scale, nvec in noise:
        n0, n1, n2 = nvec.unbind(-1)
        norm = torch.clamp(torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2), min=1e-9)
        wx, wy, wz = transform_points(pose, rx * z + (n0 / norm) * scale,
                                      ry * z + (n1 / norm) * scale,
                                      z + (n2 / norm) * scale)
        ix, iy, iz, inb = voxel_index(cfg, wx, wy, wz)
        blin = ((ix // B) * nby + (iy // B)) * nbz + (iz // B)
        mask.index_fill_(0, torch.where(valid & inb, blin, nbtot).reshape(-1).long(), True)
    bids, n_band = _compact(mask[:-1], torch.arange(nbtot, dtype=torch.int32, device=dev),
                            update_budget)
    return bids, n_band, n_band > update_budget


def frame_update_list(vol: BrickVolume, depth, pose_inv, update_budget: int,
                      pose=None, split_generator: Optional[torch.Generator] = None, *,
                      kernel: bool = False):
    """Activation and allocation for one frame: allocates the frame's new
    band bricks in place and returns the update list (bx, by, bz, slot_ok,
    slots) — band candidates then carve slots — plus the frame's overflow
    flag (0-dim bool tensor).

    With ``num_random_splits > 1`` the band list gains the jittered
    pre-split bricks, which need ``pose`` (camera-to-volume) and draw their
    noise from ``split_generator`` (None: a generator seeded 0 on the
    volume's device, anew each frame, as the JAX package uses PRNGKey(0)
    each frame). kernel: activation (the mips, the band and carve lists)
    through csrc/activation.cu's kernels, which give the plain code's lists
    (CUDA tensors only); the jitter stays torch code."""
    from .activation import band_candidate_bricks, carve_slots, depth_mips, mip_base_level

    cfg, B, C = vol.config, vol.brick_size, vol.capacity
    nb = vol.bricks_per_axis
    mips = depth_mips(depth, mip_base_level(cfg, B), kernel=kernel)
    bids, _, overflow = band_candidate_bricks(cfg, B, nb, mips, pose_inv,
                                              update_budget, kernel=kernel)
    if cfg.num_random_splits > 1:
        if pose is None:
            raise ValueError("num_random_splits > 1 needs the camera pose")
        if split_generator is None:
            split_generator = torch.Generator(device=vol.device).manual_seed(0)
        noise = draw_split_noise(depth.shape[0], depth.shape[1],
                                 cfg.num_random_splits - 1, split_generator)
        bids, _, jitter_overflow = _jitter_split_bricks(cfg, nb, depth, pose, bids,
                                                        update_budget, noise)
        overflow = overflow | jitter_overflow
    # carve pass on the PRE-allocation live set: live bricks strictly in
    # front of every depth under their footprint (hpp:189-198)
    carve_budget = carve_budget_for(update_budget)
    carve, n_carve = carve_slots(cfg, B, mips, pose_inv, vol.coords, carve_budget,
                                 kernel=kernel)
    overflow = overflow | (n_carve > carve_budget)

    tracing.stage("frame.allocation", vol.device)
    _allocate_from_list(vol, bids)
    bsafe = torch.clamp(bids, min=0)
    slots = vol.brick_map.view(-1)[bsafe.long()]
    slot_ok = (bids >= 0) & (slots >= 0)
    bc = _brick_coords(bsafe, nb)

    carve_ok = carve >= 0
    cs_safe = torch.clamp(carve, 0, C - 1)
    cc = torch.clamp(vol.coords[cs_safe.long()], min=0)
    bc = torch.cat([bc, cc], 0)
    return (bc[:, 0], bc[:, 1], bc[:, 2], torch.cat([slot_ok, carve_ok]),
            torch.cat([slots, cs_safe]), overflow)


def integrate_bricks(vol: BrickVolume, depth, pose, rgb=None,
                     update_budget: int = 1 << 13,
                     use_kernel: Optional[bool] = None,
                     split_generator: Optional[torch.Generator] = None, *,
                     graph: Optional[bool] = None) -> BrickVolume:
    """Fuse one depth frame into the brick volume, IN PLACE; returns `vol`.

    depth [H, W] (NaN = missing), pose [4, 4] camera-to-volume, rgb
    optional [H, W, 3] 0..255 — tensors or arrays, moved to the volume's
    device. update_budget bounds the band bricks updated per frame;
    exceeding it (or the carve budget, or the capacity) sets `overflowed`.
    use_kernel: None = the CUDA kernels (activation and fusion) on the card
    and their plain versions on the CPU; False = the plain versions
    anywhere. split_generator: the
    jitter's random source when num_random_splits > 1 (see
    :func:`frame_update_list`). graph: None = on the card, the frame's CUDA
    graph (:mod:`.graph`; captured at the first frame of this volume and
    these settings, which runs as its warm-up, then replayed), eagerly on
    the CPU; False = eagerly anywhere; True on the CPU raises. Both routes
    run the same program and give the same bits. The tracing call
    ``integrate_bricks``."""
    from .graph import integrate_graphed, resolve_graph

    dev = vol.device
    with tracing.call("integrate_bricks", dev):
        kernel = resolve_use_kernel(use_kernel, dev)
        if resolve_graph(graph, dev):
            integrate_graphed(vol, depth, pose, rgb, update_budget, kernel, split_generator)
            return vol
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        fuse_frame(vol, depth, pose, rgb, update_budget, kernel, split_generator)
        return vol


def fuse_frame(vol: BrickVolume, depth, pose, rgb, update_budget: int, kernel: bool,
               split_generator: Optional[torch.Generator]) -> None:
    """One frame on device tensors, in place: activation, allocation and
    the batched update, the device stages ``frame.activation``,
    ``frame.allocation`` and ``frame.batch``. Fixed shapes and no host sync
    (the graph of :mod:`.graph` captures it; tests/test_torch_graph.py
    records its ops), every state update in place. kernel: activation and
    the batched update through the CUDA kernels (csrc/activation.cu,
    csrc/fusion.cu)."""
    dev = vol.device
    tracing.stage("frame.activation", dev)
    pose_inv = rigid_inverse(pose)
    bx, by, bz, slot_ok, slots, overflow = frame_update_list(
        vol, depth, pose_inv, update_budget, pose, split_generator, kernel=kernel)
    tracing.stage("frame.batch", dev)
    fuse_brick_batch(vol.config, vol.brick_size, bx, by, bz, slot_ok, slots,
                     vol.sdf, vol.weight, vol.M, vol.nsample, vol.color,
                     depth, pose_inv, rgb, kernel)
    vol.overflowed |= overflow
    tracing.stage(None, dev)


def integrate_bricks_sequence(vol: BrickVolume, depths, poses, rgbs=None,
                              update_budget: int = 1 << 13,
                              use_kernel: Optional[bool] = None,
                              split_generator: Optional[torch.Generator] = None, *,
                              graph: Optional[bool] = None) -> BrickVolume:
    """Fuse a sequence of frames ([N, H, W] depths, [N, 4, 4] poses,
    optional [N, H, W, 3] rgbs) in order, IN PLACE; equal to calling
    :func:`integrate_bricks` per frame with the same split_generator.

    With num_random_splits > 1 and no split_generator, one generator seeded
    0 on the volume's device serves the whole sequence, so every frame
    draws its own jitter (the JAX package splits one key into per-frame
    keys).

    graph: as for :func:`integrate_bricks`. On the card the frames replay
    the frame's graph, their inputs copied on the device from one upload
    of the whole sequence, with no host sync between frames: the host
    queues the trajectory ahead of the card, as the JAX package's one
    ``lax.scan`` program runs it. The tracing call
    ``integrate_bricks_sequence``."""
    from .graph import integrate_graphed, resolve_graph

    dev = vol.device
    with tracing.call("integrate_bricks_sequence", dev):
        if not resolve_graph(graph, dev):
            if vol.config.num_random_splits > 1 and split_generator is None:
                split_generator = torch.Generator(device=dev).manual_seed(0)
            for i in range(len(depths)):
                integrate_bricks(vol, depths[i], poses[i],
                                 None if rgbs is None else rgbs[i], update_budget,
                                 use_kernel, split_generator, graph=False)
            return vol
        kernel = resolve_use_kernel(use_kernel, dev)
        depths = torch.as_tensor(depths, dtype=torch.float32, device=dev)
        poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
        if rgbs is not None:
            rgbs = torch.as_tensor(rgbs, dtype=torch.float32, device=dev)
        for i in range(len(depths)):
            # the graph's own generator (no split_generator) is seeded 0 once
            integrate_graphed(vol, depths[i], poses[i], None if rgbs is None else rgbs[i],
                              update_budget, kernel, split_generator, reseed=i == 0)
        return vol


def fuse_brick_batch(cfg: TSDFConfig, B: int, bx, by, bz, slot_ok, slots,
                     sdf, weight, M, nsample, color, depth, pose_inv,
                     rgb=None, use_kernel: bool = False) -> None:
    """Fuse one frame's update list into the [C, B^3] state rows IN PLACE.

    bx/by/bz [K] are brick-grid coords (they fix world positions); rows with
    slot_ok False write nothing. With use_kernel the update goes through the
    kernel wrapper (csrc/fusion.cu on the card, for any even brick size B),
    else through the plain engine; either way the engine also updates the
    color rows (RGB / RGBNormalized / LAB) when color and rgb are given."""
    from .ops.fusion_kernel import fuse_bricks, fuse_bricks_plain

    color_active = color is not None and rgb is not None
    if color_active:
        # trunc mirrors the reference's uint8 color observations
        rgb = torch.trunc(torch.as_tensor(rgb, dtype=torch.float32,
                                          device=sdf.device)).contiguous()
    rows = torch.stack([bx, by, bz, torch.where(slot_ok, slots, -1)], 1).to(torch.int32)
    engine = fuse_bricks if use_kernel else fuse_bricks_plain
    engine(cfg, rows.contiguous(), pose_inv.contiguous(), depth.contiguous(),
           sdf, weight, M, nsample, color if color_active else None,
           rgb if color_active else None)


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def _dense_blocks(vol: BrickVolume, data, fill):
    """[C, B^3(, c)] rows -> dense [X, Y, Z(, c)] through the brick map."""
    B = vol.brick_size
    nbx, nby, nbz = vol.bricks_per_axis
    extra = tuple(data.shape[2:])
    rows = data.reshape((data.shape[0], B, B, B) + extra)
    pad = torch.cat([rows, torch.full((1,) + rows.shape[1:], fill, dtype=data.dtype,
                                      device=data.device)], 0)
    idx = torch.where(vol.brick_map < 0, vol.capacity, vol.brick_map).reshape(-1)
    blocks = pad[idx.long()].reshape((nbx, nby, nbz, B, B, B) + extra)
    blocks = torch.movedim(blocks, (3, 4, 5), (1, 3, 5))
    return blocks.reshape((nbx * B, nby * B, nbz * B) + extra)


def to_dense(vol: BrickVolume) -> TSDFVolume:
    """Materialize the brick volume as a dense TSDFVolume (unallocated =
    d -1, w 0)."""
    return TSDFVolume(
        sdf=_dense_blocks(vol, vol.sdf, -1.0),
        weight=_dense_blocks(vol, vol.weight, 0.0),
        M=_dense_blocks(vol, vol.M, 0.0),
        nsample=_dense_blocks(vol, vol.nsample, 0),
        color=None if vol.color is None else _dense_blocks(vol, vol.color, 0.0),
        global_transform=vol.global_transform.clone(),
        config=vol.config,
    )


def from_dense(vol: TSDFVolume, brick_size: int = 8,
               capacity: Optional[int] = None) -> BrickVolume:
    """Sparsify a dense volume: allocate every brick holding an observation
    (on the dense volume's device)."""
    cfg = vol.config
    B = brick_size
    nbx, nby, nbz = cfg.xres // B, cfg.yres // B, cfg.zres // B
    obs = (vol.weight > 0).reshape(nbx, B, nby, B, nbz, B).any(5).any(3).any(1)
    if capacity is None:
        # +1: the dump row C-1 is never allocated
        n_obs = int(obs.sum())
        capacity = max(1024, 1 << int(np.ceil(np.log2(n_obs + 1))))
    bv = make_brick_volume(cfg, B, capacity, dtype=vol.sdf.dtype, device=vol.device)
    _allocate(bv, obs)

    def blockify(a):
        extra = tuple(a.shape[3:])
        blocks = a.reshape((nbx, B, nby, B, nbz, B) + extra)
        blocks = torch.movedim(blocks, (1, 3), (3, 4))  # -> nbx,nby,nbz,B,B,B
        return blocks.reshape((nbx * nby * nbz, B ** 3) + extra)

    flat = bv.brick_map.reshape(-1)
    sel = torch.nonzero(flat >= 0).squeeze(1)
    dst = flat[sel].long()
    for name in ("sdf", "weight", "M", "nsample", "color"):
        src = getattr(vol, name)
        if src is not None:
            getattr(bv, name)[dst] = blockify(src)[sel]
    bv.global_transform.copy_(vol.global_transform)
    return bv
