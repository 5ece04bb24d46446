"""Block-sparse brick volume: fusion into allocated 8^3 bricks.

Port of ``cpu_tsdf_tpu.bricks`` (the TPU package's octree replacement,
SURVEY §7):

  * the volume is divided into B^3-voxel bricks (default B=8);
  * ``brick_map`` int32 [Bx,By,Bz]: brick coord -> slot id, -1 = unallocated
    (unallocated == the reference's unobserved coarse leaf: d=-1, w=0);
  * ``sdf/weight/M/nsample`` [C, B^3]: one row per slot, voxel order
    (lx*B+ly)*B+lz (the JAX package stores the same order vreg-tiled as
    [C, 4, B^3/4]; ``convert`` moves between the two); ``color``
    [C, B^3, nc];
  * each frame, hierarchical band activation (``activation``) lists the
    bricks the frame may update, new ones get slots, a carve pass adds live
    bricks in front of the depth, and the per-voxel update runs over that
    list: in the CUDA kernel (``ops.fusion_kernel``) on the card, or in the
    plain engine that is its contract.

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
                      capacity: int = 1 << 15, dtype=torch.float32,
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
    are [n_active, C-1), in order."""
    C = vol.capacity
    dev = cand.device
    ok_c = cand >= 0
    safe = torch.clamp(cand, min=0).long()
    is_new = ok_c & (vol.brick_map.view(-1)[safe] < 0)
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
    sel = torch.nonzero(ok).squeeze(1)  # host sync: the allocation count
    vol.brick_map.view(-1)[safe[sel]] = slots[sel]
    vol.coords[slots[sel].long()] = _brick_coords(safe[sel].to(torch.int32),
                                                  vol.bricks_per_axis)
    vol.overflowed |= n_new > n_free
    vol.n_active.copy_(live.sum(dtype=torch.int32) + torch.minimum(n_new, n_free))


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def frame_update_list(vol: BrickVolume, depth, pose_inv, update_budget: int):
    """Activation and allocation for one frame: allocates the frame's new
    band bricks in place and returns the update list (bx, by, bz, slot_ok,
    slots) — band candidates then carve slots — plus the frame's overflow
    flag (0-dim bool tensor)."""
    from .activation import (_compact_chunked, band_candidate_bricks,
                             carve_candidate_slots, depth_mips, mip_base_level)

    cfg, B, C = vol.config, vol.brick_size, vol.capacity
    if cfg.num_random_splits > 1:
        raise NotImplementedError(
            "num_random_splits > 1 (jittered pre-split activation) is not "
            "ported yet")
    nb = vol.bricks_per_axis
    mips = depth_mips(depth, mip_base_level(cfg, B))
    bids, _, overflow = band_candidate_bricks(cfg, B, nb, mips, pose_inv,
                                              update_budget)
    # carve pass on the PRE-allocation live set: live bricks strictly in
    # front of every depth under their footprint (hpp:189-198)
    carve_budget = carve_budget_for(update_budget)
    live_pre = vol.coords[:, 0] >= 0
    carve_mask = carve_candidate_slots(cfg, B, mips, pose_inv, vol.coords, live_pre)
    carve_slots, n_carve = _compact_chunked(
        carve_mask, torch.arange(C, dtype=torch.int32, device=vol.device), carve_budget)
    overflow = overflow | (n_carve > carve_budget)

    _allocate_from_list(vol, bids)
    bsafe = torch.clamp(bids, min=0)
    slots = vol.brick_map.view(-1)[bsafe.long()]
    slot_ok = (bids >= 0) & (slots >= 0)
    bc = _brick_coords(bsafe, nb)

    carve_ok = carve_slots >= 0
    cs_safe = torch.clamp(carve_slots, 0, C - 1)
    cc = torch.clamp(vol.coords[cs_safe.long()], min=0)
    bc = torch.cat([bc, cc], 0)
    return (bc[:, 0], bc[:, 1], bc[:, 2], torch.cat([slot_ok, carve_ok]),
            torch.cat([slots, cs_safe]), overflow)


def integrate_bricks(vol: BrickVolume, depth, pose, rgb=None,
                     update_budget: int = 1 << 13,
                     use_kernel: Optional[bool] = None) -> BrickVolume:
    """Fuse one depth frame into the brick volume, IN PLACE; returns `vol`.

    depth [H, W] (NaN = missing), pose [4, 4] camera-to-volume, rgb
    optional [H, W, 3] 0..255 — tensors or arrays, moved to the volume's
    device. update_budget bounds the band bricks updated per frame;
    exceeding it (or the carve budget, or the capacity) sets `overflowed`.
    use_kernel: None = the CUDA kernel on the card and the plain engine on
    the CPU; False = the plain engine anywhere."""
    dev = vol.device
    kernel = resolve_use_kernel(use_kernel, dev)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    pose_inv = rigid_inverse(pose)
    bx, by, bz, slot_ok, slots, overflow = frame_update_list(
        vol, depth, pose_inv, update_budget)
    fuse_brick_batch(vol.config, vol.brick_size, bx, by, bz, slot_ok, slots,
                     vol.sdf, vol.weight, vol.M, vol.nsample, vol.color,
                     depth, pose_inv, rgb, kernel)
    vol.overflowed |= overflow
    return vol


def integrate_bricks_sequence(vol: BrickVolume, depths, poses, rgbs=None,
                              update_budget: int = 1 << 13,
                              use_kernel: Optional[bool] = None) -> BrickVolume:
    """Fuse a sequence of frames ([N, H, W] depths, [N, 4, 4] poses,
    optional [N, H, W, 3] rgbs) in order, IN PLACE; equal to calling
    :func:`integrate_bricks` per frame."""
    for i in range(len(depths)):
        integrate_bricks(vol, depths[i], poses[i],
                         None if rgbs is None else rgbs[i], update_budget,
                         use_kernel)
    return vol


def fuse_brick_batch(cfg: TSDFConfig, B: int, bx, by, bz, slot_ok, slots,
                     sdf, weight, M, nsample, color, depth, pose_inv,
                     rgb=None, use_kernel: bool = False) -> None:
    """Fuse one frame's update list into the [C, B^3] state rows IN PLACE.

    bx/by/bz [K] are brick-grid coords (they fix world positions); rows with
    slot_ok False write nothing. With use_kernel the per-voxel update goes
    through the kernel wrapper (csrc/fusion.cu on the card; B must be 8),
    else through the plain engine; either way the
    color transform (RGB / RGBNormalized / LAB) then runs as tensor code over
    the frame's rows, from the observations and effective weights the
    engine wrote per row."""
    from .ops import color as color_ops
    from .ops.fusion_kernel import fuse_bricks, fuse_bricks_plain

    if use_kernel and B != 8:
        raise ValueError("the fusion kernel takes 8^3 bricks only")
    C = sdf.shape[0]
    color_active = color is not None and rgb is not None
    if color_active:
        # trunc mirrors the reference's uint8 color observations
        rgb = torch.trunc(torch.as_tensor(rgb, dtype=torch.float32,
                                          device=sdf.device)).contiguous()
    rows = torch.stack([bx, by, bz, torch.where(slot_ok, slots, -1)], 1).to(torch.int32)
    engine = fuse_bricks if use_kernel else fuse_bricks_plain
    aux = engine(cfg, rows.contiguous(), pose_inv.contiguous(), depth.contiguous(),
                 sdf, weight, M, nsample, rgb if color_active else None)
    if not color_active:
        return
    # rows without a slot read and rewrite the dump row C-1 unchanged
    dst = torch.where(slot_ok, slots, C - 1).long()
    c0 = color[dst]
    weff = aux[:, 3]
    cvalid = slot_ok[:, None] & (weff >= 0)
    cu = color_ops.update_color(cfg.color_mode, c0, aux[:, 4], aux[:, 0],
                                aux[:, 1], aux[:, 2], torch.clamp(weff, min=0.0))
    color.index_copy_(0, dst, torch.where(cvalid[..., None], cu, c0))


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
