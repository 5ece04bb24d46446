"""Slab-sharded brick-sparse integration.

Port of ``cpu_tsdf_tpu.parallel.bricks`` onto ``torch.distributed``. The
brick table is block-distributed over the mesh's slab dim: rank r owns the
X-slab of the brick grid ``bx in [r nbx/D, (r+1) nbx/D)``, its slice of
``brick_map``, its own ``capacity_per_device`` data rows with its own dump
row (local row C_local - 1) and its own allocation count
(:class:`ShardedBrickVolume`). A frame integrates with one collective, the
overflow flag's MAX: the depth image and the pose are replicated, every
rank activates, allocates and updates only its slab, and brick updates
never cross slab boundaries.

Global slot ids are ``r * C_local + local_slot``, so the ranks' rows
concatenated in rank order form a plain, valid ``BrickVolume``
(:func:`merge_sharded`) that every single-device function takes.

The per-frame update is the SAME function as the single-device path
(``bricks.fuse_brick_batch``) over each rank's rows: on the card, the CUDA
fusion kernel, color included. Activation is slab-restricted
(``band_candidate_bricks(x_slab=...)``): each rank tests only the tile
columns that overlap its slab, and its list is the single-device list
filtered to the slab.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..bricks import BrickVolume, make_brick_volume
from ..config import TSDFConfig
from ..geometry import rigid_inverse
from ..volume import resolve_use_kernel
from .distributed import all_gather, all_reduce, shard_info


@dataclasses.dataclass
class ShardedBrickVolume:
    """This rank's part of a slab-sharded brick volume. brick_map is the
    rank's slab [nbx/D, nby, nbz] holding GLOBAL slot ids (or -1); the data
    rows are the rank's [C_local, ...]; n_active counts its live rows;
    overflowed and global_transform are the same on every rank; capacity is
    the global C_local * D."""

    brick_map: torch.Tensor
    n_active: torch.Tensor
    coords: torch.Tensor
    sdf: torch.Tensor
    weight: torch.Tensor
    M: torch.Tensor
    nsample: torch.Tensor
    color: Optional[torch.Tensor]
    global_transform: torch.Tensor
    overflowed: torch.Tensor
    config: TSDFConfig
    brick_size: int
    capacity: int
    mesh: object

    @property
    def bricks_per_axis(self):
        cfg, B = self.config, self.brick_size
        return (cfg.xres // B, cfg.yres // B, cfg.zres // B)

    @property
    def capacity_per_device(self) -> int:
        return self.sdf.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sdf.device

    @property
    def x_slab(self):
        """(first brick x of this rank's slab, slab width in bricks)."""
        nbx_local = self.brick_map.shape[0]
        return shard_info(self.mesh)[0] * nbx_local, nbx_local


def make_sharded_brick_volume(cfg: TSDFConfig, mesh, brick_size: int = 8,
                              capacity_per_device: int = 1 << 12, *,
                              device=None) -> ShardedBrickVolume:
    """This rank's part of an empty slab-sharded brick volume, on `device`
    (default CUDA). The slab count is the size of the mesh's slab dim (a
    hybrid (dcn, shard) mesh replicates the volume across dcn)."""
    _, D, _ = shard_info(mesh)
    nbx = cfg.xres // brick_size
    if nbx % D:
        raise ValueError(f"{nbx} brick planes do not split into {D} slabs")
    bv = make_brick_volume(cfg, brick_size, capacity_per_device, device=device)
    return ShardedBrickVolume(
        brick_map=bv.brick_map[:nbx // D].clone(), n_active=bv.n_active,
        coords=bv.coords, sdf=bv.sdf, weight=bv.weight, M=bv.M, nsample=bv.nsample,
        color=bv.color, global_transform=bv.global_transform, overflowed=bv.overflowed,
        config=cfg, brick_size=brick_size, capacity=capacity_per_device * D, mesh=mesh)


def integrate_bricks_sharded(bv: ShardedBrickVolume, depth, pose, mesh=None,
                             update_budget: int = 1 << 12, rgb=None,
                             use_kernel: Optional[bool] = None,
                             budget_per_device: Optional[int] = None) -> ShardedBrickVolume:
    """Fuse one frame into a slab-sharded brick volume, IN PLACE; returns bv.

    update_budget is the GLOBAL band budget; each rank's candidate list and
    carve batch are sized to budget_per_device, by default slack x
    update_budget / D, 128-aligned, at least 256 and at most the global
    budget. The slack over a uniform split is 2x at D >= 4 (a small slab can
    hold the frustum's whole near field) and 1.5x below (the JAX package's
    sizing). A slab denser than its budget, or a rank out of rows, sets
    ``overflowed`` on every rank (MAX over the slabs); nothing is dropped
    silently. use_kernel: None = the CUDA kernels (activation and fusion) on
    the card and their plain versions on the CPU. `mesh` defaults to bv's."""
    from ..activation import band_candidate_bricks, carve_slots, depth_mips, mip_base_level
    from ..bricks import _brick_coords, carve_budget_for, fuse_brick_batch

    mesh = bv.mesh if mesh is None else mesh
    r, D, group = shard_info(mesh)
    cfg, B = bv.config, bv.brick_size
    C = bv.capacity_per_device
    dev = bv.device
    kernel = resolve_use_kernel(use_kernel, dev)
    if budget_per_device is None:
        num, den = (2, 1) if D >= 4 else (3, 2)
        budget_per_device = min(update_budget,
                                max(256, -(-num * update_budget // (den * 128 * D)) * 128))
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose_inv = rigid_inverse(torch.as_tensor(pose, dtype=torch.float32, device=dev))
    nb = bv.bricks_per_axis
    _, nby, nbz = nb
    bx0, nbx_local = bv.x_slab

    # ---- slab-restricted band activation ----
    mips = depth_mips(depth, mip_base_level(cfg, B), kernel=kernel)
    cand, _, overflow = band_candidate_bricks(cfg, B, nb, mips, pose_inv,
                                              budget_per_device, x_slab=(bx0, nbx_local),
                                              kernel=kernel)
    # the carve pass runs on the PRE-allocation live set (band-new bricks
    # cannot be in front of the band)
    carve_budget = carve_budget_for(budget_per_device)
    carve, n_carve = carve_slots(cfg, B, mips, pose_inv, bv.coords, carve_budget,
                                 kernel=kernel)
    overflow = overflow | (n_carve > carve_budget)

    # ---- local allocation: the k-th new brick takes local row n_active + k
    gok = cand >= 0
    gsafe = torch.clamp(cand, min=0)
    llin = torch.where(gok, gsafe - bx0 * (nby * nbz), 0).long()
    bm = bv.brick_map.view(-1)
    is_new = gok & (bm[llin] < 0)
    rank = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    n_new = is_new.sum(dtype=torch.int32)
    slots = bv.n_active + rank
    usable = C - 1                                  # local row C - 1 is the dump row
    overflow = overflow | ((bv.n_active + n_new) > usable)
    sel = torch.nonzero(is_new & (slots < usable)).squeeze(1)  # host sync
    bm[llin[sel]] = r * C + slots[sel]
    bv.coords[slots[sel].long()] = _brick_coords(gsafe[sel], nb)
    bv.n_active.copy_(torch.clamp(bv.n_active + n_new, max=usable))
    gslots = bm[llin]
    slot_ok = gok & (gslots >= 0)
    lslots = torch.where(slot_ok, gslots - r * C, 0)
    bc = _brick_coords(gsafe, nb)

    # ---- the carve slots, then the SAME batched update as one device ----
    carve_ok = carve >= 0
    cs_safe = torch.clamp(carve, 0, C - 1)
    cc = torch.clamp(bv.coords[cs_safe.long()], min=0)
    bc = torch.cat([bc, cc], 0)
    fuse_brick_batch(cfg, B, bc[:, 0], bc[:, 1], bc[:, 2], torch.cat([slot_ok, carve_ok]),
                     torch.cat([lslots, cs_safe]), bv.sdf, bv.weight, bv.M, bv.nsample,
                     bv.color, depth, pose_inv, rgb, kernel)
    bv.overflowed |= all_reduce(overflow, dist.ReduceOp.MAX, group)
    return bv


def merge_sharded(bv: ShardedBrickVolume, device=None) -> BrickVolume:
    """The plain single-volume BrickVolume of a slab-sharded one, on every
    rank (on `device`, default bv's): brick_map slabs and data rows
    all-gathered in rank order, which is global slot order; n_active is the
    sum of the ranks' counts. Each rank's dump row stays an inert row."""
    _, _, group = shard_info(bv.mesh)
    dev = bv.device if device is None else torch.device(device)

    def g(t):
        return all_gather(t, group).to(dev)

    return BrickVolume(
        brick_map=g(bv.brick_map),
        n_active=all_reduce(bv.n_active, dist.ReduceOp.SUM, group).to(dev),
        coords=g(bv.coords), sdf=g(bv.sdf), weight=g(bv.weight), M=g(bv.M),
        nsample=g(bv.nsample), color=None if bv.color is None else g(bv.color),
        global_transform=bv.global_transform.to(dev), overflowed=bv.overflowed.to(dev),
        config=bv.config, brick_size=bv.brick_size, capacity=bv.capacity)
