"""The sharded ray-march renders: ray tiles over the ranks, and the
slab-sharded volume that is never replicated.

Port of ``cpu_tsdf_tpu.parallel.raycast`` onto ``torch.distributed``. The
JAX package marches a (brick x image tile) pair list with per-device pair
budgets; the port's march (``ops.raycast_kernel.march``: the CUDA kernel
on the card) walks each ray on the global step grid from min_sensor_dist
and has no pair lists or budgets, so:

  * :func:`render_view_pallas_sharded` replicates the packed volume and
    gives each rank a band of image rows, marched with the kernel's 8x4
    warp tiles: the same rays as the single-device render, each marched by
    one rank, so the view is equal to it. The budget arguments are accepted
    and ignored.
  * :func:`render_view_volume_sharded` packs, on each rank, only its own
    slab's rows plus the +-x neighbours' boundary brick planes (exchanged
    like the JAX package's ppermute) and relays each ray from slab to slab:
    the rank whose slab holds the ray's current sample marches it with the
    kernel's relay mode until a sample leaves the slab, and a SUM
    all-reduce hands the march state to the next slab's rank. The march
    steps by |d| of every sample it meets, so only a march that reads every
    sample from the rank holding it walks the single-device sample grid (a
    rank that marched the whole image against its partial volume would
    read an unobserved voxel in another slab's band and step differently,
    the JAX package's per-pair design has no such grid). The refinement and
    normals read the ghost planes; a hit extrapolated beyond them takes its
    normal from the rank holding it. Colors are gathered per slab and SUM
    all-reduced. The view equals the single-device render of the merged
    volume.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .distributed import all_gather, all_reduce, shard_info


def render_view_pallas_sharded(vol, pose, mesh, downsample_by: int = 1,
                               colored: bool = False, pack=None,
                               r_budget: int = 4096, pair_budget: int = 32768,
                               pair_budget_local: Optional[int] = None,
                               interpret: bool = False, *, max_steps: int = 512):
    """Render with image-row bands split over the ranks, each band marched
    with the ray-march kernel (the multi-card ``renderView``).

    `vol`: a dense or brick volume that every rank holds, or a packed
    render view; `pack`, when given, is that packed view (the volume is then
    not packed again). r_budget, pair_budget, pair_budget_local and
    interpret are the JAX kernel's budgets and interpret mode: the port's
    march has neither, so they are ignored."""
    from ..bricks import PackedRenderVolume, pack_render
    from ..ops.raycast import assemble_view, camera_rays, rays_from_channels
    from ..ops.raycast_kernel import march
    from .sharding import gather_rays, pad_rays

    if pack is None:
        pack = vol if isinstance(vol, PackedRenderVolume) else pack_render(vol)
    cfg = pack.config
    W, H = cfg.image_width // downsample_by, cfg.image_height // downsample_by
    r, D, group = shard_info(mesh)
    tiled = W % 32 == 0
    # rows a rank: whole 8x4 warp tiles (groups of 4 rows) where the row length allows
    rows = -(-H // D)
    if tiled:
        rows = -(-rows // 4) * 4
    pose = torch.as_tensor(pose, dtype=torch.float32, device=pack.device)
    origins, dirs = pad_rays(*camera_rays(cfg, pose, downsample_by), rows * D * W)
    band = slice(r * rows * W, (r + 1) * rows * W)
    o, d = origins[band].contiguous(), dirs[band].contiguous()
    ch = march(pack, o, d, max_steps, tile=W if tiled else 0)
    full = gather_rays(rays_from_channels(pack, o, d, ch, colored), group)
    return assemble_view(cfg, pose, {k: v[:H * W] for k, v in full.items()}, H, W)


def _local_pack(bv, group):
    """This rank's packed render view: its own rows, then the left and the
    right neighbour's boundary brick planes (rows of NaN where no brick is
    allocated), behind a brick map of the whole grid that maps the slab and
    the two ghost planes to those rows and everything else to -1."""
    from ..bricks import PackedRenderVolume

    r, D, _ = shard_info(bv.mesh)
    C = bv.capacity_per_device
    nbx, nby, nbz = bv.bricks_per_axis
    bx0, nbx_local = bv.x_slab
    npl = nby * nbz
    nan = torch.full_like(bv.sdf, float("nan"))
    rd = torch.where(bv.weight > 0, bv.sdf, nan)

    def plane(px):
        gs = bv.brick_map[px].reshape(-1)
        ok = gs >= 0
        rows = rd[torch.clamp(gs - r * C, 0, C - 1).long()]
        return torch.where(ok[:, None], rows, nan[:npl]), ok

    # the boundary planes of every rank: [D, 2 (left, right), npl, B^3]
    (lrows, lok), (rrows, rok) = plane(0), plane(nbx_local - 1)
    planes = all_gather(torch.stack([lrows, rrows])[None], group)
    oks = all_gather(torch.stack([lok, rok])[None], group)
    ghost = torch.arange(npl, dtype=torch.int32, device=bv.device)
    bmap = torch.full((nbx, nby, nbz), -1, dtype=torch.int32, device=bv.device)
    bmap[bx0:bx0 + nbx_local] = torch.where(bv.brick_map >= 0, bv.brick_map - r * C, -1)
    parts = [rd]
    for side, (nbr, px, row0) in enumerate(((r - 1, bx0 - 1, C),
                                            (r + 1, bx0 + nbx_local, C + npl))):
        if 0 <= nbr < D:
            # the left neighbour's right plane, the right neighbour's left plane
            bmap[px] = torch.where(oks[nbr, 1 - side], row0 + ghost, -1).reshape(nby, nbz)
            parts.append(planes[nbr, 1 - side])
        else:
            parts.append(nan[:npl])
    return PackedRenderVolume(rd=torch.cat(parts, 0), brick_map=bmap, color=None,
                              global_transform=bv.global_transform, config=bv.config,
                              brick_size=bv.brick_size, capacity=C + 2 * npl)


def _relay_march(pack, origins, dirs, max_steps: int, bv, group):
    """The march of every ray, each phase-1 segment marched by the rank
    whose slab holds it: a ray starts on the rank of its first sample
    (clamped into the grid), and the relay kernel suspends it at its first
    sample inside the volume but outside that rank's slab; an all-reduce
    (SUM: every ray is marched by one rank a round) hands the state on. A
    ray crosses the slabs in x order, so D rounds finish every ray.
    Returns the [8, N] channels of one march of the whole volume and the
    slab index of the rank that finished each ray."""
    from ..geometry import voxel_index
    from ..ops.raycast_kernel import NCH, march, relay_state

    r, D, _ = shard_info(bv.mesh)
    cfg, dev = bv.config, bv.device
    bx0, nbx_local = bv.x_slab
    nx = nbx_local * bv.brick_size
    N = origins.shape[0]
    state = relay_state(cfg, N, dev)

    def slab_of(ix):
        return torch.div(torch.clamp(ix, 0, cfg.xres - 1), nx, rounding_mode="floor").long()

    owner = slab_of(voxel_index(cfg, *(origins[:, k] + state[0] * dirs[:, k]
                                       for k in range(3)))[0])
    active = torch.ones(N, dtype=torch.bool, device=dev)
    ch = torch.zeros((NCH, N), dtype=torch.float32, device=dev)
    finisher = torch.zeros(N, dtype=torch.long, device=dev)
    for _ in range(D):
        idx = torch.nonzero(active & (owner == r)).squeeze(1)
        part = torch.zeros((NCH + state.shape[0], N), dtype=torch.float32, device=dev)
        if idx.numel():
            st = state[:, idx].contiguous()
            part[:NCH, idx] = march(pack, origins[idx].contiguous(), dirs[idx].contiguous(),
                                    max_steps, tile=0, relay=(st, bx0 * bv.brick_size,
                                                              bx0 * bv.brick_size + nx))
            part[NCH:, idx] = st
        full = all_reduce(part, dist.ReduceOp.SUM, group)
        state = torch.where(active[None], full[NCH:], state)
        ended = active & (state[6] == 0)
        ch = torch.where(ended[None], full[:NCH], ch)
        finisher = torch.where(ended, owner, finisher)
        active = active & ~ended
        owner = torch.where(active, slab_of(state[7].long()), owner)
        if not bool(active.any()):
            return ch, finisher
    raise RuntimeError("relay march: rays still suspended after one round a slab")


def _normals_beyond_ghosts(pack, ch, origins, dirs, finisher, bv, group):
    """Channels 4-7 recomputed where a refined hit lies so far from the
    slab of the rank that found its crossing that the normal's reads leave
    that rank's ghost planes (t* may extrapolate beyond its bracket): the
    rank whose slab holds the hit takes the normals (its own slab and ghost
    planes cover them) and a SUM all-reduce hands them on."""
    from ..geometry import voxel_index
    from ..ops.raycast_kernel import normals_plain

    r, _, _ = shard_info(bv.mesh)
    cfg, B = bv.config, bv.brick_size
    nx = bv.x_slab[1] * B
    valid = ch[3] > 0
    hx, hy, hz = (origins[:, k] + ch[2] * dirs[:, k] for k in range(3))
    ix = torch.clamp(voxel_index(cfg, hx, hy, hz)[0], 0, cfg.xres - 1)
    lo = finisher * nx
    # a normal reads the voxels [ix - 2, ix + 2]; a rank holds [lo - B, lo + nx + B)
    far = valid & ((ix - 2 < lo - B) | (ix + 2 >= lo + nx + B))
    if not bool(far.any()):
        return ch
    mine = far & (torch.div(ix, nx, rounding_mode="floor") == r)
    nvalid, nxo, nyo, nzo = normals_plain(pack, hx, hy, hz, mine)
    part = torch.where(mine[None], torch.stack([nvalid.float(), nxo, nyo, nzo]),
                       torch.zeros((4, ch.shape[1]), dtype=ch.dtype, device=ch.device))
    out = ch.clone()
    out[4:] = torch.where(far[None], all_reduce(part, dist.ReduceOp.SUM, group), ch[4:])
    return out


def _slab_colors(bv, hx, hy, hz, group):
    """The fused color at each hit, gathered by the rank whose slab holds
    it (0 elsewhere and in unallocated bricks) and SUM all-reduced: the
    values of ``bricks.gather_color`` on the merged volume."""
    from ..geometry import voxel_index

    cfg, B = bv.config, bv.brick_size
    r, _, _ = shard_info(bv.mesh)
    C = bv.capacity_per_device
    _, nby, nbz = bv.bricks_per_axis
    bx0, nbx_local = bv.x_slab
    ix, iy, iz, okc = voxel_index(cfg, hx, hy, hz)
    ix = torch.clamp(ix, 0, cfg.xres - 1)
    iy = torch.clamp(iy, 0, cfg.yres - 1)
    iz = torch.clamp(iz, 0, cfg.zres - 1)
    bxi = ix // B
    mine = (bxi >= bx0) & (bxi < bx0 + nbx_local)
    llin = ((bxi - bx0) * nby + iy // B) * nbz + iz // B
    gslot = bv.brick_map.reshape(-1)[torch.clamp(llin, 0, nbx_local * nby * nbz - 1).long()]
    mine = mine & (gslot >= 0)
    lin = ((torch.clamp(gslot - r * C, 0, C - 1) * B + ix % B) * B + iy % B) * B + iz % B
    nc = bv.color.shape[-1]
    c = bv.color.reshape(-1, nc)[lin.long()]
    return all_reduce(torch.where(mine[:, None], c, torch.zeros_like(c)),
                      dist.ReduceOp.SUM, group), okc


def render_view_volume_sharded(bv, pose, mesh=None, downsample_by: int = 1,
                               colored: bool = False, r_budget_local: int = 2048,
                               pair_budget_local: int = 8192, interpret: bool = False, *,
                               max_steps: int = 512):
    """Render a SLAB-SHARDED brick volume (``parallel.bricks``) without
    replicating it: each rank packs its own slab plus one ghost brick plane
    on each side, and each ray is marched slab by slab in the order it
    crosses them, by the rank holding the slab (the ray-march kernel's relay
    mode on the card; see the module docstring). With `colored`, each rank
    gathers the colors of the hits in its own slab and a SUM all-reduce
    sums them (colors are never replicated either). The truncation
    must leave a march step and the refinement's reads inside one brick
    plane (ValueError otherwise).

    Returns (view, overflowed): the port's march has no budgets, so
    overflowed is always False; r_budget_local, pair_budget_local and
    interpret are accepted and ignored."""
    from ..ops import color as color_ops
    from ..ops.raycast import assemble_view, camera_rays

    mesh = bv.mesh if mesh is None else mesh
    if colored and bv.color is None:
        raise ValueError("colored render needs a color-carrying volume")
    _, _, group = shard_info(mesh)
    cfg = bv.config
    W, H = cfg.image_width // downsample_by, cfg.image_height // downsample_by
    pose = torch.as_tensor(pose, dtype=torch.float32, device=bv.device)
    origins, dirs = camera_rays(cfg, pose, downsample_by)
    origins, dirs = origins.contiguous(), dirs.contiguous()
    if max(cfg.max_dist_pos, cfg.max_dist_neg) + 2 * max(cfg.cell_size) > \
            bv.brick_size * min(cfg.cell_size):
        raise ValueError("the ghost brick planes must cover a march step and the "
                         "refinement's reads: truncation too wide for the brick size")
    pack = _local_pack(bv, group)
    ch, finisher = _relay_march(pack, origins, dirs, max_steps, bv, group)
    ch = _normals_beyond_ghosts(pack, ch, origins, dirs, finisher, bv, group)
    t_star = ch[2]
    out = dict(hit_x=origins[:, 0] + t_star * dirs[:, 0],
               hit_y=origins[:, 1] + t_star * dirs[:, 1],
               hit_z=origins[:, 2] + t_star * dirs[:, 2],
               normal_x=ch[5], normal_y=ch[6], normal_z=ch[7], t_star=t_star,
               valid=ch[3] > 0, normal_valid=ch[4] > 0)
    if colored:
        vox, okc = _slab_colors(bv, out["hit_x"], out["hit_y"], out["hit_z"], group)
        out["rgb_r"], out["rgb_g"], out["rgb_b"] = color_ops.color_to_rgb(cfg.color_mode, vox)
        out["rgb_valid"] = okc & out["valid"]
    return assemble_view(cfg, pose, out, H, W), False
