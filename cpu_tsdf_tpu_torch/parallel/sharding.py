"""Slab sharding of the dense TSDF volume, and the ray-sharded render.

Port of ``cpu_tsdf_tpu.parallel.sharding`` onto ``torch.distributed``
(``parallel.distributed``). Every function is called by every rank of the
mesh, in the same order (SPMD):

  * INTEGRATION: rank r holds the X-slab [r X/D, (r+1) X/D) of the volume
    (:class:`ShardedVolume`); the depth image and the pose are replicated.
    Every voxel's update is independent, so a frame fuses with no
    collective, on each rank's slab at the slab's global voxel indices
    (``ops.fusion.integrate_slab``). A gradient with respect to the
    replicated depth or pose is the SUM over ranks of each rank's part: the
    backward all-reduces it, as GSPMD's psum does.
  * RENDERING: the volume is packed and replicated once
    (:func:`replicate_render_pack`); the rays are split into D equal runs
    and each rank marches its run (``ops.raycast.render_rays``: the CUDA
    ray-march kernel on the card), then the runs are all-gathered.
  * MARCHING CUBES of a sharded volume: gather the slabs
    (:func:`replicate_volume`) and extract on one volume; the triangles are
    those of the unsharded volume.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..bricks import PackedRenderVolume, pack_render
from ..volume import TSDFVolume
from .distributed import (AXIS, all_gather, all_reduce, broadcast, make_mesh,  # noqa: F401
                          shard_info)


@dataclasses.dataclass
class ShardedVolume:
    """This rank's X-slab of a dense volume sharded over ``mesh``'s slab
    dim: ``local`` holds planes [x0, x0 + xres / D) (its config is the
    global one)."""

    local: TSDFVolume
    mesh: object

    @property
    def config(self):
        return self.local.config

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def x0(self) -> int:
        r, D, _ = shard_info(self.mesh)
        return r * (self.config.xres // D)


def make_tsdf_mesh(device=None):
    """1D mesh over every rank (see ``distributed.make_mesh``)."""
    return make_mesh(device)


def _slab(a, r: int, D: int):
    n = a.shape[0] // D
    return a[r * n:(r + 1) * n].clone()


def shard_volume(vol: TSDFVolume, mesh) -> ShardedVolume:
    """This rank's X-slab of `vol` (every rank passes the same volume)."""
    r, D, _ = shard_info(mesh)
    if vol.config.xres % D:
        raise ValueError(f"xres {vol.config.xres} does not split into {D} slabs")
    return ShardedVolume(local=TSDFVolume(
        sdf=_slab(vol.sdf, r, D), weight=_slab(vol.weight, r, D), M=_slab(vol.M, r, D),
        nsample=_slab(vol.nsample, r, D),
        color=None if vol.color is None else _slab(vol.color, r, D),
        global_transform=vol.global_transform.clone(), config=vol.config), mesh=mesh)


def replicate_volume(vol, mesh) -> TSDFVolume:
    """The whole volume on every rank: a sharded volume's slabs are
    all-gathered; a plain volume is the mesh's first rank's, broadcast."""
    if isinstance(vol, ShardedVolume):
        _, _, group = shard_info(mesh)
        loc = vol.local
        return TSDFVolume(
            sdf=all_gather(loc.sdf, group), weight=all_gather(loc.weight, group),
            M=all_gather(loc.M, group), nsample=all_gather(loc.nsample, group),
            color=None if loc.color is None else all_gather(loc.color, group),
            global_transform=loc.global_transform.clone(), config=loc.config)
    src = int(mesh.mesh.flatten()[0])
    return TSDFVolume(
        sdf=broadcast(vol.sdf, src), weight=broadcast(vol.weight, src),
        M=broadcast(vol.M, src), nsample=broadcast(vol.nsample, src),
        color=None if vol.color is None else broadcast(vol.color, src),
        global_transform=broadcast(vol.global_transform, src), config=vol.config)


class _Replicated(torch.autograd.Function):
    """Identity on a replicated input; the backward sums its gradient over
    the slab group (each rank holds the part that flows from its slab)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


def integrate_sharded(vol: ShardedVolume, depth, pose, rgb=None) -> ShardedVolume:
    """Fuse one frame into a slab-sharded volume (no collective in the
    forward). vol is donated, as in ``ops.fusion.integrate``: use the
    returned volume (on the card the kernel updates the slab's tensors in
    place). Differentiable with respect to depth and pose like
    ``ops.fusion.integrate``; their gradients are all-reduced over the
    slabs in the backward, so every rank gets the whole gradient of the sum
    of the ranks' losses."""
    from ..ops.fusion import integrate_slab

    _, _, group = shard_info(vol.mesh)
    dev = vol.device
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    if depth.requires_grad:
        depth = _Replicated.apply(depth, group)
    if pose.requires_grad:
        pose = _Replicated.apply(pose, group)
    return ShardedVolume(local=integrate_slab(vol.local, depth, pose, rgb, vol.x0),
                         mesh=vol.mesh)


def replicate_render_pack(vol, mesh) -> PackedRenderVolume:
    """The packed render view of a volume on every rank, for repeated
    sharded renders: a sharded volume packs its slab and the packed slabs
    are all-gathered (half the bytes of the volume); a dense or brick volume
    that every rank holds is packed in place."""
    if isinstance(vol, PackedRenderVolume):
        return vol
    if not isinstance(vol, ShardedVolume):
        return pack_render(vol)
    _, _, group = shard_info(mesh)
    loc = pack_render(vol.local)
    return dataclasses.replace(
        loc, rd=all_gather(loc.rd, group),
        color=None if loc.color is None else all_gather(loc.color, group))


# the flat outputs of render_rays, in the order the ranks gather them
_RAY_KEYS = ("hit_x", "hit_y", "hit_z", "normal_x", "normal_y", "normal_z", "t_star",
             "valid", "normal_valid", "rgb_r", "rgb_g", "rgb_b", "rgb_valid")


def gather_rays(r: dict, group) -> dict:
    """render_rays dicts of each rank's run of rays, concatenated in rank
    order (one all-gather of the stacked channels)."""
    keys = [k for k in _RAY_KEYS if k in r]
    stacked = torch.stack([r[k].to(torch.float32) for k in keys], 1)
    full = all_gather(stacked, group)
    return {k: full[:, i] > 0 if r[k].dtype == torch.bool else full[:, i]
            for i, k in enumerate(keys)}


def _sharded_march(vol: PackedRenderVolume, origins, dirs, mesh, max_steps: int,
                   colored: bool) -> dict:
    """render_rays over rays split into D equal runs (N a multiple of D):
    each rank marches its own run, then the runs are all-gathered."""
    from ..ops.raycast import render_rays

    r, D, group = shard_info(mesh)
    n = origins.shape[0] // D
    part = render_rays(vol, origins[r * n:(r + 1) * n], dirs[r * n:(r + 1) * n],
                       max_steps=max_steps, colored=colored)
    return gather_rays(part, group)


def pad_rays(origins, dirs, n: int):
    """Rays padded to n: the padding marches from the origin along +z and
    misses."""
    pad = n - origins.shape[0]
    if not pad:
        return origins, dirs
    z = torch.zeros((pad, 3), dtype=origins.dtype, device=origins.device)
    plus_z = z.clone()
    plus_z[:, 2] = 1.0
    return torch.cat([origins, z]), torch.cat([dirs, plus_z])


def render_view_sharded(vol, pose, mesh, downsample_by: int = 1,
                        max_steps: int = 512, colored: bool = False):
    """Render with the rays split over the ranks and the volume replicated:
    the camera's rays are padded to a multiple of D and each rank marches
    one run of them. `vol`: a sharded, dense or brick volume, or a
    :func:`replicate_render_pack` result (which amortizes the packing
    across renders of one volume state)."""
    from ..ops.raycast import assemble_view, camera_rays

    vol = replicate_render_pack(vol, mesh)
    cfg = vol.config
    W = cfg.image_width // downsample_by
    H = cfg.image_height // downsample_by
    N = H * W
    _, D, _ = shard_info(mesh)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=vol.device)
    origins, dirs = pad_rays(*camera_rays(cfg, pose, downsample_by), -(-N // D) * D)
    r = _sharded_march(vol, origins, dirs, mesh, max_steps, colored)
    return assemble_view(cfg, pose, {k: v[:N] for k, v in r.items()}, H, W)
