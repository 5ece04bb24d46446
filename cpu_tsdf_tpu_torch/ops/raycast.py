"""Raycast rendering of the TSDF volume.

Port of ``cpu_tsdf_tpu.ops.raycast`` (``TSDFVolumeOctree::renderView`` /
``renderColoredView``, tsdf_volume_octree.cpp:278-450). One ray per pixel
marches the reference recurrence:

  * start at t = min_sensor_dist, initial step = 3/4 * max_dist_neg (cpp:289,311)
  * adaptive step max(cell/4, |d| * max_dist_neg)                    (cpp:360)
  * stop on a sign change with both weights nonzero                  (cpp:325)
  * half-voxel backtrack to bracket the crossing                     (cpp:329-354)
  * stop after leaving the volume once inside                        (cpp:363-367)
  * analytic refinement t* = t + step*(-1 + |last_d/(last_d-d)|) on
    trilinear samples                                                (cpp:378-390)
  * normals = central differences at +-1 voxel                       (cpp:398-419)
  * output cloud transformed back into the camera frame              (cpp:422)

The march itself is ``raycast_kernel.march`` (the CUDA kernel on the card)
or ``raycast_kernel.march_plain`` (the same recurrence as a lockstep loop
over all rays, its plain version); this module builds the rays, picks the
route, gathers colors and assembles the organized view. The reference's
missing-data branch forgets a `continue` and relies on NaN propagation
(cpp:385-390); validity is masked properly here, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import tracing
from ..bricks import gather_color
from ..config import TSDFConfig
from ..geometry import div_const, rigid_inverse, rotate_vectors, transform_points, voxel_index
from ..volume import resolve_use_kernel
from . import color as color_ops


@dataclasses.dataclass
class RenderResult:
    """Organized render output in the camera frame (like the reference's cloud)."""

    points: torch.Tensor           # [H, W, 3], NaN where no crossing
    normals: torch.Tensor          # [H, W, 3], NaN where invalid
    depth: torch.Tensor            # [H, W] = points[..., 2]
    rgb: Optional[torch.Tensor]    # [H, W, 3] when rendered colored, else None


def camera_rays(cfg: TSDFConfig, pose, downsample_by: int = 1):
    """Per-pixel unit rays in the volume frame (cpp:281-304), pixel order
    row-major. Returns (origins [N, 3], dirs [N, 3]), N = (H/d)*(W/d);
    differentiable with respect to `pose` (a [4, 4] tensor)."""
    W = cfg.image_width // downsample_by
    H = cfg.image_height // downsample_by
    fx = cfg.focal_length_x / downsample_by
    fy = cfg.focal_length_y / downsample_by
    cx = cfg.principal_point_x / downsample_by
    cy = cfg.principal_point_y / downsample_by
    N = H * W
    dev = pose.device
    px = div_const(torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx, fx)
    py = div_const(torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy, fy)
    dx = px.expand(H, W).reshape(N)
    dy = py.expand(H, W).reshape(N)
    dz = torch.ones(N, dtype=torch.float32, device=dev)
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = rotate_vectors(pose, dx / norm, dy / norm, dz / norm)
    return pose[:3, 3][None, :].expand(N, 3), torch.stack([dx, dy, dz], -1)


def render_rays(vol, origins, dirs, max_steps: int = 512, colored: bool = False, *,
                use_kernel: Optional[bool] = None) -> dict:
    """March arbitrary rays (float32 [N, 3] origins and unit dirs in the
    VOLUME frame) through a dense, brick or packed volume (a volume that is
    not packed yet is packed here, ``bricks.pack_render``).

    Returns a dict of flat [N] tensors: hit points (volume frame), normals,
    t_star, validity masks, and with `colored` the rgb of the voxel at the
    hit. Hits, normals and t_star are differentiable with respect to the
    volume's field (``vol.sdf``, or ``vol.rd`` of a packed volume), the
    origins and the dirs; the crossing's bracket is discrete
    (``raycast_kernel.march_rays``). use_kernel: None = the CUDA kernel on
    the card and the plain march (the lockstep loop of the JAX package's
    render_rays) on the CPU; False = the plain march anywhere."""
    from .raycast_kernel import march_rays

    kernel = resolve_use_kernel(use_kernel, vol.device)
    origins, dirs = origins.contiguous(), dirs.contiguous()
    ch = march_rays(vol, origins, dirs, max_steps, kernel)
    tracing.stage("render.finish", vol.device)
    return rays_from_channels(vol, origins, dirs, ch, colored)


def rays_from_channels(vol, origins, dirs, ch, colored: bool) -> dict:
    """render_rays' dict from the march's 8 channels of these rays (an
    [8, N] tensor or a sequence of [N] tensors, see ``raycast_kernel``)."""
    cfg = vol.config
    t_star = ch[2]
    hx, hy, hz = (origins[:, i] + t_star * dirs[:, i] for i in range(3))
    valid = ch[3] > 0
    out = dict(hit_x=hx, hit_y=hy, hit_z=hz,
               normal_x=ch[5], normal_y=ch[6], normal_z=ch[7],
               t_star=t_star, valid=valid, normal_valid=ch[4] > 0)
    if colored and vol.color is not None:
        # renderColoredView (cpp:427-450): nearest-voxel color at the hit
        ix, iy, iz, okc = voxel_index(cfg, hx, hy, hz)
        r, g, b = color_ops.color_to_rgb(cfg.color_mode, gather_color(vol, ix, iy, iz))
        out.update(rgb_r=r, rgb_g=g, rgb_b=b, rgb_valid=okc & valid)
    return out


def render_view(vol, pose, downsample_by: int = 1, max_steps: int = 512,
                colored: bool = False, packed: bool = True, *,
                use_kernel: Optional[bool] = None,
                graph: Optional[bool] = None) -> RenderResult:
    """Render the volume from a camera pose (camera-to-volume [4, 4]).

    `vol` is a dense or brick volume, packed here into the render view
    (``bricks.pack_render``), or an already packed ``PackedRenderVolume``,
    which amortizes the packing across renders of one volume state.
    `packed` is the JAX package's switch between the packed and the
    unpacked march, whose results it documents as identical; the port
    always packs, and accepts and ignores it.
    use_kernel: None = the CUDA kernel on the card and the plain march on
    the CPU; False = the plain march anywhere. graph: None = on the card,
    the render's CUDA graph (``graph.render_graphed``: captured at the
    first render of this volume and these settings, which runs as its
    warm-up, then replayed; the result is fresh tensors) of the kernel
    route, unless the volume or the pose requires grad, which takes the
    eager differentiable route; eagerly on the CPU and with the plain
    march; False = eagerly anywhere; True where the graph cannot run (the
    CPU, the plain march, an input that requires grad) raises. The
    tracing call ``render_view``."""
    from ..graph import render_graphed, resolve_graph

    dev = vol.device
    with tracing.call("render_view", dev):
        kernel = resolve_use_kernel(use_kernel, dev)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        use_graph = resolve_graph(graph, dev)
        if use_graph and (not kernel or _needs_grad(vol, pose)):
            if graph:
                raise ValueError("render_view: the render graph is the kernel march's "
                                 "forward (the plain march reads its done mask on the "
                                 "host, and a gradient needs the eager route)")
            use_graph = False
        if use_graph:
            return render_graphed(vol, pose, downsample_by, max_steps, colored, kernel)
        return _render(vol, pose, downsample_by, max_steps, colored, kernel)


def _needs_grad(vol, pose) -> bool:
    return torch.is_grad_enabled() and (pose.requires_grad or any(
        isinstance(t := getattr(vol, f.name), torch.Tensor) and t.requires_grad
        for f in dataclasses.fields(vol)))


def _render(vol, pose, downsample_by: int, max_steps: int, colored: bool,
            kernel: bool) -> RenderResult:
    """The render on device tensors: with the kernel march, fixed shapes
    and no host sync (the graph of ``graph.render_graphed`` captures it).
    Its device stages: ``render.rays``, ``render.pack``, ``render.march``
    and ``render.finish`` (the colors' gather and the assembly)."""
    cfg = vol.config
    tracing.stage("render.rays", vol.device)
    origins, dirs = camera_rays(cfg, pose, downsample_by)
    r = render_rays(vol, origins, dirs, max_steps, colored, use_kernel=kernel)
    view = assemble_view(cfg, pose, r, cfg.image_height // downsample_by,
                         cfg.image_width // downsample_by)
    tracing.stage(None, vol.device)
    return view


def fresh_result(r: RenderResult) -> RenderResult:
    """A copy of a render result in new tensors (depth a view of the
    points, as render_view gives it)."""
    points = r.points.clone()
    return RenderResult(points=points, normals=r.normals.clone(), depth=points[..., 2],
                        rgb=None if r.rgb is None else r.rgb.clone())


def assemble_view(cfg: TSDFConfig, pose, r: dict, H: int, W: int) -> RenderResult:
    """Pack flat render_rays output into the camera-frame organized result."""
    valid, nvalid = r["valid"], r["normal_valid"]
    # hit points and normals back into the camera frame (cpp:422)
    pose_inv = rigid_inverse(pose)
    pts = transform_points(pose_inv, r["hit_x"], r["hit_y"], r["hit_z"])
    nrm = rotate_vectors(pose_inv, r["normal_x"], r["normal_y"], r["normal_z"])

    def organized(chans, mask):
        x = torch.stack(chans, -1)
        return torch.where(mask[:, None], x, torch.full_like(x, float("nan"))).reshape(H, W, 3)

    points = organized(pts, valid)
    rgb = None
    if "rgb_r" in r:
        rgb = organized((r["rgb_r"], r["rgb_g"], r["rgb_b"]), r["rgb_valid"])
    return RenderResult(points=points, normals=organized(nrm, nvalid),
                        depth=points[..., 2], rgb=rgb)
