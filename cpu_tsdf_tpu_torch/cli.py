"""Command-line tools: ``tsdf-integrate``, ``tsdf2mesh``, ``get-intrinsics``.

Port of ``cpu_tsdf_tpu.cli``: the reference CLI programs
(cpu_tsdf/src/prog/integrate.cpp:257-293, tsdf2mesh.cpp:51-73,
get_intrinsics.cpp:109-131) with the same flags, messages and exit codes,
on this package. ``python -m cpu_tsdf_tpu_torch.cli`` runs ``integrate``.

The volume lives on the device that ``TSDF_DEVICE`` names, ``cuda`` (the
default: the CUDA kernels) or ``cpu`` (their plain versions). Without a
card and without ``TSDF_DEVICE=cpu`` the programs fail; they never carry on
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from . import tracing
from .bricks import (BrickVolume, exceeded_limits, integrate_bricks, make_brick_volume,
                     to_dense)
from .config import TSDFConfig, snap_resolution_pow2
from .io import pcd as pcd_io
from .io import ply as ply_io
from .io import poses as pose_io
from .io.checkpoint import checkpoint_meta, load_any, save_checkpoint
from .io.image import depth_to_u8, normals_to_u8, save_png
from .io.vol import save_vol
from .log import get_logger
from .ops.fusion import integrate
from .ops.marching_cubes import extract_mesh
from .ops.raycast import render_view
from .pipeline import (cleanup_mesh, estimate_intrinsics, flatten_vertices, organize_cloud,
                       voxel_downsample)
from .volume import make_volume


# the flag that raises each limit a brick frame can exceed
_RAISE = {"capacity": "--brick-capacity", "tiles": "--update-budget",
          "rough": "--update-budget", "band": "--update-budget",
          "carve": "--update-budget or --brick-capacity"}


def _warn_overflow(i: int, limits: list) -> None:
    """The warning for brick frame i, naming the limits it exceeded
    (``bricks.exceeded_limits``; none: an earlier frame overflowed)."""
    if limits:
        fix = " / ".join(dict.fromkeys(_RAISE[n] for n in limits))
        print(f"Warning: frame {i + 1} overflowed its brick "
              f"{', '.join(limits)} limit{'s' if len(limits) > 1 else ''} — increase {fix}",
              file=sys.stderr)


def _integrate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsdf-integrate",
        description="Integrates multiple clouds and returns a mesh. Assumes "
                    "clouds are PCD files and poses are ascii (.txt) or binary "
                    "float (.transform) files with the same prefix, specifying "
                    "the pose of the camera in the world frame.")
    p.add_argument("--in", dest="in_dir", required=True, help="Input dir")
    p.add_argument("--out", dest="out_dir", required=True, help="Output dir")
    p.add_argument("--save-tsdf", action="store_true",
                   help="Save the full TSDF in the output directory")
    p.add_argument("--volume-size", type=float, default=12.0)
    p.add_argument("--cell-size", type=float, default=0.006,
                   help="Size of the smallest voxel")
    p.add_argument("--max-cell-size", type=float, default=0.5)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--color", action="store_true",
                   help="Store color in addition to depth in the TSDF")
    p.add_argument("--flatten", action="store_true", help="Flatten mesh vertices")
    p.add_argument("--cleanup", action="store_true", help="Clean up mesh")
    p.add_argument("--invert", action="store_true",
                   help="Transforms are inverted (world -> camera)")
    p.add_argument("--world", action="store_true",
                   help="Clouds are given in the world frame")
    p.add_argument("--organized", action="store_true",
                   help="Clouds are already organized")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--zero-nans", action="store_true",
                   help="Nans are represented as (0,0,0)")
    p.add_argument("--num-random-splits", type=int, default=1)
    p.add_argument("--no-frustum-culling", action="store_true",
                   help="Disable the 1.1x-FOV coarse-cell frustum cull "
                        "(extension: parity testing against oracles that "
                        "omit PCL FrustumCulling)")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--save-ascii", action="store_true")
    p.add_argument("--cloud-units", type=float, default=1.0)
    p.add_argument("--pose-units", type=float, default=1.0)
    p.add_argument("--max-sensor-dist", type=float, default=3.0)
    p.add_argument("--min-sensor-dist", type=float, default=0.0)
    p.add_argument("--trunc-dist-pos", type=float, default=0.03)
    p.add_argument("--trunc-dist-neg", type=float, default=0.03)
    p.add_argument("--min-weight", type=float, default=0.0)
    p.add_argument("--cloud-only", action="store_true",
                   help="Save aggregate cloud rather than actually running TSDF")
    # extensions over the reference CLI:
    p.add_argument("--tsdf-format", choices=("npz", "vol"), default="npz",
                   help="checkpoint format for --save-tsdf (npz=native, "
                        "vol=reference-compatible)")
    p.add_argument("--sparse", action="store_true",
                   help="use the block-sparse brick volume (CUDA kernels "
                        "fast path; scales past dense-grid memory)")
    p.add_argument("--brick-size", type=int, default=8)
    p.add_argument("--brick-capacity", type=int, default=1 << 15)
    p.add_argument("--update-budget", type=int, default=1 << 13,
                   help="band bricks a --sparse frame may update; the frame's "
                        "tile and carve budgets follow from it and the capacity")
    p.add_argument("--metrics-json", default=None,
                   help="write per-frame timing/occupancy metrics to this file")
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="checkpoint the volume to OUT/checkpoint.npz every N "
                        "frames (enables cheap crash recovery)")
    p.add_argument("--resume", action="store_true",
                   help="resume from OUT/checkpoint.npz (skips already-"
                        "integrated frames)")
    p.add_argument("--visualize-every", type=int, default=0, metavar="N",
                   help="every N frames render the accumulating volume from "
                        "the current pose and write depth/normal PNGs to "
                        "OUT/viz_*.png (headless substitute for the "
                        "reference's --visualize)")
    return p


def device_from_env() -> torch.device:
    """The device named by TSDF_DEVICE: ``cuda`` (the default) or ``cpu``.
    Raises ValueError for another name, or for cuda without a card."""
    want = os.environ.get("TSDF_DEVICE") or "cuda"
    if want not in ("cuda", "cpu"):
        raise ValueError(f"TSDF_DEVICE must be cuda or cpu, got {want!r}")
    if want == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device is available (TSDF_DEVICE defaults to "
                         "cuda); set TSDF_DEVICE=cpu to run on the CPU")
    return torch.device(want)


def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work, so the host clock measures it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def integrate_main(argv=None) -> int:
    try:
        return _integrate_impl(argv)
    except (FileNotFoundError, ValueError) as e:
        # clean CLI errors instead of tracebacks (the reference prints
        # PCL_ERROR and returns 1, integrate.cpp:389-439)
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _integrate_impl(argv=None) -> int:
    args = _integrate_parser().parse_args(argv)
    dev = device_from_env()
    log = get_logger(args.verbose)
    t_start = time.time()
    width, height = args.width, args.height
    fx = args.fx if args.fx is not None else 525.0 * width / 640.0
    fy = args.fy if args.fy is not None else 525.0 * height / 480.0
    cx = args.cx if args.cx is not None else width / 2.0 - 0.5
    cy = args.cy if args.cy is not None else height / 2.0 - 0.5

    pcd_files, pose_files, binary_poses = pose_io.scrape_directory(args.in_dir)
    log.info(f"Found {len(pcd_files)} PCD files; reading "
             f"{'binary' if binary_poses else 'ascii'} pose files")
    poses = pose_io.load_poses(pose_files, invert=args.invert, pose_units=args.pose_units)
    for i, m in enumerate(poses):
        log.debug(f"Pose[{i}]\n{m}")

    res = snap_resolution_pow2(args.volume_size, args.cell_size)
    cfg = TSDFConfig(
        xres=res, yres=res, zres=res,
        xsize=args.volume_size, ysize=args.volume_size, zsize=args.volume_size,
        max_dist_pos=args.trunc_dist_pos, max_dist_neg=args.trunc_dist_neg,
        min_sensor_dist=args.min_sensor_dist, max_sensor_dist=args.max_sensor_dist,
        focal_length_x=fx, focal_length_y=fy,
        principal_point_x=cx, principal_point_y=cy,
        image_width=width, image_height=height,
        max_cell_size_x=args.max_cell_size, max_cell_size_y=args.max_cell_size,
        max_cell_size_z=args.max_cell_size,
        integrate_color=args.color,
        num_random_splits=args.num_random_splits,
        frustum_culling=not args.no_frustum_culling,
    )
    log.info(f"Setting resolution: {res} with grid size {args.volume_size}")

    if args.cloud_only:
        vol = None
    elif args.sparse:
        vol = make_brick_volume(cfg, args.brick_size, args.brick_capacity, device=dev)
    else:
        vol = make_volume(cfg, device=dev)
    aggregate_pts, aggregate_rgb = [], []
    num_frames = len(pcd_files)
    if args.num_frames is not None and 0 <= args.num_frames <= num_frames:
        num_frames = args.num_frames
    metrics = []

    # ---- checkpoint/resume (SURVEY §5 failure recovery) ----
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_path = os.path.join(args.out_dir, "checkpoint.npz")
    state_path = os.path.join(args.out_dir, "checkpoint.json")
    start_frame = 0
    if args.resume and os.path.exists(ckpt_path):
        # next_frame lives INSIDE the npz (crash-atomic with the arrays);
        # the sidecar json is a readable mirror and legacy fallback only
        meta = checkpoint_meta(ckpt_path)
        cursor = None
        if "next_frame" in meta:
            cursor = int(meta["next_frame"])
        elif os.path.exists(state_path):
            with open(state_path) as f:
                cursor = int(json.load(f)["next_frame"])
        if cursor is None:
            # a checkpoint volume with NO recoverable frame cursor (legacy
            # writer crashed between npz and json): loading it and starting
            # at frame 0 would fuse every frame a second time — start fresh
            log.warning(f"{ckpt_path} has no frame cursor (and no "
                        f"{state_path}); ignoring it and starting fresh")
        else:
            start_frame = cursor
            vol = load_any(ckpt_path, device=dev)
            # the checkpoint's volume kind wins over the --sparse flag in
            # both directions
            args.sparse = isinstance(vol, BrickVolume)
            log.info(f"Resuming from {ckpt_path} at frame {start_frame + 1} "
                     f"({'sparse' if args.sparse else 'dense'})")

    def save_ckpt(next_frame):
        save_checkpoint(ckpt_path, vol, {"next_frame": next_frame})
        tmp = state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"next_frame": next_frame}, f)
        os.replace(tmp, state_path)
        log.info(f"Checkpointed {ckpt_path} (next frame {next_frame + 1})")

    # with --metrics-json each stage ends in a device sync, so its host
    # clock measures the stage's work and not its enqueueing; each stage is
    # a span of the port's tracing
    timed = args.metrics_json is not None

    def end_stage():
        if timed:
            _sync(dev)

    for i in range(start_frame, num_frames):
        with tracing.timed("cli.frame") as frame_span:
            log.info(f"On frame {i + 1} / {num_frames}")
            with tracing.timed("cli.read") as span:
                cloud = pcd_io.load_pcd(pcd_files[i])
                xyz = cloud.xyz().astype(np.float64) * args.cloud_units
                rgb = cloud.rgb()
                if args.zero_nans:
                    zero = (xyz == 0).all(-1)
                    xyz[zero] = np.nan
                pose = poses[i] if i < len(poses) else np.eye(4)
                if args.world:
                    inv = np.linalg.inv(pose)
                    xyz = xyz @ inv[:3, :3].T + inv[:3, 3]
            frame = dict(frame=i, read_s=span.seconds)
            if args.organized:
                if cloud.height != height or cloud.width != width:
                    print(f"Error: cloud {i + 1} has size {cloud.width} x "
                          f"{cloud.height}, but TSDF is initialized for "
                          f"{width} x {height} pointclouds", file=sys.stderr)
                    return 1
                depth = torch.as_tensor(xyz[:, 2].reshape(height, width).astype(np.float32),
                                        device=dev)
                rgb_img = (None if rgb is None
                           else torch.as_tensor(rgb.reshape(height, width, 3), device=dev))
            else:
                with tracing.timed("cli.organize") as span:
                    depth, rgb_img = organize_cloud(cfg, xyz.astype(np.float32), rgb, device=dev)
                    end_stage()
                frame["organize_s"] = span.seconds
                if log.isEnabledFor(logging.DEBUG):
                    log.debug(f"Reprojection yielded {int(torch.isfinite(depth).sum())} "
                              f"valid points, of initial {np.isfinite(xyz[:, 2]).sum()}")
            # integrate.cpp:650; a directory without pose files falls back to
            # identity poses frame-by-frame (see `pose` above), so frame 0 does too
            pose0 = poses[0] if len(poses) else np.eye(4)
            pose_rel = np.linalg.inv(pose0) @ pose
            if args.cloud_only:
                depth_h = depth.cpu().numpy()
                ok = np.isfinite(depth_h.reshape(-1))
                if args.organized:
                    # the cloud carries exact x/y — keep them instead of
                    # re-deriving from (possibly default) pinhole intrinsics
                    pts = xyz.astype(np.float32)[ok]
                else:
                    uu, vv = np.meshgrid(np.arange(width), np.arange(height))
                    zz = depth_h.reshape(-1)[ok]
                    xx = (uu.reshape(-1)[ok] - cx) / fx * zz
                    yy = (vv.reshape(-1)[ok] - cy) / fy * zz
                    pts = np.stack([xx, yy, zz], -1)
                pts = pts @ pose_rel[:3, :3].T + pose_rel[:3, 3]
                aggregate_pts.append(pts)
                if rgb_img is not None:
                    aggregate_rgb.append(rgb_img.cpu().numpy().reshape(-1, 3)[ok])
            else:
                with tracing.timed("cli.integrate") as span:
                    pose_t = torch.as_tensor(pose_rel, dtype=torch.float32, device=dev)
                    rgb_in = None if (rgb_img is None or not args.color) else rgb_img
                    if args.sparse:
                        limits = {}
                        vol = integrate_bricks(vol, depth, pose_t, rgb_in, args.update_budget,
                                               limits=limits)
                        if bool(vol.overflowed):
                            _warn_overflow(i, exceeded_limits(limits))
                    else:
                        vol = integrate(vol, depth, pose_t, rgb_in)
                    end_stage()
                frame["integrate_s"] = span.seconds
            end_stage()
        metrics.append(dict(frame, seconds=frame_span.seconds))
        if args.save_every and not args.cloud_only and (i + 1) % args.save_every == 0:
            save_ckpt(i + 1)
        if args.visualize_every and not args.cloud_only \
                and (i + 1) % args.visualize_every == 0:
            r = render_view(vol, pose_t)
            save_png(os.path.join(args.out_dir, f"viz_{i:04d}_depth.png"),
                     depth_to_u8(r.depth.cpu().numpy()))
            save_png(os.path.join(args.out_dir, f"viz_{i:04d}_normals.png"),
                     normals_to_u8(r.normals.cpu().numpy()))
            log.info(f"Wrote viz_{i:04d}_*.png")

    if args.cloud_only:
        pts = np.concatenate(aggregate_pts, 0)
        rgbs = np.concatenate(aggregate_rgb, 0) if aggregate_rgb else None
        pts, rgbs = voxel_downsample(pts, rgbs, leaf=0.01)
        fields = {"x": pts[:, 0].astype(np.float32), "y": pts[:, 1].astype(np.float32),
                  "z": pts[:, 2].astype(np.float32)}
        if rgbs is not None:
            fields["rgb"] = pcd_io.pack_rgb(rgbs)
        pcd_io.save_pcd(os.path.join(args.out_dir, "cloud.pcd"),
                        pcd_io.PointCloud(fields, len(pts), 1), mode="binary")
        log.info(f"Saved to {args.out_dir}/cloud.pcd")
        return 0

    t1 = time.time()
    # one extraction a run: eager, since a graph's capture would never replay
    verts, faces, cols = extract_mesh(vol, min_weight=args.min_weight,
                                      color_by_rgb=args.color, graph=False)
    extract_s = time.time() - t1        # ends in the copy of the mesh to the host
    if args.flatten:
        verts, faces, cols = flatten_vertices(verts, faces, cols)
    if args.cleanup:
        verts, faces, cols = cleanup_mesh(verts, faces, cols)
    log.info(f"Entire pipeline took {(time.time() - t_start) * 1000.0:.1f} ms")
    mesh_path = os.path.join(args.out_dir, "mesh.ply")
    ply_io.save_ply(mesh_path, verts, faces, colors=cols, binary=not args.save_ascii)
    log.info(f"Saved to {mesh_path}")
    t1 = time.time()
    if args.save_tsdf:
        if args.tsdf_format == "vol":
            tsdf_path = os.path.join(args.out_dir, "volume.tsdf")
            dv = to_dense(vol) if args.sparse else vol
            save_vol(tsdf_path, cfg, dv.sdf.cpu().numpy(), dv.weight.cpu().numpy(),
                     dv.M.cpu().numpy(), dv.nsample.cpu().numpy(),
                     rgb=None if dv.color is None else dv.color.cpu().numpy(),
                     color_mode=cfg.color_mode)
        else:
            tsdf_path = os.path.join(args.out_dir, "volume.npz")
            save_checkpoint(tsdf_path, vol)
        log.info(f"Saved full tsdf to {tsdf_path}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(dict(frames=metrics, total_s=time.time() - t_start,
                           resolution=res, device=str(dev), extract_s=extract_s,
                           save_tsdf_s=time.time() - t1 if args.save_tsdf else None), f)
    return 0


def tsdf2mesh_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tsdf2mesh",
        description="Render a mesh from a saved TSDF volume (.npz or "
                    "reference .vol/.tsdf).")
    p.add_argument("volume_file")
    p.add_argument("mesh_file")
    p.add_argument("--min-weight", type=float, default=0.0)
    args = p.parse_args(argv)
    dev = device_from_env()
    print(f"Converting {args.volume_file} -> {args.mesh_file}")
    vol = load_any(args.volume_file, device=dev)
    print("Loaded! Running marching cubes")
    verts, faces, cols = extract_mesh(vol, min_weight=args.min_weight, graph=False)
    ply_io.save_ply(args.mesh_file, verts, faces, colors=cols, binary=True)
    return 0


def get_intrinsics_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="get-intrinsics",
        description="Estimate pinhole intrinsics from one organized cloud.")
    p.add_argument("pcd_file")
    args = p.parse_args(argv)
    cloud = pcd_io.load_pcd(args.pcd_file)
    print(f"Loading cloud {args.pcd_file}")
    xyz = cloud.xyz().reshape(cloud.height, cloud.width, 3)
    fx, fy, cx, cy, err = estimate_intrinsics(xyz, cloud.width, cloud.height)
    print(f"Width: {cloud.width}")
    print(f"Height: {cloud.height}")
    print(f"fx: {fx:.6f}")
    print(f"fy: {fy:.6f}")
    print(f"cx: {cx:.6f}")
    print(f"cy: {cy:.6f}")
    print(f"Total reprojection error: {err:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(integrate_main())
