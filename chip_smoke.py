#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py    # on a machine with a CUDA card; fails without one

Phases (any failure raises and exits non-zero before the last line):

  1. the card's name and power limit (nvidia-smi), then the kernels' build
     from cpu_tsdf_tpu_torch/csrc (one nvcc per source, all at once);
  2. the main path through the library entry points a user calls:
     make_brick_volume -> integrate_bricks over a 48-pose noisy colored
     orbit of a radius-0.5 sphere at the reference default (512^3, 3 m,
     640x480, f=525) -> extract_mesh -> save_ply. The kernels' launch
     counts are zeroed just before it and read just after: every kernel
     must have run. The mesh must lie on the sphere (median radius error
     below half a cell) and the volume must not have overflowed;
  3. the frame-time breakdown (activation + allocation, the fusion kernel
     with its color update, the glue left in fuse_brick_batch) on replayed
     frames;
  4. each kernel against its plain PyTorch version on the same card, at
     the main path's shapes (fusion: one real frame's update list with
     color, weight, nsample and RGB color exact, sdf and M within 1e-5,
     and the bound of the voxels the frame observes beside the bound of
     every voxel of its live rows; corner halo: the volume's
     candidate bricks, count, cube table, triangle counts and the corner
     rows below each count exact, its bound beside the former dense
     stack's; emission: the real cube list with the identity and a moved
     global transform, triangles and cube references exact, vertices
     within 1e-6 with the differing rows logged), with CUDA-event times of
     both; the extraction's breakdown (candidates, corner halo, scan +
     sync + emission + colors, copy to host) comes before it;
  5. whole-path parity: the first 8 frames through the kernels and through
     the plain engine on the card, volumes and meshes compared;
  6. the render path on the phase-2 volume: pack_render, then render_view
     (colored, 640x480) from all 48 orbit poses, with the ray-march launch
     count zeroed just before and read just after; every depth image held
     against the noiseless sphere (interior coverage > 0.95, median error
     below half a cell); the ray-march kernel against its plain version on
     two poses at full width (all 8 channels bit-equal), with CUDA-event
     times of both and the bound from the plain march's own count of the
     work; one render_depth_diff forward and backward at full width through
     both routes (gradients finite and nonzero, equal within 1e-5 relative,
     the pose-z derivative of the mean depth of the well-conditioned rays
     within 25 % of a central difference with the crossing brackets held).

Output: progress on stderr; on stdout a line of kernel records
{"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
HALF_CELL_M = 0.5 * 3.0 / 512


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable, with the 50 MB L2 flushed
    before each timed run: the main path reaches each kernel after other
    work has moved through the cache. With spin, about 1 ms of spinning on
    the card follows the flush, so the host has queued the events and the
    call before the card reaches them: a kernel's time is then its device
    time, not the host's launch latency (a callable that syncs with the
    host still counts its syncs). Without it, the time is what a caller
    waits for the call, host launches included."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def ms(self, fn, reps: int = 10, warmup: int = 2, spin: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(2_000_000)    # clock cycles, ~1 ms
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def device_ms(torch, fn):
    """Kernel time (ms) that fn puts on the card, summed by torch.profiler,
    and the five largest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda kv: -kv[1])
    return sum(ms for _, ms in kern), [(k[:60], round(ms, 4)) for k, ms in kern[:5]]


def orbit(cfg, n_poses: int, seed: int = 7):
    """The JAX package's trajectory-benchmark scene (bench.py): a camera
    orbiting a radius-0.5 sphere at 1 m, 1.5 mm depth noise, 5% dropouts,
    a fixed color pattern."""
    from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(cfg.image_width), np.arange(cfg.image_height))
    rgb = np.stack([uu % 256, vv % 256, (uu + vv) % 256], -1).astype(np.float32)
    poses, depths = [], []
    for i in range(n_poses):
        m = orbit_pose(2.0 * np.pi * i / n_poses)
        d = sphere_depth_world(cfg, m, radius=0.5)
        d = d + rng.normal(0.0, 0.0015, d.shape).astype(np.float32)
        d = np.where(rng.uniform(size=d.shape) < 0.05, np.nan, d)
        poses.append(m)
        depths.append(d.astype(np.float32))
    return np.stack(poses), np.stack(depths), rgb


def shadow(vol):
    """A volume sharing vol's state rows but with its own allocation
    tensors, for replaying activation + allocation without touching vol."""
    import dataclasses

    return dataclasses.replace(vol, brick_map=vol.brick_map.clone(),
                               coords=vol.coords.clone(), n_active=vol.n_active.clone(),
                               overflowed=vol.overflowed.clone())


def state_copy(vol):
    return [t.clone() for t in (vol.sdf, vol.weight, vol.M, vol.nsample)]


def assert_volumes_equal(torch, a, b, what: str) -> float:
    """Exact structure, weight, nsample and color; sdf and M within 1e-5.
    Returns the largest sdf/M difference."""
    for name in ("brick_map", "coords", "n_active", "overflowed", "weight", "nsample", "color"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differs")
    err = max(float((a.sdf - b.sdf).abs().max()), float((a.M - b.M).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"{what}: sdf/M differ by {err}")
    return err


def record(name, source, replaces, launches, err, ms, plain_ms, nbytes, nops):
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nops / FP32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None}


def mc_phase(torch, mc, vol, main_launches, timer):
    """Phase 4's MC part (see the module docstring); returns the records of
    the corner-halo and emission kernels."""
    import dataclasses

    cfg = vol.config
    cand = mc._candidate_slots(vol, 0.5)
    K = int(cand.shape[0])
    count, cube, corners, ntri = mc.corner_halo(vol, cand, 0.5)
    pcount, pcube, pcorners, pntri = mc._corner_halo_plain(vol, cand, 0.5)
    live = torch.arange(512, device=cand.device)[None] < count[:, None]
    n_cubes = int(count.sum())
    same = (torch.equal(count, pcount) and torch.equal(cube, pcube) and torch.equal(ntri, pntri)
            and torch.equal(corners[live], pcorners[live]))
    err = max(float((a - b).abs().max()) for a, b in (
        (count, pcount), (cube, pcube), (ntri, pntri), (corners[live], pcorners[live])))
    if not same:
        raise AssertionError(f"corner-halo kernel differs from its plain version ({err})")
    t_k = timer.ms(lambda: mc.corner_halo(vol, cand, 0.5), spin=True)
    t_p = timer.ms(lambda: mc._corner_halo_plain(vol, cand, 0.5), spin=True)
    halo = record("mc_corner_halo", "cpu_tsdf_tpu_torch/csrc/mc_corner_halo.cu",
                  "cpu_tsdf_tpu/ops/marching_cubes.py:695", main_launches["corner_halo"], err,
                  t_k, t_p, mc.bytes_moved_corner_halo(K, n_cubes), K * 512 * 64)
    # the former dense contract (every voxel's stack, ok and loc) as a yardstick
    halo["bound_dense_ms"] = mc.bytes_moved_dense_stack(K) / HBM_BYTES_PER_S * 1e3
    log(f"corner halo: {K} candidate bricks, {n_cubes} crossing cubes "
        f"({n_cubes / (K * 512):.4f} of their cubes), {int(ntri.sum())} triangles, "
        f"{int((count == 0).sum())} bricks without one; kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms; bound {halo['bound_ms']:.5f} ms "
        f"({mc.bytes_moved_corner_halo(K, n_cubes)} bytes), dense-stack bound "
        f"{halo['bound_dense_ms']:.5f} ms; exact")

    # the emission on the real cube list, with the volume's identity transform
    # and with a rotation and translation
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n_tri = int(ends[-1])
    off = ends - ntri
    a = 0.7
    moved = torch.tensor([[np.cos(a), 0.0, np.sin(a), 0.31], [0.0, 1.0, 0.0, -0.17],
                          [-np.sin(a), 0.0, np.cos(a), 1.23], [0.0, 0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=cand.device)
    err = 0.0
    for what, v in (("identity", vol), ("rotated", dataclasses.replace(vol, global_transform=moved))):
        vk, tk = mc.emit_triangles(v, cand, count, cube, corners, off, n_tri)
        vp, tp = mc._emit_plain(v, cand, count, cube, corners)
        if vk.shape != vp.shape or not torch.equal(tk, tp):
            raise AssertionError(f"emission kernel ({what}): triangles or cube references "
                                 f"differ ({tuple(vk.shape)} vs {tuple(vp.shape)})")
        verr = float((vk - vp).abs().max())
        err = max(err, verr)
        log(f"emission kernel vs plain ({what} transform): {n_tri} triangles, cube "
            f"references equal; vertices torch.equal {torch.equal(vk, vp)}, "
            f"{int((vk != vp).any(-1).any(-1).sum())} triangles differ, max err {verr}")
        if verr > 1e-6:
            raise AssertionError(f"emission kernel vertices differ by {verr}")
    t_k = timer.ms(lambda: mc.emit_triangles(vol, cand, count, cube, corners, off, n_tri),
                   spin=True)
    t_p = timer.ms(lambda: mc._emit_plain(vol, cand, count, cube, corners), spin=True)
    # operations: per triangle 3 vertices of 17 (interpolation) + 18
    # (transform); per cube 8 scalings and 9 for its centre
    emit = record("mc_emit", "cpu_tsdf_tpu_torch/csrc/mc_emit.cu",
                  "cpu_tsdf_tpu/ops/marching_cubes.py:631", main_launches["emit"], err, t_k, t_p,
                  mc.bytes_moved_emit(K, n_cubes, n_tri), n_tri * 105 + n_cubes * 17)
    log(f"emission: {n_tri} triangles, kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
        f"{emit['bound_ms']:.5f} ms ({mc.bytes_moved_emit(K, n_cubes, n_tri)} bytes)")
    return [halo, emit]


def render_phase(torch, cfg, vol, poses, poses_h, timer):
    """Phase 6 (see the module docstring); returns the ray-march kernel's
    record."""
    import dataclasses

    from cpu_tsdf_tpu_torch import pack_render, render_view
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse, transform_points
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
    from cpu_tsdf_tpu_torch.ops.interpolate import tsdf_value_vol
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays
    from cpu_tsdf_tpu_torch.synthetic import sphere_depth_world

    n_poses = len(poses)
    n_rays = cfg.image_width * cfg.image_height
    torch.cuda.synchronize()
    rk.launches["raycast"] = 0
    t0 = time.perf_counter()
    packed = pack_render(vol)
    views = [render_view(packed, poses[i], colored=True) for i in range(n_poses)]
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    n_launch = rk.launches["raycast"]
    log(f"render path: {n_poses} colored {cfg.image_width}x{cfg.image_height} views in "
        f"{t_render:.4f} s (host clock, one pack_render included) = "
        f"{n_poses / t_render:.2f} renders/s, {n_poses * n_rays / t_render / 1e6:.2f} M rays/s; "
        f"raycast launches {n_launch}")
    if n_launch < n_poses:
        raise AssertionError(f"the ray-march kernel ran {n_launch} times for {n_poses} renders")

    # every view against the noiseless sphere seen from its pose
    coverage, errs, n_rgb = [], [], 0
    for i, view in enumerate(views):
        truth = sphere_depth_world(cfg, poses_h[i], radius=0.5)
        d = view.depth.cpu().numpy()
        interior = ~np.isnan(truth) & (truth < np.nanmax(truth) - 0.12)
        coverage.append((~np.isnan(d) & interior).sum() / max(interior.sum(), 1))
        both = ~np.isnan(d) & ~np.isnan(truth)
        errs.append(np.abs(d[both] - truth[both]))
        rgb = view.rgb.cpu().numpy()
        ok = ~np.isnan(rgb[..., 0])
        n_rgb += int(ok.sum())
        if not (np.all(rgb[ok] >= 0) and np.all(rgb[ok] <= 255) and np.isfinite(d[both]).all()):
            raise AssertionError(f"view {i}: colors out of range or depth not finite")
    err = np.concatenate(errs)
    log(f"render depth vs the noiseless sphere: interior coverage min {min(coverage):.6f} "
        f"mean {np.mean(coverage):.6f}; error median {np.median(err) * 1e3:.4f} mm, "
        f"p99 {np.percentile(err, 99) * 1e3:.4f} mm over {err.size} pixels; "
        f"{n_rgb} colored pixels")
    if min(coverage) <= 0.95 or np.median(err) >= HALF_CELL_M:
        raise AssertionError("rendered depth does not match the sphere")

    # the kernel against its plain version at full width
    max_err = 0.0
    for i in (0, n_poses // 2):
        origins, dirs = (t.contiguous() for t in camera_rays(cfg, poses[i]))
        k = rk.march(packed, origins, dirs)
        p = rk.march_plain(packed, origins, dirs)
        diff = {name: int((k[c] != p[c]).sum()) for c, name in enumerate(rk.CHANNELS)}
        both = (k[3] > 0) & (p[3] > 0)
        max_err = max(max_err, float((k - p).abs().max()))
        log(f"raycast kernel vs plain, pose {i}: {int(both.sum())} rays valid in both, "
            f"{int(k[1].sum())} found; rays differing per channel {diff}; "
            f"channels bit-equal: {torch.equal(k, p)}")
        if not torch.equal(k, p):
            raise AssertionError("ray-march kernel differs from its plain version")
    t_k = timer.ms(lambda: rk.march(packed, origins, dirs), spin=True)
    t_p = timer.ms(lambda: rk.march_plain(packed, origins, dirs), reps=5, warmup=1, spin=True)
    nbytes, nops = rk.march_work(packed, origins, dirs)
    t_view = timer.ms(lambda: render_view(packed, poses[n_poses // 2], colored=True))
    log(f"raycast: {n_rays} rays, kernel {t_k:.4f} ms, plain {t_p:.4f} ms; work "
        f"{nbytes} bytes, {nops} operations; colored render_view of the packed "
        f"volume {t_view:.4f} ms (CUDA events, launches included)")
    n_prof = 8
    t0 = time.perf_counter()
    for k in range(n_prof):
        render_view(packed, poses[k], colored=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, top = device_ms(torch, lambda: [render_view(packed, poses[k], colored=True)
                                          for k in range(n_prof)])
    log(f"device busy over {n_prof} renders: {busy:.4f} ms of {wall:.4f} ms wall "
        f"(share {busy / wall:.4f}; torch.profiler kernel time, wall unprofiled); "
        f"largest: {top}")

    # the differentiable render at full width, both routes. The loss is the
    # mean depth over the well-conditioned rays: valid, the refined crossing
    # inside its half-cell bracket, the two trilinear samples at least 0.05
    # apart. Elsewhere the refinement extrapolates or divides by a near-zero
    # difference (reference semantics), and its derivative is unbounded.
    i = n_poses // 2
    origins, dirs = (t.contiguous() for t in camera_rays(cfg, poses[i]))
    ch = rk.march(packed, origins, dirs)
    t_bt, found = ch[0], ch[1] > 0
    half = cfg.zsize / cfg.zres / 2.0

    def points(t):
        return [origins[:, k] + t * dirs[:, k] for k in range(3)]

    sep = (tsdf_value_vol(packed, *points(t_bt - half))[0]
           - tsdf_value_vol(packed, *points(t_bt))[0]).abs()
    rays = (ch[3] > 0) & (ch[2] >= t_bt - half) & (ch[2] <= t_bt) & (sep > 0.05)

    def loss(d, valid):
        m = valid & rays.reshape(d.shape)
        return torch.where(m, d, 0.0).sum() / m.sum()

    grads = []
    for use_kernel in (True, False):
        sdf = vol.sdf.clone().requires_grad_(True)
        pose = poses[i].clone().requires_grad_(True)
        t0 = time.perf_counter()
        d, valid, ok = rk.render_depth_diff(dataclasses.replace(vol, sdf=sdf), pose,
                                            use_kernel=use_kernel)
        loss(d, valid).backward()
        torch.cuda.synchronize()
        grads.append((sdf.grad, pose.grad, time.perf_counter() - t0))
    (gk_sdf, gk_pose, t_gk), (gp_sdf, gp_pose, t_gp) = grads
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in ((gk_sdf, gp_sdf), (gk_pose, gp_pose)))

    # central differences in pose z of the same loss: with the brackets held
    # at this pose (the function the backward differentiates: the gate) and
    # free (the render itself: logged, see PERF.md)
    def mean_depth(tz, frozen):
        pose = poses[i].clone()
        pose[2, 3] += tz
        if not frozen:
            return float(loss(*rk.render_depth_diff(vol, pose)[:2]))
        o, r = camera_rays(cfg, pose)
        t = rk.refine_differentiable(vol, o, r, t_bt, found)
        t = torch.where(rays, t, 1.0)
        d = transform_points(rigid_inverse(pose), *(o[:, k] + t * r[:, k] for k in range(3)))[2]
        return float(loss(d, rays))

    eps = 1e-4
    fd, fd_free = ((mean_depth(eps, f) - mean_depth(-eps, f)) / (2 * eps) for f in (True, False))
    g_z = float(gk_pose[2, 3])
    log(f"render_depth_diff at full width: forward + backward {t_gk * 1e3:.2f} ms (kernel "
        f"route) / {t_gp * 1e3:.2f} ms (plain route), host clock; loss over "
        f"{int(rays.sum())} well-conditioned of {int((ch[3] > 0).sum())} valid rays; sdf "
        f"gradient {int((gk_sdf != 0).sum())} nonzero; routes differ by {rel:.3g} relative; "
        f"pose z derivative {g_z:.6f}, central difference {fd:.6f} with the brackets "
        f"held, {fd_free:.6f} free")
    if not (torch.isfinite(gk_sdf).all() and torch.isfinite(gk_pose).all()
            and int((gk_sdf != 0).sum()) > 0 and g_z != 0.0):
        raise AssertionError("render_depth_diff gradients are not finite and nonzero")
    if rel > 1e-5 or abs(fd - g_z) > 0.25 * max(abs(fd), abs(g_z), 1e-3):
        raise AssertionError("render_depth_diff gradients disagree")

    return record("raycast", "cpu_tsdf_tpu_torch/csrc/raycast.cu",
                  "cpu_tsdf_tpu/ops/pallas_raycast.py:367", n_launch, max_err, t_k, t_p,
                  nbytes, nops)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script measures the card and has no "
                         "CPU fallback")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import cpu_tsdf_tpu_torch as T
    from cpu_tsdf_tpu_torch import _build, bricks
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.io.ply import load_ply, save_ply
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    secs = _build.build()
    log(f"kernels built in {secs:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- phase 2: the main path ------------------------------------------
    cfg = T.TSDFConfig().with_updates(min_sensor_dist=0.3, integrate_color=True,
                                      color_mode="RGB")
    capacity, budget, n_poses = 1 << 15, 1 << 12, 48
    poses_h, depths_h, rgb_h = orbit(cfg, n_poses)
    poses = torch.as_tensor(poses_h, device=dev)       # one upload each
    depths = torch.as_tensor(depths_h, device=dev)
    rgb = torch.as_tensor(rgb_h, device=dev)
    vol = T.make_brick_volume(cfg, 8, capacity, device=dev)
    torch.cuda.synchronize()
    fk.launches["fusion"] = 0
    mc.launches.update(corner_halo=0, emit=0)
    t0 = time.perf_counter()
    for i in range(n_poses):
        T.integrate_bricks(vol, depths[i], poses[i], rgb, budget)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, colors = mc.extract_mesh(vol, min_weight=0.5, color_by_rgb=True)
    t_mesh = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.ply"
        save_ply(path, verts, faces, colors)
        v2, f2, _ = load_ply(path)
    main_launches = {"fusion": fk.launches["fusion"], **mc.launches}
    n_live = int(vol.n_active)
    radius_err = float(np.median(np.abs(np.linalg.norm(verts, axis=1) - 0.5)))
    log(f"main path: {n_poses} frames in {t_fuse:.3f} s = {n_poses / t_fuse:.2f} frames/s; "
        f"live bricks {n_live}; overflowed {bool(vol.overflowed)}; "
        f"{len(faces)} triangles; extraction {t_mesh * 1e3:.2f} ms (host clock, "
        f"includes the copy to the host); median |r-0.5| {radius_err * 1e3:.4f} mm; "
        f"launches {main_launches}")
    if bool(vol.overflowed):
        raise AssertionError("the main path overflowed its volume or budgets")
    if len(faces) < 1000 or not np.isfinite(verts).all() or v2.shape != verts.shape:
        raise AssertionError(f"bad mesh: {len(faces)} triangles")
    if radius_err >= HALF_CELL_M:
        raise AssertionError(f"mesh radius error {radius_err} >= half a cell")
    if min(main_launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: {main_launches}")

    # every frame's update list names distinct slots (blocks write in parallel)
    replay = shadow(vol)
    replay.brick_map.fill_(-1)
    replay.coords.fill_(-1)
    replay.n_active.zero_()
    lists = []
    for i in range(n_poses):
        pose_inv = rigid_inverse(poses[i])
        bx, by, bz, ok, slots, _ = bricks.frame_update_list(replay, depths[i], pose_inv, budget)
        live = slots[ok]
        if live.unique().numel() != live.numel():
            raise AssertionError(f"frame {i}: duplicate slots in the update list")
        lists.append((pose_inv, torch.stack([bx, by, bz, torch.where(ok, slots, -1)], 1)
                      .to(torch.int32).contiguous(), int(ok.sum())))
    if not torch.equal(replay.brick_map, vol.brick_map):
        raise AssertionError("replayed allocation differs from the main path's")
    log(f"update lists: slots unique in all {n_poses} frames; live rows per frame "
        f"{min(n for *_, n in lists)}..{max(n for *_, n in lists)}")

    timer = Timer(torch, dev)

    # ---- phase 3: frame-time breakdown (on replayed frames, state copies) --
    rgb_t = torch.trunc(rgb).contiguous()
    st = state_copy(vol)
    i_mid = n_poses // 2
    pose_inv, rows, n_ok = lists[i_mid]

    def activation():
        bricks.frame_update_list(shadow(vol), depths[i_mid], pose_inv, budget)

    color = vol.color.clone()

    def fuse_only():
        fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *st, color, rgb_t)

    def fuse_batch():
        bricks.fuse_brick_batch(cfg, 8, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] >= 0,
                                torch.clamp(rows[:, 3], min=0), *st, color,
                                depths[i_mid], pose_inv, rgb, True)

    def whole_frame():
        T.integrate_bricks(shadow_vol, depths[i_mid], poses[i_mid], rgb, budget)

    shadow_vol = shadow(vol)
    shadow_vol.sdf, shadow_vol.weight, shadow_vol.M, shadow_vol.nsample = st
    shadow_vol.color = color
    t_act = timer.ms(activation)
    t_fk = timer.ms(fuse_only, spin=True)
    t_fb = timer.ms(fuse_batch)
    t_frame = timer.ms(whole_frame)
    log(f"frame breakdown (frame {i_mid}, {n_ok} live rows): whole frame {t_frame:.4f} ms; "
        f"activation+allocation {t_act:.4f} ms (one host sync: the allocation count); "
        f"fusion kernel with the color update {t_fk:.4f} ms (device); fuse_brick_batch "
        f"{t_fb:.4f} ms (kernel + glue: rgb trunc, row stack; launches included), glue "
        f"{t_fb - t_fk:.4f} ms")
    n_prof = 8
    t0 = time.perf_counter()
    for i in range(n_prof):
        T.integrate_bricks(shadow_vol, depths[i], poses[i], rgb, budget)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, top = device_ms(torch, lambda: [
        T.integrate_bricks(shadow_vol, depths[i], poses[i], rgb, budget)
        for i in range(n_prof)])
    log(f"device busy over {n_prof} frames: {busy:.4f} ms of {wall:.4f} ms wall "
        f"(share {busy / wall:.4f}; torch.profiler kernel time, wall unprofiled); "
        f"largest: {top}")

    # extraction steps on the main volume (each a median of synchronized runs)
    t_cand = timer.ms(lambda: mc._candidate_slots(vol, 0.5))
    cand = mc._candidate_slots(vol, 0.5)
    t_halo = timer.ms(lambda: mc.corner_halo(vol, cand, 0.5))
    t_soup = timer.ms(lambda: mc.extract_soup_bricks(vol, 0.5, True))
    soup = mc.extract_soup_bricks(vol, 0.5, True)
    t_host = timer.ms(soup.to_numpy)
    n_cubes = int(mc.corner_halo(vol, cand, 0.5)[0].sum())
    log(f"extraction breakdown: brick stats + candidates {t_cand:.4f} ms; corner halo "
        f"{t_halo:.4f} ms; scan + sync + emission + colors {t_soup - t_cand - t_halo:.4f} ms; "
        f"copy to host {t_host:.4f} ms ({int(cand.shape[0])} candidate bricks, {n_cubes} "
        f"crossing cubes, {soup.num_triangles} triangles; 2 host syncs: candidate list, "
        f"triangle total)")

    # ---- phase 4: each kernel against its plain version -------------------
    kernels = []
    a = state_copy(vol) + [vol.color.clone()]
    b = state_copy(vol) + [vol.color.clone()]
    fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *a, rgb_t)
    fk.fuse_bricks_plain(cfg, rows, pose_inv, depths[i_mid], *b, rgb_t)
    for name, x, y in zip(("sdf", "weight", "M", "nsample", "color"), a, b):
        if name in ("weight", "nsample", "color") and not torch.equal(x, y):
            raise AssertionError(f"fusion kernel: {name} differs from the plain engine")
    if torch.equal(a[4], vol.color):
        raise AssertionError("fusion kernel: the frame changed no color")
    n_obs = int((a[3] - vol.nsample).sum())   # each observed voxel's nsample went up by 1
    err = max(float((a[0] - b[0]).abs().max()), float((a[2] - b[2]).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"fusion kernel: sdf/M err {err}")
    t_k = timer.ms(lambda: fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *a, rgb_t),
                   spin=True)
    t_p = timer.ms(lambda: fk.fuse_bricks_plain(cfg, rows, pose_inv, depths[i_mid], *b, rgb_t),
                   spin=True)
    H, W = cfg.image_height, cfg.image_width
    nc = vol.color.shape[-1]
    kernels.append(record("fusion", "cpu_tsdf_tpu_torch/csrc/fusion.cu",
                          "cpu_tsdf_tpu/ops/pallas_fusion.py:363", main_launches["fusion"],
                          err, t_k, t_p, fk.bytes_moved(n_ok, H, W, nc),
                          n_ok * 512 * (fk.OPS_PER_VOXEL
                                        + fk.COLOR_OPS_PER_VOXEL[cfg.color_mode])))
    # the bound counts every voxel of a live row; the observed ones are all
    # the function needs
    obs_bytes = fk.voxel_bytes(n_obs, H, W, nc)
    kernels[-1]["bound_observed_ms"] = obs_bytes / HBM_BYTES_PER_S * 1e3
    log(f"fusion with color: {n_ok} rows, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"max err {err}; bound {kernels[-1]['bound_ms']:.5f} ms "
        f"({fk.bytes_moved(n_ok, H, W, nc)} bytes); {n_obs} of {n_ok * 512} voxels "
        f"observed ({n_obs / (n_ok * 512):.4f}): bound of those "
        f"{kernels[-1]['bound_observed_ms']:.5f} ms ({obs_bytes} bytes)")

    kernels += mc_phase(torch, mc, vol, main_launches, timer)

    # ---- phase 5: whole-path parity, kernels vs plain engine --------------
    n_par = 8
    vk = T.make_brick_volume(cfg, 8, capacity, device=dev)
    vp = T.make_brick_volume(cfg, 8, capacity, device=dev)
    for i in range(n_par):
        T.integrate_bricks(vk, depths[i], poses[i], rgb, budget)
        T.integrate_bricks(vp, depths[i], poses[i], rgb, budget, use_kernel=False)
    err = assert_volumes_equal(torch, vk, vp, "8-frame volumes")
    sk = mc.extract_soup_bricks(vk, 0.5, True)
    sp = mc.extract_soup_bricks(vp, 0.5, True, use_kernel=False)
    if sk.num_triangles != sp.num_triangles or sk.num_triangles < 1000:
        raise AssertionError(f"meshes differ: {sk.num_triangles} vs {sp.num_triangles}")
    verr = float((sk.vertices - sp.vertices).abs().max())
    if verr > 1e-6 or not torch.equal(sk.colors, sp.colors):
        raise AssertionError(f"mesh vertices differ by {verr} (or colors differ)")
    log(f"whole-path parity over {n_par} frames: volumes match (sdf/M err {err}), "
        f"{sk.num_triangles} triangles match (vertex err {verr})")
    del vk, vp, sk, sp

    kernels.append(render_phase(torch, cfg, vol, poses, poses_h, timer))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
