#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py    # on a machine with a CUDA card; fails without one

Phases (any failure raises and exits non-zero before the last line):

  1. the card's name and power limit (nvidia-smi), then the kernels' build
     from cpu_tsdf_tpu_torch/csrc (one nvcc per source, all at once);
  2. the main path through the library entry points a user calls:
     make_brick_volume -> integrate_bricks (the frame's CUDA graph, the
     default on the card; phase 11) over a 48-pose noisy colored
     orbit of a radius-0.5 sphere at the reference default (512^3, 3 m,
     640x480, f=525) -> extract_mesh -> save_ply. The kernels' launch
     counts are zeroed just before it and read just after: every kernel
     must have run. The mesh must lie on the sphere (median radius error
     below half a cell) and the volume must not have overflowed;
  3. the eager frame's time breakdown (activation + allocation, the
     fusion kernel with its color update, the glue left in
     fuse_brick_batch) on replayed frames;
  4. each kernel against its plain PyTorch version on the same card, at
     the main path's shapes (fusion: one real frame's update list with
     color, weight, nsample and RGB color exact, sdf and M within 1e-5,
     and the bound of the voxels the frame observes beside the bound of
     every voxel of its live rows; corner halo: the volume's
     candidate bricks, count, cube table, triangle counts and the corner
     rows below each count exact, its bound beside the former dense
     stack's; emission: the real cube list with the identity and a moved
     global transform, triangles and cube references exact, vertices
     within 1e-6 with the differing rows logged; activation: one frame's
     depth mips, band list and carve list through csrc/activation.cu, every
     list and count bit-equal, both routes' stage captured in a CUDA graph
     and timed, beside the stage's bytes and its launches' floor, with
     registers and spills from ptxas -v), with CUDA-event times of
     both; the extraction's breakdown (brick stats and candidates, corner
     halo, scan + emission + colors + the batch's sync, the call with
     hints and with the default budgets, copy to host) comes before it;
  5. whole-path parity: the first 8 frames through the kernels and through
     the plain engine on the card, volumes and meshes compared;
  6. the render path on the phase-2 volume: pack_render, then render_view
     (colored, 640x480) from all 48 orbit poses, with the ray-march launch
     count zeroed just before and read just after; every depth image held
     against the noiseless sphere (interior coverage > 0.95, median error
     below half a cell); the ray-march kernel against its plain version on
     two poses at full width (all 8 channels bit-equal), with CUDA-event
     times of both and the bound from the plain march's own count of the
     work; render_depth_diff and render_view under autograd at full width
     through both routes (a loss over the well-conditioned rays: their mean
     depth, and a seeded weighting of their points and normals; gradients
     finite and nonzero, equal within 1e-5 relative, the pose-z derivative
     within 25 % of a central difference with the crossing brackets held)
     with CUDA-event times of the forward and backward and of its parts:
     the march, the refinement recomputed (2 trilinear queries a ray), the
     normals (6 more) and, by torch.profiler, the scatter into the field;
  7. the CLI path at full width: a directory of 20 colored, noisy 640x480
     binary PCDs with pose .txt files (an orbit around a radius-0.4 sphere
     that lies inside the volume in frame-0 coordinates) goes through
     cli.integrate_main --sparse --color --save-tsdf --metrics-json
     --visualize-every 8 at the reference-default 512^3 volume, with every
     kernel's launch count zeroed just before and read just after (fusion
     one a frame, the ray march one a rendered view, corner halo and
     emission one an extraction); the volume must not overflow, the mesh
     must lie on the sphere and the views must be written; tsdf2mesh_main
     on the volume.npz must give the same triangles, vertices bit-equal; a
     3-frame --sparse --brick-size 16 run (capacity 2^12: the same voxels)
     must launch fusion 3 times and each MC kernel once, not overflow, mesh
     on the sphere, and its tsdf2mesh must give the same mesh; a
     dense run of 3 frames (no --save-tsdf: the 512^3 dense npz is GBs)
     must mesh through the MC kernels, on the sphere; get_intrinsics_main
     on frame 0 must recover fx within 0.5. The per-frame means of the
     PCD read, organize_cloud and integrate_bricks, the npz write and the
     tsdf2mesh wall time go to a {"cli": ...} line on stdout;
  8. pose refinement at full width: refine.refine_pose (10 iterations,
     640x480 at downsample 2) on the phase-2 volume, from the pose of orbit
     view 24 moved by the translation of tests/test_refine.py's twist,
     against the depth of the noiseless sphere from the true pose. The loss
     must fall at least 2x and the translation error must fall; the median
     refine_pose_step time gives steps/s. A {"refine": ...} line;
  9. the sharded paths on 2 ranks that share the card (torch.distributed
     over gloo: NCCL refuses two ranks on one GPU): each rank fuses its X
     slab of the first 8 orbit frames at 512^3 with color
     (parallel.bricks.integrate_bricks_sharded, 2^14 rows a rank, the
     fusion kernel counted per rank), merge_sharded must equal the
     single-device integrate_bricks brick by brick (coords, weight,
     nsample, color exact, sdf and M within 1e-5) and mesh to the same
     triangles through the MC kernels (counted per rank); render_view_sharded,
     render_view_pallas_sharded and the colored render_view_volume_sharded
     of four poses must equal the single-device kernel render in depth,
     normals and rgb (the march counted per rank and render: once, or, for
     the volume-sharded relay, once a slab the rays cross); a 3-frame
     dense integrate_sharded at 512^3 must equal the single-device dense
     integrate on each slab. Per-frame and per-render times (host clock,
     2 ranks on 1 card) go to a {"parallel": ...} line;
 10. the main path at other brick sizes: for bricks of 4, 16 and 32
     (BRICK_SIZES: capacity and update budget; phases 2-6 are the 8^3
     yardstick), make_brick_volume ->
     integrate_bricks over every third pose of the orbit (16 frames) ->
     extract_mesh -> render_view of the same 16 poses, with every kernel's
     launch count zeroed just before and read just after (fusion and each
     activation kernel one a frame, the MC kernels one an extraction, the
     march one a render); no
     overflow, the mesh on the sphere and a render's depth on it (medians
     below half a cell); then each kernel against its plain version at that
     brick size (fusion on the middle frame's update list within its
     tolerances, the corner halo exact, the emission's triangles and cube
     references exact and vertices within 1e-6, the ray march and the
     activation lists bit-equal), with CUDA-event times and bounds. Frames/s, extraction ms, renders/s,
     triangles and radius error go to a {"brick_sizes": ...} line, the
     kernels' times to their records in the kernels line.

 11. the graphed routes (cpu_tsdf_tpu_torch/graph.py; phases 2, 6, 7 and 10
     take them by default, phase 3 times the eager frame): the 48-frame
     orbit at 8^3 fused by graphed per-frame calls, by eager ones
     (graph=False), by a graphed and by an eager integrate_bricks_sequence
     into four volumes, every state tensor bit-equal and the fusion kernel
     counted once a frame on each route, then the graphed sequence again
     (steady: its graph captured); an eager and a graphed frame under
     torch.cuda.set_sync_debug_mode("error"); the card's idle share of 8
     frames on each route (the port's tracing: the device time between one
     call's end and the next call's begin); the 48 colored renders of one
     packed volume graphed and eager, bit-equal, the march counted once a
     render, with their idle shares; a graphed pass and 100 graphed renders
     with tracing on under the sync debug mode, each stage stamped at every
     replay (its report's stages in the line); the same fusion comparison on 6 frames
     at phase 10's bricks of 4 and 16 and with num_random_splits = 3. Steady
     frame ms (host clock, the first frame apart: it captures), renders/s,
     each graph's capture ms, pool MB and launches a replay go to a
     {"graphs": ...} line.
 12. the budgeted extraction (chunks of 2048 slots, budgets, hints) on the
     phase-2 volume: the checked route's triangles and colors bit-equal to
     the single pass over every candidate brick (exact sizes, two host
     syncs: the route before the chunks), its batches, budgets and hints;
     the unchecked route (check=False) with those hints through its CUDA
     graph (the default) and eagerly, equal in tri_valid, num_triangles,
     overflowed and the valid rows, the valid triangles the checked
     route's, each MC kernel counted once a live chunk a call, an eager
     call under torch.cuda.set_sync_debug_mode("error"), a quarter of each
     budget setting overflowed and the checked route recovering the mesh;
     steady ms of both routes and of the checked call with hints (host
     clock, the first call apart), idle shares, the graph's capture ms and
     pool MB. Then phase 8's refine step and residual graphed and eager,
     bit-equal at three step scales, with steady ms and idle shares; and
     organize_cloud graphed and eager on phase 7's 20 PCDs, bit-equal, with
     the median ms a frame. The emission under a triangle budget of a third
     of the mesh is held against its plain version's truncation in phases
     4 and 10 (``budget_case`` in the emission's kernel record); phase 7's
     mesh.ply is held against the single pass too. An {"extraction": ...}
     line, with phase 3's extraction breakdown.

 13. the dense integrate and the checked extraction's graphs: 4 colored
     orbit frames fused at 512^3 by ops.fusion.integrate (the dense fusion
     kernel of csrc/fusion.cu, its default on the card), in place (the
     volume is donated: each frame returns the input's tensors and
     allocates less than one state tensor, by max_memory_allocated), the
     kernel's launch count zeroed just before and read just after (one a
     frame), and by its plain version (use_kernel=False), the volumes equal
     (weight, nsample and color exact, sdf and M within 1e-5), with each
     route's frame ms; a fifth frame under autograd (the kernel on a copy:
     one launch, the input unchanged, its host-clock ms); the kernel in
     place against integrate_slab_plain on a copy of the same state on that
     frame, with the same tolerances, CUDA-event times of both (the kernel
     on a copy kept for timing), the bound of the frame (the observed
     voxels read and written once; the candidate voxels, counted one by one
     from the pose and the depth by fusion_kernel.dense_candidates,
     projected and tested) and beside it the earlier two: every voxel projected
     (bound_every_voxel_projected_ms) and every voxel read and written once
     (bound_all_ms), the voxels the kernel projected (its column
     intervals, read back from the kernel and held equal to
     fusion_kernel.dense_column_intervals column for column), idle
     shares. Then the checked extraction
     through its graphs (the default on the card: the brick stats' graph
     replayed a live chunk, one chunk graph a budget triple replayed a
     chunk) and eagerly on phase 2's volume and on a 4^3 volume of 16 orbit
     frames:
     triangles, colors, live chunks and hints bit-equal with the default
     budgets and with the first call's hints, the first graphed call's ms
     (its capture), steady ms of each route, idle shares, the graphs' capture
     ms and pool MB, and a one-shot extract_mesh both ways (the CLIs pass
     graph=False).
     Phase 7's 3-frame dense run must launch the dense kernel once a frame,
     and phase 9's dense sharded and single-device frames once a frame a
     rank each. A {"dense_checked": ...} line; the dense kernel's record
     joins the kernels line.

Output: progress on stderr; on stdout the differentiable renders' numbers
{"render_grad": {...}}, the CLI path's {"cli": {...}}, {"refine": {...}},
{"parallel": {...}}, {"brick_sizes": {...}}, {"graphs": {...}},
{"extraction": {...}}, {"dense_checked": {...}}, a line of kernel
records {"kernels": [...]} (each with its launches on every path and its
times at the other brick sizes), the
nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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


def device_kernels(torch, fn):
    """The kernels that fn puts on the card, (name, ms, launches) by
    torch.profiler, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(kern, key=lambda kv: -kv[1])


def device_ms(torch, fn):
    """Kernel time (ms) that fn puts on the card, summed by torch.profiler,
    and the five largest kernels by name."""
    kern = device_kernels(torch, fn)
    return sum(ms for _, ms, _ in kern), [(k[:60], round(ms, 4)) for k, ms, _ in kern[:5]]


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


def fusion_check(torch, fk, vol, rows, pose_inv, depth, rgb_t, n_ok, launches, timer):
    """The fusion kernel against its plain version on one frame's update
    list (rows) of vol, with color, on copies of vol's state: weight,
    nsample and RGB color exact, sdf and M within 1e-5; CUDA-event times of
    both. Returns the kernel's record, with the bound of the voxels the
    frame observes beside the bound of every voxel of its live rows."""
    cfg, B = vol.config, vol.brick_size
    V = B ** 3
    a = state_copy(vol) + [vol.color.clone()]
    b = state_copy(vol) + [vol.color.clone()]
    fk.fuse_bricks(cfg, rows, pose_inv, depth, *a, rgb_t)
    fk.fuse_bricks_plain(cfg, rows, pose_inv, depth, *b, rgb_t)
    for name, x, y in zip(("sdf", "weight", "M", "nsample", "color"), a, b):
        if name in ("weight", "nsample", "color") and not torch.equal(x, y):
            raise AssertionError(f"fusion kernel ({B}^3 bricks): {name} differs from the "
                                 "plain engine")
    if torch.equal(a[4], vol.color):
        raise AssertionError("fusion kernel: the frame changed no color")
    n_obs = int((a[3] - vol.nsample).sum())   # each observed voxel's nsample went up by 1
    err = max(float((a[0] - b[0]).abs().max()), float((a[2] - b[2]).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"fusion kernel ({B}^3 bricks): sdf/M err {err}")
    t_k = timer.ms(lambda: fk.fuse_bricks(cfg, rows, pose_inv, depth, *a, rgb_t), spin=True)
    t_p = timer.ms(lambda: fk.fuse_bricks_plain(cfg, rows, pose_inv, depth, *b, rgb_t),
                   spin=True)
    H, W = cfg.image_height, cfg.image_width
    nc = vol.color.shape[-1]
    # the bound: the observed voxels' state and color read and written once
    # (whether a voxel is observed follows from its projection and the depth
    # image alone, so an unobserved voxel's state need not be read), and
    # every voxel of the live rows projected; beside it the kernel's own
    # traffic, every voxel of every live row read
    obs_bytes = fk.voxel_bytes(n_obs, H, W, nc)
    rows_bytes = fk.bytes_moved(n_ok, H, W, nc, B)
    rec = record("fusion", "cpu_tsdf_tpu_torch/csrc/fusion.cu",
                 "cpu_tsdf_tpu/ops/pallas_fusion.py:363", launches, err, t_k, t_p, obs_bytes,
                 fk.ops_needed(cfg, n_ok * V, n_obs))
    rec["bound_rows_ms"] = rows_bytes / HBM_BYTES_PER_S * 1e3
    log(f"fusion with color ({B}^3 bricks): {n_ok} rows, kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, max err {err}; {n_obs} of {n_ok * V} voxels observed "
        f"({n_obs / (n_ok * V):.4f}): bound {rec['bound_ms']:.5f} ms ({obs_bytes} bytes, "
        f"{rec['bound_by']}); every voxel of the live rows {rec['bound_rows_ms']:.5f} ms "
        f"({rows_bytes} bytes)")
    return rec


def mc_phase(torch, mc, vol, main_launches, timer):
    """Phase 4's MC part (see the module docstring); returns the records of
    the corner-halo and emission kernels."""
    import dataclasses

    B = vol.brick_size
    V = B ** 3
    cand = mc._candidate_slots(vol, 0.5)
    K = int(cand.shape[0])
    count, cube, corners, ntri = mc.corner_halo(vol, cand, 0.5)
    pcount, pcube, pcorners, pntri = mc._corner_halo_plain(vol, cand, 0.5)
    live = torch.arange(V, device=cand.device)[None] < count[:, None]
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
                  t_k, t_p, mc.bytes_moved_corner_halo(K, n_cubes, B), K * V * 64)
    # the former dense contract (every voxel's stack, ok and loc) as a yardstick
    halo["bound_dense_ms"] = mc.bytes_moved_dense_stack(K, B) / HBM_BYTES_PER_S * 1e3
    log(f"corner halo ({B}^3 bricks): {K} candidate bricks, {n_cubes} crossing cubes "
        f"({n_cubes / (K * V):.4f} of their cubes), {int(ntri.sum())} triangles, "
        f"{int((count == 0).sum())} bricks without one; kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms; bound {halo['bound_ms']:.5f} ms "
        f"({mc.bytes_moved_corner_halo(K, n_cubes, B)} bytes), dense-stack bound "
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
        vp, tp = mc._emit_plain(v, cand, count, cube, corners, off, n_tri)
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
    t_p = timer.ms(lambda: mc._emit_plain(vol, cand, count, cube, corners, off, n_tri),
                   spin=True)
    # operations: per triangle 3 vertices of 17 (interpolation) + 18
    # (transform); per cube 8 scalings and 9 for its centre
    emit = record("mc_emit", "cpu_tsdf_tpu_torch/csrc/mc_emit.cu",
                  "cpu_tsdf_tpu/ops/marching_cubes.py:631", main_launches["emit"], err, t_k, t_p,
                  mc.bytes_moved_emit(K, n_cubes, n_tri), n_tri * 105 + n_cubes * 17)
    log(f"emission ({B}^3 bricks): {n_tri} triangles, kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms; bound {emit['bound_ms']:.5f} ms ({mc.bytes_moved_emit(K, n_cubes, n_tri)} bytes)")

    # the emission under a triangle budget of a third of the mesh: the
    # triangles below it stored, equal to the plain version's truncation
    # and to the unbounded emission's first rows
    budget = n_tri // 3
    vk, tk = mc.emit_triangles(vol, cand, count, cube, corners, off, budget)
    vp, tp = mc._emit_plain(vol, cand, count, cube, corners, off, budget)
    full, _ = mc.emit_triangles(vol, cand, count, cube, corners, off, n_tri)
    if not (torch.equal(tk, tp) and torch.equal(vk, full[:budget])):
        raise AssertionError(f"emission kernel under a budget of {budget} triangles differs")
    err_b = float((vk - vp).abs().max())
    if err_b > 1e-6:
        raise AssertionError(f"emission kernel under a budget: vertices differ by {err_b}")
    # the cubes of the bricks whose first triangle lies below the budget
    cubes_b = int(count[:int((off < budget).sum())].sum())
    emit["budget_case"] = record(
        "mc_emit", "cpu_tsdf_tpu_torch/csrc/mc_emit.cu", "cpu_tsdf_tpu/ops/marching_cubes.py:631",
        main_launches["emit"], err_b,
        timer.ms(lambda: mc.emit_triangles(vol, cand, count, cube, corners, off, budget),
                 spin=True),
        timer.ms(lambda: mc._emit_plain(vol, cand, count, cube, corners, off, budget), spin=True),
        mc.bytes_moved_emit(K, cubes_b, budget), budget * 105 + cubes_b * 17)
    emit["budget_case"].update(tri_budget=budget, triangles=n_tri)
    log(f"emission ({B}^3 bricks) under a budget of {budget} of {n_tri} triangles: the stored "
        f"rows equal the plain truncation and the unbounded emission's (max err {err_b}); "
        f"kernel {emit['budget_case']['ms']:.4f} ms, plain {emit['budget_case']['plain_ms']:.4f} "
        f"ms, bound {emit['budget_case']['bound_ms']:.5f} ms")
    return [halo, emit]


def extraction_breakdown(torch, mc, vol, timer) -> dict:
    """The eager checked extraction's steps on vol (chunks of 2048 slots,
    the budgets of a first call's hints), each a median of synchronized runs:
    brick stats + candidates, the corner halo, the rest of the chunk
    programs with the batch's host sync, the whole call with the hints and
    with the default budgets (its retries), the copy to the host."""
    from cpu_tsdf_tpu_torch.activation import _compact

    chunk, C, dev = min(2048, vol.capacity), vol.capacity, vol.device
    soup = mc.extract_soup_bricks(vol, 0.5, True)
    live, hint = soup.live_chunks, soup.budget_hint

    def candidates():
        stats = mc._brick_stats(vol, live, chunk, 0.5)
        out = []
        for s0, (_, kb, _) in zip(live, hint):
            slots = torch.arange(s0, s0 + chunk, dtype=torch.int32, device=dev)
            bidx, _ = _compact(mc._candidate_mask(vol, stats, vol.coords[s0:s0 + chunk]),
                               slots, kb)
            out.append(torch.where(bidx >= 0, bidx, C))
        return out

    cands = candidates()
    res = {"live_chunks": list(live), "budget_hint": [list(h) for h in hint],
           "triangles": int(soup.num_triangles),
           "candidates_ms": timer.ms(candidates),
           "halo_ms": timer.ms(lambda: [mc.corner_halo(vol, c, 0.5) for c in cands]),
           "checked_hinted_ms": timer.ms(lambda: mc.extract_soup_bricks(
               vol, 0.5, True, live_chunks=live, budget_hint=hint, graph=False)),
           "checked_default_ms": timer.ms(lambda: mc.extract_soup_bricks(vol, 0.5, True,
                                                                         graph=False)),
           "to_host_ms": timer.ms(soup.to_numpy)}
    res["rest_ms"] = res["checked_hinted_ms"] - res["candidates_ms"] - res["halo_ms"]
    log(f"extraction breakdown (checked route, live chunks {live}, hints {hint}): brick "
        f"stats + candidates {res['candidates_ms']:.4f} ms; corner halo {res['halo_ms']:.4f} "
        f"ms; scan + emission + colors + the batch's host sync {res['rest_ms']:.4f} ms; the "
        f"call with the hints {res['checked_hinted_ms']:.4f} ms, with the default budgets "
        f"(retries) {res['checked_default_ms']:.4f} ms; copy to host {res['to_host_ms']:.4f} "
        f"ms ({res['triangles']} triangles)")
    return res


def render_phase(torch, cfg, vol, poses, poses_h, timer):
    """Phase 6 (see the module docstring); returns the ray-march kernel's
    record and the differentiable renders' numbers."""
    from cpu_tsdf_tpu_torch import pack_render, render_view
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
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
    busy, top = device_ms(torch, lambda: [render_view(packed, poses[k], colored=True)
                                          for k in range(n_prof)])
    log(f"kernel time over {n_prof} renders: {busy:.4f} ms (torch.profiler); largest: {top}")

    grad = render_grad_phase(torch, cfg, vol, packed, poses[n_poses // 2], timer, t_k)
    return record("raycast", "cpu_tsdf_tpu_torch/csrc/raycast.cu",
                  "cpu_tsdf_tpu/ops/pallas_raycast.py:367", n_launch, max_err, t_k, t_p,
                  nbytes, nops), grad


def render_grad_phase(torch, cfg, vol, packed, pose0, timer, t_march):
    """Phase 6's differentiable renders at full width (see the module
    docstring); returns their numbers."""
    import dataclasses

    from cpu_tsdf_tpu_torch import render_view
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse, rotate_vectors, transform_points
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
    from cpu_tsdf_tpu_torch.ops.interpolate import tsdf_value_vol
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays

    N = cfg.image_width * cfg.image_height
    origins, dirs = (t.contiguous() for t in camera_rays(cfg, pose0))
    ch = rk.march(packed, origins, dirs)
    t_bt, found = ch[0], ch[1] > 0
    half = cfg.zsize / cfg.zres / 2.0

    def points(t):
        return [origins[:, k] + t * dirs[:, k] for k in range(3)]

    # The losses run over the well-conditioned rays: valid, the refined
    # crossing inside its half-cell bracket, the two trilinear samples at
    # least 0.05 apart. Elsewhere the refinement extrapolates or divides by a
    # near-zero difference (reference semantics), and its derivative is
    # unbounded. The view's loss weights the camera-frame points of those
    # rays and the normals of those with a valid normal (weights in
    # [0.5, 1.5), seeded).
    sep = (tsdf_value_vol(packed, *points(t_bt - half))[0]
           - tsdf_value_vol(packed, *points(t_bt))[0]).abs()
    rays = (ch[3] > 0) & (ch[2] >= t_bt - half) & (ch[2] <= t_bt) & (sep > 0.05)
    nrays = rays & (ch[4] > 0)
    gen = torch.Generator(device=pose0.device).manual_seed(0)
    wts = 0.5 + torch.rand((2, N, 3), generator=gen, device=pose0.device)

    def depth_loss(d, valid):
        m = valid.reshape(-1) & rays
        return torch.where(m, d.reshape(-1), 0.0).sum() / m.sum()

    def view_loss(pts, nrm):
        # nansum: at a moved pose some of these rays may miss (the free
        # central difference)
        return (torch.where(rays[:, None], pts.reshape(N, 3) * wts[0], 0.0).nansum()
                + torch.where(nrays[:, None], nrm.reshape(N, 3) * wts[1], 0.0).nansum()
                ) / rays.sum()

    def depth_grads(use_kernel=None):
        sdf = vol.sdf.detach().requires_grad_(True)
        pose = pose0.clone().requires_grad_(True)
        d, valid, _ = rk.render_depth_diff(dataclasses.replace(vol, sdf=sdf), pose,
                                           use_kernel=use_kernel)
        return torch.autograd.grad(depth_loss(d, valid), [sdf, pose])

    def view_grads(use_kernel=None):
        sdf = vol.sdf.detach().requires_grad_(True)
        pose = pose0.clone().requires_grad_(True)
        v = render_view(dataclasses.replace(vol, sdf=sdf), pose, use_kernel=use_kernel)
        return torch.autograd.grad(view_loss(v.points, v.normals), [sdf, pose])

    # central differences in pose z of the same losses: with the brackets
    # held at this pose (the function the backward differentiates: the gate)
    # and free (the render itself: logged, see PERF.md)
    def loss_at(tz, what, frozen):
        pose = pose0.clone()
        pose[2, 3] += tz
        if not frozen:
            if what == "depth":
                return float(depth_loss(*rk.render_depth_diff(vol, pose)[:2]))
            v = render_view(vol, pose)
            return float(view_loss(v.points, v.normals))
        o, r = camera_rays(cfg, pose)
        out = rk.refine_differentiable(packed, o, r, t_bt, found, normals=what == "view")
        t = torch.where(rays, out["t_star"], 1.0)
        inv = rigid_inverse(pose)
        pts = torch.stack(transform_points(inv, *(o[:, k] + t * r[:, k] for k in range(3))), -1)
        if what == "depth":
            return float(depth_loss(pts[:, 2], rays))
        return float(view_loss(pts, torch.stack(rotate_vectors(inv, out["nx"], out["ny"],
                                                               out["nz"]), -1)))

    # the backward's parts: the recomputation from the brackets (2 trilinear
    # queries a ray; with the normals 8) and its autograd backward, which
    # ends in the scatter of each query's 8 corner gradients into the field
    cot = (0.5 + torch.rand((4, N), generator=gen, device=pose0.device)) * found

    def recompute(normals):
        sdf = vol.sdf.detach().requires_grad_(True)
        o, d = (x.detach().requires_grad_(True) for x in (origins, dirs))
        out = rk.refine_differentiable(rk._with_field(vol, sdf), o, d, t_bt, found, normals)
        return torch.autograd.grad(list(out.values()), [sdf, o, d], list(cot[:len(out)]))

    numbers = {}
    eps = 1e-4
    for what, grads_of in (("depth", depth_grads), ("view", view_grads)):
        (gk_sdf, gk_pose), (gp_sdf, gp_pose) = grads_of(True), grads_of(False)
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in ((gk_sdf, gp_sdf), (gk_pose, gp_pose)))
        fd, fd_free = ((loss_at(eps, what, f) - loss_at(-eps, what, f)) / (2 * eps)
                       for f in (True, False))
        g_z = float(gk_pose[2, 3])
        t_total = timer.ms(grads_of)
        t_plain = timer.ms(lambda: grads_of(False), reps=3, warmup=1)
        numbers[what] = dict(
            fwd_bwd_ms=t_total, plain_route_fwd_bwd_ms=t_plain, routes_rel_diff=rel,
            sdf_grad_nonzero=int((gk_sdf != 0).sum()), pose_z_grad=g_z,
            pose_z_central_difference_held=fd, pose_z_central_difference_free=fd_free)
        log(f"{what} render under autograd at full width: forward + backward {t_total:.4f} ms "
            f"(kernel route) / {t_plain:.4f} ms (plain route), CUDA events, launches "
            f"included; loss over {int(rays.sum())} well-conditioned of "
            f"{int((ch[3] > 0).sum())} valid rays ({int(nrays.sum())} with normals); sdf "
            f"gradient {int((gk_sdf != 0).sum())} nonzero; routes differ by {rel:.3g} "
            f"relative; pose z derivative {g_z:.6f}, central difference {fd:.6f} with the "
            f"brackets held, {fd_free:.6f} free")
        if not (torch.isfinite(gk_sdf).all() and torch.isfinite(gk_pose).all()
                and int((gk_sdf != 0).sum()) > 0 and g_z != 0.0):
            raise AssertionError(f"{what} render gradients are not finite and nonzero")
        if rel > 1e-5 or abs(fd - g_z) > 0.25 * max(abs(fd), abs(g_z), 1e-3):
            raise AssertionError(f"{what} render gradients disagree")

    sdf = vol.sdf.detach().requires_grad_(True)
    pose = pose0.clone().requires_grad_(True)
    t_fwd = timer.ms(lambda: render_view(dataclasses.replace(vol, sdf=sdf), pose))
    t_refine = timer.ms(lambda: recompute(False))
    t_normals = timer.ms(lambda: recompute(True))
    # device time by kind: the scatter (the gathers' index backward with
    # its sort), the zero fills of each gather's field-sized gradient and
    # the adds that sum those gradients
    kinds = {"scatter_ms": ("index", "sort"), "fill_ms": ("fill",), "add_ms": ("functor_add",)}
    parts = {}
    for normals in (False, True):
        kern = device_kernels(torch, lambda: recompute(normals))
        parts[normals] = dict(
            busy_ms=sum(ms for _, ms, _ in kern), launches=sum(n for *_, n in kern),
            top=[(k[:150], round(ms, 4)) for k, ms, _ in kern[:6]], **{
                kind: sum(ms for k, ms, _ in kern if any(w in k.lower() for w in words))
                for kind, words in kinds.items()})
    numbers["breakdown"] = dict(
        march_ms=t_march, view_forward_ms=t_fwd, refine_fwd_bwd_ms=t_refine,
        normals_fwd_bwd_ms=t_normals - t_refine, refine_device=parts[False],
        refine_and_normals_device=parts[True])
    log(f"differentiable render breakdown: the march {t_march:.4f} ms (kernel, device); "
        f"render_view forward under autograd {t_fwd:.4f} ms; the backward's recomputation "
        f"with its autograd backward: refinement {t_refine:.4f} ms, normals "
        f"{t_normals - t_refine:.4f} ms more (CUDA events, launches included); device "
        f"time refinement / with normals: busy {parts[False]['busy_ms']:.4f} / "
        f"{parts[True]['busy_ms']:.4f} ms in {parts[False]['launches']} / "
        f"{parts[True]['launches']} kernel launches, scatter into the field (index backward, sort) "
        f"{parts[False]['scatter_ms']:.4f} / {parts[True]['scatter_ms']:.4f} ms, zero "
        f"fills {parts[False]['fill_ms']:.4f} / {parts[True]['fill_ms']:.4f} ms, gradient "
        f"adds {parts[False]['add_ms']:.4f} / {parts[True]['add_ms']:.4f} ms; largest "
        f"with normals: {parts[True]['top']}")
    return numbers


CLI_FRAMES = 20          # phase 7's sparse run; the ray march renders every 8th
CLI_DENSE_FRAMES = 3
CLI_RADIUS = 0.4


def write_pcd_sequence(cfg, dirname, n_frames, radius, seed=11):
    """Phase 7's input: n_frames colored, noisy (1.5 mm, 5 % dropouts)
    organized binary PCDs of a sphere at the world origin, seen from an
    orbit 1 m away, each with its camera-in-world pose as a .txt file."""
    from cpu_tsdf_tpu_torch.io import pcd
    from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

    rng = np.random.default_rng(seed)
    W, H = cfg.image_width, cfg.image_height
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    rgb = pcd.pack_rgb(np.stack([uu % 256, vv % 256, (uu + vv) % 256], -1)
                       .reshape(-1, 3).astype(np.float32))
    os.makedirs(dirname)
    for i in range(n_frames):
        pose = orbit_pose(2.0 * np.pi * i / n_frames)
        z = sphere_depth_world(cfg, pose, radius=radius)
        z = z + rng.normal(0.0, 0.0015, z.shape)
        z = np.where(rng.uniform(size=z.shape) < 0.05, np.nan, z)
        pts = np.stack([(uu - cfg.principal_point_x) / cfg.focal_length_x * z,
                        (vv - cfg.principal_point_y) / cfg.focal_length_y * z, z], -1)
        pts = pts.reshape(-1, 3).astype(np.float32)
        fields = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "rgb": rgb}
        pcd.save_pcd(os.path.join(dirname, f"frame_{i:04d}.pcd"),
                     pcd.PointCloud(fields, W, H), "binary")
        with open(os.path.join(dirname, f"frame_{i:04d}.txt"), "w") as f:
            for row in pose[:3]:
                f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def mc_ran(got: dict, want: dict) -> bool:
    """The launch counts `got` hold `want` for the other kernels, and the
    corner halo and the emission ran once each a chunk program of a checked
    extraction (one or more: a chunk whose budget overflowed runs again)."""
    return ({k: got[k] for k in want} == want
            and got["corner_halo"] == got["emit"] >= 1)


def sphere_error(ply_path, center, radius):
    """Median |distance to center - radius| of a PLY's vertices, and its
    triangle count."""
    from cpu_tsdf_tpu_torch.io.ply import load_ply

    verts, faces, _ = load_ply(ply_path)
    return float(np.median(np.abs(np.linalg.norm(verts - center, axis=1) - radius))), len(faces)


def cli_phase(torch, tmp):
    """Phase 7 (see the module docstring); returns the {"cli": ...} numbers."""
    import logging

    from cpu_tsdf_tpu_torch import cli
    from cpu_tsdf_tpu_torch.config import TSDFConfig
    from cpu_tsdf_tpu_torch.io import poses as pose_io
    from cpu_tsdf_tpu_torch.io.checkpoint import checkpoint_meta, load_any
    from cpu_tsdf_tpu_torch.io.ply import load_ply
    from cpu_tsdf_tpu_torch.log import get_logger
    from cpu_tsdf_tpu_torch.ops import activation_kernel as ak
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk

    def zero():
        torch.cuda.synchronize()
        fk.launches.update(fusion=0, dense_fusion=0)
        rk.launches["raycast"] = 0
        mc.launches.update(corner_halo=0, emit=0)
        ak.launches.update(dict.fromkeys(ak.launches, 0))

    def counts():
        # activation: the fewest launches of its seven kernels
        return {**fk.launches, "raycast": rk.launches["raycast"], **mc.launches,
                "activation": min(ak.launches.values())}

    def mean_ms(key, rows):
        return statistics.fmean(r[key] for r in rows) * 1e3

    # the CLI logs its progress to stdout: send it to stderr here
    for h in get_logger().handlers:
        if isinstance(h, logging.StreamHandler):
            h.setStream(sys.stderr)
    cfg = TSDFConfig()                      # 640x480 at f=525, centre (320, 240)
    seq = os.path.join(tmp, "seq")
    t0 = time.perf_counter()
    write_pcd_sequence(cfg, seq, CLI_FRAMES, CLI_RADIUS)
    log(f"CLI input: {CLI_FRAMES} binary PCDs of {cfg.image_width}x{cfg.image_height} "
        f"points with pose files, written in {time.perf_counter() - t0:.2f} s")
    pose0 = pose_io.load_pose(os.path.join(seq, "frame_0000.txt"))
    center = np.linalg.inv(pose0)[:3, 3]        # the sphere in frame-0 coordinates
    base = ["--in", seq, "--volume-size", "3", "--cell-size", "0.005859375",
            "--fx", str(cfg.focal_length_x), "--fy", str(cfg.focal_length_y),
            "--cx", str(cfg.principal_point_x), "--cy", str(cfg.principal_point_y)]

    # the sparse run: every kernel
    out = os.path.join(tmp, "sparse")
    metrics_path = os.path.join(tmp, "sparse.json")
    zero()
    t0 = time.perf_counter()
    rc = cli.integrate_main(base + ["--out", out, "--sparse", "--color", "--save-tsdf",
                                    "--metrics-json", metrics_path, "--visualize-every", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = {"fusion": CLI_FRAMES, "dense_fusion": 0, "raycast": CLI_FRAMES // 8,
            "activation": CLI_FRAMES}
    log(f"integrate --sparse: rc {rc}, {wall:.3f} s wall; launches {got}")
    if rc != 0 or not mc_ran(got, want):
        raise AssertionError(f"integrate --sparse: rc {rc}, launches {got}, want {want}")
    sparse_launches = got
    npz = os.path.join(out, "volume.npz")
    with np.load(npz) as z:
        overflowed, n_active = bool(z["overflowed"]), int(z["n_active"])
    err, n_tri = sphere_error(os.path.join(out, "mesh.ply"), center, CLI_RADIUS)
    views = sorted(f for f in os.listdir(out) if f.startswith("viz_"))
    log(f"integrate --sparse: {n_active} live bricks, overflowed {overflowed}; {n_tri} "
        f"triangles, median |r - {CLI_RADIUS}| {err * 1e3:.4f} mm; views {views}")
    if overflowed or err >= HALF_CELL_M or n_tri < 1000:
        raise AssertionError("integrate --sparse: overflow, or the mesh is off the sphere")
    if len(views) != 2 * (CLI_FRAMES // 8):
        raise AssertionError(f"integrate --sparse wrote views {views}")
    with open(metrics_path) as f:
        m = json.load(f)
    frames = m["frames"]
    res = {"card": None, "frames": CLI_FRAMES, "wall_s": wall, "total_s": m["total_s"],
           **{f"{k}_ms": mean_ms(f"{k}_s", frames) for k in ("read", "organize", "integrate")},
           "frame_ms": mean_ms("seconds", frames),
           "frame_ms_after_first": mean_ms("seconds", frames[1:]),
           "extract_ms": m["extract_s"] * 1e3, "npz_write_s": m["save_tsdf_s"],
           "npz_bytes": os.path.getsize(npz), "live_bricks": n_active, "triangles": n_tri,
           "median_radius_err_mm": err * 1e3, "launches": sparse_launches}

    # tsdf2mesh on the saved volume: the same triangles, bit for bit
    zero()
    t0 = time.perf_counter()
    rc = cli.tsdf2mesh_main([npz, os.path.join(tmp, "remesh.ply")])
    res["tsdf2mesh_s"] = time.perf_counter() - t0
    v1, f1, _ = load_ply(os.path.join(out, "mesh.ply"))
    v2, f2, _ = load_ply(os.path.join(tmp, "remesh.ply"))
    log(f"tsdf2mesh: rc {rc}, {res['tsdf2mesh_s']:.3f} s wall; {len(f2)} triangles, "
        f"vertices bit-equal {np.array_equal(v1, v2)}; launches {counts()}")
    if rc != 0 or f1.shape != f2.shape or not np.array_equal(v1, v2):
        raise AssertionError("tsdf2mesh does not reproduce the integrate mesh")
    if not mc_ran(counts(), {"fusion": 0, "dense_fusion": 0, "raycast": 0}):
        raise AssertionError(f"tsdf2mesh did not run the MC kernels: {counts()}")
    # and both are the single pass's mesh (the route before the budgeted chunks)
    ref_v, _ = single_pass(torch, mc, load_any(npz, device=torch.device("cuda")), 0.0)
    if not np.array_equal(ref_v.cpu().numpy().reshape(-1, 3), v1):
        raise AssertionError("the CLI's mesh.ply differs from the single pass's mesh")
    log("integrate --sparse: mesh.ply is the single pass's mesh, bit for bit")

    # a sparse run at bricks of 16^3 and its tsdf2mesh: the kernels at
    # another brick size through the CLI (the capacity holds the same voxels)
    out = os.path.join(tmp, "sparse16")
    zero()
    t0 = time.perf_counter()
    rc = cli.integrate_main(base + ["--out", out, "--sparse", "--brick-size", "16",
                                    "--brick-capacity", str(1 << 12), "--color", "--save-tsdf",
                                    "--num-frames", str(CLI_DENSE_FRAMES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = {"fusion": CLI_DENSE_FRAMES, "dense_fusion": 0, "raycast": 0,
            "activation": CLI_DENSE_FRAMES}
    npz = os.path.join(out, "volume.npz")
    with np.load(npz) as z:
        overflowed = bool(z["overflowed"])
    brick = checkpoint_meta(npz)["brick_size"]
    err, n_tri = sphere_error(os.path.join(out, "mesh.ply"), center, CLI_RADIUS)
    zero()
    rc2 = cli.tsdf2mesh_main([npz, os.path.join(tmp, "remesh16.ply")])
    got2 = counts()
    v1, f1, _ = load_ply(os.path.join(out, "mesh.ply"))
    v2, f2, _ = load_ply(os.path.join(tmp, "remesh16.ply"))
    res.update(brick16_frames=CLI_DENSE_FRAMES, brick16_wall_s=wall, brick16_triangles=n_tri,
               brick16_median_radius_err_mm=err * 1e3, brick16_launches=got,
               brick16_tsdf2mesh_launches=got2)
    log(f"integrate --sparse --brick-size 16 ({CLI_DENSE_FRAMES} frames): rc {rc}, "
        f"{wall:.3f} s wall; brick size in the npz {brick}, overflowed {overflowed}; {n_tri} "
        f"triangles, median |r - {CLI_RADIUS}| {err * 1e3:.4f} mm; launches {got}; "
        f"tsdf2mesh rc {rc2}, vertices bit-equal {np.array_equal(v1, v2)}, launches {got2}")
    if rc != 0 or not mc_ran(got, want) or brick != 16 or overflowed:
        raise AssertionError(f"integrate --brick-size 16: rc {rc}, launches {got}, want {want}")
    if err >= HALF_CELL_M or n_tri < 1000:
        raise AssertionError("integrate --brick-size 16: the mesh is off the sphere")
    if rc2 != 0 or f1.shape != f2.shape or not np.array_equal(v1, v2) or \
            not mc_ran(got2, {"fusion": 0, "dense_fusion": 0, "raycast": 0}):
        raise AssertionError(f"tsdf2mesh of the 16^3 volume: rc {rc2}, launches {got2}")

    # a dense run: the MC kernels through from_dense
    out = os.path.join(tmp, "dense")
    metrics_path = os.path.join(tmp, "dense.json")
    zero()
    t0 = time.perf_counter()
    rc = cli.integrate_main(base + ["--out", out, "--num-frames", str(CLI_DENSE_FRAMES),
                                    "--metrics-json", metrics_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    err, n_tri = sphere_error(os.path.join(out, "mesh.ply"), center, CLI_RADIUS)
    with open(metrics_path) as f:
        m = json.load(f)
    res.update(dense_frames=CLI_DENSE_FRAMES, dense_wall_s=wall, dense_launches=got,
               dense_integrate_ms=mean_ms("integrate_s", m["frames"]),
               dense_extract_ms=m["extract_s"] * 1e3, dense_triangles=n_tri,
               dense_median_radius_err_mm=err * 1e3)
    log(f"integrate (dense, {CLI_DENSE_FRAMES} frames): rc {rc}, {wall:.3f} s wall; "
        f"integrate {res['dense_integrate_ms']:.2f} ms a frame, extraction "
        f"{res['dense_extract_ms']:.2f} ms; {n_tri} triangles, median |r - {CLI_RADIUS}| "
        f"{err * 1e3:.4f} mm; launches {got}")
    # one dense fusion kernel launch a frame
    if rc != 0 or not mc_ran(got, {"fusion": 0, "dense_fusion": CLI_DENSE_FRAMES,
                                   "raycast": 0}):
        raise AssertionError(f"dense integrate: rc {rc}, launches {got}")
    if err >= HALF_CELL_M or n_tri < 1000:
        raise AssertionError("dense integrate: the mesh is off the sphere")

    # get-intrinsics on frame 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.get_intrinsics_main([os.path.join(seq, "frame_0000.pcd")])
    fx = float(next(ln for ln in buf.getvalue().splitlines() if ln.startswith("fx:")).split()[1])
    res["get_intrinsics_fx"] = fx
    log(f"get-intrinsics: rc {rc}, fx {fx:.6f} (true {cfg.focal_length_x})")
    if rc != 0 or abs(fx - cfg.focal_length_x) >= 0.5:
        raise AssertionError("get-intrinsics did not recover fx")
    log(f"CLI path: {json.dumps(res)}")
    return res


def launch_floor_ms(torch, timer, n: int) -> float:
    """Device ms of n launches that do almost nothing, replayed from one
    CUDA graph and timed as a route's graph is: the floor of a route of n
    kernels. Each launch is csrc/trace.cu's one-thread stamp into a scratch
    ring."""
    import ctypes

    from cpu_tsdf_tpu_torch._build import check, function, stream_ptr

    stamp = function("trace", "tsdf_trace_stamp",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p])
    dev = torch.device("cuda")
    ring = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    head = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            for _ in range(n):
                check(stamp(ring.data_ptr(), head.data_ptr(), n, 0, stream_ptr(dev)), "stamp")
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return timer.ms(graph.replay, spin=True)


def ptxas_usage(torch_build, name: str) -> dict:
    """Registers and spill bytes of each kernel of csrc/<name>.cu, from the
    build's ptxas -v output: {kernel: [registers, spill stores + loads]}."""
    out, kernel = {}, None
    for line in torch_build.build_log(name).splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?_kernel)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out[kernel] = [None, int(m.group(1)) + int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel][0] = int(m.group(1))
    return out


def activation_check(torch, vol, depth, pose_inv, budget, launches, timer):
    """The activation stage of one frame (depth mips, the band list, the
    carve list: frame_update_list's half before allocation) through
    csrc/activation.cu and through the plain code, at vol's shapes: every
    list and count bit-equal. Each route is captured in a CUDA graph, as
    the frame's graph runs it, and its replays timed by CUDA events (L2
    flushed, ~1 ms spin). The bound: the depth image, the brick coords and
    the tables read once and the lists written once over 3.35 TB/s, beside
    the floor of the route's seven launches, measured here by
    launch_floor_ms."""
    from cpu_tsdf_tpu_torch import _build
    from cpu_tsdf_tpu_torch import activation as ta
    from cpu_tsdf_tpu_torch.bricks import frame_budgets

    cfg, B = vol.config, vol.brick_size
    nb, carve_budget = vol.bricks_per_axis, frame_budgets(vol, budget)[1]

    def stage(kernel):
        mips = ta.depth_mips(depth, ta.mip_base_level(cfg, B), kernel=kernel)
        band = ta.band_candidate_bricks(cfg, B, nb, mips, pose_inv, budget, kernel=kernel)
        return band + ta.carve_slots(cfg, B, mips, pose_inv, vol.coords, carve_budget,
                                     kernel=kernel)

    outs = [stage(k) for k in (True, False)]
    for name, a, b in zip(("cand", "counts", "overflow", "carve", "n_carve"), *outs):
        if not torch.equal(a, b):
            raise AssertionError(f"activation kernels ({B}^3 bricks): {name} differs from "
                                 "the plain code")
    times = []
    for kernel in (True, False):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            stage(kernel)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            stage(kernel)
        times.append(timer.ms(graph.replay, spin=True))
        del graph
    n_band, n_carve = int(outs[0][1][0]), int(outs[0][4])
    L = ta.depth_mips(depth, ta.mip_base_level(cfg, B)).flat_min.numel()
    H, W = depth.shape
    nbytes = (H * W * 4 + vol.coords.numel() * 4 + 4 * L * 4 * 2
              + (budget + carve_budget) * 4)
    rec = record("activation", "cpu_tsdf_tpu_torch/csrc/activation.cu", None, launches, 0.0,
                 times[0], times[1], nbytes, 0)
    rec["launch_floor_ms"] = launch_floor_ms(torch, timer, 7)
    rec["ptxas"] = ptxas_usage(_build, "activation")
    log(f"activation ({B}^3 bricks): band {n_band}, carve {n_carve}, lists bit-equal; "
        f"graphed stage: kernels {times[0]:.4f} ms, plain {times[1]:.4f} ms; bound "
        f"{rec['bound_ms']:.5f} ms ({nbytes} bytes), launch floor "
        f"{rec['launch_floor_ms']:.4f} ms; ptxas {rec['ptxas']}")
    return rec


# Phase 10: brick size -> (capacity, update budget). The capacity holds at
# least the main path's 2^24 voxels (2^15 rows of 8^3); at 32^3 twice that,
# since a sphere's band takes about 410 of those bricks (a 128^3 rehearsal
# at the same brick width in meters). The budget bounds a frame's band
# rows, and an eighth of it (at least 256) its carve rows: at 16^3 and
# 32^3 it is the capacity, since 1024 rows overflowed at 16^3.
BRICK_SIZES = {4: (1 << 18, 1 << 15), 16: (1 << 12, 1 << 12), 32: (1 << 10, 1 << 10)}
BRICK_FRAMES = 16        # every third pose of the 48-pose orbit


def brick_size_phase(torch, cfg, B, poses, depths, rgb, poses_h, timer):
    """Phase 10 for bricks of B^3 (see the module docstring); returns its
    numbers, with each kernel's record against its plain version."""
    from cpu_tsdf_tpu_torch import bricks, make_brick_volume, pack_render, render_view
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.ops import activation_kernel as ak
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays
    from cpu_tsdf_tpu_torch.synthetic import sphere_depth_world

    capacity, budget = BRICK_SIZES[B]
    step = len(poses) // BRICK_FRAMES
    frames = list(range(0, len(poses), step))[:BRICK_FRAMES]
    vol = make_brick_volume(cfg, B, capacity, device=poses.device)
    torch.cuda.synchronize()
    fk.launches["fusion"] = rk.launches["raycast"] = 0
    mc.launches.update(corner_halo=0, emit=0)
    ak.launches.update(dict.fromkeys(ak.launches, 0))
    t0 = time.perf_counter()
    for i in frames:
        bricks.integrate_bricks(vol, depths[i], poses[i], rgb, budget)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, _ = mc.extract_mesh(vol, min_weight=0.5, color_by_rgb=True)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = pack_render(vol)
    views = [render_view(packed, poses[i], colored=True) for i in frames]
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    launches = {"fusion": fk.launches["fusion"], **mc.launches, "raycast": rk.launches["raycast"],
                "activation": min(ak.launches.values())}
    n_live = int(vol.n_active)
    radius_err = float(np.median(np.abs(np.linalg.norm(verts, axis=1) - 0.5)))
    truth = sphere_depth_world(cfg, poses_h[frames[len(frames) // 2]], radius=0.5)
    d = views[len(frames) // 2].depth.cpu().numpy()
    both = ~np.isnan(d) & ~np.isnan(truth)
    depth_err = float(np.median(np.abs(d[both] - truth[both])))
    res = {"brick": B, "capacity": capacity, "update_budget": budget, "frames": len(frames),
           "frames_per_s": len(frames) / t_fuse, "live_bricks": n_live,
           "overflowed": bool(vol.overflowed), "triangles": len(faces),
           "extract_ms_first": t_mesh * 1e3, "median_radius_err_mm": radius_err * 1e3,
           "renders_per_s": len(frames) / t_render, "render_median_depth_err_mm": depth_err * 1e3,
           "launches": launches}
    log(f"bricks of {B}^3: {len(frames)} frames in {t_fuse:.3f} s = "
        f"{res['frames_per_s']:.2f} frames/s (capacity {capacity}, budget {budget}); live "
        f"bricks {n_live}; overflowed {res['overflowed']}; {len(faces)} triangles, "
        f"extraction {t_mesh * 1e3:.2f} ms (first call, host clock, with the copy to the "
        f"host); median |r-0.5| {radius_err * 1e3:.4f} mm; {len(frames)} colored renders in "
        f"{t_render:.4f} s = {res['renders_per_s']:.2f} renders/s (one pack_render "
        f"included), median depth error {depth_err * 1e3:.4f} mm; launches {launches}")
    if res["overflowed"]:
        raise AssertionError(f"bricks of {B}^3: the volume or a budget overflowed")
    if len(faces) < 1000 or not np.isfinite(verts).all() or radius_err >= HALF_CELL_M:
        raise AssertionError(f"bricks of {B}^3: bad mesh ({len(faces)} triangles, median "
                             f"radius error {radius_err})")
    if depth_err >= HALF_CELL_M:
        raise AssertionError(f"bricks of {B}^3: rendered depth off the sphere ({depth_err})")
    want = {"fusion": len(frames), "raycast": len(frames), "activation": len(frames)}
    if not mc_ran(launches, want):
        raise AssertionError(f"bricks of {B}^3: launches {launches}, want {want}")
    res["extract_ms"] = timer.ms(lambda: mc.extract_mesh(vol, 0.5, color_by_rgb=True))

    # each kernel against its plain version at this brick size
    i_mid = frames[len(frames) // 2]
    pose_inv = rigid_inverse(poses[i_mid])
    bx, by, bz, ok, slots, _ = bricks.frame_update_list(shadow(vol), depths[i_mid], pose_inv,
                                                        budget)
    rows = torch.stack([bx, by, bz, torch.where(ok, slots, -1)], 1).to(torch.int32).contiguous()
    res["kernels"] = [fusion_check(torch, fk, vol, rows, pose_inv, depths[i_mid],
                                   torch.trunc(rgb).contiguous(), int(ok.sum()),
                                   launches["fusion"], timer)]
    res["kernels"] += mc_phase(torch, mc, vol, launches, timer)
    res["kernels"].append(activation_check(torch, vol, depths[i_mid], pose_inv, budget,
                                           launches["activation"], timer))
    origins, dirs = (t.contiguous() for t in camera_rays(cfg, poses[i_mid]))
    k = rk.march(packed, origins, dirs)
    p = rk.march_plain(packed, origins, dirs)
    if not torch.equal(k, p):
        raise AssertionError(f"bricks of {B}^3: ray-march kernel differs from its plain version")
    nbytes, nops = rk.march_work(packed, origins, dirs)
    res["kernels"].append(record(
        "raycast", "cpu_tsdf_tpu_torch/csrc/raycast.cu", "cpu_tsdf_tpu/ops/pallas_raycast.py:367",
        launches["raycast"], 0.0, timer.ms(lambda: rk.march(packed, origins, dirs), spin=True),
        timer.ms(lambda: rk.march_plain(packed, origins, dirs), reps=3, warmup=1, spin=True),
        nbytes, nops))
    log(f"bricks of {B}^3: ray march bit-equal to its plain version, kernel "
        f"{res['kernels'][-1]['ms']:.4f} ms; kernel records {json.dumps(res['kernels'])}")
    return res


# the translation of tests/test_refine.py's twist (~3.4 cm), the refine
# phase's perturbation of the true pose
REFINE_SHIFT = (0.024, -0.018, 0.015)
REFINE_ITERS = 10


def refine_phase(torch, cfg, vol, pose_h):
    """Phase 8 (see the module docstring); returns the {"refine": ...}
    numbers."""
    from cpu_tsdf_tpu_torch import refine
    from cpu_tsdf_tpu_torch.refine import _compose, exp_se3, refine_pose, refine_pose_step
    from cpu_tsdf_tpu_torch.synthetic import sphere_depth_world

    dev = vol.device
    depth = torch.as_tensor(sphere_depth_world(cfg, pose_h, radius=0.5), device=dev)
    pose = torch.as_tensor(pose_h, device=dev)
    bad = _compose(exp_se3(torch.tensor((*REFINE_SHIFT, 0.0, 0.0, 0.0), device=dev)), pose)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, losses = refine_pose(vol, bad, depth, iters=REFINE_ITERS, downsample_by=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = host_ms(torch, lambda: refine_pose_step(vol, bad, depth, 2), 5)
    J, r0, _ = refine._jacobian(vol, bad, depth, 2)
    one = torch.full((), 1.0, device=dev)
    parts = {"residual_ms": host_ms(torch, lambda: refine._alignment_residuals(
                 vol, bad, depth, 2), 5),
             "jacobian_ms": host_ms(torch, lambda: refine._jacobian(vol, bad, depth, 2), 5),
             "solve_ms": host_ms(torch, lambda: refine._damped_step(J, r0, one), 5)}
    busy, top = device_ms(torch, lambda: refine_pose_step(vol, bad, depth, 2))
    err0 = float(torch.linalg.vector_norm(bad[:3, 3] - pose[:3, 3]))
    err1 = float(torch.linalg.vector_norm(refined[:3, 3] - pose[:3, 3]))
    rot = float((refined[:3, :3] - pose[:3, :3]).abs().max())
    step_s = step_ms / 1e3
    res = {"card": None, "points": (cfg.image_height // 2) * (cfg.image_width // 2),
           "iters": REFINE_ITERS, "loss_before": losses[0], "loss_after": losses[-1],
           "losses": losses, "translation_err_before_m": err0, "translation_err_after_m": err1,
           "rotation_err_max": rot, "refine_pose_s": wall, "step_ms": step_s * 1e3,
           "steps_per_s": 1.0 / step_s, **parts, "step_device_ms": busy}
    log(f"refine: {res['points']} points ({cfg.image_width}x{cfg.image_height} at downsample "
        f"2), {REFINE_ITERS} iterations in {wall:.3f} s; loss {losses[0]:.6g} -> {losses[-1]:.6g} "
        f"({losses[0] / max(losses[-1], 1e-30):.2f}x); translation error {err0 * 1e3:.3f} -> "
        f"{err1 * 1e3:.3f} mm; rotation max |dR| {rot:.3g}; refine_pose_step median "
        f"{step_s * 1e3:.3f} ms = {1.0 / step_s:.2f} steps/s (host clock, synchronized): "
        f"residual {parts['residual_ms']:.3f} ms, residual + Jacobian {parts['jacobian_ms']:.3f} "
        f"ms, normal equations + solve {parts['solve_ms']:.3f} ms; device busy {busy:.3f} ms "
        f"of a step (torch.profiler; largest {top})")
    if not (losses[-1] * 2.0 <= losses[0] and err1 < err0):
        raise AssertionError("refine did not halve the loss and lower the translation error")
    return res


PAR = {"ranks": 2, "frames": 8, "capacity": 1 << 14, "budget": 1 << 12, "dense_frames": 3,
       "render_poses": (0, 2, 4, 6), "orbit": 48, "timeout_s": 600}


def views_differ(torch, a, b) -> dict:
    """Pixels whose depth, normals or rgb differ between two colored renders
    (NaN equal to NaN)."""
    out = {}
    for name in ("depth", "normals", "rgb"):
        x, y = getattr(a, name), getattr(b, name)
        out[name] = int((~((x == y) | (torch.isnan(x) & torch.isnan(y)))).sum())
    return out


def bricks_differ(torch, a, b):
    """Holds a merged sharded brick volume against a single-device one
    brick by brick (their slot numbers differ): the same bricks, coords,
    weight, nsample and color exact, sdf and M within 1e-5. Returns the
    largest sdf/M difference and the brick count."""
    ma, mb = a.brick_map.reshape(-1), b.brick_map.reshape(-1)
    if not torch.equal(ma >= 0, mb >= 0):
        raise AssertionError("merged volume: another brick set than one device's")
    sel = ma >= 0
    ra, rb = ma[sel].long(), mb[sel].long()
    n = int(sel.sum())
    if int((a.coords[:, 0] >= 0).sum()) != n or int(a.n_active) != int(b.n_active):
        raise AssertionError("merged volume: live rows or n_active differ")
    for name in ("coords", "weight", "nsample", "color"):
        if not torch.equal(getattr(a, name)[ra], getattr(b, name)[rb]):
            raise AssertionError(f"merged volume: {name} differs from one device's")
    err = max(float((a.sdf[ra] - b.sdf[rb]).abs().max()), float((a.M[ra] - b.M[rb]).abs().max()))
    if err > 1e-5 or bool(a.overflowed) or bool(b.overflowed):
        raise AssertionError(f"merged volume: sdf/M differ by {err}, or a volume overflowed")
    return err, n


def parallel_rank(rank: int, port: int, out_dir: str, spec: dict) -> None:
    """One rank of phase 9: the sharded paths against the single-device
    ones on this rank's device; writes rank<r>.json."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from cpu_tsdf_tpu_torch import (TSDFConfig, integrate, integrate_bricks,
                                    make_brick_volume, make_volume, pack_render, render_view)
    from cpu_tsdf_tpu_torch.ops import activation_kernel as ak
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
    from cpu_tsdf_tpu_torch.parallel import (integrate_sharded, render_view_pallas_sharded,
                                             render_view_sharded, shard_volume)
    from cpu_tsdf_tpu_torch.parallel.bricks import (integrate_bricks_sharded,
                                                    make_sharded_brick_volume, merge_sharded)
    from cpu_tsdf_tpu_torch.parallel.distributed import initialize, make_mesh
    from cpu_tsdf_tpu_torch.parallel.raycast import render_view_volume_sharded

    dev = torch.device(spec["device"])
    initialize(f"127.0.0.1:{port}", spec["ranks"], rank, device=dev)
    mesh = make_mesh(dev)
    cfg = TSDFConfig.from_json(spec["cfg"])
    n = spec["frames"]
    poses_h, depths_h, rgb_h = orbit(cfg, spec["orbit"])
    poses = torch.as_tensor(poses_h[:n], device=dev)
    depths = torch.as_tensor(depths_h[:n], device=dev)
    rgb = torch.as_tensor(rgb_h, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    res = {"rank": rank, "backend": dist.get_backend(),
           "device": str(dev) if dev.type == "cpu" else
           f"cuda:{torch.cuda.current_device()} {torch.cuda.get_device_name()}"}

    # ---- 1. the slab-sharded brick integrate, merged, against one device ----
    sb = make_sharded_brick_volume(cfg, mesh, 8, spec["capacity"], device=dev)
    fk.launches["fusion"] = 0
    ak.launches.update(dict.fromkeys(ak.launches, 0))
    frame_ms = [timed(lambda: integrate_bricks_sharded(sb, depths[i], poses[i], mesh,
                                                       spec["budget"], rgb))[1]
                for i in range(n)]
    res["fusion_launches"] = fk.launches["fusion"]
    res["activation_launches"] = dict(ak.launches)
    merged, res["merge_ms"] = timed(lambda: merge_sharded(sb))
    single = make_brick_volume(cfg, 8, sb.capacity, device=dev)
    for i in range(n):
        integrate_bricks(single, depths[i], poses[i], rgb, spec["budget"])
    res["bricks_err"], res["bricks"] = bricks_differ(torch, merged, single)
    res.update(frame_ms=frame_ms, local_bricks=int(sb.n_active),
               local_capacity=sb.capacity_per_device)
    per_call = int(dev.type == "cuda")     # CPU tensors take the plain versions, uncounted
    if res["fusion_launches"] != n * per_call:
        raise AssertionError(f"rank {rank}: fusion ran {res['fusion_launches']} times in {n} frames")
    if set(res["activation_launches"].values()) != {n * per_call}:
        raise AssertionError(f"rank {rank}: the activation kernels ran "
                             f"{res['activation_launches']} times in {n} frames")

    # the merged volume meshes like one device's (its slot gaps included)
    mc.launches.update(corner_halo=0, emit=0)
    (vm, fm, _), res["mesh_ms"] = timed(lambda: mc.extract_mesh(merged, min_weight=0.5))
    res["mc_launches"] = dict(mc.launches)
    vs, fs, _ = mc.extract_mesh(single, min_weight=0.5)
    if fm.shape != fs.shape or not np.array_equal(np.sort(vm.reshape(-1)), np.sort(vs.reshape(-1))):
        raise AssertionError(f"rank {rank}: the merged volume's mesh differs from one device's")
    res["triangles"] = len(fm)
    halo, emit = res["mc_launches"]["corner_halo"], res["mc_launches"]["emit"]
    if halo != emit or (halo >= 1) != bool(per_call):   # once each a chunk program
        raise AssertionError(f"rank {rank}: MC launches {res['mc_launches']}")

    # ---- 2. the three sharded renders against the single-device kernel render
    packed = pack_render(merged)
    renders = {"ray_sharded": lambda p: render_view_sharded(packed, p, mesh, colored=True),
               "tile_sharded": lambda p: render_view_pallas_sharded(merged, p, mesh,
                                                                    colored=True, pack=packed),
               "volume_sharded": lambda p: render_view_volume_sharded(sb, p, mesh,
                                                                      colored=True)[0]}
    res["render_ms"] = {k: [] for k in renders}
    res["raycast_launches"] = {k: 0 for k in renders}
    for i in spec["render_poses"]:
        ref = render_view(packed, poses[i], colored=True)
        for name, fn in renders.items():
            rk.launches["raycast"] = 0
            view, ms = timed(lambda: fn(poses[i]))
            res["raycast_launches"][name] += rk.launches["raycast"]
            res["render_ms"][name].append(ms)
            diff = views_differ(torch, view, ref)
            if any(diff.values()):
                raise AssertionError(f"rank {rank}: {name} render of pose {i} differs from "
                                     f"the single-device render: {diff}")
        res["valid_pixels"] = int((~torch.isnan(ref.depth)).sum())
    # one launch a render a rank; the volume-sharded relay one a ray segment
    # a rank holds: between one and the slab count a render
    for name, count in res["raycast_launches"].items():
        lo = len(spec["render_poses"]) * per_call
        hi = lo * (spec["ranks"] if name == "volume_sharded" else 1)
        if not lo <= count <= hi:
            raise AssertionError(f"rank {rank}: {name} launched the march {count} times")
    del merged, single, packed, sb

    # ---- 3. the dense slab-sharded integrate against one device ----
    sv = shard_volume(make_volume(cfg, device=dev), mesh)
    whole = make_volume(cfg, device=dev)
    res["dense_frame_ms"] = []
    res["dense_launches"] = {"sharded": 0, "single": 0}
    for i in range(spec["dense_frames"]):
        before = fk.launches["dense_fusion"]
        sv, ms = timed(lambda: integrate_sharded(sv, depths[i], poses[i], rgb))
        res["dense_launches"]["sharded"] += fk.launches["dense_fusion"] - before
        res["dense_frame_ms"].append(ms)
        before = fk.launches["dense_fusion"]
        whole = integrate(whole, depths[i], poses[i], rgb)
        res["dense_launches"]["single"] += fk.launches["dense_fusion"] - before
    x0, nx = sv.x0, sv.local.sdf.shape[0]
    for name in ("sdf", "weight", "M", "nsample", "color"):
        if not torch.equal(getattr(sv.local, name), getattr(whole, name)[x0:x0 + nx]):
            raise AssertionError(f"rank {rank}: dense slab {name} differs from one device's")
    res["dense_observed"] = int((sv.local.weight > 0).sum())
    # one dense fusion kernel launch a frame on each route
    want = {"sharded": spec["dense_frames"] * per_call, "single": spec["dense_frames"] * per_call}
    if res["dense_launches"] != want:
        raise AssertionError(f"rank {rank}: dense fusion launches {res['dense_launches']}, "
                             f"want {want}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def parallel_phase(torch, cfg, spec=None):
    """Phase 9 (see the module docstring): spawns the ranks, waits for them
    (a rank that fails or outlives the deadline fails the phase); returns
    the {"parallel": ...} numbers."""
    import socket

    import torch.multiprocessing as mp

    spec = {**PAR, "device": "cuda", "cfg": cfg.to_json(), **(spec or {})}
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(parallel_rank, args=(port, tmp, spec), nprocs=spec["ranks"],
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + spec["timeout_s"]
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"parallel phase: ranks still running after "
                                         f"{spec['timeout_s']} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(spec["ranks"]):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    med = statistics.median
    res = {"card": None, "ranks": spec["ranks"], "cards": torch.cuda.device_count()
           if spec["device"] == "cuda" else 0,
           "layout": f"{spec['ranks']} ranks on 1 card", "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks], "frames": spec["frames"],
           "wall_s": wall, "bricks": ranks[0]["bricks"],
           "local_bricks": [r["local_bricks"] for r in ranks],
           "bricks_max_sdf_m_err": max(r["bricks_err"] for r in ranks),
           "frame_ms_median": med([med(r["frame_ms"]) for r in ranks]),
           "frame_ms_per_rank": [r["frame_ms"] for r in ranks],
           "merge_ms": [r["merge_ms"] for r in ranks],
           "render_ms_median": {k: med([med(r["render_ms"][k]) for r in ranks])
                                for k in ranks[0]["render_ms"]},
           "dense_frame_ms": [r["dense_frame_ms"] for r in ranks],
           "triangles": ranks[0]["triangles"], "mesh_ms": [r["mesh_ms"] for r in ranks],
           "launches_per_rank": {"fusion": [r["fusion_launches"] for r in ranks],
                                 "activation": [min(r["activation_launches"].values())
                                                for r in ranks],
                                 **{f"dense_fusion_{k}": [r["dense_launches"][k] for r in ranks]
                                    for k in ranks[0]["dense_launches"]},
                                 **{k: [r["mc_launches"][k] for r in ranks]
                                    for k in ranks[0]["mc_launches"]},
                                 **{f"raycast_{k}": [r["raycast_launches"][k] for r in ranks]
                                    for k in ranks[0]["raycast_launches"]}},
           "valid_pixels": ranks[0]["valid_pixels"]}
    log(f"parallel: {res['layout']}, backend {res['backend']} (both ranks share one card: "
        f"{res['devices']}); {spec['frames']} colored frames sharded: {res['bricks']} bricks "
        f"({res['local_bricks']} a rank), equal to one device's (sdf/M err "
        f"{res['bricks_max_sdf_m_err']}); frame {res['frame_ms_median']:.3f} ms (median, host "
        f"clock, 2 ranks on 1 card), merge {res['merge_ms']} ms; the three sharded renders "
        f"equal to the single-device kernel render, ms {res['render_ms_median']}; dense "
        f"{spec['dense_frames']} frames equal, ms {res['dense_frame_ms']}; launches per rank "
        f"{res['launches_per_rank']}; {wall:.1f} s wall")
    return res


# Phase 11: the orbit frames fused at the other brick sizes (phase 10's
# capacity and budget) and with the jitter
GRAPH_FRAMES = 6
GRAPH_STATE = ("sdf", "weight", "M", "nsample", "color", "brick_map", "coords", "n_active",
               "overflowed")


def assert_states_equal(torch, a, b, what: str) -> None:
    """Every state tensor of two brick volumes bit-equal (NaN where NaN)."""
    for name in GRAPH_STATE:
        x, y = getattr(a, name), getattr(b, name)
        if x.is_floating_point():
            same = torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                      y.nan_to_num())
        else:
            same = torch.equal(x, y)
        if not same:
            raise AssertionError(f"{what}: {name} differs")


def fuse_routes(torch, cfg, B, capacity, budget, poses, depths, rgb, frames):
    """The frames fused by graphed per-frame calls, by eager ones (the
    default route against graph=False) and by a graphed and an eager
    integrate_bricks_sequence, into four new volumes; the four states
    bit-equal (with the jitter: graphed against eager per route); then the
    graphed sequence once more on its volume, its graph captured. Returns
    the host ms a frame of each route (per-frame calls: all but the first,
    which captures a graph, with the first apart; sequences: all frames,
    and again steady), and the volumes."""
    from cpu_tsdf_tpu_torch import bricks, make_brick_volume

    vols = {k: make_brick_volume(cfg, B, capacity, device=poses.device)
            for k in ("graph", "eager", "seq_graph", "seq_eager")}
    ms = {}
    for route, flag in (("graph", None), ("eager", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bricks.integrate_bricks(vols[route], depths[frames[0]], poses[frames[0]], rgb, budget,
                                graph=flag)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in frames[1:]:
            bricks.integrate_bricks(vols[route], depths[i], poses[i], rgb, budget, graph=flag)
        torch.cuda.synchronize()
        ms[route + "_first"] = (t1 - t0) * 1e3
        ms[route] = (time.perf_counter() - t1) * 1e3 / (len(frames) - 1)
    idx = torch.as_tensor(frames, device=poses.device)
    rgbs = rgb.expand(len(frames), *rgb.shape)
    for route, flag in (("seq_graph", None), ("seq_eager", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bricks.integrate_bricks_sequence(vols[route], depths[idx], poses[idx], rgbs, budget,
                                         graph=flag)
        torch.cuda.synchronize()
        ms[route] = (time.perf_counter() - t0) * 1e3 / len(frames)
    what = f"{len(frames)} frames at {B}^3, {cfg.num_random_splits} split(s)"
    assert_states_equal(torch, vols["graph"], vols["eager"], f"{what}: graphed frames")
    assert_states_equal(torch, vols["seq_graph"], vols["seq_eager"], f"{what}: graphed sequence")
    if cfg.num_random_splits == 1:
        assert_states_equal(torch, vols["seq_graph"], vols["graph"], f"{what}: sequence")
    if bool(vols["graph"].overflowed) or int(vols["graph"].n_active) < 100:
        raise AssertionError(f"{what}: overflowed or nearly empty")
    # the graphed sequence again, its graph captured (the volume moves on)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bricks.integrate_bricks_sequence(vols["seq_graph"], depths[idx], poses[idx], rgbs, budget)
    torch.cuda.synchronize()
    ms["seq_graph_steady"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    return ms, vols


def idle_share(torch, fn) -> dict:
    """fn's calls into the port measured by its tracing
    (cpu_tsdf_tpu_torch/tracing.py), after one run of fn that captures
    their graphs with the stages' stamps: the run's wall ms (host clock,
    ending in a synchronize), the device ms from the first call's begin to
    the last call's end (window_ms), the share of it the card waited
    between calls (idle_share), and the device ms inside the calls outside
    their stages, by host span."""
    from cpu_tsdf_tpu_torch import tracing

    tracing.enable()
    try:
        fn()
        torch.cuda.synchronize()
        tracing.reset()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        calls = tracing.report()["calls"]
    finally:
        tracing.disable()
    return {"wall_ms": wall, "window_ms": calls["window_ms"], "idle_share": calls["idle_share"],
            "inside_ms": calls["inside_ms"], "gaps_ms": calls["gaps_ms"]}


def traced_pass_and_renders(torch, vol, packed, poses, depths, rgb, budget: int,
                            n_renders: int = 100) -> dict:
    """One graphed pass of the orbit (integrate_bricks_sequence) and
    n_renders graphed renders of `packed` with tracing on, under
    torch.cuda.set_sync_debug_mode("error") (their graphs captured with
    the stages' stamps before it): every frame and render stamps each of
    its stages. Returns the tracing report's stages, calls and spans."""
    from cpu_tsdf_tpu_torch import bricks, render_view, tracing

    n = len(poses)
    rgbs = rgb.expand(n, *rgb.shape)
    tracing.enable()
    try:
        bricks.integrate_bricks_sequence(vol, depths[:1], poses[:1], rgbs[:1], budget)
        render_view(packed, poses[0], colored=True)
        torch.cuda.synchronize()
        tracing.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bricks.integrate_bricks_sequence(vol, depths, poses, rgbs, budget)
            for i in range(n_renders):
                render_view(packed, poses[i % n], colored=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rep = tracing.report()
    finally:
        tracing.disable()
    want = {**{f"frame.{s}": n for s in ("activation", "allocation", "batch")},
            **{f"render.{s}": n_renders for s in ("rays", "march", "finish")}}
    got = {k: rep["stages"].get(k, {}).get("count") for k in want}
    if got != want or rep["calls"]["count"] != 1 + n_renders or any(rep["dropped"].values()):
        raise AssertionError(f"traced pass and renders: stages {got} (want {want}), calls "
                             f"{rep['calls']['count']}, dropped {rep['dropped']}")
    return {k: rep[k] for k in ("stages", "calls", "spans")}


def graph_phase(torch, cfg, poses, depths, rgb, smi):
    """Phase 11 (see the module docstring); returns the {"graphs": ...}
    numbers."""
    from cpu_tsdf_tpu_torch import bricks, graph, pack_render, render_view
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk

    n = len(poses)
    capacity, budget = 1 << 15, 1 << 12
    graph.clear()
    fk.launches["fusion"] = 0
    ms, vols = fuse_routes(torch, cfg, 8, capacity, budget, poses, depths, rgb, list(range(n)))
    if fk.launches["fusion"] != 5 * n:
        raise AssertionError(f"fusion launches {fk.launches['fusion']} for 5 x {n} frames")
    res = {"card": smi, "frames": n, "frame_ms": ms,
           "frames_per_s": {k: 1e3 / v for k, v in ms.items() if not k.endswith("_first")}}
    frame_graph = graph.stats()[-1]
    log(f"graphs, {n} frames at 8^3: graphed and eager frames, graphed and eager sequences "
        f"bit-equal; steady frame ms {ms} (host clock); frame graph: capture "
        f"{frame_graph['capture_ms']:.2f} ms, pool {frame_graph['pool_mb']:.2f} MB, "
        f"launches a replay {frame_graph['launches']}")

    # one eager frame under the sync debug mode (on the eager volume,
    # after the comparisons)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bricks.integrate_bricks(vols["eager"], depths[0], poses[0], rgb, budget, graph=False)
        bricks.integrate_bricks(vols["graph"], depths[0], poses[0], rgb, budget)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert_states_equal(torch, vols["graph"], vols["eager"], "a frame under the sync check")
    log("an eager and a graphed frame ran under torch.cuda.set_sync_debug_mode('error')")

    # the card's idle share of 8 frames, each route (on its volume, whose
    # graph is captured)
    res["frame_idle"] = {r: idle_share(torch, lambda: [
        bricks.integrate_bricks(vols[r], depths[i], poses[i], rgb, budget,
                                graph=None if r == "graph" else False) for i in range(8)])
        for r in ("graph", "eager")}

    # renders: all poses both routes, bit-equal
    packed = pack_render(vols["graph"])
    t = {}
    views = {}
    for route, flag in (("graph", None), ("eager", False)):
        render_view(packed, poses[0], colored=True, graph=flag)    # the graph's capture
        torch.cuda.synchronize()
        rk.launches["raycast"] = 0
        t0 = time.perf_counter()
        views[route] = [render_view(packed, poses[i], colored=True, graph=flag)
                        for i in range(n)]
        torch.cuda.synchronize()
        t[route] = (time.perf_counter() - t0) * 1e3 / n
        if rk.launches["raycast"] != n:
            raise AssertionError(f"{route} renders launched the march "
                                 f"{rk.launches['raycast']} times for {n}")
    for i, (a, b) in enumerate(zip(views["graph"], views["eager"])):
        diff = views_differ(torch, a, b)
        if any(diff.values()):
            raise AssertionError(f"graphed render {i} differs from the eager one: {diff}")
    render_graph = graph.stats()[-1]
    res["render_ms"] = t
    res["renders_per_s"] = {k: 1e3 / v for k, v in t.items()}
    res["render_idle"] = {r: idle_share(torch, lambda: [
        render_view(packed, poses[i], colored=True, graph=None if r == "graph" else False)
        for i in range(8)]) for r in ("graph", "eager")}
    log(f"graphs: {n} colored renders, graphed and eager bit-equal; ms a render {t}; render "
        f"graph: capture {render_graph['capture_ms']:.2f} ms, pool "
        f"{render_graph['pool_mb']:.2f} MB")
    res["traced"] = traced_pass_and_renders(torch, vols["graph"], packed, poses, depths, rgb,
                                            budget)
    log(f"tracing on: a graphed pass of {n} frames and 100 graphed renders ran under "
        f"torch.cuda.set_sync_debug_mode('error'), every stage stamped at every replay; "
        f"stages {json.dumps(res['traced']['stages'])}; calls "
        f"{json.dumps(res['traced']['calls'])}")
    del vols, views, packed

    # the other brick sizes, and the jitter, on a few frames
    frames = list(range(0, n, n // GRAPH_FRAMES))[:GRAPH_FRAMES]
    res["other"] = {}
    for name, B, c in (("brick_4", 4, cfg), ("brick_16", 16, cfg),
                       ("splits_3", 8, cfg.with_updates(num_random_splits=3))):
        cap, bud = BRICK_SIZES[B] if B in BRICK_SIZES else (capacity, budget)
        ms_b, _ = fuse_routes(torch, c, B, cap, bud, poses, depths, rgb, frames)
        res["other"][name] = {"frames": len(frames), "frame_ms": ms_b,
                              "graph": graph.stats()[-1]}
        log(f"graphs, {name}: {len(frames)} frames bit-equal on every route; steady frame ms "
            f"{ms_b}; frame graphs {graph.stats()[-2:]}")
    res["graphs"] = graph.stats()
    res["frame_graph"], res["render_graph"] = frame_graph, render_graph
    for r in ("graph", "eager"):
        log(f"idle share (tracing), {r}: frames {res['frame_idle'][r]['idle_share']:.4f} "
            f"(of {res['frame_idle'][r]['window_ms']:.4f} device ms; wall "
            f"{res['frame_idle'][r]['wall_ms']:.4f} ms), renders "
            f"{res['render_idle'][r]['idle_share']:.4f}")
    return res


def single_pass(torch, mc, vol, min_weight: float = 0.5):
    """The extraction as one pass over every candidate brick, with exact
    sizes and two host syncs (the candidate list, the triangle total): the
    route before the budgeted chunks, kept here as the yardstick of their
    triangles. Returns (vertices [T, 3, 3], colors [T, 3, 3])."""
    cand = mc._candidate_slots(vol, min_weight)
    count, cube, corners, ntri = mc.corner_halo(vol, cand, min_weight)
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    verts, tri_cube = mc.emit_triangles(vol, cand, count, cube, corners, ends - ntri,
                                        int(ends[-1]))
    return verts, mc._expand_colors(mc._voxel_rgb(vol, tri_cube, True, False))


def host_ms(torch, fn, reps: int = 10) -> float:
    """Median host-clock ms of fn, each call ending in a synchronize, the
    first call apart."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]) * 1e3


def soups_differ(torch, a, b) -> list:
    """The fields in which two soups differ: tri_valid, num_triangles,
    overflowed, the valid rows' vertices and colors."""
    out = [k for k in ("tri_valid", "num_triangles", "overflowed")
           if not torch.equal(getattr(a, k), getattr(b, k))]
    if not out:
        for k in ("vertices", "colors"):
            if not torch.equal(getattr(a, k)[a.tri_valid], getattr(b, k)[b.tri_valid]):
                out.append(k)
    return out


def extraction_phase(torch, cfg, vol, pose_h, smi, breakdown) -> dict:
    """Phase 12 (see the module docstring); returns the {"extraction": ...}
    numbers."""
    import logging

    from cpu_tsdf_tpu_torch import graph, refine
    from cpu_tsdf_tpu_torch.io import pcd
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
    from cpu_tsdf_tpu_torch.pipeline import organize_cloud
    from cpu_tsdf_tpu_torch.synthetic import sphere_depth_world

    res = {"card": smi, "breakdown": breakdown}

    # ---- 1. the checked route: the single pass's triangles, bit for bit ----
    batches = []

    class Batches(logging.Handler):
        def emit(self, record):
            batches.append(record.getMessage())

    logger = logging.getLogger("cpu_tsdf_tpu_torch")
    handler, level = Batches(logging.DEBUG), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        checked = mc.extract_soup_bricks(vol, 0.5, True)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    ref_v, ref_c = single_pass(torch, mc, vol)
    if not (torch.equal(checked.vertices, ref_v) and torch.equal(checked.colors, ref_c)):
        raise AssertionError("the checked extraction differs from the single pass")
    live, hint = checked.live_chunks, checked.budget_hint
    res.update(triangles=int(checked.num_triangles), live_chunks=list(live),
               budget_hint=[list(h) for h in hint], batches=batches)
    log(f"checked extraction: {res['triangles']} triangles and colors bit-equal to the single "
        f"pass; live chunks {live}, hints {hint}; batches: {batches}")

    # ---- 2. the unchecked, hinted extraction: graphed and eager ------------
    args = dict(live_chunks=live, budget_hint=hint, check=False)
    graph.clear()
    torch.cuda.synchronize()
    mc.launches.update(corner_halo=0, emit=0)
    t0 = time.perf_counter()
    first = mc.extract_soup_bricks(vol, 0.5, True, **args)
    torch.cuda.synchronize()
    res["graph_first_ms"] = (time.perf_counter() - t0) * 1e3
    graphed = mc.extract_soup_bricks(vol, 0.5, True, **args)
    eager = mc.extract_soup_bricks(vol, 0.5, True, **args, graph=False)
    torch.cuda.synchronize()
    res["launches_graphed"] = dict(mc.launches)
    want = {"corner_halo": 3 * len(live), "emit": 3 * len(live)}
    if res["launches_graphed"] != want:
        raise AssertionError(f"unchecked extractions launched {mc.launches}, want {want}")
    for what, a, b in (("graphed and eager", graphed, eager), ("capture and replay", first,
                                                               graphed)):
        diff = soups_differ(torch, a, b)
        if diff:
            raise AssertionError(f"unchecked extraction, {what}: {diff} differ")
    if bool(eager.overflowed) or not torch.equal(eager.vertices[eager.tri_valid], ref_v) or \
            not torch.equal(eager.colors[eager.tri_valid], ref_c):
        raise AssertionError("the unchecked extraction's valid triangles are not the checked "
                             "route's")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = mc.extract_soup_bricks(vol, 0.5, True, **args, graph=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if soups_differ(torch, again, eager):
        raise AssertionError("the eager unchecked extraction under the sync check differs")
    small = tuple(tuple(b // 4 for b in h) for h in hint)
    over = mc.extract_soup_bricks(vol, 0.5, True, live_chunks=live, budget_hint=small,
                                  check=False)
    recovered = mc.extract_soup_bricks(vol, 0.5, True, live_chunks=live, budget_hint=small)
    if not bool(over.overflowed) or not torch.equal(recovered.vertices, ref_v):
        raise AssertionError("a quarter of each budget: no overflow flag, or the checked "
                             "route did not recover the mesh")
    res["steady_ms"] = {r: host_ms(torch, lambda: mc.extract_soup_bricks(
        vol, 0.5, True, **args, graph=None if r == "graph" else False))
        for r in ("graph", "eager")}
    res["checked_hinted_ms"] = host_ms(torch, lambda: mc.extract_soup_bricks(
        vol, 0.5, True, live_chunks=live, budget_hint=hint))
    res["idle"] = {r: idle_share(torch, lambda: [mc.extract_soup_bricks(
        vol, 0.5, True, **args, graph=None if r == "graph" else False) for _ in range(8)])
        for r in ("graph", "eager")}
    res["extract_graph"] = [g for g in graph.stats() if g["kind"] == "extract"]
    log(f"unchecked extraction: graphed and eager equal, valid triangles the checked route's, "
        f"an eager call ran under set_sync_debug_mode('error'), a quarter of each budget "
        f"overflows and the checked route recovers; steady ms {res['steady_ms']} (host clock, "
        f"synchronized), checked with hints {res['checked_hinted_ms']:.4f} ms; first graphed "
        f"call {res['graph_first_ms']:.2f} ms; idle share graph "
        f"{res['idle']['graph']['idle_share']:.4f}, eager "
        f"{res['idle']['eager']['idle_share']:.4f}; "
        f"graph {res['extract_graph']}")

    # ---- 4. the refine step and residual: graphed and eager ----------------
    dev = vol.device
    depth = torch.as_tensor(sphere_depth_world(cfg, pose_h, radius=0.5), device=dev)
    pose = torch.as_tensor(pose_h, device=dev)
    bad = refine._compose(refine.exp_se3(torch.tensor((*REFINE_SHIFT, 0.0, 0.0, 0.0),
                                                      device=dev)), pose)
    for lr in (1.0, 0.25, 1.0):
        pg, lg = refine.refine_pose_step(vol, bad, depth, 2, 256, lr)
        pe, le = refine.refine_pose_step(vol, bad, depth, 2, 256, lr, graph=False)
        rg = refine.depth_residual(vol, pg, depth, 2)
        re_ = refine.depth_residual(vol, pe, depth, 2, graph=False)
        if not (torch.equal(pg, pe) and torch.equal(lg, le) and torch.equal(rg, re_)):
            raise AssertionError(f"graphed refine step or residual differs from eager (lr {lr}): "
                                 f"{float((pg - pe).abs().max())}, {float(lg)} vs {float(le)}")
    res["refine_step_ms"] = {r: host_ms(torch, lambda: refine.refine_pose_step(
        vol, bad, depth, 2, graph=None if r == "graph" else False)) for r in ("graph", "eager")}
    res["refine_residual_ms"] = {r: host_ms(torch, lambda: refine.depth_residual(
        vol, bad, depth, 2, graph=None if r == "graph" else False)) for r in ("graph", "eager")}
    res["refine_idle"] = {r: idle_share(torch, lambda: [refine.refine_pose_step(
        vol, bad, depth, 2, graph=None if r == "graph" else False) for _ in range(8)])
        for r in ("graph", "eager")}
    log(f"refine: graphed step and residual bit-equal to eager at 3 step scales; step ms "
        f"{res['refine_step_ms']}, residual ms {res['refine_residual_ms']}; idle share graph "
        f"{res['refine_idle']['graph']['idle_share']:.4f}, eager "
        f"{res['refine_idle']['eager']['idle_share']:.4f}")

    # ---- 5. organize_cloud: graphed and eager on phase 7's PCDs ------------
    ccfg = type(cfg)()
    times = {"graph": [], "eager": []}
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        write_pcd_sequence(ccfg, seq, CLI_FRAMES, CLI_RADIUS)
        for i in range(CLI_FRAMES):
            cloud = pcd.load_pcd(os.path.join(seq, f"frame_{i:04d}.pcd"))
            xyz, rgb = cloud.xyz().astype(np.float32), cloud.rgb()
            out = {}
            for r, flag in (("graph", None), ("eager", False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[r] = organize_cloud(ccfg, xyz, rgb, device=dev, graph=flag)
                torch.cuda.synchronize()
                times[r].append((time.perf_counter() - t0) * 1e3)
            (dg, cg), (de, ce) = out["graph"], out["eager"]
            if not (torch.equal(dg.nan_to_num(), de.nan_to_num())
                    and torch.equal(dg.isnan(), de.isnan()) and torch.equal(cg, ce)):
                raise AssertionError(f"graphed organize_cloud differs from eager on frame {i}")
    res["organize_ms"] = {r: statistics.median(t[1:]) for r, t in times.items()}
    res["organize_first_ms"] = {r: t[0] for r, t in times.items()}
    log(f"organize_cloud: {CLI_FRAMES} PCDs graphed and eager bit-equal; median ms a frame "
        f"{res['organize_ms']} (upload included, the first frame apart: "
        f"{res['organize_first_ms']})")
    return res


# Phase 13: the dense frames fused through the dense kernel and its plain
# version (orbit poses 0, 1, 2, 3; the kernel record on pose 4), and the
# 4^3 volume of the checked extraction (phase 10's capacity and budget,
# every third orbit pose)
DENSE_FRAMES = 4


def checked_routes(torch, mc, graph, vol, what: str) -> dict:
    """The checked extraction of vol (chunks of 2048 slots) through its
    graphs (the brick stats' graph replayed a live chunk, a chunk graph a
    budget triple replayed a chunk) and eagerly: bit-equal triangles,
    colors, live chunks and
    hints, the default budgets and the first call's hints; the first
    graphed call (capture), steady ms of each route (host clock), idle
    shares, and extract_mesh's one-shot call both ways (the CLI's)."""
    graph.clear()
    torch.cuda.synchronize()
    mc.launches.update(corner_halo=0, emit=0)
    t0 = time.perf_counter()
    first = mc.extract_soup_bricks(vol, 0.5, True)
    torch.cuda.synchronize()
    res = {"first_graphed_ms": (time.perf_counter() - t0) * 1e3}
    res["launches_first_call"] = dict(mc.launches)
    eager = mc.extract_soup_bricks(vol, 0.5, True, graph=False)
    hinted = dict(live_chunks=eager.live_chunks, budget_hint=eager.budget_hint)
    calls = {"default": {}, "hinted": hinted}
    for name, kw in calls.items():
        want = mc.extract_soup_bricks(vol, 0.5, True, **kw, graph=False)
        got = [mc.extract_soup_bricks(vol, 0.5, True, **kw) for _ in range(2)]
        for g in [first] * (name == "default") + got:
            same = (torch.equal(g.vertices, want.vertices) and torch.equal(g.colors, want.colors)
                    and g.live_chunks == want.live_chunks and g.budget_hint == want.budget_hint)
            if not same:
                raise AssertionError(f"{what}: the graphed checked extraction ({name}) differs "
                                     "from the eager one")
        if got[0].vertices.data_ptr() == got[1].vertices.data_ptr():
            raise AssertionError(f"{what}: two graphed results share their vertices")
    res.update(triangles=int(eager.num_triangles), live_chunks=len(eager.live_chunks),
               budget_hint=[list(h) for h in eager.budget_hint])
    res["steady_ms"] = {f"{name}_{r}": host_ms(torch, lambda: mc.extract_soup_bricks(
        vol, 0.5, True, **kw, graph=None if r == "graph" else False))
        for name, kw in calls.items() for r in ("graph", "eager")}
    res["idle"] = {r: idle_share(torch, lambda: [mc.extract_soup_bricks(
        vol, 0.5, True, graph=None if r == "graph" else False) for _ in range(8)])
        for r in ("graph", "eager")}
    res["graphs"] = [g for g in graph.stats() if g["kind"].startswith("extract_checked")]
    # extract_mesh as the CLI calls it, once: a new graph's capture, or eager
    graph.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc.extract_mesh(vol, 0.5, color_by_rgb=True)
    res["extract_mesh_one_shot_ms"] = {"graph": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    mc.extract_mesh(vol, 0.5, color_by_rgb=True, graph=False)
    res["extract_mesh_one_shot_ms"]["eager"] = (time.perf_counter() - t0) * 1e3
    log(f"checked extraction, {what}: graphed and eager bit-equal (triangles, colors, live "
        f"chunks, hints; default budgets and hints), {res['triangles']} triangles in "
        f"{res['live_chunks']} live chunks; first graphed call {res['first_graphed_ms']:.2f} "
        f"ms (launches {res['launches_first_call']}); steady ms {res['steady_ms']} (host "
        f"clock); idle share graph {res['idle']['graph']['idle_share']:.4f}, eager "
        f"{res['idle']['eager']['idle_share']:.4f}; one-shot extract_mesh ms "
        f"{res['extract_mesh_one_shot_ms']}; graphs {res['graphs']}")
    return res


def dense_phase(torch, cfg, vol, poses, depths, rgb, smi, timer):
    """Phase 13 (see the module docstring); returns the {"dense_checked":
    ...} numbers and the dense kernel's record."""
    import cpu_tsdf_tpu_torch as T
    from cpu_tsdf_tpu_torch import bricks, graph
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
    from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab_plain

    dev = poses.device
    res = {"card": smi, "grid": [cfg.xres, cfg.yres, cfg.zres], "frames": DENSE_FRAMES}
    # ---- 1. the dense frames through the kernel (integrate's default) -----
    # in place: the volume is donated, and the route allocates nothing of
    # its size
    torch.cuda.empty_cache()
    vk = T.make_volume(cfg, device=dev)
    state_bytes = vk.sdf.numel() * vk.sdf.element_size()
    torch.cuda.synchronize()
    fk.launches["dense_fusion"] = 0
    ms = {"kernel": [], "plain": []}
    extra = []
    for i in range(DENSE_FRAMES):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = T.integrate(vk, depths[i], poses[i], rgb)
        torch.cuda.synchronize()
        ms["kernel"].append((time.perf_counter() - t0) * 1e3)
        extra.append(torch.cuda.max_memory_allocated() - base)
        if out.sdf is not vk.sdf or out.color is not vk.color:
            raise AssertionError("dense integrate: the kernel route did not update in place")
        vk = out
    launches = fk.launches["dense_fusion"]
    if launches != DENSE_FRAMES:
        raise AssertionError(f"dense integrate: {launches} kernel launches in {DENSE_FRAMES} "
                             "frames")
    if max(extra) >= state_bytes:
        raise AssertionError(f"dense integrate in place allocated {max(extra)} bytes, one "
                             f"state tensor is {state_bytes}")
    vp = T.make_volume(cfg, device=dev)
    for i in range(DENSE_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vp = T.integrate(vp, depths[i], poses[i], rgb, use_kernel=False)
        torch.cuda.synchronize()
        ms["plain"].append((time.perf_counter() - t0) * 1e3)
    err = dense_equal(torch, vk, vp, f"{DENSE_FRAMES} dense frames")
    res.update(frame_ms=ms, launches=launches, frames_max_abs_err=err,
               peak_extra_bytes=extra, state_tensor_bytes=state_bytes,
               observed_voxels=int((vk.weight > 0).sum()))
    del vp
    log(f"dense integrate at {res['grid']} with RGB color, in place: {DENSE_FRAMES} frames "
        f"through the kernel equal to the plain route's (weight, nsample, color exact, sdf/M "
        f"err {err}); frame ms (host clock, synchronized) kernel {ms['kernel']}, plain "
        f"{ms['plain']}; at most {max(extra)} bytes allocated a frame (one state tensor: "
        f"{state_bytes}); {res['observed_voxels']} voxels observed; {launches} kernel launches")

    # ---- 2. the kernel against its plain version on one more frame --------
    i = DENSE_FRAMES
    depth_t = torch.as_tensor(depths[i], device=dev)
    pose_t = torch.as_tensor(poses[i], device=dev)
    # the autograd route: the kernel on a copy, the input left as it was
    start = dense_copy(vk)
    torch.cuda.synchronize()
    before = fk.launches["dense_fusion"]
    t0 = time.perf_counter()
    g = T.integrate(vk, depth_t.clone().requires_grad_(True), pose_t, rgb)
    torch.cuda.synchronize()
    res["autograd_frame_ms"] = (time.perf_counter() - t0) * 1e3
    if fk.launches["dense_fusion"] != before + 1 or g.sdf is vk.sdf:
        raise AssertionError("dense integrate under autograd: not one launch on a copy")
    dense_equal(torch, vk, start, "the input of the autograd route")
    del g
    # the kernel on vk in place, the plain version on a copy of its state;
    # the kernel writes each column's z-interval into iv
    p = integrate_slab_plain(start, depth_t, pose_t, rgb)
    n_obs = int((p.nsample - start.nsample).sum())  # an observed voxel's nsample went up by 1
    iv = torch.full((cfg.xres * cfg.yres, 2), -7, dtype=torch.int32, device=dev)
    k = fk.fuse_dense(vk, depth_t, pose_t, rgb, intervals=iv)
    err = dense_equal(torch, k, p, "the dense kernel on one frame")
    del k, p, vk
    n_vox = cfg.xres * cfg.yres * cfg.zres
    # timed on a copy kept for timing: repeated launches move its state on,
    # but not which voxels are observed (that follows from the projection
    # and the depth alone), so each launch does the same work
    t_k = timer.ms(lambda: fk.fuse_dense(start, depth_t, pose_t, rgb), spin=True)
    t_p = timer.ms(lambda: integrate_slab_plain(start, depth_t, pose_t, rgb), reps=3,
                   warmup=1, spin=True)
    # the wrapper's device time by kernel (torch.profiler): the dense
    # kernel, the depth reduction before it, and the glue (pose inverse,
    # rgb trunc)
    parts = device_kernels(torch, lambda: fk.fuse_dense(start, depth_t, pose_t, rgb))
    breakdown = {"fuse_dense_kernel": 0.0, "depth_max_kernel": 0.0, "glue": 0.0}
    for name, kms, _ in parts:
        key = next((k for k in breakdown if k in name), "glue")
        breakdown[key] += kms
    H, W, nc = cfg.image_height, cfg.image_width, start.color.shape[-1]
    # the bound: the observed voxels' state and color read and written once
    # (an in-place fusion, as JAX's donated one, touches no other voxel),
    # the candidate voxels projected and tested (counted voxel by voxel from
    # the pose and the depth: inside the pinhole frustum, in the sensor's
    # range, in front of the deepest reading plus the band), the observed
    # ones updated. Beside it the earlier kernel's two bounds: every voxel projected,
    # and every voxel read and written once
    pose_inv = rigid_inverse(pose_t)
    n_cand = int(fk.dense_candidates(cfg, pose_inv, depth_t))
    # the voxels the kernel projected: its intervals' groups of 4, as it
    # walked them; its intervals equal the cull's plain version
    lo, hi = fk.dense_column_intervals(cfg, pose_inv, depth_t)
    if not torch.equal(iv.long(), torch.stack([lo.reshape(-1), hi.reshape(-1)], 1)):
        raise AssertionError("the dense kernel's column intervals differ from "
                             "fusion_kernel.dense_column_intervals")
    klo, khi = iv[:, 0].long(), iv[:, 1].long()
    n_cull = int(torch.where(klo <= khi, (khi // 4 - klo // 4 + 1) * 4, 0).sum())
    if not n_obs <= n_cand <= n_cull:
        raise AssertionError(f"dense counts: {n_obs} observed, {n_cand} candidates, "
                             f"{n_cull} voxels in the kernel's column intervals")
    obs_bytes = fk.voxel_bytes(n_obs, H, W, nc)
    all_bytes = fk.voxel_bytes(n_vox, H, W, nc)
    rec = record("dense_fusion", "cpu_tsdf_tpu_torch/csrc/fusion.cu",
                 "cpu_tsdf_tpu/ops/fusion.py:141", launches, err, t_k, t_p, obs_bytes,
                 fk.ops_needed(cfg, n_cand, n_obs))
    rec["bound_every_voxel_projected_ms"] = max(
        obs_bytes / HBM_BYTES_PER_S, fk.ops_needed(cfg, n_vox, n_obs) / FP32_OPS_PER_S) * 1e3
    rec["bound_all_ms"] = all_bytes / HBM_BYTES_PER_S * 1e3
    rec["replaces_kind"] = "jax.jit program fused by XLA (not a Pallas kernel)"
    rec.update(candidates=n_cand, observed=n_obs, projected_by_kernel=n_cull,
               device_ms_by_kernel=breakdown)
    res.update(kernel_ms=t_k, plain_ms=t_p, bound_ms=rec["bound_ms"],
               bound_by=rec["bound_by"], bytes_observed=obs_bytes,
               bound_every_voxel_projected_ms=rec["bound_every_voxel_projected_ms"],
               bound_all_ms=rec["bound_all_ms"], bytes_all=all_bytes,
               observed_in_frame=n_obs, candidates=n_cand, projected_by_kernel=n_cull,
               share_of_bound=rec["bound_ms"] / t_k, device_ms_by_kernel=breakdown)
    res["idle"] = {r: idle_share(torch, lambda: [T.integrate(
        start, depths[j], poses[j], rgb, use_kernel=r == "kernel") for j in range(3)])
        for r in ("kernel", "plain")}
    log(f"dense kernel vs plain on frame {i}: equal (sdf/M err {err}); kernel {t_k:.5f} ms, "
        f"plain {t_p:.4f} ms (device, CUDA events); bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}: {n_cand} candidates projected, {n_obs} of {n_vox} voxels "
        f"observed, {obs_bytes} bytes), {100 * rec['bound_ms'] / t_k:.1f} % of it; the "
        f"kernel's intervals (read back from it, equal to the plain cull's) hold {n_cull} "
        f"voxels; every voxel projected "
        f"{rec['bound_every_voxel_projected_ms']:.5f} ms, every voxel read and written "
        f"{rec['bound_all_ms']:.4f} ms ({all_bytes} bytes); the autograd route's frame "
        f"{res['autograd_frame_ms']:.3f} ms (host clock); device ms by kernel "
        f"(torch.profiler) {breakdown}; idle share (tracing) kernel "
        f"{res['idle']['kernel']['idle_share']:.4f}, plain "
        f"{res['idle']['plain']['idle_share']:.4f}")
    del start
    torch.cuda.empty_cache()

    # ---- 3. the checked extraction, graphed and eager -----------------------
    res["checked_8"] = checked_routes(torch, mc, graph, vol, "8^3 bricks (phase 2's volume)")
    capacity, budget = BRICK_SIZES[4]
    frames = list(range(0, len(poses), len(poses) // BRICK_FRAMES))[:BRICK_FRAMES]
    v4 = T.make_brick_volume(cfg, 4, capacity, device=dev)
    for j in frames:
        bricks.integrate_bricks(v4, depths[j], poses[j], rgb, budget)
    if bool(v4.overflowed):
        raise AssertionError("the 4^3 volume overflowed")
    res["checked_4"] = checked_routes(torch, mc, graph, v4, "4^3 bricks")
    return res, rec


def dense_copy(vol):
    """A dense volume with copies of vol's state and color."""
    import dataclasses

    return dataclasses.replace(vol, **{k: getattr(vol, k).clone()
                                       for k in ("sdf", "weight", "M", "nsample", "color")})


def dense_equal(torch, a, b, what: str) -> float:
    """Dense volumes: weight (NaN where NaN), nsample and color exact, sdf
    and M within 1e-5. Returns the largest sdf/M difference."""
    if not (torch.equal(a.nsample, b.nsample) and torch.equal(a.color, b.color)
            and torch.equal(a.weight.isnan(), b.weight.isnan())
            and torch.equal(a.weight.nan_to_num(), b.weight.nan_to_num())):
        raise AssertionError(f"{what}: weight, nsample or color differs")
    err = max(float((a.sdf - b.sdf).abs().max()), float((a.M - b.M).abs().max()))
    if not err <= 1e-5:
        raise AssertionError(f"{what}: sdf/M differ by {err}")
    return err


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
    from cpu_tsdf_tpu_torch.ops import activation_kernel as ak
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
    ak.launches.update(dict.fromkeys(ak.launches, 0))
    t0 = time.perf_counter()
    for i in range(n_poses):
        T.integrate_bricks(vol, depths[i], poses[i], rgb, budget)
        if i == 0:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, colors = mc.extract_mesh(vol, min_weight=0.5, color_by_rgb=True)
    t_mesh = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.ply"
        save_ply(path, verts, faces, colors)
        v2, f2, _ = load_ply(path)
    main_launches = {"fusion": fk.launches["fusion"], **mc.launches,
                     "activation": min(ak.launches.values())}
    n_live = int(vol.n_active)
    radius_err = float(np.median(np.abs(np.linalg.norm(verts, axis=1) - 0.5)))
    log(f"main path: {n_poses} frames in {t_fuse:.3f} s = {n_poses / t_fuse:.2f} frames/s "
        f"(the first frame {t_first * 1e3:.2f} ms: the process's first kernels and the "
        f"frame graph's warm-up and capture; the other {n_poses - 1} "
        f"{(t_fuse - t_first) * 1e3 / (n_poses - 1):.4f} ms each); "
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
        T.integrate_bricks(shadow_vol, depths[i_mid], poses[i_mid], rgb, budget, graph=False)

    shadow_vol = shadow(vol)
    shadow_vol.sdf, shadow_vol.weight, shadow_vol.M, shadow_vol.nsample = st
    shadow_vol.color = color
    t_act = timer.ms(activation)
    t_fk = timer.ms(fuse_only, spin=True)
    t_fb = timer.ms(fuse_batch)
    t_frame = timer.ms(whole_frame)
    log(f"frame breakdown (frame {i_mid}, {n_ok} live rows): whole frame {t_frame:.4f} ms; "
        f"activation+allocation {t_act:.4f} ms (host-launched ops, no host sync); "
        f"fusion kernel with the color update {t_fk:.4f} ms (device); fuse_brick_batch "
        f"{t_fb:.4f} ms (kernel + glue: rgb trunc, row stack; launches included), glue "
        f"{t_fb - t_fk:.4f} ms")
    n_prof = 8
    busy, top = device_ms(torch, lambda: [
        T.integrate_bricks(shadow_vol, depths[i], poses[i], rgb, budget, graph=False)
        for i in range(n_prof)])
    log(f"kernel time over {n_prof} eager frames: {busy:.4f} ms (torch.profiler); "
        f"largest: {top}")

    # extraction steps on the main volume: the checked route with a first
    # call's hints (one batch, one host sync), each a median of synchronized runs
    breakdown = extraction_breakdown(torch, mc, vol, timer)

    # ---- phase 4: each kernel against its plain version -------------------
    kernels = [fusion_check(torch, fk, vol, rows, pose_inv, depths[i_mid], rgb_t, n_ok,
                            main_launches["fusion"], timer)]
    kernels += mc_phase(torch, mc, vol, main_launches, timer)
    kernels.append(activation_check(torch, vol, depths[i_mid], pose_inv, budget,
                                    main_launches["activation"], timer))

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
    if int(sk.num_triangles) != int(sp.num_triangles) or int(sk.num_triangles) < 1000:
        raise AssertionError(f"meshes differ: {int(sk.num_triangles)} vs "
                             f"{int(sp.num_triangles)}")
    verr = float((sk.vertices - sp.vertices).abs().max())
    if verr > 1e-6 or not torch.equal(sk.colors, sp.colors):
        raise AssertionError(f"mesh vertices differ by {verr} (or colors differ)")
    log(f"whole-path parity over {n_par} frames: volumes match (sdf/M err {err}), "
        f"{int(sk.num_triangles)} triangles match (vertex err {verr})")
    del vk, vp, sk, sp

    raycast, render_grad = render_phase(torch, cfg, vol, poses, poses_h, timer)
    kernels.append(raycast)
    render_grad["card"] = smi

    # ---- phase 7: the CLI path ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cli_numbers = cli_phase(torch, tmp)
    cli_numbers["card"] = smi

    # ---- phase 8: pose refinement at full width on the phase-2 volume ------
    refine_numbers = refine_phase(torch, cfg, vol, poses_h[n_poses // 2])
    refine_numbers["card"] = smi

    # ---- phase 9: the sharded paths, 2 ranks sharing the card --------------
    par = parallel_phase(torch, cfg)
    par["card"] = smi

    # ---- phase 10: the main path at other brick sizes ----------------------
    sizes = {B: brick_size_phase(torch, cfg, B, poses, depths, rgb, poses_h, timer)
             for B in BRICK_SIZES}
    for res in sizes.values():
        res["card"] = smi

    # ---- phase 11: the graphed frame, sequence and render against eager -----
    graphs = graph_phase(torch, cfg, poses, depths, rgb, smi)

    # ---- phase 12: the budgeted extraction, refine and organize graphs ------
    extraction = extraction_phase(torch, cfg, vol, poses_h[n_poses // 2], smi, breakdown)
    b16, b16_mesh = cli_numbers["brick16_launches"], cli_numbers["brick16_tsdf2mesh_launches"]
    on_paths = {"activation": {"main": main_launches["activation"],
                               "cli": cli_numbers["launches"]["activation"],
                               "cli_brick_16": b16["activation"],
                               "parallel_per_rank": par["launches_per_rank"]["activation"]},
                "fusion": {"main": main_launches["fusion"], "cli": cli_numbers["launches"]["fusion"],
                           "cli_brick_16": b16["fusion"],
                           "parallel_per_rank": par["launches_per_rank"]["fusion"]},
                "mc_corner_halo": {"main": main_launches["corner_halo"],
                                   "unchecked_graph_3_calls":
                                       extraction["launches_graphed"]["corner_halo"],
                                   "cli": cli_numbers["launches"]["corner_halo"],
                                   "cli_brick_16": b16["corner_halo"],
                                   "cli_brick_16_tsdf2mesh": b16_mesh["corner_halo"],
                                   "parallel_per_rank": par["launches_per_rank"]["corner_halo"]},
                "mc_emit": {"main": main_launches["emit"], "cli": cli_numbers["launches"]["emit"],
                            "unchecked_graph_3_calls": extraction["launches_graphed"]["emit"],
                            "cli_brick_16": b16["emit"],
                            "cli_brick_16_tsdf2mesh": b16_mesh["emit"],
                            "parallel_per_rank": par["launches_per_rank"]["emit"]},
                "raycast": {"main": kernels[-1]["launches"],
                            "cli": cli_numbers["launches"]["raycast"],
                            **{f"parallel_per_rank_{k[8:]}": v
                               for k, v in par["launches_per_rank"].items()
                               if k.startswith("raycast_")}}}
    for k in kernels:
        k["launches_on_paths"] = on_paths[k["name"]]
        for B, res in sizes.items():
            at_b = next(r for r in res["kernels"] if r["name"] == k["name"])
            k["launches_on_paths"][f"brick_{B}"] = at_b["launches"]
            k.setdefault("brick_sizes", {})[str(B)] = {
                key: at_b[key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "bound_rows_ms")
                if key in at_b}

    # ---- phase 13: the dense kernel and the checked extraction's graphs ------
    dense, dense_rec = dense_phase(torch, cfg, vol, poses, depths, rgb, smi, timer)
    dense_rec["launches_on_paths"] = {
        "dense_phase_13": dense_rec["launches"],
        "cli_dense": cli_numbers["dense_launches"]["dense_fusion"],
        **{f"parallel_per_rank_{k}": v for k, v in par["launches_per_rank"].items()
           if k.startswith("dense_fusion_")}}
    kernels.append(dense_rec)

    print(json.dumps({"render_grad": render_grad}))
    print(json.dumps({"cli": cli_numbers}))
    print(json.dumps({"refine": refine_numbers}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"brick_sizes": {str(B): {k: v for k, v in res.items() if k != "kernels"}
                                      for B, res in sizes.items()}}))
    print(json.dumps({"graphs": graphs}))
    print(json.dumps({"extraction": extraction}))
    print(json.dumps({"dense_checked": dense}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
