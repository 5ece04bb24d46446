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
  3. the frame-time breakdown (activation + allocation, fusion kernel,
     color update) on replayed frames;
  4. each kernel against its plain PyTorch version on the same card, at
     the main path's shapes (fusion: one real frame's update list, weight
     and nsample exact, sdf and M within 1e-5; corner halo: the volume's
     candidate bricks, exact; pack-left: random masks and the real
     triangle mask, exact), with CUDA-event times of both;
  5. whole-path parity: the first 8 frames through the kernels and through
     the plain engine on the card, volumes and meshes compared.

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
            if "registers" in line or "spill" in line:
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
    mc.launches.update(corner_halo=0, pack_left=0)
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

    def fuse_only():
        fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *st, rgb_t)

    color = vol.color.clone()

    def fuse_and_color():
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
    t_fc = timer.ms(fuse_and_color)
    t_frame = timer.ms(whole_frame)
    log(f"frame breakdown (frame {i_mid}, {n_ok} live rows): whole frame {t_frame:.4f} ms; "
        f"activation+allocation {t_act:.4f} ms (one host sync: the allocation count); "
        f"fusion kernel {t_fk:.4f} ms; color update {t_fc - t_fk:.4f} ms")
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
    t_halo = timer.ms(lambda: mc._compact_from_loc(*mc.corner_halo(vol, cand, 0.5)[1:]))
    t_soup = timer.ms(lambda: mc.extract_soup_bricks(vol, 0.5, True))
    soup = mc.extract_soup_bricks(vol, 0.5, True)
    t_host = timer.ms(soup.to_numpy)
    log(f"extraction breakdown: brick stats + candidates {t_cand:.4f} ms; corner halo + "
        f"cube compaction {t_halo:.4f} ms; case table + pack-left + emission + colors "
        f"{t_soup - t_cand - t_halo:.4f} ms; copy to host {t_host:.4f} ms "
        f"(3 host syncs: candidate list, cube count, triangle count)")

    # ---- phase 4: each kernel against its plain version -------------------
    kernels = []
    a, b = state_copy(vol), state_copy(vol)
    aux_k = fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *a, rgb_t)
    aux_p = fk.fuse_bricks_plain(cfg, rows, pose_inv, depths[i_mid], *b, rgb_t)
    for name, x, y in zip(("sdf", "weight", "M", "nsample"), a, b):
        if name in ("weight", "nsample") and not torch.equal(x, y):
            raise AssertionError(f"fusion kernel: {name} differs from the plain engine")
    err = max(float((a[0] - b[0]).abs().max()), float((a[2] - b[2]).abs().max()))
    okr = rows[:, 3] >= 0
    if err > 1e-5 or not torch.equal(aux_k[okr], aux_p[okr]):
        raise AssertionError(f"fusion kernel: sdf/M err {err} or aux differs")
    t_k = timer.ms(lambda: fk.fuse_bricks(cfg, rows, pose_inv, depths[i_mid], *a, rgb_t),
                   spin=True)
    t_p = timer.ms(lambda: fk.fuse_bricks_plain(cfg, rows, pose_inv, depths[i_mid], *b, rgb_t),
                   spin=True)
    H, W = cfg.image_height, cfg.image_width
    kernels.append(record("fusion", "cpu_tsdf_tpu_torch/csrc/fusion.cu",
                          "cpu_tsdf_tpu/ops/pallas_fusion.py:363", main_launches["fusion"],
                          err, t_k, t_p, fk.bytes_moved(n_ok, H, W, True),
                          n_ok * 512 * fk.OPS_PER_VOXEL))
    # bound_ms counts the least aux the color update needs; give the
    # state-and-images count and the count of what the kernel writes beside it
    b_state, b_written = (fk.bytes_moved(n_ok, H, W, True, w) / HBM_BYTES_PER_S * 1e3
                          for w in (0, fk.AUX_CHANNELS))
    log(f"fusion: {n_ok} rows, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, max err {err}; "
        f"byte bounds: {kernels[-1]['bound_ms']:.5f} ms with {fk.LEAST_AUX_WORDS} aux "
        f"words (bound_ms), {b_state:.5f} ms state and images only, {b_written:.5f} ms "
        f"with the {fk.AUX_CHANNELS} aux words the kernel writes")

    cand = mc._candidate_slots(vol, 0.5)
    dk, okk, lk = mc.corner_halo(vol, cand, 0.5)
    dp, okp = mc._corner_stacks(vol, cand, 0.5)
    lp = mc._pack_left_plain(okp)
    err = max(float((dk - dp).abs().max()), float((okk != okp).max()),
              float((lk - lp).abs().max()))
    if not (torch.equal(dk, dp) and torch.equal(okk, okp) and torch.equal(lk, lp)):
        raise AssertionError(f"corner-halo kernel differs from its plain version ({err})")
    t_k = timer.ms(lambda: mc.corner_halo(vol, cand, 0.5), spin=True)
    t_p = timer.ms(lambda: mc._pack_left_plain(mc._corner_stacks(vol, cand, 0.5)[1]),
                   spin=True)
    K = int(cand.shape[0])
    kernels.append(record("mc_corner_halo", "cpu_tsdf_tpu_torch/csrc/mc_corner_halo.cu",
                          "cpu_tsdf_tpu/ops/marching_cubes.py:695",
                          main_launches["corner_halo"], err, t_k, t_p,
                          mc.bytes_moved_corner_halo(K), K * 512 * 48))
    log(f"corner halo: {K} candidate bricks, {int(okk.sum())} cubes, kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms")

    # the real triangle mask of the extraction's kernel route
    ids = mc._compact_from_loc(okk, lk)
    vals = dk[ids] * cfg.max_dist_neg
    _, ntris = mc._case_rows(vals)
    tri = (torch.arange(mc.MAX_TRIS_PER_CUBE, device=dev)[None] < ntris[:, None]).reshape(-1)
    tri = torch.cat([tri, tri.new_zeros((-tri.shape[0]) % 512)]).to(torch.int32).reshape(-1, 512)
    gen = torch.Generator(device=dev).manual_seed(3)
    rand = (torch.rand(tri.shape, generator=gen, device=dev) < 0.3).to(torch.int32)
    err = 0.0
    for m in (rand, tri):
        lk, lp = mc.pack_left_rows(m), mc._pack_left_plain(m)
        err = max(err, float((lk - lp).abs().max()))
        if not torch.equal(lk, lp):
            raise AssertionError(f"pack-left kernel differs from its plain version ({err})")
    t_k = timer.ms(lambda: mc.pack_left_rows(tri), spin=True)
    t_p = timer.ms(lambda: mc._pack_left_plain(tri), spin=True)
    NB = int(tri.shape[0])
    kernels.append(record("pack_left", "cpu_tsdf_tpu_torch/csrc/pack_left.cu",
                          "cpu_tsdf_tpu/ops/marching_cubes.py:631",
                          main_launches["pack_left"], err, t_k, t_p,
                          mc.bytes_moved_pack_left(NB), NB * 512 * 4))
    log(f"pack-left: {NB} rows, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")

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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
