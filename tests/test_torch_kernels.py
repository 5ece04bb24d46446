"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. The file imports neither jax nor the JAX package, so that it
runs where only PyTorch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite.)
The CPU parity of the plain versions with the JAX package is in the other
tests/test_torch_*.py files.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cpu_tsdf_tpu_torch import activation as ta
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.geometry import rigid_inverse
from cpu_tsdf_tpu_torch.ops import activation_kernel as ak
from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
from cpu_tsdf_tpu_torch.ops import raycast as rc
from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

from torch_common import ACTIVATION_CASES, CULL_CASES, activation_case, cull_frame

CFG = TSDFConfig(xres=128, yres=128, zres=128, xsize=1.6, ysize=1.6, zsize=1.6,
                 max_dist_pos=0.04, max_dist_neg=0.04, min_sensor_dist=0.1,
                 image_width=160, image_height=120, focal_length_x=140.0,
                 focal_length_y=140.0, principal_point_x=80.0,
                 principal_point_y=60.0)


@pytest.fixture
def cuda_device():
    """The card; tests of the CUDA kernels skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _frames(cfg, n=4, step=0.5, noise=0.0):
    rng = np.random.default_rng(1)
    for i in range(n):
        m = orbit_pose(step * i)
        d = sphere_depth_world(cfg, m, radius=0.5)
        d = d + rng.normal(0.0, noise, d.shape)
        d = np.where(rng.uniform(size=d.shape) < 0.05, np.nan, d).astype(np.float32)
        rgb = rng.integers(0, 256, d.shape + (3,)).astype(np.float32)
        yield m, d, rgb


def _sizes(cfg, B):
    """Capacity and update budget for bricks of B^3 on cfg's grid: 4096 and
    2048 rows of 8^3 scaled to hold the same voxels, at least every brick
    of the grid (and the dump row) and a budget of 64."""
    n_bricks = (cfg.xres // B) * (cfg.yres // B) * (cfg.zres // B)
    capacity = max(4096 * 512 // B ** 3, n_bricks + 1)
    return capacity, min(capacity - 1, max(2048 * 512 // B ** 3, 64))


def _volumes(dev, mode, options=None, n=4, step=0.5, noise=0.0, B=8):
    """Two brick volumes of B^3 bricks fused from the same frames, the
    first through the fusion kernel, the second through the plain engine."""
    cfg = CFG if mode is None else CFG.with_updates(integrate_color=True, color_mode=mode)
    cfg = cfg.with_updates(**(options or {}))
    capacity, budget = _sizes(cfg, B)
    vols = [tb.make_brick_volume(cfg, B, capacity, device=dev) for _ in range(2)]
    for pose, depth, rgb in _frames(cfg, n, step, noise):
        for v, kernel in zip(vols, (True, False)):
            tb.integrate_bricks(v, depth, pose, None if mode is None else rgb, budget,
                                use_kernel=kernel)
    torch.cuda.synchronize()
    return vols


# (color mode, config options, frames, orbit step in rad, depth noise in m,
# brick size). The variance gate engages above 5 samples, so that case fuses
# 8 nearby views; its per-frame noise keeps M > 0 (identical observations
# make the gate's exp a 0/0). Bricks of 6 take the kernels' division path
# on a 96^3 grid; bricks of 2 and 4 put several rows in a fusion block,
# bricks of 16 and 32 a row in several.
B96 = {"xres": 96, "yres": 96, "zres": 96}
FUSION_CASES = {
    "plain": (None, {}, 4, 0.5, 0.0, 8),
    "rgb": ("RGB", {}, 4, 0.5, 0.0, 8),
    "rgb_normalized": ("RGBNormalized", {}, 4, 0.5, 0.0, 8),
    "lab": ("LAB", {}, 4, 0.5, 0.0, 8),
    "weight_by_depth": ("RGB", {"weight_by_depth": True}, 4, 0.5, 0.0, 8),
    "weight_by_variance": (None, {"weight_by_depth": True, "weight_by_variance": True},
                           8, 0.05, 0.0015, 8),
    "no_frustum_culling": ("RGB", {"frustum_culling": False}, 4, 0.5, 0.0, 8),
    "brick_2": ("RGB", {}, 4, 0.5, 0.0, 2),
    "brick_4": ("RGB", {}, 4, 0.5, 0.0, 4),
    "brick_6_of_96": ("RGB", B96, 4, 0.5, 0.0, 6),
    "brick_16": ("RGB", {}, 4, 0.5, 0.0, 16),
    "brick_32": ("RGB", {}, 4, 0.5, 0.0, 32),
    "brick_6_of_96_lab": ("LAB", B96, 4, 0.5, 0.0, 6),
}


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_kernel_matches_plain(cuda_device, case):
    """Weight, nsample and RGB color exact; sdf and M within 1e-5;
    RGBNormalized and LAB color within 1e-4: the kernel evaluates their
    sqrt, powf and divisions with the CUDA math library in update_color's
    order, but PyTorch's own CUDA kernels are free to evaluate pow and the
    reciprocal of a scalar divisor another way, a few ulp apart, and the
    error then averages into the color over the frames. Covers the kernel's
    option branches: depth weighting, the variance gate, no frustum
    culling, all three color modes, and brick sizes 2, 4, 6, 16 and 32
    beside 8."""
    mode, options, n, step, noise, B = FUSION_CASES[case]
    before = fk.launches["fusion"]
    k, p = _volumes(cuda_device, mode, options, n, step, noise, B)
    assert fk.launches["fusion"] == before + n
    assert int(k.n_active) > min(100, k.capacity // 4) and not bool(k.overflowed)
    if options.get("weight_by_variance"):
        assert int((k.nsample > 6).sum()) > 1000  # the gate ran on many voxels
    for name in ("brick_map", "coords", "n_active", "nsample"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    # exact weight; NaN equals NaN, for voxels clamped to +max_dist_pos in
    # every frame have M == 0 and a gate of exp(-0/0), as in the reference
    torch.testing.assert_close(k.weight, p.weight, atol=0, rtol=0, equal_nan=True)
    for name in ("sdf", "M"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name), atol=1e-5, rtol=0,
                                   equal_nan=True)
    if mode == "RGB":
        assert torch.equal(k.color, p.color)
    elif mode is not None:
        torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0, equal_nan=True)


def test_fusion_kernel_rejects_bad_input(cuda_device):
    vol = tb.make_brick_volume(CFG, 8, 64, device=cuda_device)
    rows = torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)
    pose = torch.eye(4, device=cuda_device)
    depth = torch.ones((CFG.image_height, CFG.image_width), device=cuda_device)
    with pytest.raises(ValueError):
        fk.fuse_bricks(CFG, rows.to(torch.int64), pose, depth, vol.sdf, vol.weight,
                       vol.M, vol.nsample)
    with pytest.raises(ValueError):
        fk.fuse_bricks(CFG, rows, pose, depth.t(), vol.sdf, vol.weight, vol.M,
                       vol.nsample)


# (color mode of the volume, color_by_rgb, color_by_confidence, a brick
# list with count = 0 bricks and a moved global transform, brick size,
# config options)
MC_CASES = {
    "no_color": (None, False, False, False, 8, {}),
    "rgb": ("RGB", True, False, False, 8, {}),
    "confidence": ("RGB", False, True, False, 8, {}),
    "lab": ("LAB", True, False, False, 8, {}),
    "zero_count_bricks": ("RGB", True, False, True, 8, {}),
    "brick_2": ("RGB", True, False, True, 2, {}),
    "brick_4": ("RGB", True, False, True, 4, {}),
    "brick_6_of_96": ("RGB", True, False, True, 6, B96),
    "brick_16": ("RGB", True, False, True, 16, {}),
    "brick_32": ("RGB", True, False, True, 32, {}),
}


@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_kernels_match_plain(cuda_device, case):
    """The corner halo (count, cube table, triangle counts and the live
    corner rows exact) and the emission (triangles, cube references and
    vertices bit-equal) against their plain versions on the card, then the
    kernel route's mesh against the plain route's, colors included. The
    count = 0 cases put dead, out-of-range and negative slots between the
    candidates and move the global transform; the brick-size cases run
    the kernels' template instances for 2, 4, 6 (on a 96^3 grid), 16 (one
    17^3 halo a brick) and 32 (the halo in x-slabs)."""
    mode, rgb, conf, zero, B, options = MC_CASES[case]
    vol, _ = _volumes(cuda_device, mode, options, B=B)
    cand = mc._candidate_slots(vol, 0.5)
    assert cand.shape[0] > min(50, vol.capacity // 16)
    if zero:
        C = vol.capacity
        dead = torch.tensor([C - 1, C + 5, -3], dtype=torch.int32, device=cuda_device)
        cand = torch.cat([dead, cand[:7], dead, cand[7:], dead])
        a = 0.5
        moved = torch.tensor([[np.cos(a), -np.sin(a), 0.0, 0.2], [np.sin(a), np.cos(a), 0.0, -0.1],
                              [0.0, 0.0, 1.0, 0.8], [0.0, 0.0, 0.0, 1.0]],
                             dtype=torch.float32, device=cuda_device)
        vol = dataclasses.replace(vol, global_transform=moved)
    before = dict(mc.launches)
    count, cube, corners, ntri = mc.corner_halo(vol, cand, 0.5)
    pcount, pcube, pcorners, pntri = mc._corner_halo_plain(vol, cand, 0.5)
    live = torch.arange(B ** 3, device=cuda_device)[None] < count[:, None]
    assert torch.equal(count, pcount) and torch.equal(cube, pcube) and torch.equal(ntri, pntri)
    assert torch.equal(corners[live], pcorners[live])
    if zero:
        assert int((count == 0).sum()) >= 9 and (cube[:3] == -1).all()
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n = int(ends[-1])
    vk, tk = mc.emit_triangles(vol, cand, count, cube, corners, ends - ntri, n)
    vp, tp = mc._emit_plain(vol, cand, count, cube, corners, ends - ntri, n)
    torch.cuda.synchronize()
    assert mc.launches == {"corner_halo": before["corner_halo"] + 1, "emit": before["emit"] + 1}
    assert vk.shape == vp.shape and torch.equal(tk, tp)
    assert torch.equal(vk, vp), int((vk != vp).any(-1).any(-1).sum())
    sk = mc.extract_soup_bricks(vol, 0.5, rgb, conf, use_kernel=True)
    sp = mc.extract_soup_bricks(vol, 0.5, rgb, conf, use_kernel=False)
    assert sk.num_triangles == sp.num_triangles > 1000
    assert torch.equal(sk.vertices, sp.vertices)
    assert (sk.colors is None) == (sp.colors is None) == (not (rgb or conf))
    if sk.colors is not None:
        assert torch.equal(sk.colors, sp.colors)


@pytest.mark.parametrize("B", range(2, 35, 2))
def test_every_brick_size_runs_the_kernels(cuda_device, B):
    """At every even brick size up to 34, integrate_bricks and
    extract_soup_bricks on the card launch the fusion kernel once a frame
    and, given a first extraction's budget hints, the corner halo and the
    emission once a live chunk (no plain version on the card), and give the
    plain routes' volume and mesh. The grid is the multiple of B nearest 96
    from above."""
    res = -(-96 // B) * B
    cfg = CFG.with_updates(xres=res, yres=res, zres=res, integrate_color=True,
                           color_mode="RGB")
    capacity, budget = _sizes(cfg, B)
    k, p = (tb.make_brick_volume(cfg, B, capacity, device=cuda_device) for _ in range(2))
    fk.launches["fusion"] = 0
    mc.launches.update(corner_halo=0, emit=0)
    for n, (pose, depth, rgb) in enumerate(_frames(cfg, 2), 1):
        tb.integrate_bricks(k, depth, pose, rgb, budget)
        assert fk.launches["fusion"] == n
        tb.integrate_bricks(p, depth, pose, rgb, budget, use_kernel=False)
    assert fk.launches["fusion"] == 2 and not bool(k.overflowed)
    for name in ("brick_map", "coords", "weight", "nsample", "color"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert float((k.sdf - p.sdf).abs().max()) <= 1e-5
    first = mc.extract_soup_bricks(k, 0.5, True)
    mc.launches.update(corner_halo=0, emit=0)
    sk = mc.extract_soup_bricks(k, 0.5, True, live_chunks=first.live_chunks,
                                budget_hint=first.budget_hint)
    n = len(first.live_chunks)
    assert mc.launches == {"corner_halo": n, "emit": n}
    sp = mc.extract_soup_bricks(k, 0.5, True, use_kernel=False)
    assert mc.launches == {"corner_halo": n, "emit": n}
    assert torch.equal(sk.vertices, first.vertices)
    assert sk.num_triangles == sp.num_triangles > 500
    assert torch.equal(sk.vertices, sp.vertices) and torch.equal(sk.colors, sp.colors)


def test_mc_kernels_refuse_bricks_past_shared_memory(cuda_device):
    """The corner halo stages two (B+1)^2 halo layers in a block's shared
    memory (ROADMAP, deliberate differences): bricks of 118^3, the largest
    that fit an H100's 227 KB, mesh through both MC kernels as the plain
    route does; bricks of 120^3 are refused with a ValueError that names
    the limit, and fusion takes them."""
    for B in (118, 120):
        cfg = CFG.with_updates(xres=2 * B, yres=2 * B, zres=2 * B)
        vol = tb.make_brick_volume(cfg, B, 9, device=cuda_device)
        pose, depth, _ = next(_frames(cfg, 1))
        tb.integrate_bricks(vol, depth, pose, None, 8)
        assert int(vol.n_active) > 0 and not bool(vol.overflowed)
        mc.launches.update(corner_halo=0, emit=0)
        if B == 118:
            sk = mc.extract_soup_bricks(vol, 0.5, use_kernel=True)
            sp = mc.extract_soup_bricks(vol, 0.5, use_kernel=False)
            assert mc.launches["corner_halo"] == mc.launches["emit"] >= 1
            assert sk.num_triangles == sp.num_triangles > 500
            assert torch.equal(sk.vertices, sp.vertices)
            continue
        slots = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            mc.corner_halo(vol, slots, 0.5)
        assert mc.launches == {"corner_halo": 0, "emit": 0}


def test_mc_empty_extractions_launch_nothing(cuda_device):
    """An empty volume has no candidate: its one chunk program (fixed
    shapes: the halo over dead slots, an emission whose blocks return at
    once) gives the empty soup; a brick list of dead slots has no crossing
    cube, and no emission is launched for a budget of zero triangles."""
    vol = tb.make_brick_volume(CFG.with_updates(integrate_color=True, color_mode="RGB"), 8,
                               64, device=cuda_device)
    before = dict(mc.launches)
    soup = mc.extract_soup_bricks(vol, 0.5, True)
    assert soup.num_triangles == 0 and soup.colors.shape == (0, 3, 3)
    assert soup.live_chunks == (0,) and not bool(soup.overflowed)
    assert mc.launches == {k: v + 1 for k, v in before.items()}
    before = dict(mc.launches)
    dead = torch.tensor([vol.capacity - 1, vol.capacity + 2], dtype=torch.int32,
                        device=cuda_device)
    count, cube, corners, ntri = mc.corner_halo(vol, dead, 0.5)
    assert int(count.sum()) == 0 and int(ntri.sum()) == 0 and (cube == -1).all()
    verts, tri_cube = mc.emit_triangles(vol, dead, count, cube, corners,
                                        torch.zeros_like(ntri), 0)
    assert verts.shape == (0, 3, 3) and tri_cube.shape == (0,)
    assert mc.launches == {"corner_halo": before["corner_halo"] + 1, "emit": before["emit"]}


def test_mc_bound_bytes():
    """The MC kernels' least traffic: the corner halo reads each candidate's
    9^3 halo of d and w and writes its cube table, two counts and 32 B of
    corners a crossing cube (the former dense stack wrote 40 B a voxel);
    the emission reads 36 B a crossing cube and writes 40 B a triangle."""
    assert mc.bytes_moved_corner_halo(2078, 0) == 2078 * (5832 + 2048 + 8)
    assert mc.bytes_moved_corner_halo(1, 10) - mc.bytes_moved_corner_halo(1, 0) == 320
    assert mc.bytes_moved_dense_stack(2078) == 54_676_336
    assert mc.bytes_moved_emit(2, 3, 5) == 2 * 24 + 3 * 36 + 48 + 5 * 40


# (config options, brick size of the render: 0 = dense, downsample_by,
# camera distance from the centre). The volume is fused in 8^3 bricks; a
# 96^3 grid re-bricked at B = 6 takes the kernel's division path. The far
# camera sees the sphere small: its rays enter the volume late and most of
# them miss.
RENDER_CASES = {
    "trilinear": ({}, 8, 1, 1.0),
    "nearest": ({"use_trilinear_interpolation": False}, 8, 1, 1.0),
    "asymmetric_truncation": ({"max_dist_pos": 0.08, "max_dist_neg": 0.03}, 8, 1, 1.0),
    "downsample_by_2": ({}, 8, 2, 1.0),
    "dense": ({}, 0, 1, 1.0),
    "brick_4": ({}, 4, 1, 1.0),
    "brick_6_of_96": ({"xres": 96, "yres": 96, "zres": 96}, 6, 1, 1.0),
    "camera_far_outside": ({}, 8, 1, 1.8),
}


def _render_volume(dev, options, brick):
    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB", **options)
    vol = tb.make_brick_volume(cfg, 8, 4096, device=dev)
    for pose, depth, rgb in _frames(cfg):
        tb.integrate_bricks(vol, depth, pose, rgb, 2048)
    if brick == 0:
        return tb.to_dense(vol)
    return vol if brick == 8 else tb.from_dense(tb.to_dense(vol), brick_size=brick)


def assert_channels_equal(k, p, what):
    """All 8 channels bit-equal, with enough valid rays to mean something."""
    assert int((p[3] > 0).sum()) > 1000, what
    for c, name in enumerate(rk.CHANNELS):
        assert torch.equal(k[c], p[c]), (what, name, int((k[c] != p[c]).sum()))


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_raycast_kernel_matches_plain(cuda_device, case):
    """The ray-march kernel against march_plain on the same rays, bit for
    bit (dense layout; bricks of 8, 4 and 6, the last on the division path;
    both interpolation modes, asymmetric truncation, a downsampled camera, a
    far camera whose rays mostly miss), then render_view's two routes end
    to end."""
    options, brick, ds, distance = RENDER_CASES[case]
    vol = _render_volume(cuda_device, options, brick)
    packed = tb.pack_render(vol)
    pose = torch.as_tensor(orbit_pose(0.3, orbit_radius=distance), device=cuda_device)
    origins, dirs = rc.camera_rays(vol.config, pose, ds)
    origins, dirs = origins.contiguous(), dirs.contiguous()
    before = rk.launches["raycast"]
    k = rk.march(packed, origins, dirs)
    p = rk.march_plain(packed, origins, dirs)
    torch.cuda.synchronize()
    assert rk.launches["raycast"] == before + 1
    assert_channels_equal(k, p, case)
    if distance > 1.0:
        assert float(p[1].mean()) < 0.5, "the far camera's rays should mostly miss"
    vk, vp = (rc.render_view(vol, pose, ds, colored=True, use_kernel=u) for u in (True, False))
    assert rk.launches["raycast"] == before + 2
    both = ~torch.isnan(vk.depth) & ~torch.isnan(vp.depth)
    assert float((vk.depth[both] - vp.depth[both]).abs().max()) <= 1e-5
    cb = ~torch.isnan(vk.rgb[..., 0]) & ~torch.isnan(vp.rgb[..., 0])
    assert torch.equal(vk.rgb[cb], vp.rgb[cb])


def test_tile_width():
    """The ray march tiles its warps 8x4 over camera images whose rows are a
    multiple of 32 long and come in groups of 4 (the card cases above take
    both routes: 160x120 tiled, 80x60 in rows); other ray counts get rows."""
    cfg = TSDFConfig()  # 640x480
    assert rk.tile_width(cfg, 640 * 480) == 640
    assert rk.tile_width(cfg, 320 * 240) == 320
    assert rk.tile_width(cfg, 213 * 160) == 0
    assert rk.tile_width(cfg, 1000) == 0
    assert rk.tile_width(CFG, 160 * 120) == 160
    assert rk.tile_width(CFG, 80 * 60) == 0


def test_fusion_bound_bytes():
    """Frame 24 of chip_smoke's main path (2109 live rows, RGB, 640x480):
    state and color of every voxel of a live row, both images once; the
    bound of the observed voxels alone counts fewer state bytes. Its
    operations: every voxel projected and frustum-tested, the observed ones
    updated (and colored)."""
    assert fk.bytes_moved(2109, 480, 640, 3) == 65_384_448
    assert fk.bytes_moved(2109, 480, 640, 0) == 2109 * 512 * 32 + 480 * 640 * 4
    assert fk.voxel_bytes(2109 * 512, 480, 640, 3) == fk.bytes_moved(2109, 480, 640, 3)
    assert fk.voxel_bytes(0, 480, 640, 3) == 480 * 640 * 16
    rgb = CFG.with_updates(integrate_color=True, color_mode="RGB")
    assert fk.ops_needed(rgb, 2109 * 512, 0) == 2109 * 512 * (42 + 35)
    assert fk.ops_needed(rgb, 10, 4) == 10 * 77 + 4 * (19 + 15)
    assert fk.ops_needed(CFG.with_updates(frustum_culling=False), 10, 4) == 10 * 42 + 4 * 19


def test_probe_tail_cut():
    """tools/kernel_probe.py times a scratch copy of raycast.cu without the
    refinement and normals; the line it drops must stay in the source."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("kernel_probe",
                                                  root / "tools" / "kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "cpu_tsdf_tpu_torch" / "csrc" / "raycast.cu").read_text()
    cut = probe.tail_cut(src)
    assert probe.TAIL_CALL not in cut and len(cut) == len(src) - len(probe.TAIL_CALL)
    with pytest.raises(RuntimeError):
        probe.tail_cut(cut)


def test_probe_direct_store():
    """tools/kernel_probe.py times a scratch copy of mc_emit.cu whose threads
    store their own triangles; the three passages it replaces must stay in
    the source."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("kernel_probe",
                                                  root / "tools" / "kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (root / "cpu_tsdf_tpu_torch" / "csrc" / "mc_emit.cu").read_text()
    direct = probe.direct_store(src)
    assert "st_v" not in direct and "st_c" not in direct
    assert direct.count("tri_cube[base + first + i] = ref;") == 1
    with pytest.raises(RuntimeError):
        probe.direct_store(direct)


def test_probe_block_width():
    """tools/kernel_probe.py times the MC kernels at other block widths by
    rewriting their one kThreads line, which the kernels' other sizes
    derive from."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("kernel_probe",
                                                  root / "tools" / "kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    srcs = probe.mc_sources(root / "cpu_tsdf_tpu_torch" / "csrc")
    assert "constexpr int kThreads = 128;" in srcs["mc_corner_halo"]
    assert "constexpr int kThreads = 128;" in srcs["mc_emit"]
    for name, text in srcs.items():
        assert text.count("constexpr int kThreads = ") == 1, name
    assert "constexpr int kThreads = 512;" in srcs["mc_corner_halo_512"]
    assert "constexpr int kThreads = 64;" in srcs["mc_emit_64"]
    with pytest.raises(RuntimeError):
        probe.block_width("int x;", 64)


def test_raycast_kernel_rejects_bad_input(cuda_device):
    vol = tb.pack_render(tb.make_brick_volume(CFG, 8, 64, device=cuda_device))
    rays = torch.zeros((10, 3), device=cuda_device)
    with pytest.raises(ValueError):
        rk.march(vol, rays.double(), rays)
    with pytest.raises(ValueError):
        rk.march(dataclasses.replace(vol, rd=vol.rd.t()), rays, rays)


def test_depth_gradients_kernel_route_match_plain(cuda_device):
    """render_depth_diff's gradients for the sdf and the pose through the
    kernel's forward equal those through the plain march's, within 1e-5
    relative to the largest entry."""
    vol = _render_volume(cuda_device, {}, 8)
    grads = []
    for use_kernel in (True, False):
        sdf = vol.sdf.clone().requires_grad_(True)
        pose = torch.as_tensor(orbit_pose(0.3), device=cuda_device).requires_grad_(True)
        d, valid, ok = rk.render_depth_diff(dataclasses.replace(vol, sdf=sdf), pose,
                                            use_kernel=use_kernel)
        assert ok is True and int(valid.sum()) > 1000
        (torch.where(valid, d, 0.0).sum() / valid.sum()).backward()
        grads.append((sdf.grad, pose.grad))
    (gk_sdf, gk_pose), (gp_sdf, gp_pose) = grads
    assert int((gk_sdf != 0).sum()) > 50 and float(gk_pose[2, 3]) != 0.0
    for gk, gp in ((gk_sdf, gp_sdf), (gk_pose, gp_pose)):
        assert torch.isfinite(gk).all()
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())


def test_render_view_gradients_kernel_route_match_plain(cuda_device):
    """render_view's gradients of a seeded weighting of the points and the
    normals, for the sdf and the pose, through the kernel's forward equal
    those through the plain march's within 1e-5 relative to the largest
    entry (the brackets are bit-equal; the scatter's atomic adds may sum in
    another order); the kernel route launches the kernel once."""
    vol = _render_volume(cuda_device, {}, 8)
    H, W = CFG.image_height, CFG.image_width
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    wts = torch.randn((2, H, W, 3), generator=gen, device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        sdf = vol.sdf.clone().requires_grad_(True)
        pose = torch.as_tensor(orbit_pose(0.3), device=cuda_device).requires_grad_(True)
        before = rk.launches["raycast"]
        r = rc.render_view(dataclasses.replace(vol, sdf=sdf), pose, use_kernel=use_kernel)
        assert rk.launches["raycast"] == before + int(use_kernel)
        assert int((~torch.isnan(r.normals[..., 0])).sum()) > 1000
        (torch.nansum(r.points * wts[0]) + torch.nansum(r.normals * wts[1])).backward()
        grads.append((sdf.grad, pose.grad))
    (gk_sdf, gk_pose), (gp_sdf, gp_pose) = grads
    assert int((gk_sdf != 0).sum()) > 50 and float(gk_pose[2, 3]) != 0.0
    for gk, gp in ((gk_sdf, gp_sdf), (gk_pose, gp_pose)):
        assert torch.isfinite(gk).all()
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())


def _write_cli_sequence(dirname, n=4):
    """PCD + pose .txt pairs of CFG's camera orbiting a radius-0.3 sphere
    0.8 m away, colored."""
    from cpu_tsdf_tpu_torch.io import pcd

    W, H = CFG.image_width, CFG.image_height
    fx, cx, cy = CFG.focal_length_x, CFG.principal_point_x, CFG.principal_point_y
    rng = np.random.default_rng(2)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    os.makedirs(dirname)
    for i in range(n):
        pose = orbit_pose(0.4 * i, orbit_radius=0.8)
        z = sphere_depth_world(CFG, pose, radius=0.3)
        pts = np.stack([(uu - cx) / fx * z, (vv - cy) / fx * z, z], -1).reshape(-1, 3)
        rgb = rng.integers(0, 256, (W * H, 3)).astype(np.float32)
        fields = {"x": pts[:, 0].astype(np.float32), "y": pts[:, 1].astype(np.float32),
                  "z": pts[:, 2].astype(np.float32), "rgb": pcd.pack_rgb(rgb)}
        pcd.save_pcd(os.path.join(dirname, f"cloud_{i:04d}.pcd"),
                     pcd.PointCloud(fields, W, H), "binary")
        with open(os.path.join(dirname, f"pose_{i:04d}.txt"), "w") as f:
            for row in pose[:3]:
                f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


@pytest.mark.parametrize("brick", [8, 16])
def test_cli_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch, brick):
    """integrate (--sparse --color --visualize-every 2, bricks of 8 and of
    16) with TSDF_DEVICE=cuda and =cpu: the volumes to the fusion
    tolerances (weight, nsample, color exact; sdf and M within 1e-5), the
    same triangles; the card run launched all four kernels."""
    from cpu_tsdf_tpu_torch.cli import integrate_main
    from cpu_tsdf_tpu_torch.io.ply import load_ply

    seq = str(tmp_path / "seq")
    _write_cli_sequence(seq)
    args = ["--in", seq, "--volume-size", "1.6", "--cell-size", "0.0125",
            "--width", str(CFG.image_width), "--height", str(CFG.image_height),
            "--fx", "140", "--fy", "140", "--cx", "80", "--cy", "60",
            "--trunc-dist-pos", "0.04", "--trunc-dist-neg", "0.04",
            "--min-sensor-dist", "0.1", "--max-cell-size", "0.2", "--sparse",
            "--brick-size", str(brick), "--brick-capacity", str(4096 * 512 // brick ** 3),
            "--color", "--save-tsdf", "--visualize-every", "2"]
    rk.launches["raycast"] = 0
    fk.launches["fusion"] = 0
    mc.launches.update(corner_halo=0, emit=0)
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("TSDF_DEVICE", dev)
        assert integrate_main(args + ["--out", str(tmp_path / dev)]) == 0
        if dev == "cuda":
            counts = {"fusion": fk.launches["fusion"], "raycast": rk.launches["raycast"],
                      **mc.launches}
    assert counts == {"fusion": 4, "raycast": 2, "corner_halo": 1, "emit": 1}, counts
    with np.load(tmp_path / "cuda" / "volume.npz") as a, \
            np.load(tmp_path / "cpu" / "volume.npz") as b:
        assert a.files == b.files
        for k in a.files:
            if k in ("sdf", "M"):
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (va, fa, ca), (vb, fb, cb) = (load_ply(str(tmp_path / d / "mesh.ply"))
                                  for d in ("cuda", "cpu"))
    assert len(fa) == len(fb) > 1000
    np.testing.assert_allclose(va, vb, atol=1e-5)
    np.testing.assert_array_equal(ca, cb)
    assert os.path.exists(tmp_path / "cuda" / "viz_0003_normals.png")


def test_render_rays_defaults_to_the_kernel(cuda_device):
    """render_rays on CUDA tensors launches the ray-march kernel unless the
    caller asks for the plain march, and takes an unpacked volume; both
    routes give the same channels."""
    vol = _render_volume(cuda_device, {}, 4)
    origins, dirs = rc.camera_rays(CFG, torch.as_tensor(orbit_pose(0.3), device=cuda_device))
    rk.launches["raycast"] = 0
    k = rc.render_rays(vol, origins, dirs)
    assert rk.launches["raycast"] == 1
    p = rc.render_rays(vol, origins, dirs, use_kernel=False)
    assert rk.launches["raycast"] == 1 and int(k["valid"].sum()) > 1000
    for name in k:
        assert torch.equal(k[name], p[name]), name


def test_refine_pose_step_card_matches_cpu(cuda_device):
    """One Gauss-Newton step of refine.py on the card and on the CPU, from
    the same volume and observation: pose and loss within 1e-4 (the card
    sums in another order); the rotation does not move on either."""
    from cpu_tsdf_tpu_torch.refine import exp_se3, refine_pose_step

    vol = _render_volume(cuda_device, {}, 8)
    cpu = dataclasses.replace(vol, **{f.name: getattr(vol, f.name).cpu() for f in
                                      dataclasses.fields(vol)
                                      if isinstance(getattr(vol, f.name), torch.Tensor)})
    pose = orbit_pose(0.3)
    depth = sphere_depth_world(CFG, pose, radius=0.5)
    bad = (exp_se3(torch.tensor([0.024, -0.018, 0.015, 0.0, 0.0, 0.0])).numpy()
           @ pose).astype(np.float32)
    (pk, lk), (pc, lc) = (refine_pose_step(v, bad, depth, 1) for v in (vol, cpu))
    assert pk.device.type == "cuda" and lk.device.type == "cuda"
    np.testing.assert_allclose(pk.cpu().numpy(), pc.numpy(), atol=1e-4)
    assert abs(float(lk) - float(lc)) <= 1e-4 * float(lc) and float(lc) > 0
    np.testing.assert_array_equal(pk.cpu().numpy()[:3, :3], bad[:3, :3])


def test_relay_march_kernel_matches_plain(cuda_device):
    """The ray-march kernel's relay mode (the volume-sharded render's
    march) against the plain relay march on the card, slab by slab in 2
    and 4 slabs of an oblique view: the channels bit-equal, and equal to
    one kernel march of the whole volume."""
    from torch_parallel_worker import relay_by_slabs

    pack = tb.pack_render(_render_volume(cuda_device, {}, 8))
    origins, dirs = (t.contiguous() for t in rc.camera_rays(
        CFG, torch.as_tensor(orbit_pose(0.8), device=cuda_device)))
    one = rk.march(pack, origins, dirs)
    rk.launches["raycast"] = 0
    for D in (2, 4):
        k, segments = relay_by_slabs(rk.march, pack, origins, dirs, D)
        p, _ = relay_by_slabs(rk.march_plain, pack, origins, dirs, D)
        assert segments >= 2 and int((one[3] > 0).sum()) > 1000
        assert torch.equal(k, p) and torch.equal(k, one), D
    assert rk.launches["raycast"] >= 4


# ---------------------------------------------------------------------------
# the graphed frame, sequence and render (cpu_tsdf_tpu_torch/graph.py)
# ---------------------------------------------------------------------------

STATE = ("sdf", "weight", "M", "nsample", "color", "brick_map", "coords", "n_active",
         "overflowed")


def assert_states_equal(a, b, what):
    """Every state tensor bit-equal (NaN where NaN)."""
    for name in STATE:
        x, y = getattr(a, name), getattr(b, name)
        if x.is_floating_point():
            assert torch.equal(x.isnan(), y.isnan()), (what, name)
            x, y = x.nan_to_num(), y.nan_to_num()
        assert torch.equal(x, y), (what, name)


def _graph_frames(dev, cfg, n=3):
    return [(torch.as_tensor(p, dtype=torch.float32, device=dev), torch.as_tensor(d, device=dev),
             torch.as_tensor(c, device=dev)) for p, d, c in _frames(cfg, n)]


@pytest.mark.parametrize("B,splits", [(8, 1), (4, 1), (16, 1), (8, 3)])
def test_graphed_frames_equal_eager(cuda_device, B, splits):
    """On a 128^3 volume, 3 colored frames: the graphed sequence, graphed
    per-frame calls and eager calls give bit-equal state (sdf, weight, M,
    nsample, color, brick_map, coords, n_active, overflowed) at bricks of 4,
    8 and 16, and with the jitter (num_random_splits = 3: a per-frame call
    draws the seed-0 jitter every frame, a sequence fresh jitter a frame,
    by either route). The fusion kernel counts one launch a frame on the
    graphed routes too."""
    from cpu_tsdf_tpu_torch import graph as tg

    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB", num_random_splits=splits)
    capacity, budget = _sizes(cfg, B)
    frames = _graph_frames(cuda_device, cfg)
    vols = {k: tb.make_brick_volume(cfg, B, capacity, device=cuda_device)
            for k in ("seq_graph", "seq_eager", "frame_graph", "frame_eager")}
    depths, poses, rgbs = (torch.stack([f[i] for f in frames]) for i in (1, 0, 2))
    fk.launches["fusion"] = 0
    tb.integrate_bricks_sequence(vols["seq_graph"], depths, poses, rgbs, budget)
    assert fk.launches["fusion"] == 3
    tb.integrate_bricks_sequence(vols["seq_eager"], depths, poses, rgbs, budget, graph=False)
    for pose, depth, rgb in frames:
        tb.integrate_bricks(vols["frame_graph"], depth, pose, rgb, budget)
        tb.integrate_bricks(vols["frame_eager"], depth, pose, rgb, budget, graph=False)
    torch.cuda.synchronize()
    assert fk.launches["fusion"] == 12
    assert int(vols["seq_graph"].n_active) > 100 and not bool(vols["seq_graph"].overflowed)
    assert_states_equal(vols["seq_graph"], vols["seq_eager"], "sequence")
    assert_states_equal(vols["frame_graph"], vols["frame_eager"], "frames")
    if splits == 1:
        assert_states_equal(vols["seq_graph"], vols["frame_graph"], "sequence and frames")
    assert all(s["pool_mb"] >= 0 and s["capture_ms"] > 0 for s in tg.stats())


def test_graph_recaptures_after_volume_replaced(cuda_device):
    """A volume replaced (its state tensors copied, as load_checkpoint
    gives a new volume) gets a graph of its own: the new frames land in the
    new volume, equal to the eager route's, and leave the old one as it
    was."""
    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 4)
    old = tb.make_brick_volume(cfg, 8, 4096, device=cuda_device)
    ref = tb.make_brick_volume(cfg, 8, 4096, device=cuda_device)
    for pose, depth, rgb in frames[:2]:
        tb.integrate_bricks(old, depth, pose, rgb, 2048)
        tb.integrate_bricks(ref, depth, pose, rgb, 2048, graph=False)
    new = dataclasses.replace(old, **{name: getattr(old, name).clone() for name in STATE})
    kept = dataclasses.replace(old, **{name: getattr(old, name).clone() for name in STATE})
    for pose, depth, rgb in frames[2:]:
        tb.integrate_bricks(new, depth, pose, rgb, 2048)
        tb.integrate_bricks(ref, depth, pose, rgb, 2048, graph=False)
    torch.cuda.synchronize()
    assert_states_equal(new, ref, "replaced volume")
    assert_states_equal(old, kept, "old volume")
    assert not torch.equal(new.weight, old.weight)


def test_graphed_render_equals_eager(cuda_device):
    """The graphed render_view (a brick volume and its packed view,
    colored) equals the eager one bit for bit; a render's result is not
    overwritten by the next render; each render launches the march once."""
    vol = _render_volume(cuda_device, {}, 8)
    packed = tb.pack_render(vol)
    poses = [torch.as_tensor(orbit_pose(a), dtype=torch.float32, device=cuda_device)
             for a in (0.3, 0.9, 1.5)]
    for v in (vol, packed):
        rk.launches["raycast"] = 0
        graphed = [rc.render_view(v, p, colored=True) for p in poses]
        assert rk.launches["raycast"] == len(poses)
        eager = [rc.render_view(v, p, colored=True, graph=False) for p in poses]
        torch.cuda.synchronize()
        for g, e in zip(graphed, eager):
            assert int((~e.depth.isnan()).sum()) > 1000
            for name in ("points", "normals", "depth", "rgb"):
                x, y = getattr(g, name), getattr(e, name)
                assert torch.equal(x.isnan(), y.isnan()) and torch.equal(
                    x.nan_to_num(), y.nan_to_num()), name
        assert not torch.equal(graphed[0].depth.nan_to_num(), graphed[1].depth.nan_to_num())
    with pytest.raises(ValueError):
        rc.render_view(vol, poses[0], use_kernel=False, graph=True)


def test_frames_and_renders_do_not_sync(cuda_device):
    """Under torch.cuda.set_sync_debug_mode("error"), an eager frame, a
    graphed frame and a graphed render raise nothing: no op of theirs waits
    for the card."""
    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 3)
    vols = [tb.make_brick_volume(cfg, 8, 4096, device=cuda_device) for _ in range(2)]
    pose, depth, rgb = frames[0]
    tb.integrate_bricks(vols[0], depth, pose, rgb, 2048, graph=False)
    tb.integrate_bricks(vols[1], depth, pose, rgb, 2048)
    rc.render_view(vols[1], pose, colored=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pose, depth, rgb in frames[1:]:
            tb.integrate_bricks(vols[0], depth, pose, rgb, 2048, graph=False)
            tb.integrate_bricks(vols[1], depth, pose, rgb, 2048)
            rc.render_view(vols[1], pose, colored=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert_states_equal(vols[0], vols[1], "eager and graphed frames")


def test_traced_graphs_stamp_every_replay(cuda_device):
    """With tracing on, the graphed sequence and renders capture graphs of
    their own (the key holds the tracing state) whose stamps run at every
    replay: each frame and render stamps each of its stages once, the
    stages lie inside their call, the state and the renders are bit-equal
    to tracing off, and frames and renders under
    set_sync_debug_mode("error") raise nothing."""
    from cpu_tsdf_tpu_torch import graph as tg
    from cpu_tsdf_tpu_torch import tracing

    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 3)
    depths, poses, rgbs = (torch.stack([f[i] for f in frames]) for i in (1, 0, 2))
    vols = [tb.make_brick_volume(cfg, 8, 4096, device=cuda_device) for _ in range(2)]
    tb.integrate_bricks_sequence(vols[0], depths, poses, rgbs, 2048)
    plain = [rc.render_view(vols[0], p, colored=True) for p in poses]
    tg.clear()
    tracing.enable()
    try:
        tb.integrate_bricks_sequence(vols[1], depths, poses, rgbs, 2048)
        traced = [rc.render_view(vols[1], p, colored=True) for p in poses]
        rep = tracing.report()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tb.integrate_bricks_sequence(vols[1], depths[:1], poses[:1], rgbs[:1], 2048)
            rc.render_view(vols[1], poses[0], colored=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        tracing.disable()
    for name in ("activation", "allocation", "batch"):
        assert rep["stages"][f"frame.{name}"]["count"] == 3
    for name in ("rays", "pack", "march", "finish"):
        assert rep["stages"][f"render.{name}"]["count"] == 3
    calls = rep["calls"]
    assert calls["count"] == 4 and rep["dropped"] == {"spans": 0, "stamps": 0}
    staged = sum(v["total_ms"] for v in rep["stages"].values())
    assert 0 < staged <= calls["call_ms"] and calls["call_ms"] <= calls["window_ms"]
    assert rep["counters"]["graph.captures"] == 2 and rep["counters"]["graph.replays"] == 4
    assert {"render_view", "integrate_bricks_sequence", "frame", "graph.lookup",
            "graph.replay", "render.fresh_result"} <= set(rep["spans"])
    torch.cuda.synchronize()
    vols[0] = tb.integrate_bricks_sequence(vols[0], depths[:1], poses[:1], rgbs[:1], 2048)
    assert_states_equal(vols[0], vols[1], "traced and untraced frames")
    for a, b in zip(plain, traced):
        for name in ("points", "normals", "rgb"):
            assert torch.equal(getattr(a, name).nan_to_num(), getattr(b, name).nan_to_num())


def _valid_rows(soup):
    """A soup's valid triangles and their colors, in order."""
    colors = None if soup.colors is None else soup.colors[soup.tri_valid]
    return soup.vertices[soup.tri_valid], colors


def assert_soups_equal(a, b, what):
    """Equal tri_valid, num_triangles, overflowed, valid vertices and
    colors (the rows past a chunk's count are unspecified)."""
    for name in ("tri_valid", "num_triangles", "overflowed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)
    (av, ac), (bv, bc) = _valid_rows(a), _valid_rows(b)
    assert torch.equal(av, bv) and torch.equal(ac, bc), what


def test_graphed_extraction_equals_eager(cuda_device):
    """The unchecked extraction with the checked route's hints, in chunks
    of 64 slots: its CUDA graph (the default on the card) and the eager
    route give equal tri_valid, num_triangles, overflowed, valid vertices
    and colors, the valid triangles are the checked route's in order, each
    call counts one launch of each MC kernel a live chunk, and a result is
    not overwritten by the next call. An eager call raises nothing under
    set_sync_debug_mode("error"). A hint of a quarter of each budget sets
    overflowed; graph=True raises on the plain route, and the checked route
    with graph=True (its stats and chunk graphs) gives the checked
    triangles."""
    vol = _render_volume(cuda_device, {}, 8)
    checked = mc.extract_soup_bricks(vol, 0.5, True, False, 64)
    n = len(checked.live_chunks)
    assert n >= 2 and int(checked.num_triangles) > 1000 and not bool(checked.overflowed)
    hint = dict(live_chunks=checked.live_chunks, budget_hint=checked.budget_hint, check=False)
    mc.launches.update(corner_halo=0, emit=0)
    graphed = [mc.extract_soup_bricks(vol, 0.5, True, False, 64, **hint) for _ in range(3)]
    assert mc.launches == {"corner_halo": 3 * n, "emit": 3 * n}
    eager = mc.extract_soup_bricks(vol, 0.5, True, False, 64, **hint, graph=False)
    torch.cuda.synchronize()
    for g in graphed:
        assert_soups_equal(g, eager, "graphed and eager")
    assert graphed[0].vertices.data_ptr() != graphed[1].vertices.data_ptr()
    assert not bool(eager.overflowed) and int(eager.num_triangles) == int(checked.num_triangles)
    ev, ec = _valid_rows(eager)
    assert torch.equal(ev, checked.vertices) and torch.equal(ec, checked.colors)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = mc.extract_soup_bricks(vol, 0.5, True, False, 64, **hint, graph=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert_soups_equal(again, eager, "eager under the sync debug mode")
    small = tuple(tuple(b // 4 for b in h) for h in checked.budget_hint)
    for graph in (None, False):
        soup = mc.extract_soup_bricks(vol, 0.5, True, False, 64, live_chunks=checked.live_chunks,
                                      budget_hint=small, check=False, graph=graph)
        assert bool(soup.overflowed)
    with pytest.raises(ValueError):
        mc.extract_soup_bricks(vol, 0.5, True, False, 64, **hint, use_kernel=False, graph=True)
    # the checked route takes graph=True on the card: the brick stats'
    # graph replayed a live chunk, a chunk graph a budget triple a chunk
    assert_checked_equal(mc.extract_soup_bricks(vol, 0.5, True, False, 64, graph=True),
                         mc.extract_soup_bricks(vol, 0.5, True, False, 64, graph=False),
                         "checked, graph=True and graph=False")


def assert_checked_equal(a, b, what):
    """Two checked soups: bit-equal vertices and colors, equal counts,
    live chunks and budget hints."""
    assert int(a.num_triangles) == int(b.num_triangles) > 0, what
    assert torch.equal(a.vertices, b.vertices), what
    assert (a.colors is None) == (b.colors is None), what
    assert a.colors is None or torch.equal(a.colors, b.colors), what
    assert a.live_chunks == b.live_chunks and a.budget_hint == b.budget_hint, what


def test_extraction_graph_recaptures_after_volume_replaced(cuda_device):
    """A replaced volume (its state tensors copied) gets an extraction
    graph of its own: after two more frames fused into the copy, its
    graphed unchecked extraction equals its eager one and its checked one;
    the old volume's graph still gives the old mesh."""
    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 4)
    old = tb.make_brick_volume(cfg, 8, 4096, device=cuda_device)
    for pose, depth, rgb in frames[:2]:
        tb.integrate_bricks(old, depth, pose, rgb, 2048)
    soups = {}
    for name, vol in (("old", old), ("new", None)):
        if vol is None:
            vol = dataclasses.replace(old, **{k: getattr(old, k).clone() for k in STATE})
            for pose, depth, rgb in frames[2:]:
                tb.integrate_bricks(vol, depth, pose, rgb, 2048)
        checked = mc.extract_soup_bricks(vol, 0.5, True)
        hint = dict(live_chunks=checked.live_chunks, budget_hint=checked.budget_hint,
                    check=False)
        graphed = mc.extract_soup_bricks(vol, 0.5, True, **hint)
        assert_soups_equal(graphed, mc.extract_soup_bricks(vol, 0.5, True, **hint, graph=False),
                           name)
        assert torch.equal(_valid_rows(graphed)[0], checked.vertices)
        soups[name] = (vol, hint, graphed)
    assert int(soups["new"][2].num_triangles) != int(soups["old"][2].num_triangles)
    vol, hint, graphed = soups["old"]
    assert_soups_equal(mc.extract_soup_bricks(vol, 0.5, True, **hint), graphed, "old again")


def test_emit_budget_bound_matches_plain(cuda_device):
    """The emission under a tri_budget below the mesh's triangle count
    stores the triangles below it: vertices and cube references bit-equal
    to the plain version's truncation and to the unbounded emission's
    first rows; a budget past the count stores every triangle."""
    vol, _ = _volumes(cuda_device, "RGB")
    cand = mc._candidate_slots(vol, 0.5)
    count, cube, corners, ntri = mc.corner_halo(vol, cand, 0.5)
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n, off = int(ends[-1]), ends - ntri
    full_v, full_t = mc.emit_triangles(vol, cand, count, cube, corners, off, n)
    for budget in (1, n // 3, n - 1, n + 100):
        vk, tk = mc.emit_triangles(vol, cand, count, cube, corners, off, budget)
        vp, tp = mc._emit_plain(vol, cand, count, cube, corners, off, budget)
        m = min(n, budget)
        assert vk.shape == vp.shape == (budget, 3, 3)
        assert torch.equal(vk[:m], vp[:m]) and torch.equal(tk[:m], tp[:m]), budget
        assert torch.equal(vk[:m], full_v[:m]) and torch.equal(tk[:m], full_t[:m]), budget


def test_graphed_refine_step_equals_eager(cuda_device):
    """refine_pose_step and depth_residual through their CUDA graphs (the
    default on the card) equal the eager route bit for bit at three step
    scales (the scale is a static input buffer); refine_pose gives the same
    losses and pose both ways; an eager step and residual raise nothing
    under set_sync_debug_mode("error")."""
    from cpu_tsdf_tpu_torch.refine import depth_residual, exp_se3, refine_pose, refine_pose_step

    vol = _render_volume(cuda_device, {}, 8)
    pose = orbit_pose(0.3)
    depth = torch.as_tensor(sphere_depth_world(CFG, pose, radius=0.5), device=cuda_device)
    bad = torch.as_tensor((exp_se3(torch.tensor([0.024, -0.018, 0.015, 0.0, 0.0, 0.0])).numpy()
                           @ pose).astype(np.float32), device=cuda_device)
    for lr in (1.0, 0.25, 1.0):
        pg, lg = refine_pose_step(vol, bad, depth, 1, 256, lr)
        pe, le = refine_pose_step(vol, bad, depth, 1, 256, lr, graph=False)
        assert torch.equal(pg, pe) and torch.equal(lg, le), lr
        assert torch.equal(depth_residual(vol, pg, depth, 1),
                           depth_residual(vol, pe, depth, 1, graph=False))
    assert not torch.equal(refine_pose_step(vol, bad, depth, 1, 256, 0.25)[0], pg)
    (pose_g, losses_g), (pose_e, losses_e) = (
        refine_pose(vol, bad, depth, iters=4, downsample_by=1, graph=g) for g in (None, False))
    assert losses_g == losses_e and torch.equal(pose_g, pose_e) and losses_g[-1] < losses_g[0]
    lr = torch.full((), 1.0, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        refine_pose_step(vol, bad, depth, 1, 256, lr, graph=False)
        depth_residual(vol, bad, depth, 1, graph=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_graphed_organize_equals_eager(cuda_device):
    """organize_cloud through its CUDA graph (the default on the card)
    equals the eager route bit for bit, with and without color, for two
    cloud lengths that share a padded graph and one that does not; a result
    is not overwritten by the next call."""
    from cpu_tsdf_tpu_torch.pipeline import organize_cloud

    rng = np.random.default_rng(3)
    outs = []
    for n in (3000, 2500, 5000):
        pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        pts[:, 2] += 1.2
        pts[rng.uniform(size=n) < 0.05, 2] = np.nan
        rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
        for colors in (rgb, None):
            g = organize_cloud(CFG, pts, colors, device=cuda_device)
            e = organize_cloud(CFG, pts, colors, device=cuda_device, graph=False)
            assert torch.equal(g[0].isnan(), e[0].isnan())
            assert torch.equal(g[0].nan_to_num(), e[0].nan_to_num())
            assert (g[1] is None) == (colors is None)
            if colors is not None:
                assert torch.equal(g[1], e[1])
            outs.append((g[0].clone(), g[0]))
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in outs)
    assert int((~outs[0][0].isnan()).sum()) > 1000


# ---------------------------------------------------------------------------
# the checked extraction's graphs and the dense fusion kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [8, 4])
def test_graphed_checked_extraction_equals_eager(cuda_device, B):
    """The checked extraction (chunks of 64 slots) at bricks of 8 and 4,
    with the default budgets and with a cube budget of 32, which sends
    chunks to a retry batch: its graphs (the default on the card: the
    brick stats' graph replayed a live chunk, one chunk graph a budget
    triple replayed a chunk) and the eager route give bit-equal triangles,
    colors, live chunks and
    hints; each graphed call launches the MC kernels as often as an eager
    one; a result is not overwritten by the next call. The default budgets
    take one chunk graph, the small one several (one a budget triple)."""
    from cpu_tsdf_tpu_torch import graph as tg

    vol = _render_volume(cuda_device, {}, B)
    for budget in (1 << 15, 32):
        tg.clear()
        mc.launches.update(corner_halo=0, emit=0)
        eager = mc.extract_soup_bricks(vol, 0.5, True, False, 64, budget, graph=False)
        per_call = dict(mc.launches)
        graphed = [mc.extract_soup_bricks(vol, 0.5, True, False, 64, budget)
                   for _ in range(3)]
        torch.cuda.synchronize()
        assert mc.launches == {k: 4 * v for k, v in per_call.items()}, (B, budget)
        assert len(eager.live_chunks) >= 2 and int(eager.num_triangles) > 1000
        for g in graphed:
            assert_checked_equal(g, eager, f"B={B}, cube budget {budget}")
        assert graphed[0].vertices.data_ptr() != graphed[1].vertices.data_ptr()
        kinds = [g["kind"] for g in tg.stats()]
        # the brick stats' graph and one chunk graph a budget triple: the
        # retries double the budgets batch by batch
        assert kinds.count("extract_checked_stats") == 1, kinds
        assert (kinds.count("extract_checked_chunk") == 1) == (budget > 32), kinds
        if budget == 32:
            assert per_call["emit"] > len(eager.live_chunks)  # chunks ran again


def _dense_cfg(mode, options):
    cfg = CFG if mode is None else CFG.with_updates(integrate_color=True, color_mode=mode)
    return cfg.with_updates(**options)


# (color mode, config options, frames, orbit step in rad, depth noise in m,
# first x-plane of the slab: 0 = the whole grid, else planes [x0, x0 + 48)).
# zres 90 is not a multiple of 4: the kernel's one-voxel-a-thread path.
DENSE_CASES = {
    "plain": (None, {}, 4, 0.5, 0.0, 0),
    "rgb": ("RGB", {}, 4, 0.5, 0.0, 0),
    "rgb_normalized": ("RGBNormalized", {}, 4, 0.5, 0.0, 0),
    "lab": ("LAB", {}, 4, 0.5, 0.0, 0),
    "no_frustum_culling": ("RGB", {"frustum_culling": False}, 4, 0.5, 0.0, 0),
    "weights": (None, {"weight_by_depth": True, "weight_by_variance": True}, 8, 0.05, 0.0015,
                0),
    "slab_x0_40": ("RGB", {}, 4, 0.5, 0.0, 40),
    "zres_90": ("RGB", {"zres": 90}, 4, 0.5, 0.0, 0),
}


def assert_dense_equal(k, p, mode, what):
    """fusion's tolerances: weight (NaN where NaN), nsample and RGB color
    exact; sdf and M within 1e-5; RGBNormalized and LAB color within 1e-4
    (see test_fusion_kernel_matches_plain)."""
    assert torch.equal(k.nsample, p.nsample), what
    torch.testing.assert_close(k.weight, p.weight, atol=0, rtol=0, equal_nan=True, msg=what)
    for name in ("sdf", "M"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name), atol=1e-5, rtol=0,
                                   equal_nan=True, msg=what)
    if mode == "RGB":
        assert torch.equal(k.color, p.color), what
    elif mode is not None:
        torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0, equal_nan=True,
                                   msg=what)


def _dense_clone(vol):
    return dataclasses.replace(vol, **{k: getattr(vol, k).clone()
                                       for k in ("sdf", "weight", "M", "nsample", "color")
                                       if getattr(vol, k) is not None})


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_kernel_matches_plain(cuda_device, case):
    """ops.fusion.integrate_slab through the dense kernel (its default on
    the card) against integrate_slab_plain, frame after frame on a 128^3
    grid: all three color modes, frustum culling off, the depth and
    variance weights, a slab of planes [40, 88) and a grid whose zres is
    not a multiple of 4 (the one-voxel route). The kernel updates the
    donated volume in place: each frame returns the input's own tensors,
    one launch a frame, and the plain version runs on a clone of the state
    each frame starts from; the sequences are compared too."""
    from cpu_tsdf_tpu_torch import make_volume
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab, integrate_slab_plain

    mode, options, n, step, noise, x0 = DENSE_CASES[case]
    cfg = _dense_cfg(mode, options)
    vol = make_volume(cfg, device=cuda_device)
    if x0:
        vol = dataclasses.replace(vol, **{k: getattr(vol, k)[x0:x0 + 48].clone()
                                          for k in ("sdf", "weight", "M", "nsample", "color")
                                          if getattr(vol, k) is not None})
    k, p = vol, _dense_clone(vol)
    fk.launches["dense_fusion"] = 0
    for i, (pose, depth, rgb) in enumerate(_frames(cfg, n, step, noise)):
        rgb = None if mode is None else rgb
        start = _dense_clone(k)
        out = integrate_slab(k, depth, pose, rgb, x0)
        assert out.sdf is k.sdf and out.nsample is k.nsample and out.color is k.color
        assert_dense_equal(out, integrate_slab_plain(start, depth, pose, rgb, x0), mode,
                           f"{case}: frame {i} from one state")
        k = out
        p = integrate_slab_plain(p, depth, pose, rgb, x0)
    torch.cuda.synchronize()
    assert fk.launches["dense_fusion"] == n
    assert int((k.weight > 0).sum()) > 1000
    if options.get("weight_by_variance"):
        assert int((k.nsample > 6).sum()) > 1000  # the gate ran on many voxels
    assert_dense_equal(k, p, mode, case)


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_dense_kernel_cull_cases(cuda_device, case):
    """The dense kernel's column cull at the cases of the CPU tests
    (tests/torch_common.py) on a 48^3 grid: a tilted view, a camera
    outside the volume, columns parallel to the image plane (b_z = 0), the
    optical axis along z, a slab of planes [16, 40), an all-NaN frame, a
    +inf reading and min_sensor_dist 0. The intervals the kernel writes
    equal dense_column_intervals column for column, and the frame fused in
    place equals integrate_slab_plain on a clone, bit for bit."""
    from cpu_tsdf_tpu_torch import make_volume
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab_plain

    cfg, pose, depth, x0, nx = cull_frame(case)
    pose = torch.as_tensor(pose, device=cuda_device)
    depth = torch.as_tensor(depth, device=cuda_device)
    vol = make_volume(cfg, device=cuda_device)
    vol = dataclasses.replace(vol, **{k: getattr(vol, k)[x0:x0 + nx].clone()
                                      for k in ("sdf", "weight", "M", "nsample")})
    start = _dense_clone(vol)
    iv = torch.full((nx * cfg.yres, 2), -7, dtype=torch.int32, device=cuda_device)
    out = fk.fuse_dense(vol, depth, pose, None, x0, intervals=iv)
    p = integrate_slab_plain(start, depth, pose, None, x0)
    lo, hi = fk.dense_column_intervals(cfg, rigid_inverse(pose), depth, x0, nx)
    torch.cuda.synchronize()
    assert torch.equal(iv.long(), torch.stack([lo.reshape(-1), hi.reshape(-1)], 1)), case
    for name in ("sdf", "weight", "M", "nsample"):
        torch.testing.assert_close(getattr(out, name), getattr(p, name), atol=0, rtol=0,
                                   equal_nan=True, msg=f"{case}: {name}")
    n_obs = int((p.nsample > 0).sum())
    assert n_obs == 0 if case == "all_nan" else n_obs > 50, case


def test_dense_kernel_gradients_match_plain(cuda_device):
    """integrate's gradients of a seeded weighting of the new sdf, M and
    color, for the depth, the pose, the rgb image and the old sdf, through
    the kernel's forward and through the plain version's, within 1e-5
    relative to the largest entry, NaN at the same entries (both backwards
    recompute the plain version; its gathers' backward adds with atomics,
    in any order). Under autograd the kernel runs on a copy: the input
    volume is left as it was."""
    from cpu_tsdf_tpu_torch import integrate, make_volume

    cfg = _dense_cfg("RGB", {})
    frames = list(_frames(cfg, 3))
    vol = make_volume(cfg, device=cuda_device)
    for pose, depth, rgb in frames[:2]:
        vol = integrate(vol, depth, pose, rgb)
    pose, depth, rgb = frames[2]
    before = _dense_clone(vol)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    wts = torch.randn((3,) + vol.sdf.shape, generator=gen, device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        ins = [torch.as_tensor(x, device=cuda_device).requires_grad_(True)
               for x in (depth, pose, rgb)]
        sdf = vol.sdf.clone().requires_grad_(True)
        launched = fk.launches["dense_fusion"]
        out = integrate(dataclasses.replace(vol, sdf=sdf), *ins, use_kernel=use_kernel)
        assert fk.launches["dense_fusion"] == launched + int(use_kernel)
        loss = (torch.nansum(out.sdf * wts[0]) + torch.nansum(out.M * wts[1])
                + torch.nansum(out.color * wts[2][..., None]))
        grads.append(torch.autograd.grad(loss, ins + [sdf]))
        torch.cuda.synchronize()
        assert torch.equal(sdf.detach(), before.sdf)
        assert_dense_equal(vol, before, "RGB", f"the input, use_kernel={use_kernel}")
    for name, gk, gp in zip(("depth", "pose", "rgb", "sdf"), *grads):
        # NaN where the plain version's is: the missing depth pixels and
        # the voxels that see them (a NaN observation times the zero
        # cotangent of an unobserved voxel)
        assert torch.equal(gk.isnan(), gp.isnan()), name
        assert not gk.isnan().any() if name in ("pose", "rgb") else \
            float(gk.isnan().float().mean()) < 0.5, name
        gk, gp = gk.nan_to_num(), gp.nan_to_num()
        scale = float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= 1e-5 * scale, name
        assert name == "rgb" or scale > 0, name   # trunc passes no gradient to rgb


def test_dense_kernel_version_counters(cuda_device):
    """A frame under autograd, then a no-grad frame fused in place into the
    volume it returned: a tensor that autograd saved from the first frame's
    output raises in the backward (the kernel moves the version counters
    on), and the first frame's own saved inputs are untouched, so a
    backward that saved no output gives the gradient it gives without the
    second frame."""
    from cpu_tsdf_tpu_torch import integrate, make_volume

    cfg = _dense_cfg("RGB", {})
    frames = list(_frames(cfg, 3))
    pose, depth, rgb = frames[0]
    vol = integrate(make_volume(cfg, device=cuda_device), depth, pose, rgb)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wts = torch.randn(vol.sdf.shape, generator=gen, device=cuda_device)
    pose, depth, rgb = frames[1]
    grads = []
    for second_frame in (False, True):
        d = torch.as_tensor(depth, device=cuda_device).requires_grad_(True)
        out = integrate(_dense_clone(vol), d, pose, rgb)
        saved = torch.nansum(out.sdf ** 2)   # pow saves out.sdf
        plain = torch.nansum(out.sdf * wts)  # saves wts only
        if second_frame:
            version = out.sdf._version
            pose2, depth2, rgb2 = frames[2]
            with torch.no_grad():
                again = integrate(out, depth2, pose2, rgb2)
            assert again.sdf is out.sdf and out.sdf._version > version
            with pytest.raises(RuntimeError, match="modified by an inplace operation"):
                torch.autograd.grad(saved, d, retain_graph=True)
        (g,) = torch.autograd.grad(plain, d)
        grads.append(g)
    torch.cuda.synchronize()
    # within 1e-5 of the largest entry: the backward's gathers add with
    # atomics, in any order
    assert torch.equal(grads[0].isnan(), grads[1].isnan())
    g0, g1 = grads[0].nan_to_num(), grads[1].nan_to_num()
    scale = float(g0.abs().max())
    assert scale > 0 and float((g0 - g1).abs().max()) <= 1e-5 * scale


def test_dense_kernel_64bit_offsets(cuda_device):
    """A 1024 x 1024 x 704 grid with RGB color (3 m wide; its color tensor
    has 2.2e9 entries, past 2^31; 21 GB of state) fused from one
    frame of a camera at x = +2 m looking at the sphere, in place: the
    kernel's last 8 x-planes equal integrate_slab_plain on a copy of those
    planes of the input."""
    from cpu_tsdf_tpu_torch import TSDFVolume, integrate, make_volume
    from cpu_tsdf_tpu_torch.ops.fusion import integrate_slab_plain

    torch.cuda.empty_cache()
    cfg = TSDFConfig().with_updates(xres=1024, yres=1024, zres=704, zsize=3.0 * 704 / 1024,
                                    integrate_color=True, color_mode="RGB")
    pose = orbit_pose(np.pi / 2, orbit_radius=2.0)
    depth = sphere_depth_world(cfg, pose, radius=0.5)
    rgb = np.random.default_rng(5).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    vol = make_volume(cfg, device=cuda_device)
    assert vol.color.numel() > 2 ** 31
    x0 = cfg.xres - 8
    last = TSDFVolume(**{k: getattr(vol, k)[x0:].clone()
                         for k in ("sdf", "weight", "M", "nsample", "color")},
                      global_transform=vol.global_transform, config=cfg)
    out = integrate(vol, depth, pose, rgb)   # in place: vol is donated
    del vol
    p = integrate_slab_plain(last, depth, pose, rgb, x0)
    k = TSDFVolume(**{k: getattr(out, k)[x0:] for k in ("sdf", "weight", "M", "nsample", "color")},
                   global_transform=out.global_transform, config=cfg)
    torch.cuda.synchronize()
    assert int((p.weight > 0).sum()) > 1000 and int((p.color > 0).sum()) > 1000
    assert_dense_equal(k, p, "RGB", "the last 8 planes")


# ---------------------------------------------------------------------------
# brick activation (csrc/activation.cu)
# ---------------------------------------------------------------------------

def assert_same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (what, a, b)


def activation_routes_equal(dev, case):
    """Every frame of an activation case (tests/torch_common.py) through
    the kernels and the plain code, on `dev` (routes_equal)."""
    return routes_equal(dev, *activation_case(case))


def routes_equal(dev, cfg, B, frames, budget, tile_budget, capacity):
    """Frames [(pose, depth)] through the activation kernels and the plain
    code, on `dev`: the mips' tables and level table, the band list and
    its counts under `tile_budget`, the carve list, and frame_update_list's
    batch list and overflow after allocation with the two volumes'
    allocation state, all bit-equal. Returns the kernel launches each
    frame made and the last frame's plain band count and overflow."""
    vols = [tb.make_brick_volume(cfg, B, capacity, device=dev) for _ in range(2)]
    nb = vols[0].bricks_per_axis
    carve_budget = tb.frame_budgets(vols[0], budget)[1]
    before = dict(ak.launches)
    for pose, depth in frames:
        p = torch.as_tensor(pose, device=dev)
        d = torch.as_tensor(depth, device=dev)
        pinv = rigid_inverse(p)
        mips = [ta.depth_mips(d, ta.mip_base_level(cfg, B), kernel=k) for k in (True, False)]
        for name in mips[1]._fields:
            x, y = getattr(mips[0], name), getattr(mips[1], name)
            if isinstance(y, torch.Tensor):
                assert_same(x, y, name)
            else:
                assert x == y, name
        band = [ta.band_candidate_bricks(cfg, B, nb, m, pinv, budget, tile_budget, kernel=k)
                for m, k in zip(mips, (True, False))]
        for x, y, name in zip(*band, ("cand", "counts", "overflow")):
            assert_same(x, y, name)
        coords = vols[1].coords
        carve = [ta.carve_slots(cfg, B, m, pinv, coords, carve_budget, kernel=k)
                 for m, k in zip(mips, (True, False))]
        for x, y, name in zip(*carve, ("carve", "n_carve")):
            assert_same(x, y, name)
        lists = [tb.frame_update_list(v, d, pinv, budget, p, kernel=k)
                 for v, k in zip(vols, (True, False))]
        for x, y, name in zip(*lists, ("bx", "by", "bz", "slot_ok", "slots", "overflow")):
            assert_same(x, y, name)
        for name in ("brick_map", "coords", "n_active", "overflowed"):
            assert_same(getattr(vols[0], name), getattr(vols[1], name), name)
    made = {k: (ak.launches[k] - before[k]) // len(frames) for k in before}
    return made, int(band[1][1][0]), bool(band[1][2])


@pytest.mark.parametrize("case", list(ACTIVATION_CASES))
def test_activation_kernels_match_plain(cuda_device, case):
    """csrc/activation.cu against the plain activation on the card, bit for
    bit, frame by frame (activation_routes_equal): the orbit at bricks of
    4, 8, 16 and 32, a tilted camera, NaN dropouts, a camera inside the
    volume, each budget overflowing alone. Each kernel launches twice a
    frame (the pieces, then frame_update_list)."""
    made, n_band, _ = activation_routes_equal(cuda_device, case)
    assert made == dict.fromkeys(made, 2), made
    assert n_band > 0 or case == "carve_budget"


def test_activation_kernels_match_plain_at_room_size(cuda_device):
    """InfiniTAM's published deployment (5 mm voxels: 600^3 over 3 m, mu
    0.02 m, depth 0.2-3.0 m, a pool of 2^18 rows of 8^3) with an update
    budget of 2^16, on 640x480 frames of the benchmark's room sweep
    (portbench/scenes/room.py), every 15th: the activation kernels against
    the plain code (routes_equal) under the tile and carve budgets the
    frame derives, bit for bit, with lists of ~35k band bricks, ~1.5k tiles
    and ~90k rough bricks a frame, and no budget overflowed."""
    from portbench import core

    params = core.load_json(core.HERE / "traffic/room_scan.json")["scene_params"]
    cfg = TSDFConfig(xres=600, yres=600, zres=600, max_dist_pos=0.02, max_dist_neg=0.02,
                     min_sensor_dist=0.2, max_sensor_dist=3.0)
    fr = core.scene_module("room").frames(params, cfg, cuda_device)
    frames = [(fr["poses"][i], fr["depths"][i]) for i in range(0, 120, 15)]
    budget, capacity = 1 << 16, 1 << 18
    nb = (cfg.xres // 8,) * 3
    made, n_band, overflow = routes_equal(cuda_device, cfg, 8, frames, budget,
                                          tb.tile_budget_for(budget, nb), capacity)
    assert made == dict.fromkeys(made, 2), made
    assert 20000 < n_band <= budget and not overflow


def test_traced_frame_graph_records_list_counts(cuda_device):
    """With tracing on, the frame graph records each frame's list counts
    (activation.lists: tiles, rough, band, carve; one row a frame, the
    capture's warm-up frame included) equal to the eager plain route's on
    the same frames; frames fused after tracing is turned off, through
    untraced graphs, record nothing."""
    from cpu_tsdf_tpu_torch import graph as tg
    from cpu_tsdf_tpu_torch import tracing

    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 6)
    depths, poses, rgbs = (torch.stack([f[i] for f in frames]) for i in (1, 0, 2))
    vols = [tb.make_brick_volume(cfg, 8, 4096, device=cuda_device) for _ in range(3)]
    tg.clear()
    tracing.enable()
    try:
        tb.integrate_bricks_sequence(vols[0], depths, poses, rgbs, 2048)
        graphed = tracing.report()["counters"]
        tb.integrate_bricks_sequence(vols[1], depths, poses, rgbs, 2048, use_kernel=False,
                                     graph=False)
        plain = tracing.report()["counters"]
    finally:
        tracing.disable()
    tb.integrate_bricks_sequence(vols[2], depths, poses, rgbs, 2048)
    off = tracing.report()["counters"]
    names = {f"{tb.LIST_COUNTS}.{n}" for n in ("tiles", "rough", "band", "carve")}
    assert names <= set(graphed) and not names & set(off)
    lists = {k: graphed[k] for k in names}
    assert all(v["count"] == 6 and v["max"] <= v["budget"] for v in lists.values()), lists
    assert lists == {k: plain[k] for k in names} and lists[f"{tb.LIST_COUNTS}.band"]["max"] > 100
    assert_states_equal(vols[0], vols[2], "traced and untraced frames")


def test_depth_mips_kernels_every_base_level(cuda_device):
    """The mip kernels' tables, level table and global bounds equal the
    plain depth_mips at every base level (a base texel of 1 to 2^18
    pixels: texels a warp shares, a warp's, a block's, several blocks'
    worth) on images with NaN dropouts, +inf readings, an all-NaN row
    band and sizes that are not powers of two."""
    rng = np.random.default_rng(3)
    for H, W in ((120, 160), (30, 40), (480, 640), (5, 300)):
        depth = rng.uniform(0.3, 3.0, (H, W)).astype(np.float32)
        depth[rng.uniform(size=depth.shape) < 0.05] = np.nan
        depth[H // 3: H // 2] = np.nan
        depth[0, W - 1] = np.inf
        d = torch.as_tensor(depth, device=cuda_device)
        for base in range(10):
            k, p = (ta.depth_mips(d, base, kernel=kernel) for kernel in (True, False))
            for name in p._fields:
                x, y = getattr(k, name), getattr(p, name)
                if isinstance(y, torch.Tensor):
                    assert_same(x, y, (H, W, base, name))
                else:
                    assert x == y, (H, W, base, name)


@pytest.mark.parametrize("slab", [(0, 4), (4, 5), (12, 4), (3, 10)])
def test_activation_kernels_slab_matches_plain(cuda_device, slab):
    """band_candidate_bricks with an x_slab, as the sharded route calls it
    (bricks of 8 on 128^3: 16 bricks an axis, tiles of 4): the kernels'
    list equals the plain code's, and is the global list filtered to the
    slab."""
    cfg, B, frames, budget, tile_budget, _ = activation_case("tilted")
    pose, depth = frames[0]
    pinv = rigid_inverse(torch.as_tensor(pose, device=cuda_device))
    d = torch.as_tensor(depth, device=cuda_device)
    mips = ta.depth_mips(d, ta.mip_base_level(cfg, B), kernel=True)
    nb = (16, 16, 16)
    out = [ta.band_candidate_bricks(cfg, B, nb, mips, pinv, budget, x_slab=slab, kernel=k)
           for k in (True, False)]
    for x, y, name in zip(*out, ("cand", "counts", "overflow")):
        assert_same(x, y, name)
    whole = ta.band_candidate_bricks(cfg, B, nb, mips, pinv, budget, kernel=True)[0]
    whole = whole[whole >= 0]
    bx = whole // (16 * 16)
    want = whole[(bx >= slab[0]) & (bx < slab[0] + slab[1])]
    n = int(out[0][1][0])
    assert n > 0 and torch.equal(out[0][0][:n], want)


def test_graphed_activation_pass_does_not_sync(cuda_device):
    """A graphed 48-frame orbit pass (128^3, bricks of 8, RGB) through the
    kernel route, repeated under set_sync_debug_mode("error"): nothing
    syncs, every activation kernel counts one launch a frame in both
    passes, and the state equals the eager kernel route's bit for bit."""
    cfg = CFG.with_updates(integrate_color=True, color_mode="RGB")
    frames = _graph_frames(cuda_device, cfg, 48)
    depths, poses, rgbs = (torch.stack([f[i] for f in frames]) for i in (1, 0, 2))
    vols = [tb.make_brick_volume(cfg, 8, 4096, device=cuda_device) for _ in range(2)]
    before = dict(ak.launches)
    tb.integrate_bricks_sequence(vols[0], depths, poses, rgbs, 2048)
    torch.cuda.synchronize()
    assert {k: ak.launches[k] - before[k] for k in before} == dict.fromkeys(before, 48)
    before = dict(ak.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tb.integrate_bricks_sequence(vols[0], depths, poses, rgbs, 2048)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: ak.launches[k] - before[k] for k in before} == dict.fromkeys(before, 48)
    for _ in range(2):
        tb.integrate_bricks_sequence(vols[1], depths, poses, rgbs, 2048, graph=False)
    torch.cuda.synchronize()
    assert int(vols[0].n_active) > 500
    assert_states_equal(vols[0], vols[1], "graphed and eager kernel routes")
