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

import numpy as np
import pytest
import torch

from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
from cpu_tsdf_tpu_torch.ops import raycast as rc
from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

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


def _volumes(dev, mode, options=None, n=4, step=0.5, noise=0.0):
    cfg = CFG if mode is None else CFG.with_updates(integrate_color=True, color_mode=mode)
    cfg = cfg.with_updates(**(options or {}))
    vols = [tb.make_brick_volume(cfg, 8, 4096, device=dev) for _ in range(2)]
    for pose, depth, rgb in _frames(cfg, n, step, noise):
        for v, kernel in zip(vols, (True, False)):
            tb.integrate_bricks(v, depth, pose, None if mode is None else rgb, 2048,
                                use_kernel=kernel)
    torch.cuda.synchronize()
    return vols


# (color mode, config options, frames, orbit step in rad, depth noise in m).
# The variance gate engages above 5 samples, so that case fuses 8 nearby
# views; its per-frame noise keeps M > 0 (identical observations make the
# gate's exp a 0/0).
FUSION_CASES = {
    "plain": (None, {}, 4, 0.5, 0.0),
    "rgb": ("RGB", {}, 4, 0.5, 0.0),
    "rgb_normalized": ("RGBNormalized", {}, 4, 0.5, 0.0),
    "lab": ("LAB", {}, 4, 0.5, 0.0),
    "weight_by_depth": ("RGB", {"weight_by_depth": True}, 4, 0.5, 0.0),
    "weight_by_variance": (None, {"weight_by_depth": True, "weight_by_variance": True},
                           8, 0.05, 0.0015),
    "no_frustum_culling": ("RGB", {"frustum_culling": False}, 4, 0.5, 0.0),
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
    culling, and all three color modes."""
    mode, options, n, step, noise = FUSION_CASES[case]
    before = fk.launches["fusion"]
    k, p = _volumes(cuda_device, mode, options, n, step, noise)
    assert fk.launches["fusion"] == before + n
    assert int(k.n_active) > 100 and not bool(k.overflowed)
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
# list with count = 0 bricks and a moved global transform)
MC_CASES = {
    "no_color": (None, False, False, False),
    "rgb": ("RGB", True, False, False),
    "confidence": ("RGB", False, True, False),
    "lab": ("LAB", True, False, False),
    "zero_count_bricks": ("RGB", True, False, True),
}


@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_kernels_match_plain(cuda_device, case):
    """The corner halo (count, cube table, triangle counts and the live
    corner rows exact) and the emission (triangles, cube references and
    vertices bit-equal) against their plain versions on the card, then the
    kernel route's mesh against the plain route's, colors included. The
    count = 0 case puts dead, out-of-range and negative slots between the
    candidates and moves the global transform."""
    mode, rgb, conf, zero = MC_CASES[case]
    vol, _ = _volumes(cuda_device, mode)
    cand = mc._candidate_slots(vol, 0.5)
    assert cand.shape[0] > 50
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
    live = torch.arange(512, device=cuda_device)[None] < count[:, None]
    assert torch.equal(count, pcount) and torch.equal(cube, pcube) and torch.equal(ntri, pntri)
    assert torch.equal(corners[live], pcorners[live])
    if zero:
        assert int((count == 0).sum()) >= 9 and (cube[:3] == -1).all()
    ends = torch.cumsum(ntri, 0, dtype=torch.int32)
    n = int(ends[-1])
    vk, tk = mc.emit_triangles(vol, cand, count, cube, corners, ends - ntri, n)
    vp, tp = mc._emit_plain(vol, cand, count, cube, corners)
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


def test_mc_empty_extractions_launch_nothing(cuda_device):
    """An empty volume has no candidate; a brick list of dead slots has no
    crossing cube: both give the empty soup, and no emission is launched
    for zero triangles."""
    vol = tb.make_brick_volume(CFG.with_updates(integrate_color=True, color_mode="RGB"), 8,
                               64, device=cuda_device)
    before = dict(mc.launches)
    soup = mc.extract_soup_bricks(vol, 0.5, True)
    assert soup.num_triangles == 0 and soup.colors.shape == (0, 3, 3)
    assert mc.launches == before
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
    bound of the observed voxels alone counts fewer state bytes."""
    assert fk.bytes_moved(2109, 480, 640, 3) == 65_384_448
    assert fk.bytes_moved(2109, 480, 640, 0) == 2109 * 512 * 32 + 480 * 640 * 4
    assert fk.voxel_bytes(2109 * 512, 480, 640, 3) == fk.bytes_moved(2109, 480, 640, 3)
    assert fk.voxel_bytes(0, 480, 640, 3) == 480 * 640 * 16


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
