"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. The file imports neither jax nor the JAX package, so that it
runs where only PyTorch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite.)
The CPU parity of the plain versions with the JAX package is in the other
tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk
from cpu_tsdf_tpu_torch.ops import marching_cubes as mc
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
    "lab": ("LAB", {}, 4, 0.5, 0.0),
    "weight_by_depth": ("RGB", {"weight_by_depth": True}, 4, 0.5, 0.0),
    "weight_by_variance": (None, {"weight_by_depth": True, "weight_by_variance": True},
                           8, 0.05, 0.0015),
    "no_frustum_culling": ("RGB", {"frustum_culling": False}, 4, 0.5, 0.0),
}


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_kernel_matches_plain(cuda_device, case):
    """Weight, nsample and RGB color exact; sdf and M within 1e-5; LAB color
    within 1e-4 (the transform runs as the same tensor code, but its inputs
    may round differently once sdf does). Covers the kernel's option
    branches: depth weighting, the variance gate, no frustum culling."""
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
    elif mode == "LAB":
        torch.testing.assert_close(k.color, p.color, atol=1e-4, rtol=0)


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


def test_mc_kernels_match_plain(cuda_device):
    """Corner halo (stacks, filter, per-brick compaction) and pack-left
    exact; the kernel route's mesh equals the plain route's."""
    vol, _ = _volumes(cuda_device, "RGB")
    cand = mc._candidate_slots(vol, 0.5)
    assert cand.shape[0] > 50
    # a dead slot and an out-of-range one ride along: no cube, d = -1
    slots = torch.cat([cand, torch.tensor([vol.capacity - 1, vol.capacity + 5],
                                          dtype=torch.int32, device=cuda_device)])
    dk, okk, lk = mc.corner_halo(vol, slots, 0.5)
    dp, okp = mc._corner_stacks(vol, slots, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp) and torch.equal(okk, okp)
    assert torch.equal(lk, mc._pack_left_plain(okp))
    assert not okk[-2:].any() and (dk[-1024:] == -1).all()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for density in (0.0, 0.02, 0.5, 1.0):
        mask = (torch.rand((301, 512), generator=gen, device=cuda_device)
                < density).to(torch.int32)
        assert torch.equal(mc.pack_left_rows(mask), mc._pack_left_plain(mask))
    for rgb, conf in ((False, False), (True, False), (False, True)):
        sk = mc.extract_soup_bricks(vol, 0.5, rgb, conf, use_kernel=True)
        sp = mc.extract_soup_bricks(vol, 0.5, rgb, conf, use_kernel=False)
        assert sk.num_triangles == sp.num_triangles > 1000
        assert torch.equal(sk.vertices, sp.vertices)
        assert (sk.colors is None) == (sp.colors is None)
        if sk.colors is not None:
            assert torch.equal(sk.colors, sp.colors)
