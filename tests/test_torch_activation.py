"""Port parity: hierarchical brick activation against the JAX package.

The band candidate list, the carve mask and the budgeted compactions must
come out EXACTLY as in cpu_tsdf_tpu.activation — same ids in the same
(tile-major) order, same counts, same overflow flags — on the sphere scene,
the wide-FOV off-centre scene and the disocclusion (carve) scene.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_tsdf_tpu import activation as ja
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.config import TSDFConfig as JaxConfig
from cpu_tsdf_tpu.geometry import rigid_inverse as j_rigid_inverse
from cpu_tsdf_tpu.synthetic import plane_depth, sphere_depth
from cpu_tsdf_tpu_torch import activation as ta
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.geometry import rigid_inverse, transform_points
from cpu_tsdf_tpu_torch.synthetic import sphere_depth_world

from test_fusion import tilted_pose
import torch_common  # noqa: F401  (one intra-op thread)

WIDE_FOV = dict(xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
                max_dist_pos=0.06, max_dist_neg=0.06,
                min_sensor_dist=0.05, max_sensor_dist=3.0,
                image_width=640, image_height=480,
                focal_length_x=200.0, focal_length_y=200.0,
                principal_point_x=100.0, principal_point_y=240.0,
                max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4)


def _both(jcfg, depth, pose, B=8):
    """(jax mips, port mips, jax pose_inv, port pose_inv, port cfg)."""
    cfg = TSDFConfig.from_json(jcfg.to_json())
    jm = ja.depth_mips(jnp.asarray(depth), ja.mip_base_level(jcfg, B))
    tm = ta.depth_mips(torch.from_numpy(depth), ta.mip_base_level(cfg, B))
    pose = np.asarray(pose, np.float32)
    return jm, tm, j_rigid_inverse(jnp.asarray(pose)), rigid_inverse(torch.from_numpy(pose)), cfg


def _assert_band_equal(jcfg, depth, pose, budget):
    B = 8
    nb = (jcfg.xres // B, jcfg.yres // B, jcfg.zres // B)
    jm, tm, jinv, tinv, cfg = _both(jcfg, depth, pose, B)
    np.testing.assert_array_equal(tm.flat_min.numpy(), np.asarray(jm.flat_min))
    np.testing.assert_array_equal(tm.flat_max_d.numpy(), np.asarray(jm.flat_max_d))
    jc, jn, jo = ja.band_candidate_bricks(jcfg, B, nb, jm, jinv, budget)
    tc, tn, to = ta.band_candidate_bricks(cfg, B, nb, tm, tinv, budget)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn[0]) == int(jn) and bool(to) == bool(jo)
    return int(jn), bool(jo)


@pytest.mark.parametrize("budget", [1024, 32])
def test_band_candidates_sphere(small_cfg, budget):
    depth = sphere_depth(small_cfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    n, overflow = _assert_band_equal(small_cfg, depth, tilted_pose(), budget)
    # the small budget overflows, identically in both packages
    assert (n > 32 and not overflow) if budget > 32 else overflow


def test_band_candidates_wide_fov():
    jcfg = JaxConfig(**WIDE_FOV)
    depth = np.full((480, 640), 0.1, np.float32)
    depth[100:300, 50:400] = np.nan
    assert _assert_band_equal(jcfg, depth, tilted_pose(tz=-0.6), 4096)[0] > 0
    # the crafted camera-plane-straddling sphere of the JAX package's test
    _, tm, _, _, cfg = _both(jcfg, np.full((480, 640), 0.1, np.float32), np.eye(4))
    ok = ta._band_test(cfg, tm, torch.tensor([0.4975]), torch.tensor([0.0]),
                       torch.tensor([0.05]), torch.tensor([0.1]))
    assert bool(ok[0])


def test_carve_and_compaction_disocclusion(small_cfg):
    """Frame 1 (near sphere) allocates bricks; frame 2 (far plane) must list
    them all as carve candidates, identically in both packages."""
    pose = np.asarray(tilted_pose(), np.float32)
    near = sphere_depth(small_cfg, center=(-0.013, -0.021, 0.6), radius=0.2)
    far = plane_depth(small_cfg, z0=1.4)
    bv = jb.integrate_bricks(jb.make_brick_volume(small_cfg, 8, 2048),
                             jnp.asarray(near), jnp.asarray(pose), None, 1024)
    coords = np.array(bv.coords)
    live = coords[:, 0] >= 0
    assert live.sum() > 20
    jm, tm, jinv, tinv, cfg = _both(small_cfg, far, pose)
    jmask = ja.carve_candidate_slots(small_cfg, 8, jm, jinv, jnp.asarray(coords),
                                     jnp.asarray(live))
    tmask = ta.carve_candidate_slots(cfg, 8, tm, tinv, torch.from_numpy(coords),
                                     torch.from_numpy(live))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert np.asarray(jmask).sum() > live.sum() // 2
    ids = np.arange(coords.shape[0], dtype=np.int32)
    for budget in (256, 16):
        js, jn = ja._compact_chunked(jmask, jnp.asarray(ids), budget)
        ts, tn = ta._compact_chunked(tmask, torch.from_numpy(ids), budget)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(tn) == int(jn)


def test_compact_chunked_random_masks():
    rng = np.random.default_rng(3)
    for C in (1000, 9000):
        for mask in (np.zeros(C, bool), rng.uniform(size=C) < 0.01,
                     rng.uniform(size=C) < 0.5):
            ids = np.arange(C, dtype=np.int32) * 3 + 1
            for budget in (64, 512):
                js, jn = ja._compact_chunked(jnp.asarray(mask), jnp.asarray(ids), budget)
                ts, tn = ta._compact_chunked(torch.from_numpy(mask), torch.from_numpy(ids),
                                             budget)
                np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
                assert int(tn) == int(jn)


# ---------------------------------------------------------------------------
# the kernel route (csrc/activation.cu runs only on the card: these hold
# its host side, and check that the card tests' cases take their paths)
# ---------------------------------------------------------------------------

from cpu_tsdf_tpu_torch import _build  # noqa: E402
from cpu_tsdf_tpu_torch import bricks as tb  # noqa: E402
from cpu_tsdf_tpu_torch.ops import activation_kernel as ak  # noqa: E402

from torch_common import ACTIVATION_CASES, activation_case  # noqa: E402

# which compaction of a frame overflows in each case: (tiles, rough list
# U2, band list, carve list), on the case's last frame
_OVERFLOWS = {"tile_budget": (True, False, False, False),
              "rough_budget": (False, True, False, False),
              "update_budget": (False, False, True, False),
              "carve_budget": (False, False, False, True)}


@pytest.mark.parametrize("case", list(ACTIVATION_CASES))
def test_activation_cases_take_their_paths(monkeypatch, case):
    """The plain code on each of the card tests' activation cases
    (tests/torch_common.py) overflows exactly the budget the case names
    (the tile budget with the case's own, through band_candidate_bricks;
    the others through frame_update_list), lists bricks, and the camera
    inside the volume lists tiles that straddle the camera plane. A frame
    on the CPU takes the plain route: no activation kernel launches."""
    cfg, B, frames, budget, tile_budget, capacity = activation_case(case)
    vol = tb.make_brick_volume(cfg, B, capacity, device="cpu")
    seen = []
    compact = ta._compact

    def spy(mask, ids, n_max):
        out, n = compact(mask, ids, n_max)
        seen.append(int(n) > n_max)
        return out, n

    monkeypatch.setattr(ta, "_compact", spy)
    before = dict(ak.launches)
    for pose, depth in frames:
        d, p = torch.from_numpy(depth), torch.from_numpy(pose)
        pinv = rigid_inverse(p)
        mips = ta.depth_mips(d, ta.mip_base_level(cfg, B))
        seen.clear()
        _, counts, overflow = ta.band_candidate_bricks(cfg, B, vol.bricks_per_axis, mips, pinv,
                                                       budget, tile_budget)
        tile_over = seen[0]
        seen.clear()
        *_, frame_over = tb.frame_update_list(vol, d, pinv, budget, p)
    assert ak.launches == before
    want = _OVERFLOWS.get(case, (False,) * 4)
    assert (tile_over, *seen[1:]) == want, seen
    assert bool(frame_over) == any(want[1:]) and bool(overflow) == any(want[:3])
    assert int(counts[0]) > 0 or case == "carve_budget"
    if case == "dropouts":
        hit = ~np.isnan(sphere_depth_world(cfg, frames[-1][0], radius=0.5))
        assert 0.04 < float(np.isnan(frames[-1][1])[hit].mean()) < 0.06
    if case == "inside":
        # band-active tiles whose sphere reaches behind the camera plane
        nb, TB = vol.bricks_per_axis, ta.pick_tile_bricks(vol.bricks_per_axis)
        t = torch.arange(nb[0] // TB * (nb[1] // TB) * (nb[2] // TB), dtype=torch.int32)
        nt = nb[1] // TB
        ext = TB * B * cfg.cell_size[0]
        lo = [(t // (nt * nt)).float() * ext, ((t // nt) % nt).float() * ext,
              (t % nt).float() * ext]
        c = [x + 0.5 * ext - cfg.xsize / 2 for x in lo]
        r = 0.5 * float(np.sqrt(3.0)) * ext
        ccx, ccy, ccz = transform_points(pinv, *c)
        act = ta._band_test(cfg, mips, ccx, ccy, ccz, torch.full_like(ccx, r), dilated=True)
        assert int((act & (ccz - r <= 1e-3)).sum()) > 5


def test_kernel_route_refuses_cpu_tensors():
    """kernel=True (use_kernel=True) on CPU tensors raises at every entry
    point: the activation kernels have no CPU mode and nothing falls back."""
    cfg, B, frames, budget, _, capacity = activation_case("tilted")
    pose, depth = (torch.from_numpy(a) for a in frames[0])
    pinv = rigid_inverse(pose)
    vol = tb.make_brick_volume(cfg, B, capacity, device="cpu")
    mips = ta.depth_mips(depth, ta.mip_base_level(cfg, B))
    calls = [lambda: ta.depth_mips(depth, 4, kernel=True),
             lambda: ta.band_candidate_bricks(cfg, B, vol.bricks_per_axis, mips, pinv, budget,
                                              kernel=True),
             lambda: ta.carve_slots(cfg, B, mips, pinv, vol.coords, 256, kernel=True),
             lambda: tb.frame_update_list(vol, depth, pinv, budget, pose, kernel=True),
             lambda: tb.integrate_bricks(vol, depth, pose, None, budget, use_kernel=True)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert int(vol.n_active) == 0


def test_build_names_activation_without_building():
    """_build.KERNELS names the activation source, and importing the port
    and running CPU frames builds and loads nothing."""
    assert "activation" in _build.KERNELS
    assert (_build.CSRC / "activation.cu").exists()
    cfg, B, frames, budget, _, capacity = activation_case("tilted")
    vol = tb.make_brick_volume(cfg, B, capacity, device="cpu")
    tb.integrate_bricks(vol, frames[0][1], frames[0][0], None, budget)
    assert int(vol.n_active) > 0 and not _build._libs


def _struct_fields(name):
    """(type, field) pairs of `struct name` in csrc/activation.cu, arrays
    as type[n]."""
    src = (_build.CSRC / "activation.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        kind, names = decl.split(None, 1)
        for n in names.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)\])?", n.strip())
            out.append((kind if m.group(2) is None else f"{kind}[{m.group(2)}]", m.group(1)))
    return out


@pytest.mark.parametrize("struct", ["MipLayout", "ActParams"])
def test_kernel_structs_mirror_the_source(struct):
    """The ctypes structures of ops/activation_kernel.py name csrc/
    activation.cu's struct fields in order, with their types."""
    kinds = {ctypes.c_float: "float", ctypes.c_int: "int",
             ctypes.c_int * ak.MAX_LEVELS: "int[kMaxLevels]"}
    got = [(kinds[t], n) for n, t in getattr(ak, struct)._fields_]
    assert got == _struct_fields(struct)


@pytest.mark.parametrize("H,W", [(120, 160), (480, 640), (30, 40), (1, 1), (5, 300)])
def test_mip_layout_matches_depth_mips(H, W):
    """The kernels' pyramid layout (offsets, widths, heights, the base
    texel's cell) is the plain depth_mips' at every base level."""
    depth = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 2.0, (H, W)).astype(np.float32))
    Hp, Wp = ta.mip_shapes(H, W)[0]
    for base in range(12):
        m = ta.depth_mips(depth, base)
        L = ak.mip_layout(H, W, base)
        n = L.n_levels
        assert (L.base_level, n, L.n_texels) == (m.base_level, m.n_levels, m.flat_min.numel())
        assert list(L.offsets[:n]) == m.offsets.tolist()
        assert list(L.widths[:n]) == m.widths.tolist()
        sizes = [L.heights[k] * L.widths[k] for k in range(n)]
        assert [L.offsets[k] + sizes[k] for k in range(n - 1)] == list(L.offsets[1:n])
        assert (Hp >> L.cell_h_shift, Wp >> L.cell_w_shift) == (L.heights[0], L.widths[0])


def test_act_params_round_the_plain_constants():
    """Each kernel constant is the float32 rounding of the double the plain
    code computes, and the tile grid is the plain band pass's, slab or not."""
    cfg = activation_case("tilted")[0]
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    m_lo, m_hi = ta._band_margins(cfg)
    tan_h, tan_v = ta._cone_tans(cfg)
    for slab in (None, (3, 10)):
        p = ak.act_params(cfg, 8, (16, 16, 16), 2048, 1024, slab)
        TB, nt, first, n_tiles, tile_budget, U2 = ta._tile_grid((16, 16, 16), 2048, 1024, slab)
        assert (1 << p.tb_shift, (p.ntx, p.nty, p.ntz), p.tile_first, p.n_tiles,
                p.tile_budget, p.rough_budget) == (TB, nt, first, n_tiles, tile_budget, U2)
        assert (p.slab_lo, p.slab_hi) == ((0, 16) if slab is None else (3, 13))
    assert (p.m_lo, p.m_hi, p.tan_h, p.tan_v) == (f32(m_lo), f32(m_hi), f32(tan_h), f32(tan_v))
    cs = cfg.cell_size[0]
    assert (p.tile_x, p.brick_x, p.carve_half_x, p.half_x) == (
        f32(4 * 8 * cs), f32(8 * cs), f32(0.5 * 8 * cs), f32(cfg.xsize / 2))
    assert p.carve_r == f32(0.5 * float(np.sqrt(3 * (8 * cs) ** 2)))
