"""Port parity: brick marching cubes and its two kernels' plain versions
against the JAX package.

pack-left, the corner stacks and the corner halo's compacted outputs are
held EXACTLY against the Pallas kernels in interpret mode; the emission's
plain version against the JAX route through the Pallas pack-left kernel
(vertices within 1e-6, the same triangles in the same order); the extracted
mesh (from the same volume state, carried across with ``convert``) against
the JAX XLA route: the same triangles in the same order, vertices within
1e-6. The CUDA kernels against these plain versions are
tests/test_torch_kernels.py, on the card; the case tables the kernels carry
are held against mc_tables here.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch import make_volume
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc
from cpu_tsdf_tpu_torch.ops.mc_tables import TRI_COUNT, TRI_TABLE

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays

MIN_W = 0.5


@pytest.fixture(scope="module")
def volumes():
    """A two-frame colored JAX brick volume and its port copy (CPU)."""
    jcfg = J.TSDFConfig(
        xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
        max_sensor_dist=3.0, image_width=40, image_height=30,
        focal_length_x=35.0, focal_length_y=35.0, principal_point_x=20.0,
        principal_point_y=15.0, max_cell_size_x=0.4, max_cell_size_y=0.4,
        max_cell_size_z=0.4, integrate_color=True, color_mode="LAB")
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = np.random.default_rng(5).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    jv = jb.make_brick_volume(jcfg, 8, 1024)
    for p in (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88)):
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                 jnp.asarray(rgb), 1024)
    tv = brick_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()),
                                  jax_arrays(jv), device="cpu")
    return jv, tv


def test_pack_left_plain_matches_pallas():
    rng = np.random.default_rng(11)
    for density in (0.0, 0.03, 0.5, 1.0):
        mask = (rng.uniform(size=(70, 512)) < density).astype(np.int32)
        jloc = np.asarray(jmc._pack_left_rows(jnp.asarray(mask), True))
        tloc = tmc._pack_left_plain(torch.from_numpy(mask))
        np.testing.assert_array_equal(tloc.numpy(), jloc)


def _padded_candidates(tv):
    cand = tmc._candidate_slots(tv, MIN_W)
    assert 10 < cand.shape[0] < 128
    slots = np.full(128, tv.capacity, np.int32)  # the Pallas grid wants 64-brick blocks
    slots[:cand.shape[0]] = cand.numpy()
    return slots


def test_corner_stacks_plain_match_pallas(volumes):
    jv, tv = volumes
    slots = _padded_candidates(tv)
    jd, jok, jloc, _, _ = jmc._corner_stacks_pallas(jv, jnp.asarray(slots), MIN_W, True)
    td, tok = tmc._corner_stacks(tv, torch.from_numpy(slots), MIN_W)
    tloc = tmc._pack_left_plain(tok)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tok.sum() > 100
    # and the JAX package's own XLA stacks agree with both
    xd, xok, _, _ = jmc._corner_stacks(jv, jnp.asarray(slots), MIN_W)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(xok))


def test_corner_halo_plain_matches_pallas(volumes):
    """corner_halo's compacted outputs (the kernel's contract) are the
    Pallas kernel's dense stacks gathered through its pack-left table:
    count, cube codes, triangle counts and the live corner rows exact."""
    jv, tv = volumes
    slots = _padded_candidates(tv)
    jd, jok, jloc, _, _ = jmc._corner_stacks_pallas(jv, jnp.asarray(slots), MIN_W, True)
    jd, jok, jloc = np.asarray(jd), np.asarray(jok), np.asarray(jloc)
    count, cube, corners, ntri = tmc.corner_halo(tv, torch.from_numpy(slots), MIN_W)
    K = len(slots)
    want_count = jok.sum(1)
    np.testing.assert_array_equal(count.numpy(), want_count)
    for k in range(K):
        n = int(want_count[k])
        vox = jloc[k, :n]
        d = jd[k * 512 + vox]                                      # [n, 8]
        ci = ((d * np.float32(tv.config.max_dist_neg) < 0) << np.arange(8)).sum(1)
        np.testing.assert_array_equal(cube[k, :n].numpy(), ci * 512 + vox)
        assert (cube[k, n:] == -1).all()
        np.testing.assert_array_equal(corners[k, :n].numpy(), d)
        assert int(ntri[k]) == int(TRI_COUNT[ci].sum())
    assert int(count.sum()) > 100 and int((count == 0).sum()) > 0


@pytest.mark.parametrize("moved", [False, True])
def test_emit_plain_matches_pallas_emission(volumes, moved):
    """The emission's plain version against the JAX kernel route's
    emission (_emit_soup_compacted: the Pallas pack-left kernel in
    interpret mode, then _compact_from_loc) on the same cube list: the
    same triangles in the same order, each referring to the same cube,
    vertices within 1e-6; with the identity and a moved global transform."""
    jv, tv = volumes
    m = np.eye(4, dtype=np.float32)
    if moved:
        a = 0.4
        m[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        m[:3, 3] = (0.21, -0.13, 0.9)
    tv = dataclasses.replace(tv, global_transform=torch.from_numpy(m))
    cand = tmc._candidate_slots(tv, MIN_W)
    count, cube, corners, ntri = tmc.corner_halo(tv, cand, MIN_W)
    verts, tri_cube = tmc._emit_plain(tv, cand, count, cube, corners)
    assert verts.shape[0] == int(ntri.sum()) > 100 and tri_cube.shape == verts.shape[:1]

    # the same cube list for JAX, padded to whole 512-lane mask rows
    live = torch.arange(512)[None] < count[:, None]
    k, r = torch.nonzero(live, as_tuple=True)
    code = cube[k, r].long()
    flat = (cand[k].long() * 512 + code % 512).numpy()
    cs = tv.coords[cand[k].long()].numpy()
    within = (code % 512).numpy()
    N = len(flat)
    Np = -(-N // 512) * 512
    pad = Np - N

    def padded(a, fill=0):
        return jnp.asarray(np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]))

    ci = padded((cs[:, 0] * 8 + within // 64).astype(np.int32))
    cj = padded((cs[:, 1] * 8 + (within // 8) % 8).astype(np.int32))
    ck = padded((cs[:, 2] * 8 + within % 8).astype(np.int32))
    vals = padded((corners[k, r] * tv.config.max_dist_neg).numpy())
    ok = padded(np.ones(N, bool), False)
    ids = padded(np.repeat(np.arange(N, dtype=np.float32)[:, None], 3, 1))  # cube id as color
    T = verts.shape[0]
    js = jmc._emit_soup_compacted(jv.config, jnp.asarray(m), ci, cj, ck, vals, ok, ids,
                                  jnp.bool_(False), T + 64, True)
    assert int(js.num_triangles) == T
    np.testing.assert_allclose(verts.numpy(), np.asarray(js.vertices)[:T], atol=1e-6)
    jcube = np.asarray(js.colors)[:T, 0, 0].astype(np.int64)
    np.testing.assert_array_equal(tri_cube.numpy(), flat[jcube])


def _c_array(name: str, array: str) -> list:
    src = (Path(tmc.__file__).resolve().parent.parent / "csrc" / name).read_text()
    body = re.search(array + r"\[256\] = \{(.*?)\};", src, re.S).group(1)
    return [int(x, 0) for x in re.findall(r"0x[0-9a-f]+|\d+", body.replace("ull", ""))]


def test_kernel_case_tables_match_mc_tables():
    """The case tables written into the CUDA sources equal mc_tables: the
    corner halo's triangle counts and the emission's packed rows (edge of
    vertex j of triangle i in bits 12i+4j.., the count in bits 60-63)."""
    np.testing.assert_array_equal(_c_array("mc_corner_halo.cu", "kTriCount"), TRI_COUNT)
    rows = _c_array("mc_emit.cu", "kTriRows")
    assert len(rows) == 256
    for c, w in enumerate(rows):
        n = w >> 60
        assert n == TRI_COUNT[c]
        edges = [(w >> (4 * i)) & 15 for i in range(3 * n)]
        np.testing.assert_array_equal(edges, TRI_TABLE[c, :3 * n])
        assert (w & ((1 << 60) - 1)) >> (12 * n) == 0  # unused slots empty


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("coloring", ["none", "rgb", "confidence"])
def test_extract_mesh_matches_jax(volumes, kernel_route, coloring):
    """Both routes (plain; and the kernel route's glue, with the kernels'
    plain versions standing in on the CPU) give the JAX triangles in the
    JAX order."""
    jv, tv = volumes
    rgb, conf = coloring == "rgb", coloring == "confidence"
    sx = jmc.extract_soup_bricks(jv, MIN_W, rgb, conf, corner_engine="xla")
    n = int(sx.num_triangles)
    assert n > 100
    st = tmc._extract(tv, MIN_W, rgb, conf, kernel_route)
    assert st.num_triangles == n
    np.testing.assert_allclose(st.vertices.numpy(), np.asarray(sx.vertices)[:n], atol=1e-6)
    if coloring == "none":
        assert st.colors is None
    else:
        np.testing.assert_allclose(st.colors.numpy(), np.asarray(sx.colors)[:n], atol=1e-4)
    if conf:
        v, f, c = tmc.extract_mesh(tv, MIN_W, color_by_confidence=True)
        assert len(c) == len(v) == 3 * len(f)
        assert (c[:, 2] > 200).all()  # w <= 2 -> mostly blue


def test_dense_extract_mesh_not_ported(small_cfg):
    cfg = TSDFConfig.from_json(small_cfg.to_json())
    with pytest.raises(NotImplementedError):
        tmc.extract_mesh(make_volume(cfg, device="cpu"))

