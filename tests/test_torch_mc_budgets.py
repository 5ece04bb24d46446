"""Port parity: the budgeted, chunked brick extraction and the budgeted
dense route against the JAX package's XLA routes, on the CPU.

The scene is the 64^3 two-frame sphere of tests/test_torch_marching_cubes.py
(capacity 1024), fused in RGB so that colors compare exactly. The checked
route (one host sync a batch of chunks, overflowing chunks run again with
a doubled budget) gives the JAX package's triangles, live chunks and budget
hints exactly; the unchecked route (check=False, no host sync) with those
hints gives its shapes, tri_valid and overflowed exactly, valid vertices
within 1e-6 and colors exactly. The port's corner halo keeps each brick's
crossing cubes, so its triangle count under a cube overflow is not the JAX
package's (which drops the cubes past the budget): only the flags are held
there. tests/test_bricks.py:201-235 holds the JAX package to the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.ops import marching_cubes as jmc
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays, tsdf_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)

MIN_W = 0.5
POSES = (tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88))


def _scene_config():
    return J.TSDFConfig(
        xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
        max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
        max_sensor_dist=3.0, image_width=40, image_height=30,
        focal_length_x=35.0, focal_length_y=35.0, principal_point_x=20.0,
        principal_point_y=15.0, max_cell_size_x=0.4, max_cell_size_y=0.4,
        max_cell_size_z=0.4, integrate_color=True, color_mode="RGB")


def _frames(jcfg):
    depth = sphere_depth(jcfg, center=(-0.013, -0.021, 0.9), radius=0.3)
    rgb = np.random.default_rng(5).integers(0, 256, depth.shape + (3,)).astype(np.float32)
    return depth, rgb


@pytest.fixture(scope="module")
def volumes():
    """A two-frame RGB JAX brick volume and its port copy (CPU)."""
    jcfg = _scene_config()
    depth, rgb = _frames(jcfg)
    jv = jb.make_brick_volume(jcfg, 8, 1024)
    for p in POSES:
        jv = jb.integrate_bricks(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32),
                                 jnp.asarray(rgb), 1024)
    tv = brick_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()),
                                  jax_arrays(jv), device="cpu")
    return jv, tv


def _assert_checked_equal(ts, js):
    """A port soup from the checked route against a compact JAX soup: the
    same triangles in the same order (vertices within 1e-6), the same RGB
    colors, the same live chunks and hints."""
    n = int(js.num_triangles)
    assert int(ts.num_triangles) == n > 100 and ts.vertices.shape[0] == n
    assert bool(ts.tri_valid.all()) and not bool(ts.overflowed)
    np.testing.assert_allclose(ts.vertices.numpy(), np.asarray(js.vertices)[:n], atol=1e-6)
    np.testing.assert_array_equal(ts.colors.numpy(), np.asarray(js.colors)[:n])
    assert ts.live_chunks == tuple(js.live_chunks)
    assert ts.budget_hint == tuple(tuple(int(b) for b in h) for h in js.budget_hint)


@pytest.mark.parametrize("chunk_slots", [2048, 128], ids=["one_chunk", "chunks"])
def test_checked_extraction_matches_jax(volumes, chunk_slots):
    """The checked route with the default budgets (one chunk of the 1024
    slots; a retry of the brick, cube and triangle budgets) and in chunks
    of 128 slots (several live chunks): JAX's triangles, colors, live
    chunks and hints; the chunked mesh is the one-chunk mesh, bit for
    bit."""
    jv, tv = volumes
    js = jmc.extract_soup_bricks(jv, MIN_W, True, False, chunk_slots, corner_engine="xla")
    ts = tmc.extract_soup_bricks(tv, MIN_W, True, False, chunk_slots)
    _assert_checked_equal(ts, js)
    if chunk_slots == 128:
        assert len(ts.live_chunks) > 1
        whole = tmc.extract_soup_bricks(tv, MIN_W, True)
        assert torch.equal(ts.vertices, whole.vertices) and torch.equal(ts.colors, whole.colors)


def test_cube_budget_retry_gives_the_default_mesh(volumes):
    """cube_budget=64 (brick budget 256, triangle budget 128) retries until
    every budget holds: the default route's triangles, bit for bit, and
    its live chunks and hints (the default route is held against JAX's
    above; tests/test_bricks.py holds JAX's retry to its default)."""
    _, tv = volumes
    ts = tmc.extract_soup_bricks(tv, MIN_W, True, cube_budget=64)
    whole = tmc.extract_soup_bricks(tv, MIN_W, True)
    assert int(ts.num_triangles) == int(whole.num_triangles) > 100
    assert torch.equal(ts.vertices, whole.vertices) and torch.equal(ts.colors, whole.colors)
    assert ts.live_chunks == whole.live_chunks and ts.budget_hint == whole.budget_hint


@pytest.mark.parametrize("chunk_slots", [2048, 128], ids=["one_chunk", "chunks"])
def test_unchecked_extraction_matches_jax(volumes, chunk_slots):
    """check=False with the checked route's live chunks and hints: JAX's
    shapes, tri_valid, num_triangles and overflowed exactly, the valid
    vertices within 1e-6 and their colors exactly; the valid triangles are
    the checked route's. A hint of a quarter of each budget sets overflowed
    in both packages; the checked route still gives the whole mesh."""
    jv, tv = volumes
    js = jmc.extract_soup_bricks(jv, MIN_W, True, False, chunk_slots, corner_engine="xla")
    ts = tmc.extract_soup_bricks(tv, MIN_W, True, False, chunk_slots)
    ju = jmc.extract_soup_bricks(jv, MIN_W, True, False, chunk_slots,
                                 live_chunks=js.live_chunks, budget_hint=js.budget_hint,
                                 check=False, corner_engine="xla")
    tu = tmc.extract_soup_bricks(tv, MIN_W, True, False, chunk_slots,
                                 live_chunks=ts.live_chunks, budget_hint=ts.budget_hint,
                                 check=False)
    assert tu.vertices.shape == ju.vertices.shape and tu.colors.shape == ju.colors.shape
    valid = np.asarray(ju.tri_valid)
    np.testing.assert_array_equal(tu.tri_valid.numpy(), valid)
    assert int(tu.num_triangles) == int(ju.num_triangles) == int(ts.num_triangles)
    assert bool(tu.overflowed) is bool(ju.overflowed) is False
    np.testing.assert_allclose(tu.vertices.numpy()[valid], np.asarray(ju.vertices)[valid],
                               atol=1e-6)
    np.testing.assert_array_equal(tu.colors.numpy()[valid], np.asarray(ju.colors)[valid])
    assert torch.equal(tu.vertices[tu.tri_valid], ts.vertices)
    assert tu.live_chunks == ts.live_chunks and tu.budget_hint == ts.budget_hint
    v, f, c = tu.to_numpy()
    np.testing.assert_array_equal(v, ts.vertices.numpy().reshape(-1, 3))
    assert len(f) == int(ts.num_triangles) and c.shape == v.shape

    small = tuple(tuple(b // 4 for b in h) for h in ts.budget_hint)
    jo = jmc.extract_soup_bricks(jv, MIN_W, True, False, chunk_slots, live_chunks=js.live_chunks,
                                 budget_hint=small, check=False, corner_engine="xla")
    to = tmc.extract_soup_bricks(tv, MIN_W, True, False, chunk_slots, live_chunks=ts.live_chunks,
                                 budget_hint=small, check=False)
    assert bool(to.overflowed) and bool(jo.overflowed)
    again = tmc.extract_soup_bricks(tv, MIN_W, True, False, chunk_slots,
                                    live_chunks=ts.live_chunks, budget_hint=small)
    assert torch.equal(again.vertices, ts.vertices)


def test_budget_hint_must_match_live_chunks(volumes):
    _, tv = volumes
    with pytest.raises(ValueError, match="budget_hint has 2 entries"):
        tmc.extract_soup_bricks(tv, MIN_W, live_chunks=(0,), budget_hint=((1024, 256, 2048),) * 2)


def test_corner_engine_routes(volumes):
    """corner_engine "xla" and "interpret" take the plain route, "pallas"
    the kernels (the CPU raises, as use_kernel=True does); a use_kernel
    that names another route raises; the routes give the same mesh."""
    _, tv = volumes
    base = tmc.extract_soup_bricks(tv, MIN_W, True)
    for engine in ("xla", "interpret"):
        soup = tmc.extract_soup_bricks(tv, MIN_W, True, corner_engine=engine)
        assert torch.equal(soup.vertices, base.vertices)
    for kw in ({"corner_engine": "pallas"}, {"use_kernel": True},
               {"corner_engine": "xla", "use_kernel": True}, {"corner_engine": "mosaic"}):
        with pytest.raises(ValueError):
            tmc.extract_soup_bricks(tv, MIN_W, **kw)


@pytest.fixture(scope="module")
def dense_volumes():
    """A two-frame RGB JAX dense volume and its port copy (CPU)."""
    jcfg = _scene_config()
    depth, rgb = _frames(jcfg)
    jv = J.make_volume(jcfg)
    for p in POSES:
        jv = J.integrate(jv, jnp.asarray(depth), jnp.asarray(p, jnp.float32), jnp.asarray(rgb))
    arrays = {k: np.asarray(getattr(jv, k)) for k in
              ("sdf", "weight", "M", "nsample", "color", "global_transform")}
    tv = tsdf_volume_from_arrays(TSDFConfig.from_json(jcfg.to_json()), arrays, device="cpu")
    return jv, tv


@pytest.mark.parametrize("max_cubes", [256, 8192])
def test_dense_budget_matches_jax(dense_volumes, max_cubes):
    """The dense marching_cubes(max_cubes): JAX's overflow flag, shapes,
    tri_valid and num_triangles exactly, valid vertices within 1e-5 and
    colors exactly, with a budget below the crossing cubes (overflow: the
    cubes past it dropped) and above."""
    jv, tv = dense_volumes
    js = jmc.marching_cubes(jv, MIN_W, max_cubes, True)
    ts = tmc.marching_cubes(tv, MIN_W, max_cubes, True)
    n_active = tmc.count_active_cubes(tv, MIN_W)
    assert bool(ts.overflowed) == bool(js.overflowed) == (n_active > max_cubes)
    assert ts.vertices.shape == js.vertices.shape
    valid = np.asarray(js.tri_valid)
    np.testing.assert_array_equal(ts.tri_valid.numpy(), valid)
    assert int(ts.num_triangles) == int(js.num_triangles) > 100
    np.testing.assert_allclose(ts.vertices.numpy()[valid], np.asarray(js.vertices)[valid],
                               atol=1e-5)
    np.testing.assert_array_equal(ts.colors.numpy()[valid], np.asarray(js.colors)[valid])
