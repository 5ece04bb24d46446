"""Port parity: the sharded paths (``parallel/`` on torch.distributed)
against the JAX package's, on 4 CPU ranks over gloo.

One module-scoped run of tests/torch_parallel_worker.py spawns the 4 ranks
(each imports only the port and checks that jax is not loaded), computes
every sharded case and the port's single-device counterparts, and writes
them to npz files; the cases below hold them against the JAX package. The
cases mirror tests/test_sharding.py, tests/test_sharded_bricks.py and
tests/test_sharded_raycast.py with their tolerances. The JAX side runs its
XLA paths on jax.devices("cpu")[:4] and on a 2x4 slice of the 8 virtual
devices; the port's tile- and volume-sharded renders are held against the
port's own single-device render bit for bit (that render is held against
the JAX package in tests/test_torch_render.py), which keeps the
interpret-mode Pallas traces of tests/test_sharded_raycast.py out of this
file.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import cpu_tsdf_tpu as J
from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu.parallel import make_tsdf_mesh as jax_mesh
from cpu_tsdf_tpu.parallel import bricks as jpb
from cpu_tsdf_tpu.synthetic import sphere_depth
from cpu_tsdf_tpu_torch.bricks import to_dense
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.parallel.distributed import backend_for, initialize

from test_fusion import tilted_pose
from test_torch_bricks import jax_arrays
from torch_parallel_worker import relay_by_slabs
import torch_common  # noqa: F401  (one intra-op thread)

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg_a():
    from conftest import TSDFConfig as JaxConfig

    return JaxConfig(xres=64, yres=64, zres=64, xsize=1.6, ysize=1.6, zsize=1.6,
                     max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
                     max_sensor_dist=3.0, image_width=40, image_height=30,
                     focal_length_x=35.0, focal_length_y=35.0,
                     principal_point_x=20.0, principal_point_y=15.0,
                     max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4)


def _cfg_b():
    from conftest import TSDFConfig as JaxConfig

    return JaxConfig(xres=128, yres=128, zres=128, xsize=1.6, ysize=1.6, zsize=1.6,
                     max_dist_pos=0.04, max_dist_neg=0.04, min_sensor_dist=0.1,
                     max_sensor_dist=3.0, image_width=64, image_height=48,
                     focal_length_x=56.0, focal_length_y=56.0,
                     principal_point_x=32.0, principal_point_y=24.0,
                     max_cell_size_x=0.4, max_cell_size_y=0.4, max_cell_size_z=0.4,
                     integrate_color=True, color_mode="RGB")


@pytest.fixture(scope="module")
def scene():
    """The inputs both packages fuse: tests/test_sharding.py's 64^3 scene
    (two tilted poses, a random color image) and
    tests/test_sharded_raycast.py's colored 128^3 scene."""
    from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

    cfg_a, cfg_b = _cfg_a(), _cfg_b()
    depth_a = sphere_depth(cfg_a, center=(-0.013, -0.021, 0.9), radius=0.3)
    depth_b = np.asarray(sphere_depth(cfg_b, center=(-0.013, -0.021, 0.9), radius=0.3))
    # the main path's cell and brick over 1.5 m; 80x60 at the 640x480 field of view
    cfg_c = TSDFConfig(xres=256, yres=256, zres=256, xsize=1.5, ysize=1.5, zsize=1.5,
                       min_sensor_dist=0.3, image_width=80, image_height=60,
                       focal_length_x=65.625, focal_length_y=65.625, principal_point_x=40.0,
                       principal_point_y=30.0, integrate_color=True, color_mode="RGB")
    poses_c = np.stack([orbit_pose(2.0 * np.pi * i / 48) for i in range(8)])
    uu, vv = np.meshgrid(np.arange(80), np.arange(60))
    return dict(
        cfg_c=cfg_c.to_json(), poses_c=poses_c,
        depths_c=np.stack([sphere_depth_world(cfg_c, p, radius=0.5) for p in poses_c]),
        rgb_c=np.stack([uu % 256, vv % 256, (uu + vv) % 256], -1).astype(np.float32),
        cfg_a=cfg_a.to_json(), cfg_b=cfg_b.to_json(), depth_a=depth_a, depth_b=depth_b,
        poses_a=np.stack([tilted_pose(), tilted_pose(tx=0.063, ty=0.041, tz=-0.88)])
        .astype(np.float32),
        pose_b=tilted_pose().astype(np.float32),
        rgb_a=np.random.default_rng(3).integers(0, 256, depth_a.shape + (3,))
        .astype(np.float32),
        rgb_b=np.broadcast_to(np.array([180.0, 90.0, 40.0], np.float32),
                              depth_b.shape + (3,)).copy())


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """The 4 ranks' outputs (one spawn for the module)."""
    tmp = tmp_path_factory.mktemp("ranks")
    np.savez(tmp / "inputs.npz", **scene)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, WORKER, str(tmp / "inputs.npz"), str(tmp), str(port)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    out = [dict(np.load(tmp / f"rank{k}.npz")) for k in range(4)]
    print("seconds per case on rank 0:", out[0]["times"])
    return out


@pytest.fixture(scope="module")
def jax_dense(scene):
    """The JAX package's dense volume after one and two frames (numpy
    fields; integrate donates its input), and its render of the first."""
    v = J.make_volume(_cfg_a())
    vols = []
    for k, p in enumerate(scene["poses_a"]):
        v = J.integrate(v, jnp.asarray(scene["depth_a"]), jnp.asarray(p))
        if k == 0:
            view = J.render_view(v, scene["poses_a"][0])
        vols.append({n: np.asarray(getattr(v, n)) for n in ("sdf", "weight", "M", "nsample")})
    return vols, view


def _port_cfg(scene, name):
    return TSDFConfig.from_json(str(scene[name]))


def _port_bricks(scene, out, prefix):
    fields = ("brick_map", "n_active", "coords", "sdf", "weight", "M", "nsample",
              "color", "global_transform", "overflowed")
    arrays = {k: out.get(f"{prefix}_{k}") for k in fields}
    return brick_volume_from_arrays(_port_cfg(scene, "cfg_a"), arrays, device="cpu")


@pytest.mark.parametrize("D", [2, 4])
def test_relay_march_equals_one_march(D):
    """The plain relay march of a whole volume, slab by slab in ray order,
    gives the channels of one march bit for bit, on oblique views whose
    rays cross the slabs (256^3 over 1.5 m, the main path's cell)."""
    import cpu_tsdf_tpu_torch as T
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays
    from cpu_tsdf_tpu_torch.ops.raycast_kernel import march_plain
    from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

    cfg = TSDFConfig(xres=256, yres=256, zres=256, xsize=1.5, ysize=1.5, zsize=1.5,
                     min_sensor_dist=0.3, image_width=48, image_height=36,
                     focal_length_x=39.375, focal_length_y=39.375, principal_point_x=24.0,
                     principal_point_y=18.0)
    vol = T.make_brick_volume(cfg, 8, 4096, device="cpu")
    poses = [orbit_pose(2.0 * np.pi * i / 48) for i in (0, 3, 6)]
    for p in poses:
        T.integrate_bricks(vol, sphere_depth_world(cfg, p, radius=0.5), p, None, 4096)
    pack = T.pack_render(vol)
    origins, dirs = (t.contiguous() for t in camera_rays(cfg, torch.as_tensor(poses[2])))
    one = march_plain(pack, origins, dirs)
    relayed, segments = relay_by_slabs(march_plain, pack, origins, dirs, D)
    assert int((one[1] > 0).sum()) > 500 and segments >= 2
    assert torch.equal(relayed, one)


# ---------------------------------------------------------------------------
# the runtime (parallel/distributed.py)
# ---------------------------------------------------------------------------

def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert backend_for("cpu", 4) == "gloo"
    # two ranks that would share a card, or no card at all: gloo
    assert backend_for("cuda", torch.cuda.device_count() + 1) == "gloo"


def test_runtime_on_four_ranks(ranks):
    """initialize is idempotent; the 2x2 hybrid mesh puts rank k at (k // 2,
    k % 2); shard_to_mesh keeps each rank's block of a global array on the
    slab dim; replicate_to_mesh gives every rank the first rank's value."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for k, o in enumerate(ranks):
        assert bool(o["initialize_again"])
        np.testing.assert_array_equal(o["hybrid_shape"], [2, 2])
        np.testing.assert_array_equal(o["hybrid_coords"], [k // 2, k % 2])
        np.testing.assert_array_equal(o["shard_block"], x[2 * k:2 * k + 2])
        np.testing.assert_array_equal(o["shard_block_hybrid"], x[4 * (k % 2):4 * (k % 2) + 4])
        np.testing.assert_array_equal(o["replicated"], [0, 0, 0])


# ---------------------------------------------------------------------------
# dense slab sharding (parallel/sharding.py; tests/test_sharding.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [1, 2])
def test_sharded_integrate_matches_single(ranks, jax_dense, frames):
    """The gathered slabs equal the port's single-device volume exactly,
    and the JAX package's within the fusion tolerances (sdf and M within
    1e-5, weight and nsample exact)."""
    o = ranks[0]
    for name in ("sdf", "weight", "M", "nsample"):
        np.testing.assert_array_equal(o[f"dense{frames}_{name}"],
                                      o[f"dense{frames}_{name}_single"], err_msg=name)
    jv = jax_dense[0][frames - 1]
    assert (jv["weight"] > 0).sum() > 1000
    for name in ("weight", "nsample"):
        np.testing.assert_array_equal(o[f"dense{frames}_{name}"], jv[name])
    for name in ("sdf", "M"):
        np.testing.assert_allclose(o[f"dense{frames}_{name}"], jv[name], atol=1e-5)


def test_sharded_render_matches_single(ranks, jax_dense):
    """The ray-sharded render of a replicated and of a slab-sharded volume
    equals the port's single-device render; against the JAX render_view,
    the render tolerances (tests/test_torch_render.py)."""
    from test_torch_render import assert_renders_match

    o = ranks[0]
    for name in ("render", "render_from_shards"):
        np.testing.assert_array_equal(o[f"{name}_depth"], o["render_depth_single"])
        np.testing.assert_array_equal(o[f"{name}_normals"], o["render_normals_single"])
    rj = jax_dense[1]

    class Port:
        depth = torch.from_numpy(o["render_depth"])
        normals = torch.from_numpy(o["render_normals"])
        rgb = None

    assert_renders_match(rj, Port, "ray-sharded", min_valid=300)


def test_mc_on_sharded_volume(ranks):
    """Marching cubes of the gathered slabs: the single-device triangles."""
    o = ranks[0]
    assert len(o["mc_faces"]) == len(o["mc_faces_single"]) > 200
    np.testing.assert_array_equal(o["mc_faces"], o["mc_faces_single"])
    np.testing.assert_allclose(np.sort(o["mc_verts"].reshape(-1)),
                               np.sort(o["mc_verts_single"].reshape(-1)), atol=1e-6)


def test_gradient_allreduce_through_sharded_volume(ranks, scene):
    """The pose gradient of the sum of the ranks' slab losses, all-reduced
    in the backward: the same on every rank, and the single-device
    gradient of the JAX package within its tolerance (rtol 1e-4, atol
    1e-5)."""
    cfg = _cfg_a()

    def loss(pose_t, vol0, d):
        v = J.integrate(vol0, d, pose_t)
        return jnp.sum(jnp.where(v.weight > 0, v.sdf, 0.0) ** 2)

    g1 = np.asarray(jax.grad(loss)(jnp.asarray(scene["poses_a"][0]), J.make_volume(cfg),
                                   jnp.asarray(scene["depth_a"])))
    assert np.abs(g1).max() > 1.0
    for o in ranks:
        np.testing.assert_array_equal(o["grad"], ranks[0]["grad"])
    np.testing.assert_allclose(ranks[0]["grad"], g1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_single"], g1, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# slab-sharded bricks (parallel/bricks.py; tests/test_sharded_bricks.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded(scene):
    """The JAX package's sharded brick volume of frame 0 on 4 devices,
    merged."""
    mesh = jax_mesh(jax.devices("cpu")[:4])
    sb = jpb.make_sharded_brick_volume(_cfg_a(), mesh, 8, capacity_per_device=512)
    sb = jpb.integrate_bricks_sharded(sb, scene["depth_a"], scene["poses_a"][0], mesh)
    return jpb.merge_sharded(sb)


def test_merged_volume_matches_jax_row_for_row(ranks, jax_sharded):
    """The global slot layout: rank r's brick map slab and rows land where
    JAX's merge_sharded puts device r's (structure, weight and nsample
    exact; sdf and M within 1e-5)."""
    o = ranks[0]
    j = jax_arrays(jax_sharded)
    for k in ("brick_map", "coords", "n_active", "overflowed", "weight", "nsample"):
        np.testing.assert_array_equal(o[f"b1_{k}"], j[k], err_msg=k)
    for k in ("sdf", "M"):
        np.testing.assert_allclose(o[f"b1_{k}"], j[k], atol=1e-5, err_msg=k)
    assert int(j["n_active"]) > 100 and not bool(j["overflowed"])
    # each rank: its slab of 2 brick planes, its own rows and count
    counts = [int(r["local_n_active"]) for r in ranks]
    assert sum(counts) == int(j["n_active"]) and min(counts) > 0
    for r in ranks:
        np.testing.assert_array_equal(r["local_brick_map_shape"], [2, 8, 8])


def test_sharded_bricks_match_dense_band(ranks, jax_dense, scene):
    dense = jax_dense[0][0]
    bd = to_dense(_port_bricks(scene, ranks[0], "b1"))
    w_dense, d_dense = dense["weight"], dense["sdf"]
    band = (w_dense > 0) & (np.abs(d_dense) < 0.999)
    assert band.sum() > 500
    np.testing.assert_allclose(bd.sdf.numpy()[band], d_dense[band], atol=2e-5)
    np.testing.assert_array_equal(bd.weight.numpy()[band], w_dense[band])
    assert ((bd.weight.numpy() > 0) & (w_dense == 0)).sum() == 0


def test_sharded_bricks_match_single_device_bricks(ranks):
    o = ranks[0]
    obs = o["b2_weight_single"] > 0
    assert obs.sum() > 1000
    np.testing.assert_array_equal(o["b2_weight"][obs], o["b2_weight_single"][obs])
    np.testing.assert_allclose(o["b2_sdf"][obs], o["b2_sdf_single"][obs], atol=2e-5)


def test_sharded_bricks_render_and_mesh(ranks):
    """The merged volume (slot gaps between the ranks' rows) feeds the
    single-device render and marching cubes."""
    o = ranks[0]
    assert int(o["b1_render_valid"]) > 300
    v, f = o["b1_mesh_verts"], o["b1_mesh_faces"]
    assert len(f) > 200
    assert abs(np.median(np.linalg.norm(v, axis=1)) - 0.3) < 0.05


def test_sharded_color_fusion_matches_single_device(ranks):
    o = ranks[0]
    obs = o["b3_weight_single"] > 0
    assert obs.sum() > 500
    np.testing.assert_array_equal(o["b3_weight"][obs], o["b3_weight_single"][obs])
    np.testing.assert_array_equal(o["b3_color"][obs], o["b3_color_single"][obs])


def test_sharded_budget_per_device_overflow_flag(ranks):
    """A slab denser than budget_per_device raises `overflowed` (on every
    rank); a sufficient per-rank budget equals the default one."""
    for o in ranks:
        assert not o["b4_full_overflowed"] and o["b4_tight_overflowed"]
        assert not o["b4_ok_overflowed"]
    o = ranks[0]
    np.testing.assert_array_equal(o["b4_ok_weight"], o["b4_full_weight"])
    np.testing.assert_array_equal(o["b4_ok_sdf"], o["b4_full_sdf"])


def test_hybrid_mesh_matches_1d(ranks, scene):
    """A 2x2 (dcn, shard) mesh (the volume replicated across dcn, slabs on
    the inner dim) fuses the field of the 1D mesh of 4, and that of the
    JAX package's 2x4 hybrid mesh of 8 virtual devices."""
    from cpu_tsdf_tpu.parallel.distributed import DCN_AXIS
    from cpu_tsdf_tpu.parallel.sharding import AXIS

    o = ranks[0]
    assert int(o["b5_1d_n_active"]) == int(o["b5_hybrid_n_active"]) > 20
    assert not o["b5_1d_overflowed"] and not o["b5_hybrid_overflowed"]
    np.testing.assert_array_equal(o["b5_hybrid_weight"], o["b5_1d_weight"])
    np.testing.assert_allclose(o["b5_hybrid_sdf"], o["b5_1d_sdf"], atol=1e-6)
    meshh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(2, 4), (DCN_AXIS, AXIS))
    jv = jpb.make_sharded_brick_volume(_cfg_a(), meshh, 8, capacity_per_device=512)
    jv = jpb.integrate_bricks_sharded(jv, jnp.asarray(scene["depth_a"]),
                                      jnp.asarray(scene["poses_a"][0]), meshh,
                                      update_budget=1024)
    jd = jb.to_dense(jpb.merge_sharded(jv))
    assert int(jpb.merge_sharded(jv).n_active) == int(o["b5_hybrid_n_active"])
    np.testing.assert_array_equal(o["b5_hybrid_weight"], np.asarray(jd.weight))
    np.testing.assert_allclose(o["b5_hybrid_sdf"], np.asarray(jd.sdf), atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded renders (parallel/raycast.py; tests/test_sharded_raycast.py)
# ---------------------------------------------------------------------------

def _assert_views_equal(o, name, single="single", colored=True, prefix="r"):
    for c in ("depth", "normals") + (("rgb",) if colored else ()):
        np.testing.assert_array_equal(o[f"{prefix}_{name}_{c}"], o[f"{prefix}_{single}_{c}"],
                                      err_msg=c)


def test_tile_sharded_render_equals_single(ranks):
    """Row bands over the ranks: depth, normals and colors equal to the
    single-device render; the JAX budget arguments are ignored (a
    16-pair local budget changes nothing)."""
    o = ranks[0]
    assert np.isfinite(o["r_single_depth"]).sum() > 800
    assert not o["r_overflowed"]
    for rank in ranks:
        _assert_views_equal(rank, "tiles")
    _assert_views_equal(o, "tiles_budget16")


def test_volume_sharded_render_equals_single(ranks):
    """Slab packs with ghost planes, the relay march, colors gathered per
    slab: equal to the single-device render of the merged volume, also
    downsampled; no rank holds the whole volume (256 rows a rank)."""
    o = ranks[0]
    assert int(o["r_n_active"]) > 256
    for rank in ranks:
        _assert_views_equal(rank, "volume")
    _assert_views_equal(o, "volume_ds2", "single_ds2", colored=False)


def test_volume_sharded_render_of_oblique_views(ranks):
    """Oblique views at the main path's cell and brick size, where rays
    cross one slab's truncation band beyond the ghost plane before their
    crossing in the next slab: the march's step there depends on |d| of
    the other slab, so only the relay march (each segment marched by the
    rank holding it) walks the single-device sample grid. All three sharded
    renders equal the single-device render."""
    o = ranks[0]
    assert not o["c_overflowed"]
    for i in (0, 6):
        assert np.isfinite(o[f"c{i}_single_depth"]).sum() > 2000
        for name in ("rays", "tiles", "volume"):
            _assert_views_equal(o, name, "single", prefix=f"c{i}")
