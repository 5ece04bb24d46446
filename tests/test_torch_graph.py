"""The graphed frame and render (cpu_tsdf_tpu_torch/graph.py), on the CPU.

A CUDA graph replays a fixed program: a frame or a render that reads a
value back to the host, or sizes a tensor from one, cannot be captured.
These tests record the aten ops of one eager frame and of the render glue
with a TorchDispatchMode and refuse every op that syncs with the host: a
nonzero, a scalar read (``.item()``, ``int(t)``, ``bool(t)``), a masked
select, a unique, a boolean-mask index, and a Python value moved to the
device inside the program (``lift_fresh``; on a card an assignment of a
Python value through an index copies it from the host). They also hold
the sync-free allocation against the JAX package's exactly, the eager
sequence against the JAX package's ``lax.scan`` sequence, and the graph
switch on the CPU. The graph itself runs only on the card
(tests/test_torch_kernels.py).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cpu_tsdf_tpu import bricks as jb
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch import graph as tg
from cpu_tsdf_tpu_torch import integrate, make_volume, render_view, tracing
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.convert import brick_volume_from_arrays
from cpu_tsdf_tpu_torch.ops import raycast_kernel as rk
from cpu_tsdf_tpu_torch.ops.raycast import camera_rays

from test_fusion import tilted_pose
from test_torch_bricks import JAX_FIELDS, POSES, _scene, assert_volumes_match, jax_arrays
import torch_common  # noqa: F401  (one intra-op thread)

# ops that read a device value back to the host, or size a tensor from one
SYNC_OPS = ("aten.nonzero", "aten._local_scalar_dense", "aten.masked_select",
            "aten.unique", "aten._unique", "aten.is_nonzero", "aten.lift_fresh")
INDEX_OPS = ("aten.index.Tensor", "aten.index_put_.default", "aten.index_put.default",
             "aten._index_put_impl_.default")


class SyncRecorder(TorchDispatchMode):
    """Counts the aten ops run under it; `syncs` lists those that sync with
    the host (SYNC_OPS, an index by a boolean mask, a copy to another
    device)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.syncs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops[name] += 1
        if name.startswith(SYNC_OPS):
            self.syncs.append(name)
        if name in INDEX_OPS and any(i is not None and i.dtype in (torch.bool, torch.uint8)
                                     for i in args[1]):
            self.syncs.append(f"{name} by a boolean mask")
        if name == "aten._to_copy.default" and "device" in (kwargs or {}) \
                and kwargs["device"] != args[0].device:
            self.syncs.append(f"{name} to {kwargs['device']}")
        return func(*args, **(kwargs or {}))


def test_recorder_catches_syncs():
    x = torch.arange(6.0)
    with SyncRecorder() as rec:
        torch.nonzero(x > 2)
        x[x > 3]
        x[torch.tensor([0, 1])] = 5.0
        bool(x.sum() > 0)
        int(x.sum())
        x.unique()
    want = ["aten.nonzero", "aten.index.Tensor by a boolean mask", "aten.lift_fresh",
            "aten._local_scalar_dense", "aten._unique"]
    assert all(any(s.startswith(w) for s in rec.syncs) for w in want), rec.syncs


@pytest.fixture(params=[False, True], ids=["untraced", "traced"])
def traced(request):
    """Tracing off or on (its spans, stages and calls) for the test."""
    if request.param:
        tracing.enable()
    yield request.param
    tracing.disable()


def assert_stamped(traced: bool, want: dict) -> None:
    """With tracing on, each device stage of `want` was stamped as often as
    it says."""
    if traced:
        stages = tracing.report()["stages"]
        assert {k: stages[k]["count"] for k in want} == want, stages


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("B", [4, 8, 16])
def test_frame_has_no_host_sync(small_cfg, B, splits, traced):
    """Two eager integrate_bricks frames with color (the second sees live
    bricks in its carve pass and its allocation) run no op that syncs with
    the host, at bricks of 4, 8 and 16, with and without the jitter, with
    tracing off and on (then each frame stamps its three stages)."""
    _, cfg, depth, rgb = _scene(small_cfg.with_updates(num_random_splits=splits), "RGB")
    budget = 4096 if B == 4 else 1024
    vol = tb.make_brick_volume(cfg, B, 2 * budget, device="cpu")
    depth_t, rgb_t = torch.as_tensor(depth), torch.as_tensor(rgb)
    poses = [torch.as_tensor(p, dtype=torch.float32) for p in POSES[:2]]
    with SyncRecorder() as rec:
        for p in poses:
            tb.integrate_bricks(vol, depth_t, p, rgb_t, budget)
    assert rec.syncs == [], rec.syncs
    assert sum(rec.ops.values()) > 1000 and int(vol.n_active) > 0
    assert not bool(vol.overflowed)
    assert_stamped(traced, {"frame.activation": 2, "frame.allocation": 2, "frame.batch": 2})


def test_dense_integrate_has_no_host_sync(small_cfg, traced):
    """Two dense integrate frames with color (the CPU route: the plain
    version of the dense kernel, whose wrapper runs on the card) run no op
    that syncs with the host, with tracing off and on (then each frame is
    one call)."""
    _, cfg, depth, rgb = _scene(small_cfg, "RGB")
    vol = make_volume(cfg, device="cpu")
    depth_t, rgb_t = torch.as_tensor(depth), torch.as_tensor(rgb)
    poses = [torch.as_tensor(p, dtype=torch.float32) for p in POSES[:2]]
    with SyncRecorder() as rec:
        for p in poses:
            vol = integrate(vol, depth_t, p, rgb_t)
    assert rec.syncs == [], rec.syncs
    assert sum(rec.ops.values()) > 50 and int((vol.weight > 0).sum()) > 0
    if traced:
        assert tracing.report()["calls"]["count"] == 2


def test_render_glue_has_no_host_sync(small_cfg, monkeypatch, traced):
    """The render glue (pack_render, camera_rays, the color gather,
    assemble_view) runs no op that syncs with the host, with tracing off
    and on (then the render stamps its stages). The plain march runs
    outside the recorder: its early exit reads the done mask, and on the
    card the kernel takes its place."""
    _, cfg, depth, rgb = _scene(small_cfg, "RGB")
    vol = tb.make_brick_volume(cfg, 8, 2048, device="cpu")
    for p in POSES:
        tb.integrate_bricks(vol, depth, p, rgb, 1024)
    pose = torch.as_tensor(POSES[1], dtype=torch.float32)
    want = render_view(vol, pose, colored=True)
    origins, dirs = camera_rays(cfg, pose)
    ch = rk.march_plain(tb.pack_render(vol), origins.contiguous(), dirs.contiguous())
    monkeypatch.setattr(rk, "march_plain", lambda *args, **kw: ch)
    if traced:
        tracing.reset()
    with SyncRecorder() as rec:
        got = render_view(vol, pose, colored=True)
    assert rec.syncs == [], rec.syncs
    assert int((~got.depth.isnan()).sum()) > 300
    for name in ("points", "normals", "depth", "rgb"):
        assert torch.equal(getattr(got, name).nan_to_num(), getattr(want, name).nan_to_num())
    assert_stamped(traced, {f"render.{s}": 1 for s in ("rays", "pack", "march", "finish")})


def _gapped(jcfg, capacity, live_rows):
    """A JAX brick volume whose rows `live_rows` hold bricks (slot gaps
    between them), as merge_sharded leaves one."""
    jv = jb.make_brick_volume(jcfg, 8, capacity)
    nbx, nby, nbz = jv.bricks_per_axis
    bids = np.arange(len(live_rows)) * 37 + 5
    coords = np.asarray(jv.coords).copy()
    bm = np.asarray(jv.brick_map).copy().reshape(-1)
    for row, b in zip(live_rows, bids):
        coords[row] = (b // (nby * nbz), (b // nbz) % nby, b % nbz)
        bm[b] = row
    return dataclasses.replace(jv, coords=jnp.asarray(coords),
                               brick_map=jnp.asarray(bm.reshape(nbx, nby, nbz)),
                               n_active=jnp.asarray(len(live_rows), jnp.int32))


@pytest.mark.parametrize("capacity,n_new", [(64, 20), (16, 20)], ids=["gaps", "overflow"])
def test_allocate_from_list_matches_jax(small_cfg, capacity, n_new):
    """The sync-free allocation against the JAX package's, exactly
    (brick_map, coords, n_active, overflowed): a volume with slot gaps
    (rows 0, 2, 3, 7, 9 live), a candidate list of new bricks, already
    allocated ones and padding; at capacity 16 the new bricks outnumber the
    free rows."""
    from cpu_tsdf_tpu_torch.config import TSDFConfig

    jv = _gapped(small_cfg, capacity, [0, 2, 3, 7, 9])
    cand = np.full(64, -1, np.int32)
    cand[:n_new] = np.arange(n_new) * 11 + 300           # new bricks
    cand[n_new:n_new + 3] = (5, 42, 79)                  # already allocated
    cand = np.random.default_rng(1).permutation(cand)
    tv = brick_volume_from_arrays(TSDFConfig.from_json(small_cfg.to_json()),
                                  jax_arrays(jv), device="cpu")
    j = jax_arrays(jb._allocate_from_list(jv, jnp.asarray(cand)))
    cand = torch.as_tensor(cand)
    with SyncRecorder() as rec:
        tb._allocate_from_list(tv, cand)
    assert rec.syncs == [], rec.syncs
    for k in ("brick_map", "coords", "n_active", "overflowed"):
        np.testing.assert_array_equal(getattr(tv, k).numpy(), j[k], err_msg=k)
    assert bool(tv.overflowed) == (capacity == 16)
    assert int(tv.n_active) == min(5 + n_new, capacity - 1)


def test_eager_sequence_with_color_matches_jax(small_cfg):
    """The eager integrate_bricks_sequence with color against the JAX
    package's lax.scan sequence (the tolerances of
    test_integrate_bricks_matches_jax)."""
    jcfg, cfg, depth, rgb = _scene(small_cfg, "RGB")
    poses = np.stack(POSES).astype(np.float32)
    n = len(poses)
    jv = jb.integrate_bricks_sequence(jb.make_brick_volume(jcfg, 8, 2048),
                                      jnp.asarray(np.stack([depth] * n)), jnp.asarray(poses),
                                      jnp.asarray(np.stack([rgb] * n)), 1024)
    tv = tb.integrate_bricks_sequence(tb.make_brick_volume(cfg, 8, 2048, device="cpu"),
                                      np.stack([depth] * n), poses, np.stack([rgb] * n), 1024)
    assert int(jv.n_active) > 50 and not bool(jv.overflowed)
    assert_volumes_match(tv, jv, "RGB")


def test_graph_switch_on_the_cpu(small_cfg):
    """graph=True on CPU tensors raises in every entry point; graph=None on
    the CPU runs the eager route (the same bits as graph=False)."""
    _, cfg, depth, rgb = _scene(small_cfg, "RGB")
    vols = [tb.make_brick_volume(cfg, 8, 2048, device="cpu") for _ in range(2)]
    with pytest.raises(ValueError):
        tb.integrate_bricks(vols[0], depth, POSES[0], rgb, 1024, graph=True)
    with pytest.raises(ValueError):
        tb.integrate_bricks_sequence(vols[0], depth[None], POSES[:1], rgb[None], 1024,
                                     graph=True)
    assert int(vols[0].n_active) == 0
    for p in POSES:
        tb.integrate_bricks(vols[0], depth, p, rgb, 1024)
        tb.integrate_bricks(vols[1], depth, p, rgb, 1024, graph=False)
    for k in JAX_FIELDS:
        a, b = getattr(vols[0], k), getattr(vols[1], k)
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), k
    with pytest.raises(ValueError):
        render_view(vols[0], POSES[0], graph=True)
    a = render_view(vols[0], POSES[0], colored=True)
    b = render_view(vols[0], POSES[0], colored=True, graph=False)
    assert torch.equal(a.points.nan_to_num(), b.points.nan_to_num())
    assert tg.resolve_graph(None, torch.device("cpu")) is False
    assert tg.resolve_graph(None, torch.device("cuda")) is True
    assert tg.resolve_graph(False, torch.device("cuda")) is False


def test_state_key_follows_the_volume(small_cfg):
    """A graph's key changes with any state tensor of the volume (a
    replaced tensor, a new volume) and with the config, and not with the
    values in the tensors."""
    _, cfg, depth, _ = _scene(small_cfg, None)
    vol = tb.make_brick_volume(cfg, 8, 256, device="cpu")
    key = tg.state_key(vol)
    tb.integrate_bricks(vol, depth, tilted_pose(), None, 1024)
    assert tg.state_key(vol) == key          # the frame updates in place
    vol.sdf = vol.sdf.clone()
    assert tg.state_key(vol) != key
    other = tb.make_brick_volume(cfg.with_updates(max_weight=7.0), 8, 256, device="cpu")
    assert tg.state_key(other)[1:3] != key[1:3]


def _fused(small_cfg, capacity=2048):
    """A colored (RGB) brick volume of the three POSES, on the CPU."""
    _, cfg, depth, rgb = _scene(small_cfg, "RGB")
    vol = tb.make_brick_volume(cfg, 8, capacity, device="cpu")
    for p in POSES:
        tb.integrate_bricks(vol, depth, p, rgb, 1024)
    return vol, depth


@pytest.mark.parametrize("chunk_slots", [2048, 64], ids=["one_chunk", "chunks"])
def test_unchecked_extraction_has_no_host_sync(small_cfg, chunk_slots):
    """The unchecked extraction with a checked call's live chunks and hints
    (the chunk programs: brick stats, candidates, the corner halo's and the
    budgeted emission's plain versions, the scan, the colors) runs no op
    that syncs with the host, and gives the checked call's triangles. A
    first call copies the case tables to the device once (that call is
    not recorded); the checked route syncs once a batch by design."""
    from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

    vol, _ = _fused(small_cfg)
    checked = tmc.extract_soup_bricks(vol, 0.5, True, False, chunk_slots)
    hint = dict(live_chunks=checked.live_chunks, budget_hint=checked.budget_hint, check=False)
    with SyncRecorder() as rec:
        soup = tmc.extract_soup_bricks(vol, 0.5, True, False, chunk_slots, **hint)
    assert rec.syncs == [], rec.syncs
    assert int(checked.num_triangles) > 300 and not bool(soup.overflowed)
    assert torch.equal(soup.vertices[soup.tri_valid], checked.vertices)
    assert torch.equal(soup.colors[soup.tri_valid], checked.colors)
    if chunk_slots == 64:
        assert len(checked.live_chunks) > 1


def test_checked_extraction_syncs_once_a_batch(small_cfg, monkeypatch):
    """The checked extraction in chunks of 64 slots, its budgets small
    enough that a chunk retries, with the live chunks given: no op that
    syncs with the host runs in it, and its only host reads are the
    counts of each batch (one .tolist() a batch: the brick stats of each
    live chunk and each pending chunk's program are what the card replays
    from graphs, one a budget triple). graph=False gives the default's
    triangles, colors and hints on CPU tensors, and graph=True raises
    there."""
    from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc

    vol, _ = _fused(small_cfg)
    want = tmc.extract_soup_bricks(vol, 0.5, True, False, 64)
    assert len(want.live_chunks) > 1 and int(want.num_triangles) > 300
    reads = []
    tolist = torch.Tensor.tolist

    def counted(t):
        reads.append(tuple(t.shape))
        return tolist(t)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    with SyncRecorder() as rec:
        got = tmc.extract_soup_bricks(vol, 0.5, True, False, 64, 512,
                                      live_chunks=want.live_chunks)
    assert rec.syncs == [], rec.syncs
    n = len(want.live_chunks)
    assert len(reads) >= 2 and reads[0] == (n, 6) and all(r[1:] == (6,) for r in reads)
    monkeypatch.undo()
    eager = tmc.extract_soup_bricks(vol, 0.5, True, False, 64, 512,
                                    live_chunks=want.live_chunks, graph=False)
    for soup in (got, eager):
        assert torch.equal(soup.vertices, want.vertices) and torch.equal(soup.colors,
                                                                         want.colors)
    assert got.budget_hint == eager.budget_hint == want.budget_hint
    with pytest.raises(ValueError):
        tmc.extract_soup_bricks(vol, 0.5, True, False, 64, graph=True)


def test_refine_step_and_residual_have_no_host_sync(small_cfg):
    """A refine_pose_step and a depth_residual on device tensors (the step
    scale a 0-dim tensor: a Python number is filled on the device) run no
    op that syncs with the host: no copy of the pose's bottom row, no
    error check of the solve."""
    from cpu_tsdf_tpu_torch import refine as tr

    vol, depth = _fused(small_cfg)
    pose = torch.as_tensor(POSES[1], dtype=torch.float32)
    depth = torch.as_tensor(depth)
    lr = torch.full((), 0.5)
    with SyncRecorder() as rec:
        new, loss = tr.refine_pose_step(vol, pose, depth, 1, 256, lr)
        res = tr.depth_residual(vol, new, depth, 1)
    assert rec.syncs == [], rec.syncs
    want, want_loss = tr.refine_pose_step(vol, pose.numpy(), depth.numpy(), 1, 256, 0.5)
    assert torch.equal(new, want) and torch.equal(loss, want_loss) and float(loss) > 0
    assert 0 < float(res) < float(tr.depth_residual(vol, pose, depth, 1))


def test_organize_has_no_host_sync(small_cfg):
    """organize_cloud on device tensors runs no op that syncs with the host,
    with and without colors."""
    from cpu_tsdf_tpu_torch.pipeline import organize_cloud

    cfg = TSDFConfig.from_json(small_cfg.to_json())
    rng = np.random.default_rng(2)
    pts = torch.as_tensor(rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)) + \
        torch.tensor([0.0, 0.0, 1.0])
    rgb = torch.as_tensor(rng.integers(0, 256, (500, 3)).astype(np.float32))
    with SyncRecorder() as rec:
        depth, _ = organize_cloud(cfg, pts, device="cpu")
        depth_c, img = organize_cloud(cfg, pts, rgb, device="cpu")
    assert rec.syncs == [], rec.syncs
    assert int((~depth.isnan()).sum()) > 100 and torch.equal(depth.nan_to_num(),
                                                             depth_c.nan_to_num())


def test_graph_switch_of_extraction_refine_organize(small_cfg):
    """graph=True raises on the CPU in the unchecked and the checked
    extraction, extract_mesh of a brick and of a dense volume, the refine
    step, the residual, refine_pose and organize_cloud; graph=None on the
    CPU is the eager route."""
    from cpu_tsdf_tpu_torch import refine as tr
    from cpu_tsdf_tpu_torch.ops import marching_cubes as tmc
    from cpu_tsdf_tpu_torch.pipeline import organize_cloud

    vol, depth = _fused(small_cfg, 512)
    pose = POSES[1].astype(np.float32)
    calls = [lambda g: tmc.extract_soup_bricks(vol, 0.5, check=False, graph=g),
             lambda g: tmc.extract_soup_bricks(vol, 0.5, graph=g),
             lambda g: tr.refine_pose_step(vol, pose, depth, graph=g),
             lambda g: tr.depth_residual(vol, pose, depth, graph=g),
             lambda g: tr.refine_pose(vol, pose, depth, iters=1, graph=g),
             lambda g: organize_cloud(vol.config, np.ones((4, 3), np.float32), device="cpu",
                                      graph=g),
             lambda g: tmc.extract_mesh(vol, 0.5, graph=g),
             lambda g: tmc.extract_mesh(tb.to_dense(vol), 0.5, graph=g)]
    for call in calls:
        with pytest.raises(ValueError):
            call(True)
    a, b = calls[0](None), calls[0](False)
    assert torch.equal(a.tri_valid, b.tri_valid) and torch.equal(a.vertices[a.tri_valid],
                                                                 b.vertices[b.tri_valid])
    assert torch.equal(calls[2](None)[0], calls[2](False)[0])


def test_checked_extraction_keeps_at_most_its_own_graphs(monkeypatch):
    """A checked extraction's key keeps at most MAX_CHECKED_GRAPHS graphs:
    a capture past that drops its least recently used chunk graph, never
    its brick stats' graph (a replay makes a graph the most recently used
    of its key); the key counts as one of the MAX_GRAPHS keys."""
    monkeypatch.setattr(tg, "MAX_GRAPHS", 2)
    monkeypatch.setattr(tg, "MAX_CHECKED_GRAPHS", 3)
    monkeypatch.setattr(tg, "_cache", collections.OrderedDict())

    class Captured:
        out = "out"
        warm = "warm"

        def __init__(self, device=None, program=None):
            pass

        def replay(self):
            pass

    monkeypatch.setattr(tg, "_Captured", Captured)
    checked = tg._CheckedGraphs.__new__(tg._CheckedGraphs)
    checked.bv = dataclasses.make_dataclass("Vol", ["device"])(torch.device("cpu"))
    checked.graphs = collections.OrderedDict()
    for k in ("stats", 0, 1):
        assert checked._run(k, None) == ("warm", False)    # a capture, its warm-up's result
    assert checked._run(0, None) == ("out", True)          # a replay
    assert list(checked.graphs) == ["stats", 1, 0]
    assert checked._run(2, None) == ("warm", False)
    assert list(checked.graphs) == ["stats", 0, 2]
    assert checked._run("stats", None) == ("out", True)
    assert checked._run(3, None) == ("warm", False)
    assert list(checked.graphs) == [2, "stats", 3]
    tg._keep("checked", checked)
    tg._keep("frame", object())
    assert list(tg._cache) == ["checked", "frame"]
    tg._keep("render", object())                          # "checked" is the oldest key
    assert list(tg._cache) == ["frame", "render"]
