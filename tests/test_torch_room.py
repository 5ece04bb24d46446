"""A room on the brick route, on the CPU, in plain torch (no JAX): the frame
budgets the port derives from the update budget and the volume
(``bricks.tile_budget_for``, ``carve_budget_for``), a small room fused
through ``integrate_bricks_sequence`` against the dense route, the list
counts that a frame records with tracing on (the counter group
``activation.lists``), and nothing recorded with tracing off.

The room is the benchmark's room scene (``portbench/scenes/room.py``) at a
160x120 image on a 160^3 grid over 3 m, a band of four voxels, 12 poses of
its sweep: its frames carve up to ~316 live bricks, more than the former
carve budget of an eighth of the band budget (256 at 2048) held."""

import pytest
import torch

from cpu_tsdf_tpu_torch import activation as ta
from cpu_tsdf_tpu_torch import bricks as tb
from cpu_tsdf_tpu_torch import tracing
from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.geometry import rigid_inverse
from cpu_tsdf_tpu_torch.ops.fusion import integrate
from cpu_tsdf_tpu_torch.volume import make_volume

import torch_common  # noqa: F401  (one intra-op thread)

# (update budget, capacity, bricks an axis) -> the largest counts a frame
# reached in a CPU rehearsal of the configuration's scene (the band-active
# tiles, the rough bricks, the band bricks, the carve slots), or None: the
# derived budgets must be exactly the former 1024 tiles and 1024 slots.
BUDGET_CASES = {
    # bricks8.scan: KinectFusion's 512^3 orbit, 2^13 band bricks, 2^15 rows
    "orbit": (1 << 13, 1 << 15, 64, None),
    # InfiniTAM's deployment (5 mm voxels, 600^3 over 3 m, a pool of 2^18
    # rows) on the benchmark's room sweep with 2^16 band bricks; the
    # rehearsal's largest counts over two passes of its 120 frames
    "room": (1 << 16, 1 << 18, 75, (1752, 100433, 39289, 16805)),
}


@pytest.mark.parametrize("case", list(BUDGET_CASES))
def test_frame_budgets(case):
    """At bricks8.scan's values the derived budgets are the former ones (so
    its frame graph launches the same work); at the room's, the tile list,
    the rough list U2, the band list and the carve list each hold the
    rehearsal's largest count with at least 25 % to spare."""
    U, C, n, most = BUDGET_CASES[case]
    nb = (n, n, n)
    tiles = tb.tile_budget_for(U, nb)
    carve = tb.carve_budget_for(U, capacity=C, nb=nb)
    _, _, _, n_tiles, tiles_held, U2 = ta._tile_grid(nb, U, tiles)
    if most is None:
        assert (tiles, carve) == (1024, 1024)
        assert (tiles_held, U2) == (1024, 2 * U)
        return
    for held, count in zip((tiles_held, U2, U, carve), most):
        assert held >= 1.25 * count, (held, count)
    assert tiles_held == n_tiles == 19 ** 3 and carve <= C


def test_budgets_keep_their_floors():
    """The derivation never goes below the former budgets' floors: 1024
    tiles (the JAX package's fixed budget), an eighth of the band budget
    and 256 carve slots; and the carve list never outgrows the pool."""
    for U in (4, 256, 1 << 13, 1 << 15):
        for C, n in ((8, 8), (2048, 8), (1 << 15, 64), (1 << 15, 256)):
            nb = (n, n, n)
            assert tb.tile_budget_for(U, nb) >= 1024
            carve = tb.carve_budget_for(U, capacity=C, nb=nb)
            assert carve <= C and (carve == C or carve >= max(256, U // 8))
            assert carve == C or carve % 128 == 0


ROOM_CFG = TSDFConfig(xres=160, yres=160, zres=160, max_dist_pos=0.075, max_dist_neg=0.075,
                      min_sensor_dist=0.2, image_width=160, image_height=120,
                      focal_length_x=131.25, focal_length_y=131.25, principal_point_x=80.0,
                      principal_point_y=60.0, integrate_color=True)
ROOM_BUDGET, ROOM_CAPACITY = 2048, 4096


@pytest.fixture(scope="module")
def room_frames():
    from portbench import core

    params = core.load_json(core.HERE / "traffic" / "room_scan.json")["scene_params"]
    params["path"]["poses"] = 12
    return core.scene_module("room").frames(params, ROOM_CFG, "cpu")


def test_small_room_fuses_into_bricks_like_dense(room_frames):
    """Two passes of the small room through integrate_bricks_sequence: no
    overflow; in the truncation band (the dense volume's voxels with weight
    > 0 and |sdf| < 0.999) the brick volume equals the dense route voxel
    by voxel (sdf, weight, nsample, color); and its frames carve more live
    bricks than the former carve budget (an eighth of the band budget, at
    least 256) held, so that budget would have overflowed."""
    fr = room_frames
    seq = [torch.cat([fr[k]] * 2) for k in ("depths", "poses", "rgbs")]
    vol = tb.make_brick_volume(ROOM_CFG, 8, ROOM_CAPACITY, device="cpu")
    tracing.enable()
    try:
        tb.integrate_bricks_sequence(vol, *seq, ROOM_BUDGET)
        counts = tracing.report()["counters"]
    finally:
        tracing.disable()
    assert not bool(vol.overflowed) and int(vol.n_active) > 2000
    former_carve = max(256, (ROOM_BUDGET // 8 + 127) // 128 * 128)
    assert counts["activation.lists.carve"]["max"] > former_carve
    assert counts["activation.lists.carve"]["budget"] == tb.frame_budgets(vol, ROOM_BUDGET)[1]

    dense = make_volume(ROOM_CFG, device="cpu")
    for depth, pose, rgb in zip(*seq):
        dense = integrate(dense, depth, pose, rgb)
    got = tb.to_dense(vol)
    band = (dense.weight > 0) & (dense.sdf.abs() < 0.999)
    assert int(band.sum()) > 100_000
    for name in ("sdf", "weight", "nsample", "color"):
        a, b = getattr(got, name)[band], getattr(dense, name)[band]
        assert torch.equal(a, b), name


def test_list_counts_are_the_lists_lengths(room_frames, monkeypatch):
    """With tracing on, each frame records its lists' lengths in full
    (activation.lists: tiles, rough, band, carve), each beside its budget:
    the report's means and maxima equal those of the lengths counted from
    the plain code's masks on the volume as each frame finds it."""
    fr = room_frames
    vol = tb.make_brick_volume(ROOM_CFG, 8, ROOM_CAPACITY, device="cpu")
    nb, B = vol.bricks_per_axis, 8
    tile_budget, carve_budget = tb.frame_budgets(vol, ROOM_BUDGET)
    _, _, _, _, tiles_held, U2 = ta._tile_grid(nb, ROOM_BUDGET, tile_budget)
    masks = []
    compact = ta._compact

    def spy(mask, ids, n_max):
        masks.append(int(mask.sum()))
        return compact(mask, ids, n_max)

    want = {"tiles": [], "rough": [], "band": [], "carve": []}
    tracing.enable()
    try:
        for f in range(4):
            depth, pose, rgb = fr["depths"][f], fr["poses"][f], fr["rgbs"][f]
            pinv = rigid_inverse(pose)
            mips = ta.depth_mips(depth, ta.mip_base_level(ROOM_CFG, B))
            monkeypatch.setattr(ta, "_compact", spy)
            masks.clear()
            ta.band_candidate_bricks(ROOM_CFG, B, nb, mips, pinv, 1 << 20, tile_budget=1 << 20)
            monkeypatch.setattr(ta, "_compact", compact)
            carve = ta.carve_candidate_slots(ROOM_CFG, B, mips, pinv, vol.coords,
                                             vol.coords[:, 0] >= 0)
            for name, n in zip(want, masks + [int(carve.sum())]):
                want[name].append(n)
            tb.integrate_bricks(vol, depth, pose, rgb, ROOM_BUDGET)
        rep = tracing.report()["counters"]
    finally:
        tracing.disable()
    budgets = {"tiles": tiles_held, "rough": U2, "band": ROOM_BUDGET, "carve": carve_budget}
    assert max(want["carve"]) > 0 and max(want["band"]) > 1000
    for name, lengths in want.items():
        got = rep[f"activation.lists.{name}"]
        assert got == {"count": 4, "mean": sum(lengths) / 4, "max": max(lengths),
                       "budget": budgets[name]}, name


@pytest.mark.parametrize("budget,capacity,want", [
    (ROOM_BUDGET, ROOM_CAPACITY, []), (ROOM_BUDGET, 256, ["capacity"]),
    (1024, ROOM_CAPACITY, ["rough", "band"])], ids=["room", "capacity", "update_budget"])
def test_frame_limits_name_what_overflowed(room_frames, budget, capacity, want):
    """integrate_bricks(limits=...) hands back the frame's own list lengths
    and pool rows, each beside its limit, as the frame computed them:
    exceeded_limits names those a frame exceeded, and a frame names one
    exactly when it sets ``overflowed``."""
    fr = room_frames
    vol = tb.make_brick_volume(ROOM_CFG, 8, capacity, device="cpu")
    limits = {}
    tb.integrate_bricks(vol, fr["depths"][0], fr["poses"][0], fr["rgbs"][0], budget,
                        limits=limits)
    assert set(limits) == {"tiles", "rough", "band", "carve", "capacity"}
    assert tb.exceeded_limits(limits) == want
    assert bool(vol.overflowed) == bool(want)
    assert int(limits["band"][1]) == budget and int(limits["band"][0]) > 1000
    assert int(limits["capacity"][1]) == capacity - 1    # the free rows; the dump row is kept


def test_untraced_frames_record_nothing(room_frames, monkeypatch):
    """With tracing off a frame records no counts (tracing.count is not
    called, so the frame's graph has no node for it); with it on, one row
    a frame."""
    calls = []
    monkeypatch.setattr(tracing, "count", lambda *a, **k: calls.append(a[0]))
    fr = room_frames
    vol = tb.make_brick_volume(ROOM_CFG, 8, ROOM_CAPACITY, device="cpu")
    tb.integrate_bricks_sequence(vol, fr["depths"][:2], fr["poses"][:2], fr["rgbs"][:2],
                                 ROOM_BUDGET)
    assert calls == []
    tracing.enable()
    try:
        tb.integrate_bricks_sequence(vol, fr["depths"][:2], fr["poses"][:2], fr["rgbs"][:2],
                                     ROOM_BUDGET)
    finally:
        tracing.disable()
    assert calls == [tb.LIST_COUNTS] * 2


def test_count_refuses_what_it_cannot_record():
    """tracing.count takes 1 to MAX_COUNTS int32 scalars on the device it
    is given."""
    tracing.enable()
    try:
        one = torch.ones((), dtype=torch.int32)
        with pytest.raises(ValueError):
            tracing.count("g", torch.device("cpu"), {"a": (one.long(), 1)})
        with pytest.raises(ValueError):
            tracing.count("g", torch.device("cpu"), {})
        tracing.count("g", torch.device("cpu"), {"a": (one, 4), "b": (one + 2, 5)})
        tracing.count("g", torch.device("cpu"), {"a": (one + 1, 4), "b": (one, 5)})
        rep = tracing.report()["counters"]
    finally:
        tracing.disable()
    assert rep["g.a"] == {"count": 2, "mean": 1.5, "max": 2, "budget": 4}
    assert rep["g.b"] == {"count": 2, "mean": 2.0, "max": 3, "budget": 5}
