"""The work counts of portbench/work/ agree with the port's own arithmetic
(bytes_moved, ops_needed, dense_candidates, march_work) and with what the
port does, at a small size on the CPU."""

import pytest
import torch
from small import small_files

from portbench import core
from portbench.check import field_of
from portbench.system import System
from portbench.work import dense_fusion, fusion, march


def setup(cell):
    files = small_files(cell)
    cfg = core.tsdf_config(files["config"])
    tr = files["traffic"]
    frames = core.scene_module(tr["scene"]).frames(tr["scene_params"], cfg, "cpu")
    return files, cfg, frames


@pytest.mark.parametrize("n", [0, 1, 219729])
def test_fusion_bytes_and_ops_match_the_port(n):
    from cpu_tsdf_tpu_torch.ops import fusion_kernel as fk

    cfg = core.tsdf_config(core.cell_files("bricks8.scan")["config"])
    assert fusion.frame_bytes(n, 480, 640, 3) == fk.voxel_bytes(n, 480, 640, 3)
    assert fusion.frame_ops(cfg, 5 * n, n) == fk.ops_needed(cfg, 5 * n, n)


def test_brick_observed_voxels_are_what_the_port_updates():
    files, cfg, frames = setup("bricks8.scan")
    s = System(files["config"], cfg, "cpu")
    s.fuse_pass(frames["depths"][:1], frames["poses"][:1], frames["rgbs"][:1])
    lin = fusion.brick_voxels(cfg, s.live_rows(), s.vol.brick_size)
    assert fusion.observed(cfg, frames, 0, lin) == int((s.vol.weight > 0).sum()) > 100


def test_dense_counts_match_the_port():
    from cpu_tsdf_tpu_torch.geometry import rigid_inverse
    from cpu_tsdf_tpu_torch.ops.fusion_kernel import dense_candidates

    files, cfg, frames = setup("dense512.scan")
    s = System(files["config"], cfg, "cpu")
    for f in (0, 3):
        s.vol.weight.zero_()
        s.fuse_pass(frames["depths"][f:f + 1], frames["poses"][f:f + 1], frames["rgbs"][f:f + 1])
        n_obs, n_cand = dense_fusion.frame_counts(cfg, frames["depths"][f], frames["poses"][f],
                                                  frames["rgbs"][f])
        assert n_obs == int((s.vol.weight > 0).sum()) > 1000
        assert n_cand == int(dense_candidates(cfg, rigid_inverse(frames["poses"][f]),
                                              frames["depths"][f]))


def test_march_operations_match_the_port():
    from cpu_tsdf_tpu_torch.bricks import pack_render
    from cpu_tsdf_tpu_torch.ops.raycast import camera_rays
    from cpu_tsdf_tpu_torch.ops.raycast_kernel import march_work

    files, cfg, frames = setup("bricks8.view")
    s = System(files["config"], cfg, "cpu")
    s.fuse_pass(frames["depths"], frames["poses"], frames["rgbs"])
    pose = frames["poses"][2]
    _, ops = march.render_work(cfg, field_of(s), pose, 512)
    o, d = camera_rays(cfg, pose)
    assert ops == march_work(pack_render(s.vol), o.contiguous(), d.contiguous(), 512)[1] > 0
