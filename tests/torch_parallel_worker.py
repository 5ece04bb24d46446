"""The port's sharded paths on 4 CPU ranks over gloo, for
tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py INPUTS.npz OUT_DIR PORT

spawns 4 ranks (torch.multiprocessing) that rendezvous on
tcp://127.0.0.1:PORT, run every sharded case on the scenes in INPUTS.npz,
and write OUT_DIR/rank<r>.npz. Each rank also computes the port's
single-device result where a case compares with it. The ranks import only
the port and check that jax is not loaded; a rank that hangs is ended at
the deadline and the script exits non-zero. relay_by_slabs, the relay march
in one process, serves the CPU and card tests of the relay mode.
"""

import json
import os
import sys
import time

import numpy as np

WORLD = 4
DEADLINE_S = 240


def relay_by_slabs(march, pack, origins, dirs, D):
    """One process's stand-in for the relay of parallel/raycast.py: each
    ray marched slab by slab (D slabs of voxel x), each segment from the
    state where the last stopped. Returns the channels and the number of
    segments the rays took at most."""
    import torch

    from cpu_tsdf_tpu_torch.geometry import voxel_index
    from cpu_tsdf_tpu_torch.ops.raycast_kernel import relay_state

    cfg = pack.config
    nx = cfg.xres // D
    N = origins.shape[0]
    state = relay_state(cfg, N, origins.device)
    ch = torch.zeros((8, N), device=origins.device)
    ix = voxel_index(cfg, *(origins[:, k] + state[0] * dirs[:, k] for k in range(3)))[0]
    owner = torch.clamp(ix, 0, cfg.xres - 1).long() // nx
    active = torch.ones(N, dtype=torch.bool, device=origins.device)
    for segments in range(1, D + 1):
        for r in range(D):
            idx = torch.nonzero(active & (owner == r)).squeeze(1)
            if not idx.numel():
                continue
            st = state[:, idx].contiguous()
            c = march(pack, origins[idx].contiguous(), dirs[idx].contiguous(), 512,
                      relay=(st, r * nx, (r + 1) * nx))
            state[:, idx] = st
            ended = st[6] == 0
            ch[:, idx[ended]] = c[:, ended]
            active[idx[ended]] = False
            owner[idx[~ended]] = torch.clamp(st[7, ~ended].long(), 0, cfg.xres - 1) // nx
        if not bool(active.any()):
            return ch, segments
    raise AssertionError("rays still suspended")


def _scene_cfg(inputs, name):
    from cpu_tsdf_tpu_torch.config import TSDFConfig

    return TSDFConfig.from_json(str(inputs[name]))


def _dense_cases(inputs, mesh, out):
    """tests/test_sharding.py: integrate, two frames, render, MC, gradient."""
    import torch

    from cpu_tsdf_tpu_torch import integrate, make_volume, render_view
    from cpu_tsdf_tpu_torch.ops.marching_cubes import extract_mesh
    from cpu_tsdf_tpu_torch.parallel import (integrate_sharded, render_view_sharded,
                                             replicate_volume, shard_volume)

    cfg = _scene_cfg(inputs, "cfg_a")
    depth = torch.from_numpy(inputs["depth_a"])
    poses = [torch.from_numpy(p) for p in inputs["poses_a"]]
    single = make_volume(cfg, device="cpu")
    sharded = shard_volume(make_volume(cfg, device="cpu"), mesh)
    assert sharded.local.sdf.shape[0] == cfg.xres // WORLD
    for k, p in enumerate(poses):
        single = integrate(single, depth, p)
        sharded = integrate_sharded(sharded, depth, p)
        full = replicate_volume(sharded, mesh)
        for name in ("sdf", "weight", "M", "nsample"):
            out[f"dense{k + 1}_{name}"] = getattr(full, name).numpy()
            out[f"dense{k + 1}_{name}_single"] = getattr(single, name).numpy()
        if k == 0:
            one, one_single = sharded, single

    # the ray-sharded render, of a replicated volume and of a sharded one
    for name, vol in (("render", one_single), ("render_from_shards", one)):
        r = render_view_sharded(vol, poses[0], mesh)
        out[f"{name}_depth"], out[f"{name}_normals"] = r.depth.numpy(), r.normals.numpy()
    r = render_view(one_single, poses[0])
    out["render_depth_single"], out["render_normals_single"] = r.depth.numpy(), r.normals.numpy()

    # marching cubes of the gathered slabs
    v, f, _ = extract_mesh(replicate_volume(one, mesh), min_weight=0.5)
    vs, fs, _ = extract_mesh(one_single, min_weight=0.5)
    out.update(mc_verts=v, mc_faces=f, mc_verts_single=vs, mc_faces_single=fs)

    # the pose gradient through the sharded integrate, all-reduced
    def loss(v):
        return torch.sum(torch.where(v.weight > 0, v.sdf, 0.0) ** 2)

    pose = poses[0].clone().requires_grad_(True)
    loss(integrate_sharded(shard_volume(make_volume(cfg, device="cpu"), mesh),
                           depth, pose).local).backward()
    out["grad"] = pose.grad.numpy()
    pose1 = poses[0].clone().requires_grad_(True)
    loss(integrate(make_volume(cfg, device="cpu"), depth, pose1)).backward()
    out["grad_single"] = pose1.grad.numpy()


def _brick_cases(inputs, mesh, hybrid, out):
    """tests/test_sharded_bricks.py: the slab-sharded brick integrate."""
    import torch

    from cpu_tsdf_tpu_torch import render_view
    from cpu_tsdf_tpu_torch.bricks import integrate_bricks, make_brick_volume, to_dense
    from cpu_tsdf_tpu_torch.convert import brick_volume_to_arrays
    from cpu_tsdf_tpu_torch.ops.marching_cubes import extract_mesh
    from cpu_tsdf_tpu_torch.parallel.bricks import (integrate_bricks_sharded,
                                                    make_sharded_brick_volume,
                                                    merge_sharded)

    cfg = _scene_cfg(inputs, "cfg_a")
    depth = inputs["depth_a"]
    poses = inputs["poses_a"]

    def sharded(c, frames, m=mesh, rgb=None, **kw):
        bv = make_sharded_brick_volume(c, m, 8, capacity_per_device=512, device="cpu")
        for p in frames:
            integrate_bricks_sharded(bv, depth, p, m, rgb=rgb, **kw)
        return bv

    # one frame at the default budget: held against JAX's merge_sharded row for row
    bv = sharded(cfg, poses[:1])
    out["local_n_active"] = int(bv.n_active)
    out["local_brick_map_shape"] = np.array(bv.brick_map.shape)
    merged = merge_sharded(bv)
    for k, a in brick_volume_to_arrays(merged).items():
        if a is not None:
            out[f"b1_{k}"] = a
    r = render_view(merged, poses[0])
    out["b1_render_valid"] = int((~torch.isnan(r.depth)).sum())
    v, f, _ = extract_mesh(merged, min_weight=0.5)
    out["b1_mesh_verts"], out["b1_mesh_faces"] = v, f

    # two frames against the single-device brick path
    m2 = to_dense(merge_sharded(sharded(cfg, poses)))
    single = make_brick_volume(cfg, 8, 2048, device="cpu")
    for p in poses:
        integrate_bricks(single, depth, p)
    s2 = to_dense(single)
    for name in ("sdf", "weight"):
        out[f"b2_{name}"], out[f"b2_{name}_single"] = (getattr(m2, name).numpy(),
                                                       getattr(s2, name).numpy())

    # color fusion at update_budget 128
    ccfg = cfg.with_updates(integrate_color=True, color_mode="RGB")
    rgb = inputs["rgb_a"]
    mc = to_dense(merge_sharded(sharded(ccfg, poses[:1], rgb=rgb, update_budget=128)))
    sc = to_dense(integrate_bricks(make_brick_volume(ccfg, 8, 2048, device="cpu"),
                                   depth, poses[0], rgb))
    for name in ("weight", "color"):
        out[f"b3_{name}"], out[f"b3_{name}_single"] = (getattr(mc, name).numpy(),
                                                       getattr(sc, name).numpy())

    # per-rank budgets: too small overflows; sufficient equals the default
    for name, kw in (("full", {}), ("tight", {"budget_per_device": 8}),
                     ("ok", {"budget_per_device": 512})):
        vol = sharded(cfg, poses[:1], update_budget=4096, **kw)
        out[f"b4_{name}_overflowed"] = bool(vol.overflowed)
        if name != "tight":
            d = to_dense(merge_sharded(vol))
            out[f"b4_{name}_sdf"], out[f"b4_{name}_weight"] = d.sdf.numpy(), d.weight.numpy()

    # a 2x2 (dcn, shard) mesh against the 1D mesh of 4
    for name, m in (("1d", mesh), ("hybrid", hybrid)):
        vol = sharded(cfg, poses[:1], m=m, update_budget=1024)
        d = to_dense(merge_sharded(vol))
        out[f"b5_{name}_n_active"] = int(merge_sharded(vol).n_active)
        out[f"b5_{name}_overflowed"] = bool(vol.overflowed)
        out[f"b5_{name}_sdf"], out[f"b5_{name}_weight"] = d.sdf.numpy(), d.weight.numpy()


def _render_cases(inputs, mesh, out):
    """tests/test_sharded_raycast.py: the tile- and volume-sharded renders
    against the port's single-device render of the merged volume."""
    from cpu_tsdf_tpu_torch import render_view
    from cpu_tsdf_tpu_torch.parallel import render_view_pallas_sharded
    from cpu_tsdf_tpu_torch.parallel.bricks import (integrate_bricks_sharded,
                                                    make_sharded_brick_volume,
                                                    merge_sharded)
    from cpu_tsdf_tpu_torch.parallel.raycast import render_view_volume_sharded

    cfg = _scene_cfg(inputs, "cfg_b")
    pose = inputs["pose_b"]
    sb = make_sharded_brick_volume(cfg, mesh, 8, capacity_per_device=256, device="cpu")
    integrate_bricks_sharded(sb, inputs["depth_b"], pose, mesh, rgb=inputs["rgb_b"])
    merged = merge_sharded(sb)
    out["r_n_active"] = int(merged.n_active)
    out["r_overflowed"] = bool(merged.overflowed)
    views = {"single": render_view(merged, pose, colored=True),
             "tiles": render_view_pallas_sharded(merged, pose, mesh, colored=True),
             "tiles_budget16": render_view_pallas_sharded(merged, pose, mesh, colored=True,
                                                          pair_budget_local=16),
             "volume": render_view_volume_sharded(sb, pose, mesh, colored=True)[0],
             "volume_ds2": render_view_volume_sharded(sb, pose, mesh, downsample_by=2)[0],
             "single_ds2": render_view(merged, pose, downsample_by=2)}
    for name, r in views.items():
        out[f"r_{name}_depth"], out[f"r_{name}_normals"] = r.depth.numpy(), r.normals.numpy()
        if r.rgb is not None:
            out[f"r_{name}_rgb"] = r.rgb.numpy()


def _oblique_cases(inputs, mesh, out):
    """The sharded renders of oblique views: 8 views of an orbit around a
    radius-0.5 sphere fused at the main path's cell and brick size (5.9 mm,
    47 mm; 256^3 over 1.5 m, 80x60 pixels at the 640x480 camera's field of
    view). Rays of view 6 cross the band of one slab beyond the ghost plane
    before their crossing in the next, where the adaptive step reads |d|
    (parallel/raycast.py)."""
    from cpu_tsdf_tpu_torch import render_view
    from cpu_tsdf_tpu_torch.parallel import render_view_pallas_sharded, render_view_sharded
    from cpu_tsdf_tpu_torch.parallel.bricks import (integrate_bricks_sharded,
                                                    make_sharded_brick_volume, merge_sharded)
    from cpu_tsdf_tpu_torch.parallel.raycast import render_view_volume_sharded

    cfg = _scene_cfg(inputs, "cfg_c")
    sb = make_sharded_brick_volume(cfg, mesh, 8, capacity_per_device=1 << 12, device="cpu")
    for depth, pose in zip(inputs["depths_c"], inputs["poses_c"]):
        integrate_bricks_sharded(sb, depth, pose, mesh, 1 << 12, inputs["rgb_c"])
    merged = merge_sharded(sb)
    out["c_overflowed"] = bool(merged.overflowed)
    for i in (0, 6):
        pose = inputs["poses_c"][i]
        views = {"single": render_view(merged, pose, colored=True),
                 "rays": render_view_sharded(merged, pose, mesh, colored=True),
                 "tiles": render_view_pallas_sharded(merged, pose, mesh, colored=True),
                 "volume": render_view_volume_sharded(sb, pose, mesh, colored=True)[0]}
        for name, r in views.items():
            for c in ("depth", "normals", "rgb"):
                out[f"c{i}_{name}_{c}"] = getattr(r, c).numpy()


def _runtime_cases(rank, mesh, hybrid, out):
    """distributed.py: idempotent initialize, meshes, shard and replicate."""
    import torch

    from cpu_tsdf_tpu_torch.parallel.distributed import (AXIS, DCN_AXIS, initialize,
                                                         replicate_to_mesh, shard_to_mesh)

    out["initialize_again"] = initialize()
    out["hybrid_shape"] = np.array(hybrid.mesh.shape)
    out["hybrid_coords"] = np.array([hybrid.get_local_rank(DCN_AXIS),
                                     hybrid.get_local_rank(AXIS)])
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out["shard_block"] = shard_to_mesh(x, mesh, (AXIS,), device="cpu").numpy()
    out["shard_block_hybrid"] = shard_to_mesh(x, hybrid, (AXIS,), device="cpu").numpy()
    out["replicated"] = replicate_to_mesh(np.full(3, rank, np.int32), mesh,
                                          device="cpu").numpy()
    assert torch.distributed.get_backend() == "gloo"


def rank_main(rank, inputs_path, out_dir, port):
    import torch

    torch.set_num_threads(2)
    from cpu_tsdf_tpu_torch.parallel.distributed import (initialize, make_hybrid_mesh,
                                                         make_mesh)

    assert initialize(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    mesh = make_mesh("cpu")
    hybrid = make_hybrid_mesh(2, device="cpu")
    inputs = dict(np.load(inputs_path))
    out = {}
    times = {}
    for name, case in (("runtime", lambda: _runtime_cases(rank, mesh, hybrid, out)),
                       ("dense", lambda: _dense_cases(inputs, mesh, out)),
                       ("bricks", lambda: _brick_cases(inputs, mesh, hybrid, out)),
                       ("render", lambda: _render_cases(inputs, mesh, out)),
                       ("oblique", lambda: _oblique_cases(inputs, mesh, out))):
        t0 = time.perf_counter()
        case()
        times[name] = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "cpu_tsdf_tpu.")))
    assert not loaded, loaded
    out["times"] = json.dumps(times)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp

    inputs_path, out_dir, port = argv[1], argv[2], int(argv[3])
    ctx = mp.start_processes(rank_main, args=(inputs_path, out_dir, port), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                print(f"ranks still running after {DEADLINE_S} s", file=sys.stderr)
                return 1
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
