"""The system under test: the port's public entry points, as a user of the
port calls them, behind the few verbs the traffic runners use. The harness
takes nothing else from the program than these calls, their results, the
program's state as the judge reads it, ``graph.stats()`` and the launch
counters.

A configuration's ``volume`` picks the route: ``bricks`` (``make_brick_volume``,
``integrate_bricks(_sequence)``, the frame's CUDA graph on the card) or
``dense`` (``make_volume``, ``ops.fusion.integrate``, the dense fusion
kernel in place)."""

from __future__ import annotations

import torch


class System:
    def __init__(self, config: dict, cfg, device):
        from cpu_tsdf_tpu_torch import bricks
        from cpu_tsdf_tpu_torch.volume import make_volume

        self.bricks, self.cfg, self.device = bricks, cfg, torch.device(device)
        self.kind = config["volume"]
        self.budget = int(config.get("update_budget", 0))
        if self.kind == "bricks":
            self.vol = bricks.make_brick_volume(cfg, int(config["brick_size"]),
                                           int(config["capacity"]), device=self.device)
        elif self.kind == "dense":
            self.vol = make_volume(cfg, device=self.device)
        else:
            raise ValueError(f"unknown volume kind {self.kind!r}")

    # ---- the timed calls -------------------------------------------------

    def fuse_pass(self, depths, poses, rgbs) -> None:
        """Fuse frames in order, dispatched ahead: no host sync."""
        if self.kind == "bricks":
            self.bricks.integrate_bricks_sequence(self.vol, depths, poses, rgbs, self.budget)
            return
        from cpu_tsdf_tpu_torch.ops.fusion import integrate

        for i in range(depths.shape[0]):
            self.vol = integrate(self.vol, depths[i], poses[i], rgbs[i])

    def render(self, pose, render: dict):
        """A render_view result (RenderResult of device tensors)."""
        from cpu_tsdf_tpu_torch.ops.raycast import render_view

        return render_view(self.vol, pose, int(render["downsample_by"]),
                           int(render["max_steps"]), bool(render["colored"]))

    # ---- what the judge and the evidence lines read ------------------------

    def overflowed(self) -> bool:
        ovf = getattr(self.vol, "overflowed", None)
        return bool(ovf) if ovf is not None else False

    def live_bricks(self):
        return int(self.vol.n_active) if self.kind == "bricks" else None

    def read_voxels(self, lin):
        """The program's (sdf, weight, nsample, color [V, nc]) at linear
        voxel indices ``lin`` (int64, x-major) of the grid; a voxel of an
        unallocated brick reads unobserved (sdf -1, weight 0)."""
        v = self.vol
        if self.kind == "dense":
            c = None if v.color is None else v.color.reshape(-1, v.color.shape[-1])[lin]
            return (v.sdf.reshape(-1)[lin], v.weight.reshape(-1)[lin],
                    v.nsample.reshape(-1)[lin], c)
        cfg, B = self.cfg, v.brick_size
        Y, Z = cfg.yres, cfg.zres
        ix, iy, iz = lin // (Y * Z), (lin // Z) % Y, lin % Z
        slot = v.brick_map[ix // B, iy // B, iz // B].long()
        row = torch.clamp(slot, min=0)
        inner = ((ix % B) * B + (iy % B)) * B + (iz % B)
        ok = slot >= 0

        def pick(t, fill):
            val = t[row, inner]
            return torch.where(ok if val.dim() == 1 else ok[:, None], val,
                               torch.full_like(val, fill))

        return (pick(v.sdf, -1.0), pick(v.weight, 0.0), pick(v.nsample, 0),
                None if v.color is None else pick(v.color, 0.0))

    def dense_state(self):
        """The program's state as dense grids (sdf, weight, color [X, Y, Z,
        nc]), unallocated bricks unobserved: what the reference march and
        the work counts read."""
        v = self.vol
        if self.kind == "dense":
            return v.sdf, v.weight, v.color
        cfg, B = self.cfg, v.brick_size
        nb = (cfg.xres // B, cfg.yres // B, cfg.zres // B)
        slot = v.brick_map.reshape(-1).long()
        ok = slot >= 0
        row = torch.clamp(slot, min=0)

        def grid(t, fill):
            extra = tuple(t.shape[2:])
            rows = torch.where(ok.reshape((-1,) + (1,) * (1 + len(extra))),
                               t[row].reshape((-1, B ** 3) + extra),
                               torch.full((), fill, dtype=t.dtype, device=t.device))
            g = rows.reshape(nb + (B, B, B) + extra)
            g = g.permute((0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(extra))))
            return g.reshape(cfg.resolution + extra)

        return grid(v.sdf, -1.0), grid(v.weight, 0.0), \
            None if v.color is None else grid(v.color, 0.0)

    def live_rows(self):
        """Live brick coordinates [L, 3] (bricks route only)."""
        return self.vol.coords[self.vol.coords[:, 0] >= 0]


def graph_stats() -> list:
    from cpu_tsdf_tpu_torch import graph

    return graph.stats()


def launch_counts() -> dict:
    from cpu_tsdf_tpu_torch.ops import fusion_kernel, raycast_kernel

    return {**fusion_kernel.launches, **raycast_kernel.launches}
