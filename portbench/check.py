"""The comparison that decides ``correct``, run once the window has closed
and the memory peak has been read.

* The state: the plain reference (``reference/fusion.py``) fuses the run's
  whole frame sequence (set-up, window and traced slice, in the run's
  order) into the voxels near the scene's surfaces (within ``band_m`` of
  them, analytically; at most ``voxels`` of them, a sample drawn from the
  seed), and the program's state there is held against it.
* A view cell's renders: a sample of the window's renders (drawn from the
  seed) against the reference march (``reference/march.py``) of the same
  pose over a field whose band voxels (those the state check compares,
  where every hit, refinement, normal and color is read) hold the
  reference's own fused values. Outside the band the field is the
  program's state: which bricks exist there is the brick route's own
  allocation, which the reference does not redo.

``control=True`` puts the reference computed in bfloat16 in the program's
place (the state kept and updated in bfloat16; the render field rounded
to bfloat16, its band the bfloat16 reference's), which has to come out not
correct."""

from __future__ import annotations

import torch

from portbench.reference import compare, fusion, march

PLANES = 32


def band_voxels(cfg, scene, params: dict, band_m: float, limit: int, seed: int, device):
    """Linear indices (sorted, int64) of the voxels whose centres lie within
    band_m of the scene's surfaces; a sample of ``limit`` of them drawn from
    the seed where there are more."""
    plane = cfg.yres * cfg.zres
    out = []
    for x0 in range(0, cfg.xres, PLANES):
        lin = torch.arange(x0 * plane, min(cfg.xres, x0 + PLANES) * plane, device=device)
        x, y, z = fusion.centers(cfg, *fusion.voxel_indices(cfg, lin), torch.float64)
        out.append(lin[scene.surface_distance(params, x, y, z) <= band_m])
    lin = torch.cat(out)
    if lin.numel() > limit:
        gen = torch.Generator(device=device).manual_seed(seed)
        lin = torch.sort(lin[torch.randperm(lin.numel(), generator=gen, device=device)[:limit]])[0]
    return lin


def field_of(system):
    """The program's state as the reference march reads it: the packed
    field (NaN where unobserved) and the colors, dense."""
    sdf, weight, color = system.dense_state()
    rd = torch.where(weight > 0, sdf, torch.full_like(sdf, float("nan")))
    return march.Field(system.cfg, rd, color)


def band_field(field, lin, mask, fused):
    """``field`` with the voxels ``lin[mask]`` set to ``fused``'s values
    there."""
    at = lin[mask]
    rd = field.rd.clone()
    rd[at] = fused.sdf[mask].float()
    color = field.color
    if color is not None:
        color = color.clone().reshape(-1, color.shape[-1])
        color[at] = fused.color[mask].float()
        color = color.reshape(field.color.shape)
    return march.Field(field.cfg, rd, color)


def view_numbers(run, lin, ref, ctrl) -> dict:
    """The widest gaps over the sampled renders; ``ctrl`` (the bfloat16
    reference's state) puts the control in the program's place."""
    cfg, render = run.cfg, run.traffic["render"]
    mask = compare.compared(ref, run.voxels[1], run.kind == "bricks")
    field = band_field(run.field, lin, mask, ref)
    if ctrl is not None:
        rounded = march.Field(cfg, run.field.rd.to(torch.bfloat16).float(), run.field.color)
        cfield = band_field(rounded, lin, mask, ctrl)
    worst = {}
    for pose_id, out in run.renders:
        pose = run.poses[pose_id]
        want = march.render(cfg, field, pose, int(render["max_steps"]))
        if ctrl is not None:
            out = _RenderLike(march.render(cfg, cfield, pose, int(render["max_steps"])))
        for k, v in compare.render_numbers(out, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


class _RenderLike:
    def __init__(self, r: dict):
        self.points, self.normals, self.depth = r["points"], r["normals"], r["depth"]
        self.rgb = r.get("rgb")


def check_voxels(runner, scene):
    chk = runner.traffic["check"]
    return band_voxels(runner.system.cfg, scene, runner.traffic["scene_params"],
                       float(chk["band_m"]), int(chk["voxels"]), runner.seed, runner.device)


class Outputs:
    """What the judge takes from a finished run, read before the program's
    state is freed: the program's state at the compared voxels, and the
    view cell's sampled renders and the state they were rendered from."""

    def __init__(self, runner, lin):
        self.cfg, self.traffic, self.kind = runner.system.cfg, runner.traffic, runner.system.kind
        self.n_fused, self.poses = runner.n_fused, runner.frames["poses"]
        self.voxels = runner.system.read_voxels(lin)
        view = runner.traffic["loop"] == "view"
        self.renders = runner.sample.items if view else []
        self.field = field_of(runner.system) if view else None


def numbers(run: Outputs, frames: dict, start: int, lin, control: bool = False) -> dict:
    """Every number of this run's comparison, by name. frames: the scene's
    distinct frames in their own order; the run's frame k is (start + k)
    mod F."""
    ref = fusion.fuse(run.cfg, frames, start, run.n_fused, lin)
    ctrl = fusion.fuse(run.cfg, frames, start, run.n_fused, lin, torch.bfloat16) if control \
        else None
    prog = run.voxels if ctrl is None else (ctrl.sdf.float(), ctrl.weight.float(), ctrl.nsample,
                                            None if ctrl.color is None else ctrl.color.float())
    out = compare.fusion_numbers(prog, ref, run.kind == "bricks")
    if run.traffic["loop"] == "view":
        out.update(view_numbers(run, lin, ref, ctrl))
    return out
