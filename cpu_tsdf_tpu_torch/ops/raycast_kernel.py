"""The ray march: the CUDA kernel (``csrc/raycast.cu``) and its plain version.

:func:`march` marches one ray per row of ``origins``/``dirs`` through a
packed render view (``bricks.PackedRenderVolume``, brick rows of any B with
a brick map, or a dense grid) and returns float32 channels [8, N]:

    t_bt, found, t_star, valid, nvalid, nx, ny, nz

(t_bt = the ray parameter after the half-voxel backtrack, or where the
march stopped when nothing was found; found/valid/nvalid as 0/1; t_star the
refined crossing; n the unit normal in the volume frame). Rays without a
crossing carry zeros from t_star on; rays with no valid refinement carry
zero normals.

It replaces the TPU kernel ``cpu_tsdf_tpu/ops/pallas_raycast.py::_kernel``.
Its contract is the reference march as ``cpu_tsdf_tpu/ops/raycast.py::
render_rays`` writes it out, which :func:`march_plain` keeps as a lockstep
loop over all rays: on a CPU tensor :func:`march` runs it; on a CUDA tensor
it launches the kernel (there is no fallback). Both evaluate the same
float32 operations in the same order, so on the card they agree bit for
bit wherever the compiler keeps that order (the kernel is built without
contraction into FMAs and without fast math).

:func:`march_rays` is the differentiable march behind ``render_rays``,
``render_view`` and :func:`render_depth_diff`: the march (kernel or plain)
locates the crossing; the refinement t* and the normals are recomputed
under autograd in the backward, as the JAX package's custom VJP does
(``pallas_raycast.py::_phase3_xla``, ``_march_diff_bwd``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import tracing
from ..bricks import PackedRenderVolume, gather_dw, pack_render
from ..config import TSDFConfig
from ..geometry import div_const, in_volume, voxel_index
from .interpolate import _clipped_base, _corner_base, tsdf_value_vol

NCH = 8
CHANNELS = ("t_bt", "found", "t_star", "valid", "nvalid", "nx", "ny", "nz")

# Kernel launches since the last reset (plain runs not counted).
launches = tracing.counters("raycast_kernel.launches", {"raycast": 0})


class RaycastParams(ctypes.Structure):
    """Mirror of ``struct RaycastParams`` in csrc/raycast.cu."""

    _fields_ = ([(n, ctypes.c_float) for n in (
        "size_x", "size_y", "size_z", "half_x", "half_y", "half_z",
        "cell_x", "cell_y", "cell_z", "two_cell_x", "two_cell_y", "two_cell_z",
        "min_dist", "max_dist", "min_step", "min_adaptive_step", "mdn",
        "half_cell")]
        + [(n, ctypes.c_int) for n in (
            "xres", "yres", "zres", "brick", "nbx", "nby", "nbz", "capacity",
            "max_steps", "bt_max", "trilinear", "brick_shift", "brick_mask",
            "tile_width", "relay_x_lo", "relay_x_hi")])

# The relay march's state rows, [RELAY_ROWS, N] float32 (csrc/raycast.cu
# RelayRow): t, step, last_d, last_w, hit (0/1), iteration, suspended (0/1)
# and the voxel x index of the sample that suspended the ray.
RELAY_ROWS = 8


def _constants(cfg: TSDFConfig):
    """The march's constants as the Python doubles the plain version
    computes (the kernel gets their float32 roundings)."""
    return dict(
        min_step=cfg.max_dist_neg * 3.0 / 4.0,
        half_cell=(cfg.zsize / cfg.zres) / 2.0,
        min_adaptive_step=min(cfg.cell_size) / 4.0,
    )


def bt_steps(cfg: TSDFConfig) -> int:
    """Backtrack iterations: enough to walk back one full coarse step at
    half-voxel strides; the pre-crossing step can reach max_dist_pos, so
    the larger truncation bound counts (ops/raycast.py:172)."""
    return int(max(cfg.max_dist_pos, cfg.max_dist_neg) / _constants(cfg)["half_cell"]) + 4


def tile_width(cfg: TSDFConfig, n_rays: int) -> int:
    """The row length under which the kernel gives each warp an 8x4 pixel
    tile: that of the camera image (or of a downsampled one) when n_rays
    rays fill it and its rows are a multiple of 32 long and come in groups
    of 4; else 0, one row of 32 rays a warp. Any such length only permutes
    which thread marches which ray, so the result does not depend on it."""
    W, H = cfg.image_width, cfg.image_height
    for ds in range(1, min(W, H) + 1):
        w, h = W // ds, H // ds
        if w * h == n_rays:
            return w if w % 32 == 0 and h % 4 == 0 else 0
    return 0


def raycast_params(vol: PackedRenderVolume, max_steps: int,
                   tile: int = 0, relay_x=(0, 0)) -> RaycastParams:
    """The kernel's parameters; tile: see :func:`tile_width`; relay_x: the
    slab's voxel x range for the relay march."""
    cfg = vol.config
    k = _constants(cfg)
    csx, csy, csz = cfg.cell_size
    B = vol.brick_size if vol.brick_map is not None else 0
    nb = (cfg.xres // B, cfg.yres // B, cfg.zres // B) if B else (0, 0, 0)
    return RaycastParams(
        cfg.xsize, cfg.ysize, cfg.zsize, cfg.xsize / 2.0, cfg.ysize / 2.0,
        cfg.zsize / 2.0, csx, csy, csz, 2 * csx, 2 * csy, 2 * csz,
        cfg.min_sensor_dist, cfg.max_sensor_dist, k["min_step"],
        k["min_adaptive_step"], cfg.max_dist_neg, k["half_cell"],
        cfg.xres, cfg.yres, cfg.zres, B, *nb, vol.capacity, max_steps,
        bt_steps(cfg), int(cfg.use_trilinear_interpolation),
        B.bit_length() - 1 if B and B & (B - 1) == 0 else -1, B - 1, tile, *relay_x)


def relay_state(cfg: TSDFConfig, n: int, device) -> torch.Tensor:
    """The relay state of n rays that have not started: t = min_sensor_dist,
    the initial step 3/4 max_dist_neg, no sample yet."""
    state = torch.zeros((RELAY_ROWS, n), dtype=torch.float32, device=device)
    state[0] = cfg.min_sensor_dist
    state[1] = _constants(cfg)["min_step"]
    return state


def _sign_change(d, last_d):
    return ((d < 0) & (last_d > 0)) | ((d > 0) & (last_d < 0))


class _Work:
    """What one plain march does, counted over the rays that run each step
    (as the kernel's threads do): nearest-voxel samples of the march and
    the backtrack, refined and normal-bearing rays, and the bricks (dense:
    voxels) whose values were looked up."""

    def __init__(self, vol: PackedRenderVolume):
        cfg = vol.config
        self.vol = vol
        self.B = vol.brick_size if vol.brick_map is not None else 1
        self.nb = (cfg.xres // self.B, cfg.yres // self.B, cfg.zres // self.B)
        self.touched = torch.zeros(self.nb, dtype=torch.bool, device=vol.device)
        self.samples = 0
        self.refined = 0
        self.normals = 0

    def mark(self, ix, iy, iz, mask):
        cfg, B = self.vol.config, self.B
        ix = torch.clamp(ix[mask], 0, cfg.xres - 1) // B
        iy = torch.clamp(iy[mask], 0, cfg.yres - 1) // B
        iz = torch.clamp(iz[mask], 0, cfg.zres - 1) // B
        self.touched[ix.long(), iy.long(), iz.long()] = True

    def mark_query(self, x, y, z, mask):
        """The voxels one tsdf_value_vol query at (x, y, z) reads."""
        cfg = self.vol.config
        if not cfg.use_trilinear_interpolation:
            ix, iy, iz, _ = voxel_index(cfg, x, y, z)
            self.mark(ix, iy, iz, mask)
            return
        ixc, iyc, izc = _clipped_base(cfg, *_corner_base(cfg, x, y, z)[:3])
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    self.mark(ixc + dx, iyc + dy, izc + dz, mask)

    def bytes_moved(self, n_rays: int) -> int:
        """Each input byte read once, each output byte written once: the
        touched bricks' rows (allocated ones) and brick-map entries (dense:
        the touched voxels), the rays (6 floats) and the output channels."""
        if self.vol.brick_map is None:
            volume = int(self.touched.sum()) * 4
        else:
            live = int((self.touched & (self.vol.brick_map >= 0)).sum())
            volume = live * self.B ** 3 * 4 + int(self.touched.sum()) * 4
        return volume + n_rays * (6 + NCH) * 4

    def operations(self) -> int:
        return (self.samples * OPS_PER_SAMPLE + self.refined * OPS_PER_REFINE
                + self.normals * OPS_PER_NORMAL)


# Float32 operations, counted from csrc/raycast.cu: one nearest-voxel sample
# with its step update (position 6, index 9, bounds 6, step and tests ~9);
# the refinement of a found ray (two trilinear queries of ~85 each: index,
# corner base, fractions, the 8-term blend; then t*); the six trilinear
# queries, positions and normalisation of a ray's normal.
OPS_PER_SAMPLE = 30
OPS_PER_REFINE = 180
OPS_PER_NORMAL = 535


def march_plain(vol: PackedRenderVolume, origins, dirs, max_steps: int = 512,
                work: Optional[_Work] = None, relay=None):
    """Plain PyTorch version of the kernel: the reference march of
    ``cpu_tsdf_tpu/ops/raycast.py::render_rays`` (phases 1-3 and the
    normals) as a lockstep loop over all rays. Same arguments and channels
    as :func:`march`; `work`, when given, counts what the march does."""
    cfg = vol.config
    dev = origins.device
    N = origins.shape[0]
    k = _constants(cfg)
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]

    def full(v):
        return torch.full((N,), v, dtype=torch.float32, device=dev)

    def point(t):
        return ox + t * dx, oy + t * dy, oz + t * dz

    def sample_nn(t, mask):
        x, y, z = point(t)
        ix, iy, iz, _ = voxel_index(cfg, x, y, z)
        d, w = gather_dw(vol, ix, iy, iz)
        if work is not None:
            work.samples += int(mask.sum())
            work.mark(ix, iy, iz, mask)
        return d, w, in_volume(cfg, x, y, z)

    # ---- phase 1: adaptive march (cpp:318-371) ----
    if relay is None:
        t, step = full(cfg.min_sensor_dist), full(k["min_step"])
        last_d, last_w = full(0.0), full(0.0)
        hit_voxel = torch.zeros(N, dtype=torch.bool, device=dev)
        iters = torch.zeros(N, dtype=torch.int32, device=dev)
    else:
        state, x_lo, x_hi = relay
        t, step, last_d, last_w = (state[r].clone() for r in range(4))
        hit_voxel = state[4] > 0
        iters = state[5].to(torch.int32)
        suspended = torch.zeros_like(hit_voxel)
        suspended_ix = full(0.0)
    found = torch.zeros_like(hit_voxel)
    done = iters >= max_steps
    for it in range(max_steps):
        # done rays never change, so the check may skip iterations
        if it % 4 == 0 and bool(done.all()):
            break
        active = ~done
        if relay is not None:
            # a sample inside the volume but outside the slab suspends the ray
            x, y, z = point(t)
            ix = voxel_index(cfg, x, y, z)[0]
            stop = active & in_volume(cfg, x, y, z) & ((ix < x_lo) | (ix >= x_hi))
            suspended_ix = torch.where(stop, ix.to(torch.float32), suspended_ix)
            suspended = suspended | stop
            done = done | stop
            active = active & ~stop
        d, w, inside = sample_nn(t, active)
        crossing = inside & _sign_change(d, last_d) & (last_w != 0) & (w != 0) & active
        # leaving the volume after having been inside ends the ray (cpp:363-367)
        exit_ray = ~inside & hit_voxel & active
        new_step = torch.clamp(torch.abs(d) * cfg.max_dist_neg, min=k["min_adaptive_step"])
        upd = active & inside & ~crossing
        last_d = torch.where(upd, d, last_d)
        last_w = torch.where(upd, w, last_w)
        step = torch.where(upd, new_step, step)
        hit_voxel = hit_voxel | (inside & active)
        found = found | crossing
        t = torch.where(active & ~crossing & ~exit_ray, t + step, t)
        iters = iters + active.to(torch.int32)
        done = done | crossing | exit_ray | (t >= cfg.max_sensor_dist) | (iters >= max_steps)
    if relay is not None:
        state[0], state[1], state[2], state[3] = t, step, last_d, last_w
        state[4], state[5] = hit_voxel.to(torch.float32), iters.to(torch.float32)
        state[6], state[7] = suspended.to(torch.float32), suspended_ix

    # ---- phase 2: half-voxel backtrack (cpp:329-354) ----
    # `while (t >= old_t) { t -= step; sample; if outside break;
    #  if same-sign { record; t += step; break; } }`
    old_t = t - step
    t_bt = t
    bdone = ~found
    half_cell = k["half_cell"]
    for it in range(bt_steps(cfg)):
        if it % 4 == 0 and bool(bdone.all()):
            break
        active = ~bdone
        exit_loop = active & (t_bt < old_t)
        stepping = active & ~exit_loop
        t_new = t_bt - half_cell
        d, _, inside = sample_nn(t_new, stepping)
        same_sign = ((last_d > 0) & (d > 0)) | ((last_d < 0) & (d < 0))
        hit = stepping & inside & same_sign
        brk_out = stepping & ~inside
        last_d = torch.where(hit, d, last_d)
        # a hit re-adds the step: t stays; break-out and continue keep t_new
        t_bt = torch.where(stepping & ~hit, t_new, t_bt)
        bdone = bdone | exit_loop | hit | brk_out

    # ---- phase 3: trilinear refinement (cpp:378-390) ----
    step_r = torch.where(found, full(half_cell), step)
    t_prev = t_bt - step_r
    last_d_tri, valid_prev = tsdf_value_vol(vol, *point(t_prev))
    d_tri, valid_curr = tsdf_value_vol(vol, *point(t_bt))
    valid = (found & valid_prev & valid_curr & ~torch.isnan(d_tri)
             & ~torch.isnan(last_d_tri))
    denom = last_d_tri - d_tri
    denom = torch.where(denom == 0, full(1e-20), denom)
    t_star = t_bt + step_r * (-1.0 + torch.abs(last_d_tri / denom))
    hx, hy, hz = point(t_star)
    nvalid, nx, ny, nz = normals_plain(vol, hx, hy, hz, valid)

    if work is not None:
        work.refined += int(found.sum())
        work.normals += int(valid.sum())
        for tq in (t_prev, t_bt):
            work.mark_query(*point(tq), found)
        for q in _normal_queries(cfg, hx, hy, hz):
            work.mark_query(*q, valid)

    zero = full(0.0)
    return torch.stack([t_bt, found.float(), torch.where(found, t_star, zero), valid.float(),
                        nvalid.float(), nx, ny, nz])


def _normal_queries(cfg: TSDFConfig, hx, hy, hz):
    csx, csy, csz = cfg.cell_size
    return ((hx - csx, hy, hz), (hx + csx, hy, hz), (hx, hy - csy, hz),
            (hx, hy + csy, hz), (hx, hy, hz - csz), (hx, hy, hz + csz))


def normals_plain(vol, hx, hy, hz, valid):
    """The march's normals at the hits (hx, hy, hz) of the `valid` rays:
    central differences at +-1 cell (cpp:398-419), unit length; (nvalid,
    nx, ny, nz), zero normals where not valid. Channels 4-7 of
    :func:`march_plain`, which the kernel reproduces bit for bit."""
    cfg = vol.config
    nvalid = valid & in_volume(cfg, hx, hy, hz)
    vals = []
    for q in _normal_queries(cfg, hx, hy, hz):
        v, ok = tsdf_value_vol(vol, *q)
        nvalid = nvalid & ok
        vals.append(v)
    d_xm, d_xp, d_ym, d_yp, d_zm, d_zp = vals
    csx, csy, csz = cfg.cell_size
    nx = div_const((d_xp - d_xm) * cfg.max_dist_neg, 2 * csx)
    ny = div_const((d_yp - d_ym) * cfg.max_dist_neg, 2 * csy)
    nz = div_const((d_zp - d_zm) * cfg.max_dist_neg, 2 * csz)
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nn = torch.where(nn == 0, torch.ones_like(nn), nn)
    zero = torch.zeros_like(nn)
    return (nvalid, torch.where(valid, nx / nn, zero), torch.where(valid, ny / nn, zero),
            torch.where(valid, nz / nn, zero))


def _check_inputs(vol: PackedRenderVolume, origins, dirs) -> None:
    from .._build import check_tensor

    cfg, dev = vol.config, vol.device
    N = origins.shape[0]
    check_tensor("march: origins", origins, torch.float32, (N, 3), dev)
    check_tensor("march: dirs", dirs, torch.float32, (N, 3), dev)
    if vol.brick_map is None:
        check_tensor("march: rd", vol.rd, torch.float32, cfg.resolution, dev)
        return
    B = vol.brick_size
    check_tensor("march: rd", vol.rd, torch.float32, (vol.capacity, B ** 3), dev)
    check_tensor("march: brick_map", vol.brick_map, torch.int32,
                 (cfg.xres // B, cfg.yres // B, cfg.zres // B), dev)


def march(vol: PackedRenderVolume, origins, dirs, max_steps: int = 512,
          tile: Optional[int] = None, relay=None):
    """March the rays (float32 [N, 3] origins and unit dirs, volume frame)
    through the packed render view; returns float32 [8, N] channels (see
    the module docstring).

    tile: the row length of the rays' pixel layout for the kernel's 8x4
    warp tiles (a multiple of 32 that divides N into groups of 4 rows), 0
    for none; None = :func:`tile_width` of the camera image. It only
    permutes which thread marches which ray.

    relay = (state, x_lo, x_hi): the relay march of a slab [x_lo, x_hi) of
    voxel x indices. Each ray starts from its column of `state` ([RELAY_ROWS,
    N], see :func:`relay_state`) and is suspended at its first sample
    inside the volume but outside the slab; `state` is updated in place
    (suspended rays keep the state at that sample, the others are done).
    Marching a ray slab by slab, each slab from where the last stopped,
    gives the channels of one march of the whole volume.

    On CPU tensors this is :func:`march_plain`; on CUDA tensors it launches
    csrc/raycast.cu and raises on anything the kernel does not take."""
    if vol.device.type == "cpu":
        return march_plain(vol, origins, dirs, max_steps, relay=relay)
    from .._build import check, check_tensor, function, stream_ptr

    _check_inputs(vol, origins, dirs)
    dev = vol.device
    N = origins.shape[0]
    if tile is None:
        tile = tile_width(vol.config, N)
    if tile and (tile % 32 or N % (4 * tile)):
        raise ValueError(f"march: tile {tile} does not lay {N} rays out in 8x4 tiles")
    state = None
    if relay is not None:
        state, x_lo, x_hi = relay
        check_tensor("march: relay state", state, torch.float32, (RELAY_ROWS, N), dev)
    out = torch.empty((NCH, N), dtype=torch.float32, device=dev)
    fn = function("raycast", "tsdf_raycast",
                  [ctypes.POINTER(RaycastParams)] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] + [ctypes.c_void_p] * 3)
    params = raycast_params(vol, max_steps, tile, (0, 0) if relay is None else (x_lo, x_hi))
    err = fn(ctypes.byref(params), vol.rd.data_ptr(),
             None if vol.brick_map is None else vol.brick_map.data_ptr(),
             origins.data_ptr(), dirs.data_ptr(), N, out.data_ptr(),
             None if state is None else state.data_ptr(), stream_ptr(dev))
    check(err, "march")
    launches["raycast"] += 1
    return out


def march_work(vol: PackedRenderVolume, origins, dirs, max_steps: int = 512):
    """(bytes, operations) the march of these rays needs, counted by the
    plain march on the same rays."""
    work = _Work(vol)
    march_plain(vol, origins, dirs, max_steps, work)
    return work.bytes_moved(origins.shape[0]), work.operations()


# ---------------------------------------------------------------------------
# the differentiable march
# ---------------------------------------------------------------------------

def refine_differentiable(vol, origins, dirs, t_bt, found, normals: bool = True) -> dict:
    """t* and the unit normals recomputed from the march's brackets,
    differentiable with respect to the volume's field and the rays: the
    JAX package's ``pallas_raycast.py::_phase3_xla``. Returns flat [N]
    tensors t_star and, with `normals`, nx, ny, nz (volume frame).

    Rays without a crossing get t = 1 before any position is formed (a
    masked NaN or inf still poisons a gradient through where()); degenerate
    brackets (|denom| <= 1e-6, which would put ~1/denom^2 into the
    gradient) are left out of the differentiable set; the normals' norm is
    at least 1e-6 (the derivative of sqrt at 0 is inf). Rays left out get
    0 everywhere."""
    cfg = vol.config
    step = (cfg.zsize / cfg.zres) / 2.0
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    t = torch.where(found, t_bt, torch.ones_like(t_bt)).detach()

    def point(tq):
        return ox + tq * dx, oy + tq * dy, oz + tq * dz

    last_d_tri = tsdf_value_vol(vol, *point(t - step))[0]
    d_tri = tsdf_value_vol(vol, *point(t))[0]
    denom = last_d_tri - d_tri
    ok = found & (torch.abs(denom) > 1e-6)
    denom = torch.where(ok, denom, torch.ones_like(denom))
    t_star = torch.where(ok, t + step * (-1.0 + torch.abs(last_d_tri / denom)), t)
    zero = torch.zeros_like(t)
    out = dict(t_star=torch.where(ok, t_star, zero))
    if normals:
        d_xm, d_xp, d_ym, d_yp, d_zm, d_zp = (
            tsdf_value_vol(vol, *q)[0] for q in _normal_queries(cfg, *point(t_star)))
        csx, csy, csz = cfg.cell_size
        nx = div_const((d_xp - d_xm) * cfg.max_dist_neg, 2 * csx)
        ny = div_const((d_yp - d_ym) * cfg.max_dist_neg, 2 * csy)
        nz = div_const((d_zp - d_zm) * cfg.max_dist_neg, 2 * csz)
        nn = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-12))
        out.update(nx=torch.where(ok, nx / nn, zero), ny=torch.where(ok, ny / nn, zero),
                   nz=torch.where(ok, nz / nn, zero))
    return out


def _with_field(vol, field):
    """The packed render view of `vol` with `field` in place of its sdf
    (of its packed channel, for a packed volume)."""
    if isinstance(vol, PackedRenderVolume):
        return dataclasses.replace(vol, rd=field)
    return pack_render(dataclasses.replace(vol, sdf=field))


class _MarchRays(torch.autograd.Function):
    """The march's 8 channels (:data:`CHANNELS`, one [N] tensor each) of a
    dense, brick or packed volume, differentiable in t_star and the normals
    with respect to the volume's field (`field`: ``vol.sdf``, or ``vol.rd``
    of a packed volume), the origins and the dirs.

    Forward: the march (the kernel or the plain loop) without autograd, so
    the crossing's bracket is discrete, as JAX's stop_gradient holds it;
    the packing and the march are the device stages ``render.pack`` and
    ``render.march``. Backward: :func:`refine_differentiable` from the saved bracket under
    autograd (the normals only where their gradient is asked for), its
    cotangents kept on the rays that found a crossing, as the JAX package's
    ``_march_diff_bwd`` does."""

    @staticmethod
    def forward(ctx, field, origins, dirs, vol, max_steps, kernel):
        packed = vol
        if not isinstance(vol, PackedRenderVolume):
            tracing.stage("render.pack", vol.device)
            packed = pack_render(vol)
        tracing.stage("render.march", vol.device)
        ch = (march if kernel else march_plain)(packed, origins, dirs, max_steps)
        ctx.set_materialize_grads(False)
        ctx.vol = vol
        ctx.save_for_backward(field, origins, dirs, ch)
        out = ch.unbind(0)
        ctx.mark_non_differentiable(*(out[CHANNELS.index(c)]
                                      for c in ("t_bt", "found", "valid", "nvalid")))
        return out

    @staticmethod
    def backward(ctx, *grads):
        field, origins, dirs, ch = ctx.saved_tensors
        found = ch[1] > 0
        cot = {name: torch.where(found, g, torch.zeros_like(g))
               for name, g in zip(CHANNELS, grads)
               if g is not None and name in ("t_star", "nx", "ny", "nz")}
        need = ctx.needs_input_grad[:3]
        if not cot or not any(need):
            return (None,) * 6
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(n) for x, n in zip((field, origins, dirs), need)]
            out = refine_differentiable(_with_field(ctx.vol, inputs[0]), inputs[1], inputs[2],
                                        ch[0], found, normals=any(k != "t_star" for k in cot))
            wanted = [x for x, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad([out[k] for k in cot], wanted, list(cot.values()),
                                           allow_unused=True))
        return tuple(next(got) if n else None for n in need) + (None, None, None)


def march_rays(vol, origins, dirs, max_steps: int = 512, use_kernel: bool = True):
    """The march's channels (one [N] tensor each, in :data:`CHANNELS`
    order) of contiguous float32 [N, 3] rays in the volume frame through a
    dense, brick or packed volume, with t_star and the normals
    differentiable (:class:`_MarchRays`). use_kernel: the CUDA kernel
    (:func:`march`, which runs :func:`march_plain` on CPU tensors) or the
    plain march."""
    field = vol.rd if isinstance(vol, PackedRenderVolume) else vol.sdf
    return _MarchRays.apply(field, origins, dirs, vol, max_steps, use_kernel)


def render_depth_diff(vol, pose, downsample_by: int = 1, max_steps: int = 512,
                      use_kernel: Optional[bool] = None):
    """Differentiable depth render: (depth [H, W] camera z with NaN where
    invalid, valid [H, W], ok), the depth of :func:`ops.raycast.render_view`.

    Gradients flow to the volume's field and to `pose` (a float32 [4, 4]
    tensor, camera-to-volume) through the refined crossing t*; the
    crossing's bracket is discrete. The counterpart of the JAX package's
    ``render_depth_pallas_diff``; nothing here has a budget to overflow, so
    `ok` is always True. use_kernel: None = the CUDA kernel on the card and
    the plain march on the CPU; False = the plain march anywhere."""
    from .raycast import render_view

    depth = render_view(vol, pose, downsample_by, max_steps, use_kernel=use_kernel).depth
    return depth, ~torch.isnan(depth), True
