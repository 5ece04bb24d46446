"""Brick and dense fusion: the CUDA kernels (``csrc/fusion.cu``) and their
plain versions.

:func:`fuse_bricks` fuses one depth frame, and with color its rgb image,
into the rows of a brick volume named by an update list, IN PLACE (the JAX
package donated the volume's buffers; here the tensors themselves are
updated). It replaces the TPU kernel
``cpu_tsdf_tpu/ops/pallas_fusion.py::_kernel_inplace`` and the XLA color
transform after it. On a CPU tensor it runs :func:`fuse_bricks_plain`, the
plain engine that is the contract of the kernel (the JAX package's
``xla_update`` branch of ``bricks.fuse_brick_batch``); on a CUDA tensor it
launches the kernel.

The update list ``rows`` is int32 [K, 4]: the brick coordinates (bx, by,
bz) and the slot of each row, with slot -1 for a row that names no brick.
State rows are [C, B^3] (bricks of any even size B, the voxel order
(lx*B+ly)*B+lz), color rows [C, B^3, nc].

:func:`fuse_dense` fuses one frame into a dense volume (or an X-slab of
one) in one kernel launch, in place: the counterpart of the JAX package's
jitted, XLA-fused dense ``integrate`` (not a Pallas kernel), whose volume
is donated. Its plain version is ``ops.fusion.integrate_slab_plain``; both
kernels share the per-voxel device functions of ``csrc/fusion.cu``. The
kernel culls each (x, y) column to the z-interval of voxels the frame can
observe; :func:`dense_column_intervals` is the plain version of that cull,
and :func:`dense_candidates` counts, voxel by voxel, the voxels any fusion
of the frame must project and test.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..config import COLOR_MODE_LAB, COLOR_MODE_RGB, COLOR_MODE_RGB_NORMALIZED, TSDFConfig
from ..geometry import frustum_tans, rigid_inverse
from ..volume import TSDFVolume, color_channels
from . import color as color_ops
from .fusion import (coarse_cell_frustum, compute_observation, fuse_observation,
                     gather_image, integrate_slab_plain, variance_weight)

# The kernel's color_mode codes (csrc/fusion.cu, enum ColorMode); 0 = none.
COLOR_CODES = {COLOR_MODE_RGB: 1, COLOR_MODE_RGB_NORMALIZED: 2, COLOR_MODE_LAB: 3}

# Kernel launches since the last reset (plain runs not counted): the brick
# kernel and the dense one.
launches = tracing.counters("fusion_kernel.launches", {"fusion": 0, "dense_fusion": 0})


class FusionParams(ctypes.Structure):
    """Mirror of ``struct FusionParams`` in csrc/fusion.cu."""

    _fields_ = ([(n, ctypes.c_float) for n in (
        "cell_x", "cell_y", "cell_z", "half_x", "half_y", "half_z",
        "coarse_x", "coarse_y", "coarse_z", "fx", "fy", "pcx", "pcy",
        "min_dist", "max_dist", "max_dist_pos", "max_dist_neg", "max_weight",
        "tan_h", "tan_v")]
        + [(n, ctypes.c_int) for n in (
            "xres", "yres", "zres", "n_coarse", "width", "height",
            "frustum_culling", "weight_by_depth", "weight_by_variance",
            "color_mode")])


def fusion_params(cfg: TSDFConfig, color: bool) -> FusionParams:
    """The kernel's constants, each the float32 rounding (done by ctypes) of
    the Python double the plain engine computes; with color, the config's
    color mode."""
    n = 1 << cfg.num_coarse_levels
    tan_h, tan_v = frustum_tans(cfg)
    return FusionParams(
        cfg.xsize / cfg.xres, cfg.ysize / cfg.yres, cfg.zsize / cfg.zres,
        cfg.xsize / 2, cfg.ysize / 2, cfg.zsize / 2,
        cfg.xsize / n, cfg.ysize / n, cfg.zsize / n,
        cfg.focal_length_x, cfg.focal_length_y,
        cfg.principal_point_x, cfg.principal_point_y,
        cfg.min_sensor_dist, cfg.max_sensor_dist,
        cfg.max_dist_pos, cfg.max_dist_neg, cfg.max_weight, tan_h, tan_v,
        cfg.xres, cfg.yres, cfg.zres, n, cfg.image_width, cfg.image_height,
        int(cfg.frustum_culling), int(cfg.weight_by_depth),
        int(cfg.weight_by_variance), COLOR_CODES[cfg.color_mode] if color else 0)


def brick_size_of(rows_width: int) -> int:
    """The brick size B of state rows [C, B^3]."""
    B = round(rows_width ** (1 / 3))
    if B ** 3 != rows_width:
        raise ValueError(f"state rows of {rows_width} voxels are not a cube")
    return B


def _voxel_centers(cfg: TSDFConfig, rows, B: int):
    """Voxel indices and centers [K, B^3] of the update list's bricks."""
    lid = torch.arange(B ** 3, dtype=torch.int32, device=rows.device)
    vx = rows[:, 0:1] * B + (lid // (B * B))[None]
    vy = rows[:, 1:2] * B + ((lid // B) % B)[None]
    vz = rows[:, 2:3] * B + (lid % B)[None]
    cx = (vx.to(torch.float32) + 0.5) * (cfg.xsize / cfg.xres) - cfg.xsize / 2
    cy = (vy.to(torch.float32) + 0.5) * (cfg.ysize / cfg.yres) - cfg.ysize / 2
    cz = (vz.to(torch.float32) + 0.5) * (cfg.zsize / cfg.zres) - cfg.zsize / 2
    return (vx, vy, vz), (cx, cy, cz)


def fuse_bricks_plain(cfg: TSDFConfig, rows, pose_inv, depth, sdf, weight, M,
                      nsample, color=None, rgb=None) -> None:
    """Plain PyTorch version of the fusion kernel; same arguments, same
    in-place effect (on the color rows too, when color and rgb are given).

    Rows without a slot read and rewrite the dump row C-1 unchanged (their
    voxels are all invalid), which keeps the scatter free of a host sync."""
    C, V = sdf.shape
    B = brick_size_of(V)
    slot_ok = rows[:, 3] >= 0
    dst = torch.where(slot_ok, rows[:, 3], C - 1).long()
    (vx, vy, vz), (cx, cy, cz) = _voxel_centers(cfg, rows, B)
    d0, w0, M0, n0 = sdf[dst], weight[dst], M[dst], nsample[dst]
    d_obs, w_obs, valid, _, u, v = compute_observation(cfg, depth, pose_inv, cx, cy, cz)
    if cfg.frustum_culling:
        valid = valid & coarse_cell_frustum(cfg, pose_inv, vx, vy, vz)
    valid = valid & slot_ok[:, None]
    w_eff = variance_weight(cfg, w_obs, d_obs, d0, w0, M0, n0)
    du, wu, Mu, nu = fuse_observation(d0, w0, M0, n0, d_obs, w_eff, cfg.max_weight)
    sdf.index_copy_(0, dst, torch.where(valid, du, d0))
    weight.index_copy_(0, dst, torch.where(valid, wu, w0))
    M.index_copy_(0, dst, torch.where(valid, Mu, M0))
    nsample.index_copy_(0, dst, torch.where(valid, nu, n0))
    if color is None or rgb is None:
        return
    # the pre-update weight w0; a NaN gate (w_eff NaN) keeps the old color
    c0 = color[dst]
    r, g, b = (gather_image(rgb[..., c], v, u) for c in range(3))
    cu = color_ops.update_color(cfg.color_mode, c0, w0, r, g, b, w_eff)
    seen = (valid & (w_eff >= 0))[..., None]
    color.index_copy_(0, dst, torch.where(seen, cu, c0))


def fuse_bricks(cfg: TSDFConfig, rows, pose_inv, depth, sdf, weight, M, nsample,
                color=None, rgb=None) -> None:
    """Fuse one frame into the rows of the update list, in place.

    rows int32 [K, 4] (bx, by, bz, slot or -1); pose_inv float32 [4, 4]
    (volume -> camera); depth float32 [H, W] (NaN = missing); sdf/weight/M
    float32 and nsample int32, all [C, B^3] for bricks of B^3 voxels;
    color float32 [C, B^3, nc] and rgb float32 [H, W, 3], already
    truncated, both or neither. With both, the color rows are updated too
    (cfg.color_mode).

    On CPU tensors this is :func:`fuse_bricks_plain`; on CUDA tensors it
    launches csrc/fusion.cu, which takes every even B (a thread's 4 voxels
    are one 16-byte access, so B^3 must be a multiple of 4, as the TPU
    kernel's [C, 4, B^3/4] rows are), and raises on anything the kernel
    does not take."""
    if sdf.device.type == "cpu":
        fuse_bricks_plain(cfg, rows, pose_inv, depth, sdf, weight, M, nsample, color, rgb)
        return
    from .._build import check, check_tensor, function, stream_ptr

    dev = sdf.device
    C, V = sdf.shape
    B = brick_size_of(V)
    if B % 2:
        raise ValueError(f"fuse_bricks: the kernel takes even brick sizes, got {B}")
    H, W = cfg.image_height, cfg.image_width
    with_color = color is not None and rgb is not None
    if with_color and cfg.color_mode not in COLOR_CODES:
        raise ValueError(f"fuse_bricks: color mode {cfg.color_mode!r} has no color rows")
    nc = color_channels(cfg)
    checks = [("rows", rows, torch.int32, (rows.shape[0], 4)),
              ("pose_inv", pose_inv, torch.float32, (4, 4)),
              ("depth", depth, torch.float32, (H, W)),
              ("sdf", sdf, torch.float32, (C, V)),
              ("weight", weight, torch.float32, (C, V)),
              ("M", M, torch.float32, (C, V)),
              ("nsample", nsample, torch.int32, (C, V))]
    if with_color:
        checks += [("color", color, torch.float32, (C, V, nc)),
                   ("rgb", rgb, torch.float32, (H, W, 3))]
    for what, t, dt, shape in checks:
        check_tensor(f"fuse_bricks: {what}", t, dt, shape, dev)
    for what, t in (("rows", rows), ("sdf", sdf), ("weight", weight), ("M", M),
                    ("nsample", nsample), ("color", color if with_color else None)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fuse_bricks: {what} must be 16-byte aligned "
                             "(read as int4 / float4)")
    K = rows.shape[0]
    pose12 = pose_inv[:3].contiguous()
    fn = function("fusion", "tsdf_fuse_bricks",
                  [ctypes.POINTER(FusionParams), ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 9)
    params = fusion_params(cfg, with_color)
    err = fn(ctypes.byref(params), rows.data_ptr(), K, B, pose12.data_ptr(),
             depth.data_ptr(), rgb.data_ptr() if with_color else None,
             sdf.data_ptr(), weight.data_ptr(), M.data_ptr(), nsample.data_ptr(),
             color.data_ptr() if with_color else None, stream_ptr(dev))
    check(err, "fuse_bricks")
    launches["fusion"] += 1


def fuse_dense(vol: TSDFVolume, depth, pose, rgb=None, x0: int = 0, *,
               intervals=None) -> TSDFVolume:
    """One frame fused into the dense X-slab [x0, x0 + n) that vol's
    [n, yres, zres] tensors hold. vol is donated, as the JAX package's
    ``integrate`` donates its volume: use the returned one. depth [H, W],
    pose [4, 4] camera-to-volume, rgb [H, W, 3] (0..255, truncated here).

    On CPU tensors this is ``ops.fusion.integrate_slab_plain``, which
    returns fresh tensors. On CUDA tensors it launches csrc/fusion.cu's
    dense kernel once: vol's state (and, with rgb, its color) is updated in
    place, only the voxels the frame observes are read or written, and
    vol's tensors are returned with their autograd version counters moved
    on (a tensor autograd saved earlier then raises in its backward). It
    raises on anything the kernel does not take, and on tensors that
    require grad while grad mode is on: ``ops.fusion.integrate_slab`` is
    the differentiable route.

    intervals, an int32 [n * yres, 2] tensor on vol's device, receives the
    z-interval [lo, hi] of each column (x, y), at row x * yres + y (lo > hi
    where empty): on the card the kernel's own cull, on the CPU its plain
    version :func:`dense_column_intervals`.

    On the card its host spans are ``fuse_dense.prepare`` (the inputs, the
    inverse pose, the checks, the kernel's constants and its function) and
    ``fuse_dense.launch``."""
    cfg, dev = vol.config, vol.device
    nx = vol.sdf.shape[0]
    if intervals is not None:
        ok = (intervals.dtype == torch.int32 and intervals.device == dev
              and intervals.shape == (nx * cfg.yres, 2)
              and intervals.is_contiguous())
        if not ok:
            raise ValueError(f"fuse_dense: intervals must be a contiguous int32 "
                             f"[{nx * cfg.yres}, 2] tensor on {dev}")
    if vol.device.type == "cpu":
        if intervals is not None:
            pose_inv = rigid_inverse(torch.as_tensor(pose, dtype=torch.float32))
            lo, hi = dense_column_intervals(
                cfg, pose_inv, torch.as_tensor(depth, dtype=torch.float32), x0, nx)
            intervals.copy_(torch.stack([lo.reshape(-1), hi.reshape(-1)], 1))
        return integrate_slab_plain(vol, depth, pose, rgb, x0)
    from .._build import check, check_tensor, function, stream_ptr

    with tracing.span("fuse_dense.prepare"):
        if not 0 <= x0 <= x0 + nx <= cfg.xres:
            raise ValueError(f"fuse_dense: planes [{x0}, {x0 + nx}) are not in the grid's "
                             f"{cfg.xres}")
        H, W = cfg.image_height, cfg.image_width
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev).contiguous()
        pose_inv = rigid_inverse(torch.as_tensor(pose, dtype=torch.float32, device=dev))
        with_color = vol.color is not None and rgb is not None
        if with_color and cfg.color_mode not in COLOR_CODES:
            raise ValueError(f"fuse_dense: color mode {cfg.color_mode!r} has no color channels")
        state = [vol.sdf, vol.weight, vol.M, vol.nsample] + ([vol.color] if with_color else [])
        if torch.is_grad_enabled() and any(t.requires_grad for t in state):
            raise ValueError("fuse_dense updates the volume in place; a volume that requires "
                             "grad goes through ops.fusion.integrate_slab")
        shape = (nx, cfg.yres, cfg.zres)
        checks = [("depth", depth, torch.float32, (H, W)),
                  ("sdf", vol.sdf, torch.float32, shape),
                  ("weight", vol.weight, torch.float32, shape),
                  ("M", vol.M, torch.float32, shape),
                  ("nsample", vol.nsample, torch.int32, shape)]
        if with_color:
            rgb = torch.trunc(torch.as_tensor(rgb, dtype=torch.float32, device=dev)).contiguous()
            checks += [("color", vol.color, torch.float32, shape + (color_channels(cfg),)),
                       ("rgb", rgb, torch.float32, (H, W, 3))]
        for what, t, dt, want in checks:
            check_tensor(f"fuse_dense: {what}", t, dt, want, dev)
        pose12 = pose_inv[:3].contiguous()
        dmax_key = torch.empty((), dtype=torch.int32, device=dev)  # the frame's deepest reading
        fn = function("fusion", "tsdf_fuse_dense",
                      [ctypes.POINTER(FusionParams), ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 11)
        params = fusion_params(cfg, with_color)

        def ptr(t):
            return t.data_ptr() if with_color else None

    with tracing.span("fuse_dense.launch"):
        err = fn(ctypes.byref(params), x0, nx, pose12.data_ptr(), dmax_key.data_ptr(),
                 depth.data_ptr(), ptr(rgb), vol.sdf.data_ptr(), vol.weight.data_ptr(),
                 vol.M.data_ptr(), vol.nsample.data_ptr(), ptr(vol.color),
                 None if intervals is None else intervals.data_ptr(), stream_ptr(dev))
        check(err, "fuse_dense")
        launches["dense_fusion"] += 1
        for t in state:
            torch.autograd.graph.increment_version(t)
    return vol


# Float64 constants of the cull in csrc/fusion.cu (kPixelSlack,
# kRoundingSlack): pixels added to each side of the image, and the bound on
# the float32 rounding of a voxel's camera-frame coordinate, relative to
# the magnitude of its transform's terms.
PIXEL_SLACK = 1.0
ROUNDING_SLACK = 1e-5


def depth_max(depth):
    """The frame's deepest reading, NaN skipped (-inf for an all-NaN frame),
    as a 0-dim float32 tensor on depth's device: csrc/fusion.cu's
    depth_max_kernel. A voxel behind it by more than max_dist_neg is
    observed by no pixel."""
    return torch.where(torch.isnan(depth), float("-inf"), depth).amax()


def _clip_ge(alpha, beta, lo, hi):
    """{z : alpha + beta z >= 0} intersected into the real intervals [lo, hi]
    (float64 tensors of one shape): csrc/fusion.cu's clip_ge."""
    root = -alpha / beta
    lo = torch.where((beta > 0) & ~torch.isnan(root), torch.maximum(lo, root), lo)
    hi = torch.where((beta < 0) & ~torch.isnan(root), torch.minimum(hi, root), hi)
    return lo, torch.where((beta == 0) & (alpha < 0), float("-inf"), hi)


def dense_column_intervals(cfg: TSDFConfig, pose_inv, depth, x0: int = 0, nx=None):
    """Plain version of the dense kernel's column cull (csrc/fusion.cu,
    column_interval): for each column (x, y) of the X-slab [x0, x0 + nx),
    the voxel indices [lo, hi] (int64 [nx, yres] each; empty where lo > hi)
    that hold every voxel the frame can observe. pose_inv [4, 4] volume ->
    camera, depth [H, W].

    Along a column the camera-frame point is affine in z, p(z) = a + z b,
    and each test that admits a voxel is linear in z: the sensor range,
    p_z <= d_max + max_dist_neg (:func:`depth_max`), and the pixel tests
    u_f > -1, u_f < W (and v) multiplied out by p_z > 0. Each is relaxed
    by far more than the float32 rounding of the voxel's own projection
    (and the pixel tests by PIXEL_SLACK pixels); the intersection is
    rounded outwards and widened by one voxel each end. Computed in
    float64 from the float32 constants the kernel is given."""
    nx = cfg.xres - x0 if nx is None else nx
    dev = depth.device
    f64 = torch.float64

    def f32(v):  # a constant as the kernel's FusionParams holds it
        return float(torch.tensor(v, dtype=torch.float32))

    cell = [f32(cfg.xsize / cfg.xres), f32(cfg.ysize / cfg.yres), f32(cfg.zsize / cfg.zres)]
    half = [f32(cfg.xsize / 2), f32(cfg.ysize / 2), f32(cfg.zsize / 2)]
    gx = torch.arange(x0, x0 + nx, dtype=torch.float32, device=dev)[:, None]
    gy = torch.arange(cfg.yres, dtype=torch.float32, device=dev)[None, :]
    cx = ((gx + 0.5) * cell[0] - half[0]).to(f64).expand(nx, cfg.yres)
    cy = ((gy + 0.5) * cell[1] - half[1]).to(f64).expand(nx, cfg.yres)
    cz0 = 0.5 * cell[2] - half[2]
    hz = half[2] + cell[2]
    m = pose_inv.to(device=dev, dtype=torch.float32).to(f64)
    a, b, e = [], [], []
    for i in range(3):
        a.append(m[i, 0] * cx + m[i, 1] * cy + m[i, 2] * cz0 + m[i, 3])
        b.append((m[i, 2] * cell[2]).expand(nx, cfg.yres))
        e.append(ROUNDING_SLACK * (torch.abs(m[i, 0] * cx) + torch.abs(m[i, 1] * cy)
                                   + torch.abs(m[i, 2]) * hz + torch.abs(m[i, 3])) + 1e-9)
    lo = torch.zeros((nx, cfg.yres), dtype=f64, device=dev)
    hi = torch.full((nx, cfg.yres), float(cfg.zres - 1), dtype=f64, device=dev)
    z_near = f32(cfg.min_sensor_dist) - e[2]
    lo, hi = _clip_ge(a[2] - z_near, b[2], lo, hi)
    lo, hi = _clip_ge(f32(cfg.max_sensor_dist) + e[2] - a[2], -b[2], lo, hi)
    dmax = depth_max(depth.to(torch.float32)).to(f64)
    z_far = dmax + f32(cfg.max_dist_neg)  # +inf (a +inf reading) clips nothing
    lo, hi = _clip_ge(z_far + 1e-6 * torch.abs(z_far) + e[2] - a[2], -b[2], lo, hi)
    W, H = float(cfg.image_width), float(cfg.image_height)
    fx, fy = f32(cfg.focal_length_x), f32(cfg.focal_length_y)
    pcx, pcy = f32(cfg.principal_point_x), f32(cfg.principal_point_y)
    err_u = (abs(fx) * e[0] + (W + abs(pcx) + 2.0) * e[2]) / z_near
    err_v = (abs(fy) * e[1] + (H + abs(pcy) + 2.0) * e[2]) / z_near
    pix = (z_near > 0) & (err_u <= 0.5 * PIXEL_SLACK) & (err_v <= 0.5 * PIXEL_SLACK)
    u_lo, u_hi = pcx + 1.0 + PIXEL_SLACK, W + PIXEL_SLACK - pcx
    v_lo, v_hi = pcy + 1.0 + PIXEL_SLACK, H + PIXEL_SLACK - pcy
    plo, phi = lo, hi
    for alpha, beta in ((fx * a[0] + u_lo * a[2], fx * b[0] + u_lo * b[2]),
                        (u_hi * a[2] - fx * a[0], u_hi * b[2] - fx * b[0]),
                        (fy * a[1] + v_lo * a[2], fy * b[1] + v_lo * b[2]),
                        (v_hi * a[2] - fy * a[1], v_hi * b[2] - fy * b[1])):
        plo, phi = _clip_ge(alpha, beta, plo, phi)
    lo, hi = torch.where(pix, plo, lo), torch.where(pix, phi, hi)
    empty = ~(lo <= hi) | torch.isneginf(dmax)
    # lo and hi lie in [0, zres - 1] where not empty
    zl = torch.clamp(torch.floor(lo.clamp(0, cfg.zres - 1)) - 1, min=0).to(torch.int64)
    zh = torch.clamp(torch.ceil(hi.clamp(0, cfg.zres - 1)) + 1, max=cfg.zres - 1).to(torch.int64)
    return torch.where(empty, 1, zl), torch.where(empty, 0, zh)


def dense_candidates(cfg: TSDFConfig, pose_inv, depth, x0: int = 0, nx=None,
                     planes: int = 32):
    """The voxels of the X-slab [x0, x0 + nx) that any fusion of this frame
    must project and test, counted voxel by voxel (an int64 0-dim tensor):
    those whose camera-frame centre lies inside the pinhole frustum (its
    pixel in the image), between min_sensor_dist and max_sensor_dist, with
    camera z at most the frame's deepest reading plus max_dist_neg. A voxel
    the frame observes is one of them (its reading is at most the deepest).
    `planes` x-planes at a time."""
    from ..geometry import reproject_point, transform_points
    from ..volume import voxel_centers_grid

    nx = cfg.xres - x0 if nx is None else nx
    depth = depth.to(torch.float32)
    far = depth_max(depth) + cfg.max_dist_neg
    n = torch.zeros((), dtype=torch.int64, device=depth.device)
    for s in range(x0, x0 + nx, planes):
        cx, cy, cz = voxel_centers_grid(cfg, device=depth.device,
                                        x_slab=(s, min(planes, x0 + nx - s)))
        vx, vy, vz = transform_points(pose_inv, cx, cy, cz)
        _, _, in_image = reproject_point(cfg, vx, vy, vz)
        n += (in_image & (vz >= cfg.min_sensor_dist) & (vz <= cfg.max_sensor_dist)
              & (vz <= far)).sum()
    return n


def bytes_moved(n_live_rows: int, H: int, W: int, nc: int, B: int = 8) -> int:
    """Device-memory traffic of one fuse_bricks call on bricks of B^3
    voxels: each live row's 4 state fields read and written once (32 B a
    voxel), the depth image read once, and with nc > 0 color channels each
    live row's color read and written once and the rgb image read once."""
    return voxel_bytes(n_live_rows * B ** 3, H, W, nc)


def voxel_bytes(n_voxels: int, H: int, W: int, nc: int) -> int:
    """The traffic of :func:`bytes_moved` for n_voxels voxels' state and
    color. Given the count of voxels the frame observes (whether a voxel is
    observed depends only on its projection and the depth image), this is
    the least any fusion of the frame must move."""
    b = n_voxels * 4 * 4 * 2 + H * W * 4
    if nc:
        b += n_voxels * nc * 4 * 2 + H * W * 3 * 4
    return b


# Float32 operations counted from csrc/fusion.cu: the projection of a
# voxel (cell centre, pose, pixel, range tests), the coarse frustum test
# where frustum culling is on, the update of an observed voxel
# (observation, weighted average, Welford update), and the color update of
# each mode.
PROJECT_OPS_PER_VOXEL = 42
FRUSTUM_OPS_PER_VOXEL = 35
UPDATE_OPS_PER_VOXEL = 19
COLOR_OPS_PER_VOXEL = {COLOR_MODE_RGB: 15, COLOR_MODE_RGB_NORMALIZED: 25,
                       COLOR_MODE_LAB: 72}


def ops_needed(cfg, n_projected: int, n_observed: int) -> int:
    """Float32 operations of one fuse_bricks call: n_projected voxels (every
    voxel of the live rows) projected and tested, n_observed of them
    updated."""
    per_voxel = PROJECT_OPS_PER_VOXEL + (FRUSTUM_OPS_PER_VOXEL if cfg.frustum_culling else 0)
    per_obs = UPDATE_OPS_PER_VOXEL + (COLOR_OPS_PER_VOXEL.get(cfg.color_mode, 0)
                                      if cfg.integrate_color else 0)
    return n_projected * per_voxel + n_observed * per_obs
