"""Reference-compatible ``.vol`` checkpoint codec.

A copy of ``cpu_tsdf_tpu.io.vol`` (numpy, on the host; the bytes written
are the same). The writer recurses in Python over every octree node, so it
is slow at 512^3.

Byte-level implementation of the reference's save/load format so checkpoints
interoperate both ways:
  * ASCII meta header            cpu_tsdf/src/lib/tsdf_volume_octree.cpp:223-245
  * eigen_extensions ASCII 4x4   include/eigen_extensions/eigen_extensions.h:289-300
  * octree stream header         src/lib/octree.cpp:645-657 ("#OCTREEBINARY",
    size_t resolutions = 8-byte LE on this platform)
  * recursive node records       octree.cpp:289-304 (d, w, ctr, size, M f32;
    nsample i32; nchild u64) with per-type color prefixes (octree.cpp:360-376,
    416-433, 565-581). NOTE the reference truncates RGBNormalized/LAB floats
    to one byte when serializing (its documented bug); we read AND write those
    low bytes exactly as the reference does — loading reconstructs the same
    denormal floats its own deserialize produces (byte patched into a
    zero-initialized float member, octree.h:218-221,268-269). NOCOLOR/RGB
    volumes round-trip exactly.

Our octree WRITER emits a tree the reference loader accepts: uniform
subdivision to the coarse level, then full subdivision to the finest level
inside any coarse cell that contains observed voxels.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np

from ..config import TSDFConfig

_NODE_FMT = "<7fi"          # d w cx cy cz size M nsample
_NODE_SIZE = struct.calcsize(_NODE_FMT)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def line(self) -> str:
        if self.pos >= len(self.data):
            # without this, find() returning -1 would reset pos to 0 and the
            # callers' scan-until loops would spin forever on truncated files
            raise ValueError("unexpected EOF while parsing .vol header")
        nl = self.data.find(b"\n", self.pos)
        if nl == -1:
            s = self.data[self.pos:].decode("ascii", "replace")
            self.pos = len(self.data)
        else:
            s = self.data[self.pos:nl].decode("ascii", "replace")
            self.pos = nl + 1
        return s

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


def _color_prefix_size(type_string: str) -> int:
    return {"NOCOLOR": 0, "RGB": 3, "RGBNormalized": 4, "LAB": 3}[type_string]


def load_vol(path: str):
    """Parse a .vol file. Returns (config, arrays dict, global_transform 4x4).

    arrays: sdf, weight, M, nsample, finest_mask (+ rgb when type RGB);
    coarse leaves are rasterized into their whole voxel span, finest_mask
    marks voxels stored at finest resolution.
    """
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    header = r.line()
    if "TSDFVolumeOctree" not in header:
        raise ValueError(f"{path}: not a TSDFVolumeOctree .vol file")
    xres, yres, zres = (int(v) for v in r.line().split())
    xsize, ysize, zsize = (float(v) for v in r.line().split())
    max_dist_pos = float(r.line())
    max_dist_neg = float(r.line())
    max_weight = float(r.line())
    min_sensor_dist = float(r.line())
    max_sensor_dist = float(r.line())
    mc = [float(v) for v in r.line().split()]
    intr = [float(v) for v in r.line().split()]
    width, height = (int(v) for v in r.line().split())
    _is_empty = r.line().strip()
    weight_by_depth = r.line().strip() == "1"
    weight_by_variance = r.line().strip() == "1"
    # eigen ASCII: "% rows cols" then rows lines
    hdr = r.line()
    while not hdr.strip():
        hdr = r.line()
    if not hdr.lstrip().startswith("%"):
        raise ValueError(f".vol parse error: expected eigen '%' header, got {hdr!r}")
    rows, cols = (int(v) for v in hdr.lstrip()[1:].split())
    mat = np.zeros((rows, cols))
    for i in range(rows):
        mat[i] = [float(v) for v in r.line().split()]
    # octree header
    type_string = r.line().strip()
    while type_string == "":
        type_string = r.line().strip()
    line = r.line()
    while not line.startswith("#O"):
        line = r.line()
    rx, ry, rz = struct.unpack_from("<3Q", data, r.pos); r.pos += 24
    sx, sy, sz = struct.unpack_from("<3f", data, r.pos); r.pos += 12

    cfg = TSDFConfig(
        xres=xres, yres=yres, zres=zres, xsize=xsize, ysize=ysize, zsize=zsize,
        max_dist_pos=max_dist_pos, max_dist_neg=max_dist_neg, max_weight=max_weight,
        min_sensor_dist=min_sensor_dist, max_sensor_dist=max_sensor_dist,
        focal_length_x=intr[0], focal_length_y=intr[1],
        principal_point_x=intr[2], principal_point_y=intr[3],
        image_width=width, image_height=height,
        max_cell_size_x=mc[0], max_cell_size_y=mc[1], max_cell_size_z=mc[2],
        weight_by_depth=weight_by_depth, weight_by_variance=weight_by_variance,
        integrate_color=(type_string != "NOCOLOR"),
        color_mode=("RGB" if type_string == "NOCOLOR" else type_string),
    )

    cells = (xsize / xres, ysize / yres, zsize / zres)
    if not (math.isclose(cells[0], cells[1], rel_tol=1e-6)
            and math.isclose(cells[0], cells[2], rel_tol=1e-6)):
        # leaf spans below derive from the node's single cubic size; unequal
        # cells would rasterize y/z at shifted indices (silent corruption)
        raise ValueError(
            f".vol loader requires cubic cells; got {cells} — the reference "
            "octree subdivides cubically, so such a file is not a faithful "
            "reference artifact anyway")
    shape = (xres, yres, zres)
    sdf = np.full(shape, -1.0, np.float32)
    weight = np.zeros(shape, np.float32)
    M = np.zeros(shape, np.float32)
    nsample = np.zeros(shape, np.int32)
    finest_mask = np.zeros(shape, bool)
    cprefix = _color_prefix_size(type_string)
    color = (np.zeros(shape + (cprefix,), np.float32) if cprefix else None)

    finest = xsize / xres
    pos = r.pos

    def decode_color(raw: bytes) -> np.ndarray:
        if type_string == "RGB":
            # RGBNode stores genuine uint8 members (octree.cpp:360-366)
            return np.frombuffer(raw, np.uint8).astype(np.float32)
        # RGBNormalized/LAB write only the LOW BYTE of each float member
        # (octree.cpp:416-424,565-571 — the reference's documented float-as-
        # byte truncation); its own deserialize patches that byte into a
        # zero-initialized float (octree.h:218-221,268-269), yielding the
        # denormal  byte * 2^-149.  Reproduce that bit pattern exactly so our
        # in-memory channels match the reference loader's.
        return np.frombuffer(raw, np.uint8).astype("<u4").view("<f4")

    def parse(pos: int):
        raw_color = data[pos:pos + cprefix]
        pos += cprefix
        d, w, cx, cy, cz, size, Mv, ns = struct.unpack_from(_NODE_FMT, data, pos)
        pos += _NODE_SIZE
        (nchild,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        if nchild == 0:
            # rasterize this leaf's span
            i0 = int(math.floor((cx - size / 2 + xsize / 2) / xsize * xres + 0.5))
            j0 = int(math.floor((cy - size / 2 + ysize / 2) / ysize * yres + 0.5))
            k0 = int(math.floor((cz - size / 2 + zsize / 2) / zsize * zres + 0.5))
            span = max(1, int(round(size / finest)))
            sl = (slice(max(i0, 0), min(i0 + span, xres)),
                  slice(max(j0, 0), min(j0 + span, yres)),
                  slice(max(k0, 0), min(k0 + span, zres)))
            sdf[sl] = d
            weight[sl] = w
            M[sl] = Mv
            nsample[sl] = ns
            if size <= finest * 1.0001:
                finest_mask[sl] = True
            if color is not None:
                color[sl] = decode_color(raw_color)
        else:
            if nchild != 8:
                raise ValueError(
                    f".vol parse error: node child count {nchild} (not 0/8) "
                    f"at byte {pos - 8} — corrupt or misaligned stream")
            for _ in range(8):
                pos = parse(pos)
        return pos

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        parse(pos)
    finally:
        sys.setrecursionlimit(old_limit)

    arrays = dict(sdf=sdf, weight=weight, M=M, nsample=nsample, finest_mask=finest_mask)
    if color is not None:
        arrays["color"] = color
        if type_string == "RGB":
            arrays["rgb"] = color  # back-compat alias
    return cfg, arrays, mat


def _fmt(v: float) -> str:
    """Mimic C++ ostream with precision(16)."""
    return f"{v:.16g}"


def save_vol(path: str, cfg: TSDFConfig, sdf, weight, M=None, nsample=None,
             rgb=None, global_transform: Optional[np.ndarray] = None,
             color_mode: str = "RGB") -> None:
    """Write a reference-loadable .vol checkpoint from dense arrays.

    `rgb` is the fused color-channel array for `color_mode`: [X,Y,Z,3] 0..255
    for RGB, [X,Y,Z,4] (r_n,g_n,b_n,i) for RGBNormalized, [X,Y,Z,3] (L,A,B)
    for LAB. Non-RGB modes serialize only the LOW BYTE of each float channel,
    exactly like the reference's broken writer (octree.cpp:416-424,565-571) —
    the bytes the reference's own loader expects.
    """
    if not (cfg.xres == cfg.yres == cfg.zres
            and cfg.xsize == cfg.ysize == cfg.zsize):
        # the reference octree subdivides cubically (OctreeNode stores one
        # scalar size_); the pyramid/node math below assumes the same, and
        # silently truncated the volume for unequal axes before this guard
        raise ValueError(
            ".vol interop requires a cubic volume; got resolution "
            f"{(cfg.xres, cfg.yres, cfg.zres)} size "
            f"{(cfg.xsize, cfg.ysize, cfg.zsize)} — use the native npz "
            "checkpoint (io.checkpoint) for anisotropic volumes")
    sdf = np.asarray(sdf, np.float32)
    weight = np.asarray(weight, np.float32)
    M = np.zeros_like(sdf) if M is None else np.asarray(M, np.float32)
    nsample = (np.zeros(sdf.shape, np.int32) if nsample is None
               else np.asarray(nsample, np.int32))
    if global_transform is None:
        global_transform = np.eye(4)
    type_string = color_mode if rgb is not None else "NOCOLOR"
    if rgb is not None:
        if type_string == "RGB":
            rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
        else:
            assert type_string in ("RGBNormalized", "LAB"), type_string
            assert np.asarray(rgb).shape[-1] == _color_prefix_size(type_string)
            rgb = (np.asarray(rgb, "<f4").view("<u4") & 0xFF).astype(np.uint8)

    out = []
    out.append(b"# TSDFVolumeOctree Meta Information\n")
    out.append(f"{cfg.xres} {cfg.yres} {cfg.zres}\n".encode())
    out.append(f"{_fmt(cfg.xsize)} {_fmt(cfg.ysize)} {_fmt(cfg.zsize)}\n".encode())
    out.append(f"{_fmt(cfg.max_dist_pos)}\n".encode())
    out.append(f"{_fmt(cfg.max_dist_neg)}\n".encode())
    out.append(f"{_fmt(cfg.max_weight)}\n".encode())
    out.append(f"{_fmt(cfg.min_sensor_dist)}\n".encode())
    out.append(f"{_fmt(cfg.max_sensor_dist)}\n".encode())
    out.append((" ".join(_fmt(v) for v in
                         (cfg.max_cell_size_x, cfg.max_cell_size_y, cfg.max_cell_size_z)) + "\n").encode())
    out.append((" ".join(_fmt(v) for v in
                         (cfg.focal_length_x, cfg.focal_length_y,
                          cfg.principal_point_x, cfg.principal_point_y)) + "\n").encode())
    out.append(f"{cfg.image_width} {cfg.image_height}\n".encode())
    is_empty = int(not (weight > 0).any())  # nsample is optional; weights
    # alone decide whether the reference should treat the volume as fused
    out.append(f"{is_empty}\n".encode())
    out.append(f"{int(cfg.weight_by_depth)}\n".encode())
    out.append(f"{int(cfg.weight_by_variance)}\n".encode())
    out.append(b"% 4 4\n")
    for row in np.asarray(global_transform):
        out.append((" ".join(_fmt(v) for v in row) + "\n").encode())
    out.append(f"{type_string}\n".encode())
    out.append(b"#OCTREEBINARY\n")
    out.append(struct.pack("<3Q", cfg.xres, cfg.yres, cfg.zres))
    out.append(struct.pack("<3f", cfg.xsize, cfg.ysize, cfg.zsize))

    # Observed-region pyramid guiding subdivision: level L block has 2^L voxels.
    obs = weight > 0
    levels = [obs]
    while levels[-1].shape[0] > 1:
        a = levels[-1]
        levels.append(a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2,
                                a.shape[2] // 2, 2).any((1, 3, 5)))
    # levels[k] indexed by block coords at voxel-span 2^k
    num_levels = len(levels) - 1          # root span = 2^num_levels
    coarse = cfg.num_coarse_levels        # always subdivide this deep
    cell = (cfg.xsize / cfg.xres, cfg.ysize / cfg.yres, cfg.zsize / cfg.zres)

    def node_bytes(i, j, k, lvl):
        """Emit node covering voxel block [i*2^lvl, (i+1)*2^lvl) etc."""
        span = 1 << lvl
        size = span * cell[0]
        cx = (i + 0.5) * span * cell[0] - cfg.xsize / 2
        cy = (j + 0.5) * span * cell[1] - cfg.ysize / 2
        cz = (k + 0.5) * span * cell[2] - cfg.zsize / 2
        depth = num_levels - lvl
        subdivide = lvl > 0 and (depth < coarse or levels[lvl][i, j, k])
        if lvl == 0:
            d, w = float(sdf[i, j, k]), float(weight[i, j, k])
            Mv, ns = float(M[i, j, k]), int(nsample[i, j, k])
        else:
            d, w, Mv, ns = -1.0, 0.0, 0.0, 0
        prefix = b""
        if type_string != "NOCOLOR":
            if lvl == 0:
                prefix = rgb[i, j, k].tobytes()
            else:
                prefix = b"\x00" * _color_prefix_size(type_string)
        rec = prefix + struct.pack(_NODE_FMT, d, w, cx, cy, cz, size, Mv, ns)
        if subdivide:
            parts = [rec, struct.pack("<Q", 8)]
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in (0, 1):
                        parts.append(node_bytes(2 * i + di, 2 * j + dj, 2 * k + dk, lvl - 1))
            return b"".join(parts)
        return rec + struct.pack("<Q", 0)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        out.append(node_bytes(0, 0, 0, num_levels))
    finally:
        sys.setrecursionlimit(old_limit)
    with open(path, "wb") as f:
        f.write(b"".join(out))
