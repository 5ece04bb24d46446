"""Pipeline stages around the volume ops, as the CLI runs them.

Port of ``cpu_tsdf_tpu.pipeline`` (the reference CLI's helper passes,
cpu_tsdf/src/prog/integrate.cpp):
  * organize-by-reprojection (scatter-min depth)    integrate.cpp:582-635
  * flattenVertices (vertex dedup + degenerate cull) integrate.cpp:104-150
  * cleanupMesh (small-cluster face removal)         integrate.cpp:152-214
  * intrinsics estimation (linear least squares)     src/prog/get_intrinsics.cpp:57-107
  * VoxelGrid downsampling for --cloud-only          integrate.cpp:662-669

``organize_cloud`` runs in torch ops on the device it is given (CUDA by
default), on the card as a CUDA graph (the counterpart of the JAX
package's jitted ``_organize_jit``); the mesh and cloud passes are numpy on
the host, copied from the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Tuple

import numpy as np
import torch

from .config import TSDFConfig
from .geometry import pixel_index
from .volume import resolve_device


def _pixel(f, hi: int):
    """trunc(f) as int32, kept in range (``geometry.pixel_index``) with NaN
    taken to 0, as XLA's saturating conversion does in the JAX package: a
    point with a NaN coordinate but a valid z lands in column or row 0."""
    return pixel_index(torch.nan_to_num(f, nan=0.0), hi)


def organize_cloud(cfg: TSDFConfig, points, rgb=None, *, device=None,
                   graph: Optional[bool] = None):
    """Reproject an unorganized cloud into an organized depth (+rgb) image,
    keeping the nearest depth per pixel (scatter-min). Matches
    integrate.cpp:582-635 including the truncation-toward-zero pixel math.

    points [N, 3] and rgb [N, 3] (0..255) are arrays or tensors, moved to
    ``device`` (default CUDA). Returns (depth [H, W] float32 with NaN where
    no point landed, rgb [H, W, 3] float32 or None), tensors on the device.

    Of the points tied at a pixel's nearest depth, the one with the largest
    index gives the pixel its color: a deterministic "last nearest wins",
    the reference's scan order, and what the JAX package gives on the CPU.

    graph: None = on the card the CUDA graph of the cloud's length padded
    to a power of two (``graph.organize_graphed``), eager on the CPU; False
    = eager; True on the CPU raises."""
    from .graph import organize_graphed, resolve_graph

    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    if rgb is not None:
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    if resolve_graph(graph, dev):
        return organize_graphed(cfg, pts, rgb)
    return _organize(cfg, pts, rgb)


def _organize(cfg: TSDFConfig, pts, rgb=None):
    """organize_cloud on device tensors: fixed shapes, no host sync."""
    dev = pts.device
    W, H = cfg.image_width, cfg.image_height
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    # the 1e-3-pixel nudge keeps points that sit on pixel centers (clouds
    # backprojected from depth images) from flipping into the neighbour
    u = _pixel(x * cfg.focal_length_x / z + cfg.principal_point_x + 1e-3, W)
    v = _pixel(y * cfg.focal_length_y / z + cfg.principal_point_y + 1e-3, H)
    ok = ~torch.isnan(z) & (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = torch.where(ok, v.long() * W + u, W * H)    # invalid -> overflow slot
    zsafe = torch.where(ok, z, float("inf"))
    depth = torch.full((W * H + 1,), float("inf"), dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, lin, zsafe, "amin")
    out_depth = depth[:W * H].reshape(H, W)
    out_depth = torch.where(torch.isinf(out_depth), float("nan"), out_depth)
    if rgb is None:
        return out_depth, None
    winner = ok & (zsafe == depth[lin])
    idx = torch.where(winner, torch.arange(len(z), device=dev), -1)
    best = torch.full((W * H + 1,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, torch.where(winner, lin, W * H), idx, "amax")
    # pixels without a point read the zero row appended at index N
    pad = torch.cat([rgb.reshape(-1, 3), rgb.new_zeros((1, 3))])
    best = best[:W * H]
    out_rgb = pad[torch.where(best >= 0, best, len(z))]
    return out_depth, out_rgb.reshape(H, W, 3)


def flatten_vertices(verts: np.ndarray, faces: np.ndarray,
                     colors: Optional[np.ndarray] = None,
                     min_dist: float = 0.0001):
    """Weld vertices closer than min_dist and drop degenerate faces
    (integrate.cpp:104-150). Spatial-hash dedup replaces the KD-tree."""
    verts = np.asarray(verts)
    keys = np.round(verts / max(min_dist, 1e-12)).astype(np.int64)
    _, first_idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    new_verts = verts[first_idx]
    new_cols = None if colors is None else np.asarray(colors)[first_idx]
    # map old unique-id -> compact id ordered by first occurrence
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = rank[inv]
    new_verts = new_verts[order]
    if new_cols is not None:
        new_cols = new_cols[order]
    f = remap[faces]
    good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])
    return new_verts, f[good], new_cols


def cleanup_mesh(verts: np.ndarray, faces: np.ndarray,
                 colors: Optional[np.ndarray] = None,
                 face_dist: float = 0.02, min_neighbors: int = 5):
    """Remove connected clusters of <= min_neighbors faces (by centroid
    proximity), then drop unreferenced vertices (integrate.cpp:152-214)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    if len(faces) == 0:
        return verts[:0], faces, None if colors is None else colors[:0]
    cent = verts[faces].mean(1)
    # union-find over a uniform grid: faces within face_dist land in the same
    # or adjacent cells
    cell = np.floor(cent / face_dist).astype(np.int64)
    parent = np.arange(len(faces))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    buckets = defaultdict(list)
    for i, c in enumerate(map(tuple, cell)):
        buckets[c].append(i)
    d2 = face_dist * face_dist
    for c, members in buckets.items():
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    nb = (c[0] + dx, c[1] + dy, c[2] + dz)
                    if nb not in buckets or nb < c:
                        continue
                    for i in members:
                        for j in buckets[nb]:
                            if i < j or nb != c:
                                dd = cent[i] - cent[j]
                                if dd @ dd <= d2:
                                    union(i, j)
    roots = np.array([find(i) for i in range(len(faces))])
    sizes = dict(zip(*np.unique(roots, return_counts=True)))
    keep = np.array([sizes[r] > min_neighbors for r in roots])
    faces = faces[keep]
    # drop unused vertices + remap
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    new_idx = np.cumsum(used) - 1
    out_faces = new_idx[faces]
    out_verts = verts[used]
    out_cols = None if colors is None else np.asarray(colors)[used]
    return out_verts, out_faces, out_cols


def estimate_intrinsics(xyz: np.ndarray, width: int, height: int
                        ) -> Tuple[float, float, float, float, float]:
    """Pinhole fx/fy/cx/cy from one organized cloud via linear least squares
    (get_intrinsics.cpp:57-107). xyz: [H, W, 3]. Returns (fx, fy, cx, cy,
    reprojection_error)."""
    H, W = xyz.shape[:2]
    if (W, H) != (width, height):
        raise ValueError(f"cloud is {W} x {H}, expected {width} x {height}")
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = xyz[..., 0].astype(np.float64)
    y = xyz[..., 1].astype(np.float64)
    z = xyz[..., 2].astype(np.float64)
    ok = ~(np.isnan(x) | np.isnan(y) | np.isnan(z) | (x == 0) | (y == 0))
    n = int(ok.sum())
    A = np.zeros((2 * n, 4))
    b = np.zeros(2 * n)
    xs, ys, zs = x[ok], y[ok], z[ok]
    us, vs = uu[ok], vv[ok]
    A[0::2, 0] = zs
    A[0::2, 2] = xs
    b[0::2] = zs * us
    A[1::2, 1] = zs
    A[1::2, 3] = ys
    b[1::2] = zs * vs
    X, *_ = np.linalg.lstsq(A, b, rcond=None)
    cx, cy, fx, fy = X
    reproj = float(((A @ X - b) ** 2).sum() / (fx * fx * n))
    return float(fx), float(fy), float(cx), float(cy), reproj


def voxel_downsample(points: np.ndarray, rgb: Optional[np.ndarray],
                     leaf: float = 0.01):
    """VoxelGrid downsampling for the --cloud-only path
    (integrate.cpp:662-669): average of points per leaf cell."""
    keys = np.floor(points / leaf).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    cnt = np.bincount(inv).astype(np.float64)
    out = np.zeros((len(uniq), 3))
    for k in range(3):
        out[:, k] = np.bincount(inv, weights=points[:, k]) / cnt
    orgb = None
    if rgb is not None:
        orgb = np.zeros((len(uniq), 3))
        for k in range(3):
            orgb[:, k] = np.bincount(inv, weights=rgb[:, k]) / cnt
    return out, orgb
