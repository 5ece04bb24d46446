"""Minimal dependency-free PNG writing for headless visualization dumps.

A copy of ``cpu_tsdf_tpu.io.image`` (numpy; the bytes written are the
same). The reference's ``--visualize`` opens interactive PCL windows
(cpu_tsdf/src/prog/integrate.cpp:266-268,636-648, compiled only when
PCL visualization is present). Headless machines have no display, so the
equivalent capability here is periodic rendered-view dumps: depth and normal
images of the accumulating volume written as PNGs (encoder uses only zlib +
struct from the standard library).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W] (grayscale) or [H, W, 3] (RGB) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("save_png expects uint8")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    color_type = {1: 0, 3: 2}[C]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(H))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    hdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", hdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def depth_to_u8(depth: np.ndarray, lo: float = None, hi: float = None) -> np.ndarray:
    """Map a metric depth image (NaN = miss) to uint8 (0 = miss)."""
    d = np.asarray(depth, np.float32)
    ok = np.isfinite(d)
    if not ok.any():
        return np.zeros(d.shape, np.uint8)
    lo = float(np.min(d[ok])) if lo is None else lo
    hi = float(np.max(d[ok])) if hi is None else hi
    span = max(hi - lo, 1e-6)
    out = np.clip((d - lo) / span, 0.0, 1.0) * 254.0 + 1.0
    return np.where(ok, out, 0.0).astype(np.uint8)


def normals_to_u8(normals: np.ndarray) -> np.ndarray:
    """Map [H, W, 3] unit normals (NaN = miss) to an RGB uint8 image."""
    n = np.asarray(normals, np.float32)
    ok = np.isfinite(n).all(-1, keepdims=True)
    img = (np.clip(n * 0.5 + 0.5, 0, 1) * 255.0)
    return np.where(ok, img, 0.0).astype(np.uint8)
