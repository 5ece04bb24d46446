"""PCD point-cloud I/O (ascii / binary / binary_compressed).

Replaces the reference's pcl::io::loadPCDFile / savePCDFileBinaryCompressed
usage (cpu_tsdf/src/prog/integrate.cpp:558,681). Supports the PCL 0.7
header, AoS binary layout, and the LZF-compressed SoA layout PCL writes for
binary_compressed. A copy of ``cpu_tsdf_tpu.io.pcd`` (numpy; the bytes
written are the same).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

_TYPE_MAP = {("F", 4): "<f4", ("F", 8): "<f8",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression (liblzf format, as used by PCL).

    Literal runs are slice copies; back-references copy in chunks of the
    back-distance (correct for the overlapping case, where the run repeats
    the last `dist` bytes) — per-frame host time matters, this sits on the
    cloud-loading path for PCL's default binary_compressed format."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            cnt = ctrl + 1
            out += data[i:i + cnt]
            i += cnt
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            dist = ((ctrl & 0x1F) << 8) + data[i] + 1
            i += 1
            ref = len(out) - dist
            remaining = length + 2
            while remaining > 0:
                chunk = min(dist, remaining)
                out += out[ref:ref + chunk]
                ref += chunk
                remaining -= chunk
    return bytes(out)


def _lzf_compress(data: bytes) -> bytes:
    """Trivial LZF encoder: emits literal runs only (valid, not optimal)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        cnt = min(32, n - i)
        out.append(cnt - 1)
        out += data[i:i + cnt]
        i += cnt
    return bytes(out)


class PointCloud:
    """Lightweight organized point cloud: dict of [H*W] field arrays."""

    def __init__(self, fields: Dict[str, np.ndarray], width: int, height: int):
        self.fields = fields
        self.width = width
        self.height = height

    @property
    def size(self) -> int:
        return self.width * self.height

    def xyz(self) -> np.ndarray:
        return np.stack([self.fields["x"], self.fields["y"], self.fields["z"]], -1)

    def rgb(self) -> Optional[np.ndarray]:
        """Unpack packed RGB float/uint (PCL convention) to [N,3] 0..255."""
        key = "rgb" if "rgb" in self.fields else ("rgba" if "rgba" in self.fields else None)
        if key is None:
            return None
        raw = self.fields[key]
        if raw.dtype.kind == "f":
            packed = raw.view(np.uint32)
        else:
            packed = raw.astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        return np.stack([r, g, b], -1).astype(np.float32)

    def depth_image(self) -> np.ndarray:
        """[H, W] z-channel (the reference's organized-cloud depth)."""
        return self.fields["z"].reshape(self.height, self.width)

    def rgb_image(self) -> Optional[np.ndarray]:
        c = self.rgb()
        if c is None:
            return None
        return c.reshape(self.height, self.width, 3)


def load_pcd(path: str) -> PointCloud:
    with open(path, "rb") as f:
        data = f.read()
    # header is ASCII lines until the DATA line
    lines = []
    off = 0
    while True:
        nl = data.find(b"\n", off)
        if nl == -1:
            # without this, off = nl + 1 would reset the scan to byte 0 and
            # loop forever on non-PCD / truncated files
            raise ValueError(f"{path}: no DATA line — not a valid PCD header")
        line = data[off:nl].decode("ascii", "replace")
        off = nl + 1
        if line.startswith("#"):
            continue
        lines.append(line)
        if line.startswith("DATA"):
            break
    hdr = {}
    for line in lines:
        parts = line.split()
        hdr[parts[0]] = parts[1:]
    fields = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    width = int(hdr["WIDTH"][0])
    height = int(hdr["HEIGHT"][0])
    npts = int(hdr.get("POINTS", [width * height])[0])
    mode = hdr["DATA"][0]

    dtypes = []
    for name, sz, tp, cnt in zip(fields, sizes, types, counts):
        base = _TYPE_MAP[(tp, sz)]
        if cnt == 1:
            dtypes.append((name, base))
        else:
            dtypes.append((name, base, (cnt,)))
    rec = np.dtype(dtypes)

    if mode == "ascii":
        text = data[off:].decode("ascii")
        raw = np.loadtxt(text.strip().split("\n"), dtype=np.float64, ndmin=2)
        out = {}
        ci = 0
        for name, sz, tp, cnt in zip(fields, sizes, types, counts):
            base = np.dtype(_TYPE_MAP[(tp, sz)])
            col = raw[:, ci:ci + cnt]
            ci += cnt
            if tp == "U" and name in ("rgb", "rgba"):
                out[name] = col[:, 0].astype(np.uint32)
            else:
                out[name] = col[:, 0].astype(base) if cnt == 1 else col.astype(base)
        return PointCloud(out, width, height)
    elif mode == "binary":
        arr = np.frombuffer(data[off:off + rec.itemsize * npts], dtype=rec, count=npts)
        return PointCloud({n: np.ascontiguousarray(arr[n]) for n in rec.names}, width, height)
    elif mode == "binary_compressed":
        comp_size, uncomp_size = struct.unpack_from("<II", data, off)
        comp = data[off + 8: off + 8 + comp_size]
        raw = _lzf_decompress(comp, uncomp_size)
        # SoA layout: field by field (each with its COUNT lanes)
        out = {}
        pos = 0
        for name, sz, tp, cnt in zip(fields, sizes, types, counts):
            nbytes = sz * cnt * npts
            a = np.frombuffer(raw[pos:pos + nbytes], dtype=_TYPE_MAP[(tp, sz)])
            pos += nbytes
            out[name] = a if cnt == 1 else a.reshape(npts, cnt)
        return PointCloud(out, width, height)
    raise ValueError(f"unsupported PCD DATA mode {mode}")


def save_pcd(path: str, cloud: PointCloud, mode: str = "binary") -> None:
    fields = list(cloud.fields)
    arrays = [np.asarray(cloud.fields[f]) for f in fields]
    npts = cloud.size
    sizes = [a.dtype.itemsize for a in arrays]
    types = [{"f": "F", "i": "I", "u": "U"}[a.dtype.kind] for a in arrays]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(str(s) for s in sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join('1' for _ in fields)}\n"
        f"WIDTH {cloud.width}\nHEIGHT {cloud.height}\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {npts}\nDATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if mode == "ascii":
            cols = np.stack([a.astype(np.float64) for a in arrays], -1)
            np.savetxt(f, cols, fmt="%.9g")
        elif mode == "binary":
            rec = np.dtype([(n, a.dtype) for n, a in zip(fields, arrays)])
            out = np.empty(npts, dtype=rec)
            for n, a in zip(fields, arrays):
                out[n] = a
            f.write(out.tobytes())
        elif mode == "binary_compressed":
            raw = b"".join(a.tobytes() for a in arrays)
            comp = _lzf_compress(raw)
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode}")


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """[N,3] 0..255 -> packed float32 rgb field (PCL convention)."""
    r = rgb[:, 0].astype(np.uint32)
    g = rgb[:, 1].astype(np.uint32)
    b = rgb[:, 2].astype(np.uint32)
    return ((r << 16) | (g << 8) | b).view(np.float32)
