"""PLY mesh I/O (binary little-endian and ASCII).

Replaces the reference's pcl::io::savePLYFileBinary / savePLYFile usage
(cpu_tsdf/src/prog/integrate.cpp:707-710, tsdf2mesh.cpp:65-71).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None, binary: bool = True,
             normals: Optional[np.ndarray] = None) -> None:
    """Write a triangle mesh. colors: [N,3] 0..255; normals: [N,3] float."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n_v, n_f = len(vertices), len(faces)
    has_c = colors is not None
    has_n = normals is not None

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append("comment generated by cpu_tsdf_tpu")
    header.append(f"element vertex {n_v}")
    header += ["property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append(f"element face {n_f}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            # structured-array tobytes(): identical byte layout to the old
            # per-row struct.pack loop, milliseconds instead of minutes on
            # the multi-million-vertex meshes MC produces at high res
            vfields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_n:
                vfields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if has_c:
                vfields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            vrec = np.zeros(n_v, np.dtype(vfields))
            vrec["x"], vrec["y"], vrec["z"] = vertices.T
            if has_n:
                nrm = np.asarray(normals, np.float32)
                vrec["nx"], vrec["ny"], vrec["nz"] = nrm.T
            if has_c:
                cols = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
                vrec["r"], vrec["g"], vrec["b"] = cols.T
            f.write(vrec.tobytes())
            frec = np.zeros(n_f, np.dtype([("k", "u1"), ("v", "<i4", (3,))]))
            frec["k"] = 3
            frec["v"] = faces
            f.write(frec.tobytes())
        else:
            lines = []
            cols = None if not has_c else np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            nrm = None if not has_n else np.asarray(normals, np.float32)
            for i in range(n_v):
                parts = [f"{v:.8g}" for v in vertices[i]]
                if has_n:
                    parts += [f"{v:.8g}" for v in nrm[i]]
                if has_c:
                    parts += [str(int(v)) for v in cols[i]]
                lines.append(" ".join(parts))
            for i in range(n_f):
                lines.append("3 " + " ".join(str(int(v)) for v in faces[i]))
            f.write(("\n".join(lines) + "\n").encode("ascii"))


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read a PLY mesh (subset: as written by save_ply or PCL). Returns
    (vertices, faces, colors|None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end + len(b"end_header\n"):]

    fmt = "ascii"
    n_v = n_f = 0
    v_props = []
    cur = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_v = int(t[2])
            elif t[1] == "face":
                n_f = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            v_props.append((t[1], t[2]))

    type_map = {"float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
                "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
                "int": ("i", 4), "uint": ("I", 4), "short": ("h", 2), "ushort": ("H", 2)}
    names = [p[1] for p in v_props]

    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        verts = np.zeros((n_v, 3), np.float32)
        cols = np.zeros((n_v, 3), np.float32) if "red" in names else None
        for i in range(n_v):
            vals = text[i].split()
            rec = dict(zip(names, vals))
            verts[i] = (float(rec["x"]), float(rec["y"]), float(rec["z"]))
            if cols is not None:
                cols[i] = (float(rec["red"]), float(rec["green"]), float(rec["blue"]))
        faces = []
        for i in range(n_v, n_v + n_f):
            vals = text[i].split()
            k = int(vals[0])
            faces.append([int(x) for x in vals[1:1 + k]])
        faces = np.asarray(faces, np.int32)
    elif fmt == "binary_little_endian":
        np_map = {"f": "<f4", "d": "<f8", "B": "u1", "b": "i1",
                  "i": "<i4", "I": "<u4", "h": "<i2", "H": "<u2"}
        vdt = np.dtype([(nm, np_map[type_map[tp][0]]) for tp, nm in v_props])
        rec_size = vdt.itemsize
        vrec = np.frombuffer(body, vdt, count=n_v)
        verts = np.stack([vrec["x"], vrec["y"], vrec["z"]],
                         -1).astype(np.float32)
        cols = None
        if "red" in names:
            cols = np.stack([vrec["red"], vrec["green"], vrec["blue"]],
                            -1).astype(np.float32)
        off = n_v * rec_size
        # faces: the common all-triangles case reads as one record array;
        # mixed polygon sizes fall back to the scan
        fdt = np.dtype([("k", "u1"), ("v", "<i4", (3,))])
        if n_f and len(body) >= off + n_f * fdt.itemsize:
            frec = np.frombuffer(body, fdt, count=n_f, offset=off)
            if (frec["k"] == 3).all() and (len(body) - off) >= n_f * fdt.itemsize:
                faces = frec["v"].astype(np.int32)
            else:
                frec = None
        else:
            frec = None
        if n_f == 0:
            faces = np.zeros((0, 3), np.int32)
        elif frec is None or not (frec["k"] == 3).all():
            faces = []
            for i in range(n_f):
                (k,) = struct.unpack_from("<B", body, off)
                off += 1
                faces.append(struct.unpack_from(f"<{k}i", body, off))
                off += 4 * k
            faces = np.asarray(faces, np.int32)
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return verts, faces, cols
