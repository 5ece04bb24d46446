"""Camera pose file loading and cloud/pose pairing.

Replicates the reference CLI conventions
(cpu_tsdf/src/prog/integrate.cpp:369-473):
  * poses are 3x4 or 4x4 row-major matrices, camera-in-world;
  * `.txt` = ASCII floats, `.transform` = raw little-endian float32 binary;
  * clouds pair with pose files via the shared filename prefix rule.

A copy of ``cpu_tsdf_tpu.io.poses`` (numpy).
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence, Tuple

import numpy as np


def load_pose_txt(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(t) for t in line.split())
    return _to_4x4(vals, path)


def load_pose_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    n = len(raw) // 4
    vals = list(struct.unpack(f"<{n}f", raw[: 4 * n]))
    return _to_4x4(vals, path)


def _to_4x4(vals: Sequence[float], path: str) -> np.ndarray:
    # The reference reads exactly 12 values and pins the last row
    # (integrate.cpp:448-461); accept 16 too.
    if len(vals) < 12:
        raise ValueError(f"pose file {path}: expected >=12 floats, got {len(vals)}")
    m = np.eye(4, dtype=np.float64)
    m[:3, :] = np.asarray(vals[:12], np.float64).reshape(3, 4)
    if len(vals) >= 16:
        m[3, :] = vals[12:16]
    return m


def load_pose(path: str) -> np.ndarray:
    if path.lower().endswith(".transform"):
        return load_pose_binary(path)
    return load_pose_txt(path)


def shared_prefix(files: Sequence[str]) -> str:
    """getSharedPrefix (integrate.cpp:224-246): longest common prefix of the
    first and last sorted names, stopping at the first digit."""
    if not files:
        return ""
    first, last = files[0], files[-1]
    i = 0
    for i in range(len(first)):
        if i >= len(last) or first[i] != last[i] or first[i].isdigit():
            break
    else:
        i = len(first)
    return first[:i]


def scrape_directory(dirname: str) -> Tuple[List[str], List[str], bool]:
    """Find (pcd_files, pose_files, binary_poses) with the reference's pairing
    (integrate.cpp:369-441). Raises on mixed pose extensions or missing pairs.
    """
    pcd_files, pose_unordered = [], []
    pose_ext = None
    for name in os.listdir(dirname):
        path = os.path.join(dirname, name)
        ext = os.path.splitext(name)[1].lower()
        if ext == ".pcd":
            pcd_files.append(path)
        elif ext in (".transform", ".txt"):
            if pose_ext is not None and ext != pose_ext:
                raise ValueError(
                    f"mixed pose extensions {ext} and {pose_ext} in {dirname}")
            pose_ext = ext
            pose_unordered.append(path)
    pcd_files.sort()
    pose_unordered.sort()
    if not pcd_files:
        raise FileNotFoundError(f"no .pcd files in {dirname}")
    # Prefix matching on basenames (the reference uses full paths,
    # integrate.cpp:421-429, which breaks when parent dirs contain digits —
    # fixed here).
    pcd_prefix = shared_prefix([os.path.basename(p) for p in pcd_files])
    pose_prefix = shared_prefix([os.path.basename(p) for p in pose_unordered]) \
        if pose_unordered else ""
    pose_files = []
    for pcd_path in pcd_files:
        suffix = os.path.splitext(os.path.basename(pcd_path)[len(pcd_prefix):])[0]
        pose_path = os.path.join(dirname, pose_prefix + suffix + (pose_ext or ""))
        if pose_ext is not None and os.path.exists(pose_path):
            pose_files.append(pose_path)
        elif pose_ext is not None:
            raise FileNotFoundError(f"no matching pose file for {pcd_path}")
    return pcd_files, sorted(pose_files), pose_ext == ".transform"


def load_poses(pose_files: Sequence[str], invert: bool = False,
               pose_units: float = 1.0) -> List[np.ndarray]:
    """Load all poses with the CLI's postprocessing (integrate.cpp:444-473)."""
    out = []
    for p in pose_files:
        m = load_pose(p)
        if invert:
            m = np.linalg.inv(m)
        m[:3, 3] *= pose_units
        out.append(m)
    return out
