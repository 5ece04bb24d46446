"""Marching-cubes case tables, derived programmatically.

The reference leans on PCL's internal Bourke tables
(``pcl::MarchingCubes::createSurface``, used via
``cpu_tsdf/src/lib/marching_cubes_tsdf_octree.cpp:207``). We own our
tables instead, generating all 256 cases from first principles with a
face-tracing construction:

  * on every cube face, the isosurface crosses sign-change edges; each maximal
    run of inside corners around the face cycle contributes one segment
    connecting its two bounding crossed edges (a purely face-local rule, so
    adjacent cubes always agree -> watertight by construction, including the
    ambiguous saddle faces);
  * faces are oriented outward-CCW, which makes the segments a directed graph
    in which every crossed edge has in-degree = out-degree = 1; the disjoint
    directed cycles are the isosurface polygons, triangulated by fanning.

Corner/edge numbering matches PCL's so that interpolated vertex positions are
bit-identical to the reference mesh vertices:

  corner i offset: x = (i&1)^((i>>1)&1), y = (i>>2)&1, z = (i>>1)&1
  edges: 0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0) 4:(4,5) 5:(5,6) 6:(6,7) 7:(7,4)
         8:(0,4) 9:(1,5) 10:(2,6) 11:(3,7)

"inside" = value < iso, matching PCL's cubeindex bit rule.
"""

from __future__ import annotations

import numpy as np

# Corner offsets (x, y, z), PCL numbering.
CORNER_OFFSETS = np.array(
    [[((i & 1) ^ ((i >> 1) & 1)), (i >> 2) & 1, (i >> 1) & 1] for i in range(8)],
    dtype=np.int32,
)

# Edge endpoints (corner indices), PCL numbering.
EDGE_CORNERS = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
     (0, 4), (1, 5), (2, 6), (3, 7)],
    dtype=np.int32,
)

# Cube faces as outward-CCW corner cycles.
_FACES = (
    (0, 1, 2, 3),  # y=0, normal -y
    (4, 7, 6, 5),  # y=1, normal +y
    (0, 3, 7, 4),  # x=0, normal -x
    (1, 5, 6, 2),  # x=1, normal +x
    (0, 4, 5, 1),  # z=0, normal -z
    (3, 2, 6, 7),  # z=1, normal +z
)

_EDGE_OF = {}
for _e, (_a, _b) in enumerate(EDGE_CORNERS):
    _EDGE_OF[(int(_a), int(_b))] = _e
    _EDGE_OF[(int(_b), int(_a))] = _e


def _face_segments(inside):
    """Directed segments (edge_in -> edge_out) on all faces for one config."""
    segs = []
    for face in _FACES:
        n = len(face)
        ins = [inside[c] for c in face]
        if not any(ins) or all(ins):
            continue
        for k in range(n):
            a, b = face[k], face[(k + 1) % n]
            if not inside[a] and inside[b]:
                # entry into an inside-run at edge (a,b); walk to its end
                e_in = _EDGE_OF[(a, b)]
                m = (k + 1) % n
                while inside[face[(m + 1) % n]]:
                    m = (m + 1) % n
                c, d = face[m], face[(m + 1) % n]
                e_out = _EDGE_OF[(c, d)]
                segs.append((e_in, e_out))
    return segs


def _build_case(code):
    """Triangle list (flat edge indices) for one of the 256 sign configs."""
    inside = [(code >> i) & 1 == 1 for i in range(8)]
    segs = _face_segments(inside)
    succ = {}
    for e_in, e_out in segs:
        assert e_in not in succ, "crossed edge with out-degree > 1"
        succ[e_in] = e_out
    tris = []
    visited = set()
    for start in list(succ):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        nxt = succ[start]
        while nxt != start:
            loop.append(nxt)
            visited.add(nxt)
            nxt = succ[nxt]
        for k in range(1, len(loop) - 1):
            tris.extend((loop[0], loop[k], loop[k + 1]))
    return tris


def build_tables():
    """Returns (edge_table[256] uint16, tri_table[256, MAX*3] int8 -1-padded,
    tri_count[256] int32)."""
    all_tris = [_build_case(code) for code in range(256)]
    max_entries = max(len(t) for t in all_tris)
    tri_table = np.full((256, max_entries), -1, dtype=np.int8)
    tri_count = np.zeros(256, dtype=np.int32)
    edge_table = np.zeros(256, dtype=np.uint16)
    for code, tris in enumerate(all_tris):
        tri_table[code, :len(tris)] = tris
        tri_count[code] = len(tris) // 3
        for e in tris:
            edge_table[code] |= 1 << int(e)
    return edge_table, tri_table, tri_count


EDGE_TABLE, TRI_TABLE, TRI_COUNT = build_tables()
MAX_TRIS_PER_CUBE = int(TRI_COUNT.max())
