"""TSDF volume configuration.

One frozen dataclass replaces the ~20 setter/getter knobs of the reference volume
(``cpu_tsdf/include/cpu_tsdf/tsdf_volume_octree.h:60-296``) plus the octree's
voxel-type string factory (``cpu_tsdf/src/lib/octree.cpp:192-206``).

Defaults mirror the reference constructor
(``cpu_tsdf/src/lib/tsdf_volume_octree.cpp:54-85``) exactly so that parity
tests share a working point.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple

# Reference: UNOBSERVED_VOXEL = NaN (cpu_tsdf/src/lib/tsdf_volume_octree.cpp:75)
UNOBSERVED_VOXEL = float("nan")

COLOR_MODE_NONE = "NOCOLOR"
COLOR_MODE_RGB = "RGB"
COLOR_MODE_RGB_NORMALIZED = "RGBNormalized"
COLOR_MODE_LAB = "LAB"
_COLOR_MODES = (COLOR_MODE_NONE, COLOR_MODE_RGB, COLOR_MODE_RGB_NORMALIZED, COLOR_MODE_LAB)


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Static configuration of a TSDF volume (hashable; usable as a jit static arg)."""

    # Grid resolution (voxels per axis). Reference default 512^3.
    xres: int = 512
    yres: int = 512
    zres: int = 512
    # Physical extent in meters, centered on the origin. Reference default 3 m^3.
    xsize: float = 3.0
    ysize: float = 3.0
    zsize: float = 3.0
    # Truncation band: +max_dist_pos in front of the surface, -max_dist_neg behind.
    max_dist_pos: float = 0.03
    max_dist_neg: float = 0.03
    # Weight saturation limit (applied after averaging, octree.cpp:156-159).
    max_weight: float = 100.0
    # Sensor depth-of-field bounds.
    min_sensor_dist: float = 0.3
    max_sensor_dist: float = 3.0
    # Pinhole intrinsics + image geometry.
    focal_length_x: float = 525.0
    focal_length_y: float = 525.0
    principal_point_x: float = 320.0
    principal_point_y: float = 240.0
    image_width: int = 640
    image_height: int = 480
    # Coarsest cell size the reference octree kept in free space; here it only
    # controls .vol export granularity and brick activation conservatism.
    max_cell_size_x: float = 0.5
    max_cell_size_y: float = 0.5
    max_cell_size_z: float = 0.5
    # Weighting options (impl/tsdf_volume_octree.hpp:200-204).
    weight_by_depth: bool = False
    weight_by_variance: bool = False
    # Color fusion (octree.cpp:328-581). color_mode selects the accumulation
    # transform; integrate_color gates it.
    integrate_color: bool = False
    color_mode: str = COLOR_MODE_RGB
    # Rendering interpolation toggle (tsdf_volume_octree.cpp:462).
    use_trilinear_interpolation: bool = True
    # Jittered pre-split sampling (hpp:69-75). PRNG-keyed here, default off (=1).
    num_random_splits: int = 1
    # Replicate the reference's coarse-cell frustum culling
    # (tsdf_volume_octree.cpp:619-652): voxels inside a max_cell-sized block
    # whose CENTER falls outside the 1.1x-FOV frustum are skipped even when
    # they project into the image. Default True for parity; disable to
    # integrate everything the camera actually sees.
    frustum_culling: bool = True

    def __post_init__(self):
        if self.color_mode not in _COLOR_MODES:
            raise ValueError(f"invalid color mode {self.color_mode!r}; want one of {_COLOR_MODES}")
        for r in (self.xres, self.yres, self.zres):
            if r <= 0:
                raise ValueError("resolution must be positive")

    # ---- derived quantities ----

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return (self.xres, self.yres, self.zres)

    @property
    def grid_size(self) -> Tuple[float, float, float]:
        return (self.xsize, self.ysize, self.zsize)

    @property
    def cell_size(self) -> Tuple[float, float, float]:
        return (self.xsize / self.xres, self.ysize / self.yres, self.zsize / self.zres)

    @property
    def num_coarse_levels(self) -> int:
        """Initial uniform subdivision depth (octree.cpp:594-599)."""
        desired = max(
            self.xsize / self.max_cell_size_x,
            self.ysize / self.max_cell_size_y,
            self.zsize / self.max_cell_size_z,
        )
        # volumes smaller than max_cell_size degrade to a root-only coarse
        # grid (the reference's int-truncated log(0) path ends up skipping
        # the recursive split); math.log(0) would raise here
        if int(desired) <= 1:
            return 0
        return int(math.ceil(math.log(int(desired)) / math.log(2)))

    @property
    def num_levels(self) -> int:
        """Total octree depth to the finest cell (root -> xres leaves)."""
        return int(round(math.log2(max(self.xres, self.yres, self.zres))))

    def with_updates(self, **kw) -> "TSDFConfig":
        return dataclasses.replace(self, **kw)

    # ---- (de)serialization ----

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TSDFConfig":
        return cls(**json.loads(s))


def snap_resolution_pow2(volume_size: float, cell_size: float) -> int:
    """Snap (volume/cell) UP to the next power of two.

    Mirrors the CLI behavior at cpu_tsdf/src/prog/integrate.cpp:486-494.
    """
    desired = int(volume_size / cell_size)
    n = 1
    while desired > n:
        n *= 2
    return n
