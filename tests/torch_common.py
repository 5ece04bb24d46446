"""Shared by the port's tests (tests/test_torch_*.py), each of which imports
this module, so that a file runs alike alone and in the whole suite.

One torch intra-op thread. The suite runs in several worker processes that
share the machine's cores; with torch's default of one thread a core, each
worker's small CPU ops wait on threads that the other workers' work keeps
off the cores (in a six-worker run a test of a few milliseconds alone took
seconds). Results do not depend on the count. Processes that the port's
tests start (the no-JAX script, the gloo ranks) choose their own.

The cases of the dense kernel's column cull, without JAX: the CPU tests
hold the cull's plain version (fusion_kernel.dense_column_intervals)
against the plain fusion, the card tests hold the kernel against both.
"""

import numpy as np
import torch

from cpu_tsdf_tpu_torch.config import TSDFConfig
from cpu_tsdf_tpu_torch.synthetic import orbit_pose, sphere_depth_world

torch.set_num_threads(1)


def tilted_pose(tx=0.013, ty=0.021, tz=-0.9):
    """The slightly rotated camera of the JAX package's fusion tests
    (tests/test_fusion.py::tilted_pose), whose module imports JAX."""
    ax, ay = 0.03, -0.02
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    m = np.eye(4)
    m[:3, :3] = Ry @ Rx
    m[:3, 3] = (tx, ty, tz)
    return m


# The JAX tests' small_cfg (tests/conftest.py) at 48^3: a 1.6 m grid, a
# 40x30 image, a 6 cm band.
CULL_CFG = TSDFConfig(xres=48, yres=48, zres=48, xsize=1.6, ysize=1.6, zsize=1.6,
                      max_dist_pos=0.06, max_dist_neg=0.06, min_sensor_dist=0.1,
                      max_sensor_dist=3.0, image_width=40, image_height=30,
                      focal_length_x=35.0, focal_length_y=35.0, principal_point_x=20.0,
                      principal_point_y=15.0, max_cell_size_x=0.4, max_cell_size_y=0.4,
                      max_cell_size_z=0.4)

_AXIS_X = np.array([[0, 0, 1, -1.2], [1, 0, 0, 0.05], [0, 1, 0, 0.02], [0, 0, 0, 1]],
                   np.float32)   # looking along +x; camera x, y = volume y, z
_AXIS_Z = np.array([[1, 0, 0, 0.03], [0, 1, 0, -0.02], [0, 0, 1, -1.1], [0, 0, 0, 1]],
                   np.float32)   # looking along +z

# (pose, first x-plane and planes of the slab, depth edit, config options):
# a tilted view, a camera outside the volume, two axis-aligned views
# (columns parallel to the image plane: b_z = 0; and along the optical
# axis), a slab of planes [16, 40), an all-NaN frame, a frame with a +inf
# reading (no far limit), and a sensor range from 0.
CULL_CASES = {
    "tilted": (tilted_pose(), 0, 48, None, {}),
    "outside": (orbit_pose(0.7, orbit_radius=2.5), 0, 48, None, {}),
    "axis_x": (_AXIS_X, 0, 48, None, {}),
    "axis_z": (_AXIS_Z, 0, 48, None, {}),
    "slab_x0_16": (tilted_pose(), 16, 24, None, {}),
    "all_nan": (tilted_pose(), 0, 48, "nan", {}),
    "inf_reading": (tilted_pose(), 0, 48, "inf", {}),
    "min_sensor_dist_0": (tilted_pose(), 0, 48, None, {"min_sensor_dist": 0.0}),
}


def cull_frame(case):
    """(cfg, pose [4, 4] float32, depth [H, W] float32, x0, nx) of a cull
    case: the sphere of radius 0.5 m seen from the case's pose."""
    pose, x0, nx, edit, options = CULL_CASES[case]
    cfg = CULL_CFG.with_updates(**options)
    depth = sphere_depth_world(cfg, pose, radius=0.5).astype(np.float32)
    if edit == "nan":
        depth = np.full_like(depth, np.nan)
    elif edit == "inf":
        depth[cfg.image_height // 2, cfg.image_width // 3] = np.inf
    return cfg, pose.astype(np.float32), depth, x0, nx


# Brick activation's cases, without JAX: the CPU tests check with the plain
# code that each case takes the path its name gives, the card tests hold
# csrc/activation.cu's kernels to the plain code on every frame of each.
# The grid of tests/test_torch_kernels.py: 128^3 over 1.6 m, 160x120.
ACT_CFG = TSDFConfig(xres=128, yres=128, zres=128, xsize=1.6, ysize=1.6, zsize=1.6,
                     max_dist_pos=0.04, max_dist_neg=0.04, min_sensor_dist=0.1,
                     image_width=160, image_height=120, focal_length_x=140.0,
                     focal_length_y=140.0, principal_point_x=80.0, principal_point_y=60.0)

_ORBIT = [orbit_pose(a) for a in (0.0, 0.5, 1.0)]

# name -> (brick size, the frames' poses, depth edit, update budget, tile
# budget, capacity): the orbit at bricks of 4, 8, 16 and 32 (budgets and
# capacities of tests/test_torch_kernels.py::_sizes); a tilted camera; 5 %
# NaN dropouts; a camera inside the volume 0.12 m from the sphere (spheres
# straddle the camera plane: the cone and whole-image test); budgets small
# enough that the tile budget, U2 (twice the update budget) and the update
# budget each overflow alone (the last at bricks of 32, where more than
# half the rough bricks are tight); a frame whose depth lies past the
# volume after one of the sphere, so that more live bricks than the carve
# budget lie in front.
ACTIVATION_CASES = {
    "orbit_b4": (4, _ORBIT, None, 16384, 1024, 32769),
    "orbit_b8": (8, _ORBIT, None, 2048, 1024, 4096),
    "orbit_b16": (16, _ORBIT, None, 256, 1024, 513),
    "orbit_b32": (32, _ORBIT, None, 64, 1024, 65),
    "tilted": (8, [tilted_pose()], None, 2048, 1024, 4096),
    "dropouts": (8, _ORBIT, "dropouts", 2048, 1024, 4096),
    "inside": (8, [orbit_pose(0.3, orbit_radius=0.62)], None, 2048, 1024, 4096),
    "tile_budget": (8, _ORBIT[:1], None, 2048, 12, 4096),
    "rough_budget": (8, _ORBIT[:1], None, 64, 1024, 4096),
    "update_budget": (32, _ORBIT[1:2], None, 32, 1024, 65),
    "carve_budget": (4, [_ORBIT[0], _ORBIT[0]], "far", 4096, 1024, 32769),
}


def activation_case(case):
    """(cfg, B, [(pose, depth)] float32, update budget, tile budget,
    capacity) of an activation case: the sphere of radius 0.5 m at the
    origin seen from each pose."""
    B, poses, edit, budget, tile_budget, capacity = ACTIVATION_CASES[case]
    rng = np.random.default_rng(7)
    frames = []
    for i, pose in enumerate(poses):
        depth = sphere_depth_world(ACT_CFG, pose, radius=0.5)
        if edit == "dropouts":
            depth = np.where(rng.uniform(size=depth.shape) < 0.05, np.nan, depth)
        elif edit == "far" and i > 0:
            depth = np.full_like(depth, 2.5)
        frames.append((np.asarray(pose, np.float32), depth.astype(np.float32)))
    return ACT_CFG, B, frames, budget, tile_budget, capacity
