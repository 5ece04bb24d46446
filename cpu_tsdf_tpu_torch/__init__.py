"""cpu_tsdf_tpu_torch: the PyTorch / CUDA port of cpu_tsdf_tpu for NVIDIA
Hopper cards.

Projective depth fusion into a truncated signed distance field, dense or in
a brick-sparse volume, raycast rendering (differentiable in depth), field
queries, marching-cubes extraction to PLY, npz and .vol checkpoints, and the
reference's three CLI programs (``cli``), in PyTorch, with the hot
paths in CUDA kernels written for sm_90a (``csrc/``). Entry points allocate
on the CUDA device unless the caller passes ``device="cpu"``; functions run
on the device of the tensors they get. On CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

This package imports neither jax nor cpu_tsdf_tpu.
"""

from .config import TSDFConfig, snap_resolution_pow2  # noqa: F401
from .volume import TSDFVolume, make_volume, reset  # noqa: F401
from .ops.fusion import integrate  # noqa: F401
from .ops.raycast import RenderResult, render_view  # noqa: F401
from .ops import interpolate  # noqa: F401
from .bricks import (  # noqa: F401
    BrickVolume,
    PackedRenderVolume,
    from_dense,
    integrate_bricks,
    make_brick_volume,
    pack_render,
    to_dense,
)
from .io.checkpoint import load_any, load_checkpoint, save_checkpoint  # noqa: F401
from .io.vol import load_vol, save_vol  # noqa: F401

__version__ = "0.1.0"
