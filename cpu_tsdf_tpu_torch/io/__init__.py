"""File formats of the port: PLY, PCD, pose files, PNG dumps, native npz
checkpoints and the reference's .vol codec (a mirror of ``cpu_tsdf_tpu.io``)."""

from . import checkpoint, image, pcd, ply, poses, vol  # noqa: F401
from .checkpoint import load_any, load_checkpoint, save_checkpoint  # noqa: F401
