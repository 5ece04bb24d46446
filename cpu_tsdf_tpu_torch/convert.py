"""Carry volume state between the JAX package and this port as numpy arrays.

The arrays use the JAX package's field names and layouts: a brick volume's
sdf/weight/M/nsample rows are vreg-tiled ``[C, 4, B^3/4]`` there (``[1, B^3]``
when B^3 is not a multiple of 4) and its color ``[C, B, B, B, nc]``; this
port keeps plain ``[C, B^3]`` rows and ``[C, B^3, nc]`` color, in the same
voxel order. A config crosses as ``TSDFConfig.from_json(other.to_json())``.
Nothing here imports jax: the caller turns the other package's arrays into
numpy (``np.asarray``) and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .bricks import BrickVolume
from .config import TSDFConfig
from .volume import TSDFVolume, resolve_device

BRICK_FIELDS = ("brick_map", "n_active", "coords", "sdf", "weight", "M",
                "nsample", "color", "global_transform", "overflowed")
DENSE_FIELDS = ("sdf", "weight", "M", "nsample", "color", "global_transform")


def soa_inner(brick_size: int) -> tuple:
    """Inner dims of the JAX package's tiled brick rows: [4, V/4] when the
    brick volume divides into 4, else [1, V]."""
    nv = brick_size ** 3
    return (4, nv // 4) if nv % 4 == 0 else (1, nv)


def _tensor(a, device):
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def brick_volume_from_arrays(cfg: TSDFConfig, arrays: Dict[str, np.ndarray],
                             device=None) -> BrickVolume:
    """A BrickVolume on ``device`` (default CUDA) from arrays in the JAX
    package's layout."""
    dev = resolve_device(device)
    sdf = np.asarray(arrays["sdf"])
    C = sdf.shape[0]
    nv = int(np.prod(sdf.shape[1:]))
    B = round(nv ** (1 / 3))
    if B ** 3 != nv:
        raise ValueError(f"brick rows of {nv} voxels are not a cube")

    def rows(name):
        return _tensor(np.asarray(arrays[name]).reshape(C, nv), dev)

    color = arrays.get("color")
    if color is not None:
        color = np.asarray(color).reshape(C, nv, -1)
    return BrickVolume(
        brick_map=_tensor(arrays["brick_map"], dev),
        n_active=_tensor(np.asarray(arrays["n_active"], np.int32).reshape(()), dev),
        coords=_tensor(arrays["coords"], dev),
        sdf=rows("sdf"), weight=rows("weight"), M=rows("M"), nsample=rows("nsample"),
        color=_tensor(color, dev),
        global_transform=_tensor(arrays["global_transform"], dev),
        overflowed=_tensor(np.asarray(arrays["overflowed"], bool).reshape(()), dev),
        config=cfg, brick_size=B, capacity=C,
    )


def brick_volume_to_arrays(vol: BrickVolume) -> Dict[str, np.ndarray]:
    """The volume's arrays in the JAX package's layout (numpy, on the host)."""
    C, B = vol.capacity, vol.brick_size
    out = {}
    for name in BRICK_FIELDS:
        t = getattr(vol, name)
        a = None if t is None else t.detach().cpu().numpy()
        if name in ("sdf", "weight", "M", "nsample"):
            a = a.reshape((C,) + soa_inner(B))
        elif name == "color" and a is not None:
            a = a.reshape(C, B, B, B, -1)
        out[name] = a
    return out


def tsdf_volume_from_arrays(cfg: TSDFConfig, arrays: Dict[str, np.ndarray],
                            device=None) -> TSDFVolume:
    """A dense TSDFVolume on ``device`` (default CUDA); the layout is the
    same in both packages."""
    dev = resolve_device(device)
    return TSDFVolume(**{n: _tensor(arrays.get(n), dev) for n in DENSE_FIELDS},
                      config=cfg)


def tsdf_volume_to_arrays(vol: TSDFVolume) -> Dict[str, np.ndarray]:
    return {n: (None if getattr(vol, n) is None
                else getattr(vol, n).detach().cpu().numpy()) for n in DENSE_FIELDS}
