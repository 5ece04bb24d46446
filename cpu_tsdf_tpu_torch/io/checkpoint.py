"""Native checkpoint format: config JSON + the volume's arrays in one .npz.

Port of ``cpu_tsdf_tpu.io.checkpoint``, in the JAX package's layout, so a
checkpoint written by either package loads in the other: a brick volume's
sdf/weight/M/nsample rows are stored ``[C, 4, B^3/4]`` and its color
``[C, B, B, B, nc]`` (``convert`` moves between that and this port's
``[C, B^3]`` rows); a dense volume's arrays are stored as they are. The
``__meta__`` entry is a JSON object: format version, config, volume kind
(with brick size and capacity for a brick volume) and any extra keys, such
as the CLI's resume cursor ``next_frame``. The reference's ``.vol`` octree
stream is :mod:`.vol`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..bricks import BrickVolume
from ..config import TSDFConfig
from ..convert import (brick_volume_from_arrays, brick_volume_to_arrays,
                       tsdf_volume_from_arrays, tsdf_volume_to_arrays)
from ..volume import TSDFVolume, resolve_device

FORMAT_VERSION = 1


def save_checkpoint(path: str, vol, extra_meta: dict | None = None) -> None:
    """Save a dense TSDFVolume or a BrickVolume (kind recorded), copying its
    tensors to the host.

    The write is crash-atomic: the arrays go to a temp file in the same
    directory, then `os.replace` installs it, so a crash mid-write leaves
    the previous checkpoint intact. `extra_meta` is stored in the npz
    itself, so it can never disagree with the arrays."""
    brick = isinstance(vol, BrickVolume)
    a = brick_volume_to_arrays(vol) if brick else tsdf_volume_to_arrays(vol)
    names = ["sdf", "weight", "M", "nsample", "global_transform"]
    if a["color"] is not None:
        names.append("color")
    meta = dict(version=FORMAT_VERSION, config=json.loads(vol.config.to_json()))
    if extra_meta:
        meta.update(extra_meta)
    if brick:
        meta.update(kind="brick", brick_size=vol.brick_size, capacity=vol.capacity)
        names += ["brick_map", "coords", "n_active", "overflowed"]
    else:
        meta.update(kind="dense")
    tmp = path + ".tmp.npz"
    try:
        np.savez_compressed(tmp, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **{n: a[n] for n in names})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def checkpoint_meta(path: str) -> dict:
    """Read only the embedded metadata of a native checkpoint."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def load_checkpoint(path: str, *, device=None):
    """A native checkpoint as a TSDFVolume or BrickVolume on ``device``
    (default CUDA)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    cfg = TSDFConfig(**meta["config"])
    if meta.get("kind") == "brick":
        vol = brick_volume_from_arrays(cfg, arrays, device)
        if (vol.brick_size, vol.capacity) != (meta["brick_size"], meta["capacity"]):
            raise ValueError(f"{path}: arrays of {vol.capacity} bricks of "
                             f"{vol.brick_size}^3 do not match the metadata")
        return vol
    return tsdf_volume_from_arrays(cfg, arrays, device)


def load_any(path: str, *, device=None):
    """Factory dispatch on file contents, the TSDFInterface::instantiateFromFile
    analog (cpu_tsdf/src/lib/tsdf_interface.cpp:44-51): a native .npz
    checkpoint (zip magic ``PK``) loads as it was saved, a reference .vol
    file as a dense TSDFVolume. Tensors go to ``device`` (default CUDA)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"PK":
        return load_checkpoint(path, device=device)
    from .vol import load_vol

    dev = resolve_device(device)
    cfg, arrays, transform = load_vol(path)
    color = None
    if "color" in arrays:
        color = torch.as_tensor(arrays["color"], device=dev)
    else:
        cfg = cfg.with_updates(integrate_color=False)
    return TSDFVolume(
        sdf=torch.as_tensor(arrays["sdf"], device=dev),
        weight=torch.as_tensor(arrays["weight"], device=dev),
        M=torch.as_tensor(arrays["M"], device=dev),
        nsample=torch.as_tensor(arrays["nsample"], device=dev),
        color=color,
        global_transform=torch.as_tensor(transform, dtype=torch.float32, device=dev),
        config=cfg,
    )
