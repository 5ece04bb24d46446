"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, at first use, under ``build/torch_kernels/`` at the
root of the checkout. The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
The libraries are loaded with ``ctypes``: nothing here includes PyTorch's
headers, so one source builds in seconds.

Kernels run only on an sm_90a card (H100/H200). Nothing in this module runs
when the package is imported: the CPU test suite imports every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("fusion", "mc_corner_halo", "mc_emit", "raycast", "trace")

# --fmad=false: the fusion, ray-march and MC emission kernels must
# reproduce their plain versions' float32 rounding op for op (a contracted
# FMA in the projection moves a voxel onto the next depth pixel, see
# csrc/fusion.cu; in the march it moves a sample onto the next voxel, see
# csrc/raycast.cu; in the emission it moves a vertex by an ulp, see
# csrc/mc_emit.cu). No --use_fast_math anywhere.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one nvcc each, all
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) for a built kernel."""
    p = _target(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(name: str, symbol: str, argtypes):
    """The C launch function ``symbol`` of ``csrc/<name>.cu``, with its
    argument types declared (every launch function returns the CUDA error
    code of its launch as an int)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_tensor(what: str, t, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape on this
    device: the kernels read raw pointers."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {tuple(shape)} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stream_ptr(device) -> int:
    """The current CUDA stream of the device, as the launch functions take it."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
