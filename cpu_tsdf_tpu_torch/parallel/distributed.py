"""The multi-process runtime of the sharded paths: ``torch.distributed``.

Port of ``cpu_tsdf_tpu.parallel.distributed``. The JAX package runs one
controller per host over a global device mesh. Here every rank is one
process that drives one device, and a rank holds only its own partition of
a sharded volume:

  * :func:`initialize` starts the process group once per process, from
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK or from its arguments;
  * the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
    package's dim names: ``shard`` (:data:`AXIS`, the slab dim) and ``dcn``
    (:data:`DCN_AXIS`, the replicated outer dim of :func:`make_hybrid_mesh`);
  * the collectives below stand for JAX's: ``pmax``/``pmin``/``psum`` are
    :func:`all_reduce` with MAX/MIN/SUM, ``ppermute`` of boundary planes and
    ``device_put`` to one device are :func:`all_gather`, on the group of the
    ``shard`` dim.

The backend follows one rule (:func:`backend_for`): NCCL where each rank
has a card of its own, gloo otherwise (CPU ranks, and ranks that share one
card: NCCL refuses two ranks on one GPU). Gloo takes CUDA tensors for only
some collectives, so every collective here hands gloo a host copy of a CUDA
tensor and copies the result back. The compute stays on the card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..volume import resolve_device

AXIS = "shard"
DCN_AXIS = "dcn"


def backend_for(device, ranks_per_host: int) -> str:
    """The process group's backend: "nccl" when the ranks run on CUDA and
    the host has a card for each of its ranks, else "gloo"."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               device=None) -> bool:
    """Start the process group of this rank (once; later calls are no-ops).

    coordinator_address ("host:port"), num_processes and process_id default
    to MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK. Without an address and
    a process count this is a single-process run and nothing starts
    (returns False); else returns True. There is no counterpart of the JAX
    package's TPU-pod auto-detection: a multi-process run names its
    coordinator. `device` is what the rank computes on (default CUDA);
    on CUDA, local_device_ids[0] (default: the rank modulo the card count)
    becomes the current card. LOCAL_WORLD_SIZE, where set, is the number of
    ranks on this host (else all of them) for :func:`backend_for`."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False  # a single-process run
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the "
                         "process count and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device_ids[0] if local_device_ids
                              else process_id % torch.cuda.device_count())
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dist.init_process_group(backend_for(dev, per_host),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_mesh(device=None):
    """1D mesh over every rank (the slab dim, :data:`AXIS`)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


def make_hybrid_mesh(ici_per_host: Optional[int] = None, device=None):
    """2D (dcn, shard) mesh: the slab dim runs over the ranks of one host,
    the outer dim across hosts, ranks in order (rank = dcn * shard_size +
    shard). ici_per_host defaults to LOCAL_WORLD_SIZE, else every rank (one
    host: a [1, world] mesh). A volume sharded on the inner dim is
    replicated across the outer one."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if ici_per_host is None:
        ici_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % ici_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {ici_per_host}")
    return init_device_mesh(resolve_device(device).type, (world // ici_per_host, ici_per_host),
                            mesh_dim_names=(DCN_AXIS, AXIS))


def _dim_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def shard_info(mesh):
    """(this rank's coordinate on the slab dim, the slab count, the dim's
    process group)."""
    return mesh.get_local_rank(AXIS), _dim_size(mesh, AXIS), mesh.get_group(AXIS)


# ---------------------------------------------------------------------------
# collectives (host copies for gloo on CUDA tensors)
# ---------------------------------------------------------------------------

def _host(t, group):
    """The tensor the backend of `group` works on: t itself, or a host copy
    when gloo meets a CUDA tensor; bool travels as uint8."""
    staged = t.is_cuda and dist.get_backend(group) != "nccl"
    h = t.cpu() if staged else t
    return h.to(torch.uint8) if h.dtype == torch.bool else h.contiguous()


def all_reduce(t, op, group):
    """All-reduce of t over `group` (dist.ReduceOp.MAX / MIN / SUM);
    returns the result on t's device (t is not modified)."""
    h = _host(t, group).clone()
    dist.all_reduce(h, op=op, group=group)
    return h.to(device=t.device, dtype=t.dtype)


def all_gather(t, group):
    """Every member's t (equal shapes), concatenated along dim 0 in group
    rank order, on t's device."""
    h = _host(t, group)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    return torch.cat(parts, 0).to(device=t.device, dtype=t.dtype)


def broadcast(t, src: int, group=None):
    """t of global rank `src` on every member of `group`, on t's device."""
    h = _host(t, group).clone()
    dist.broadcast(h, src, group=group)
    return h.to(device=t.device, dtype=t.dtype)


def replicate_to_mesh(x, mesh, *, device=None):
    """Host data as one tensor on every rank of the mesh: the value of the
    mesh's first rank, broadcast (every rank passes its own copy)."""
    t = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    return broadcast(t, int(mesh.mesh.flatten()[0]))


def shard_to_mesh(x, mesh, spec, *, device=None):
    """This rank's block of a GLOBAL host array that every rank passes
    whole. spec names, for each leading axis of x, the mesh dim it is split
    over, or None (a PartitionSpec as a tuple: (AXIS,) splits axis 0 over
    the slab dim)."""
    x = np.asarray(x)
    idx = []
    for axis, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        n, c = _dim_size(mesh, name), mesh.get_local_rank(name)
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of length {x.shape[axis]} does not split "
                             f"into {n} blocks")
        step = x.shape[axis] // n
        idx.append(slice(c * step, (c + 1) * step))
    return torch.as_tensor(np.ascontiguousarray(x[tuple(idx)]), device=resolve_device(device))
