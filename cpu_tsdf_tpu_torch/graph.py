"""CUDA graphs of a frame and of a render: the port's counterparts of the
JAX package's compiled programs.

The JAX package runs a frame as one jitted program with the volume donated
(``cpu_tsdf_tpu/bricks.py::_integrate_bricks_jit``), a trajectory as one
``lax.scan`` program (``_integrate_bricks_seq_jit``) and a render as one
jitted program (``cpu_tsdf_tpu/ops/raycast.py::_render_view_jit``). Here
a frame (``bricks.fuse_frame``) and a render (``ops.raycast._render``) are
programs of fixed shapes with no host sync (``tests/test_torch_graph.py``
records their ops), so on the card each is captured once into a
``torch.cuda.CUDAGraph`` and replayed: the hand-written kernels and their
glue run with no per-op host dispatch.

* **Static inputs.** A graph reads its depth, pose and rgb (a render: its
  pose) from buffers of its own; a call copies its inputs into them on the
  device and replays. A graph addresses the volume's state tensors
  directly: every state update of the frame is in place.
* **Warm-up and capture.** The first call of a graph runs the program
  eagerly on a side stream (the real frame or render: it loads the
  kernel libraries and the stream's cuBLAS workspace, neither of which may
  happen during a capture), then captures it on that stream.
* **Cache.** Graphs are kept by the device, the address, shape and type of
  every state tensor of the volume, the config, the brick size, the input
  shapes, the budget, color, the kernel route and the split generator; a
  changed key (a new or reloaded volume, other settings) captures anew.
  At most :data:`MAX_GRAPHS` are kept, the least recently used dropped.
* **Random draws.** With ``num_random_splits > 1`` the jitter draws from a
  generator registered with the graph, so each replay draws where the
  generator stands, as an eager draw would. Without a split generator a
  graph has its own, seeded 0 before every single frame (the JAX package's
  ``PRNGKey(0)`` each frame) and once before a sequence (fresh jitter each
  frame).
* **Launch counts.** The kernels a capture records are counted at every
  replay in the wrappers' counters (``fusion_kernel.launches``,
  ``raycast_kernel.launches``); the capture itself launches nothing.

A capture or replay that fails raises: nothing falls back to the eager
route. Out of the graphs: ``extract_mesh`` (its exact budgets need two host
syncs), the sharded paths (gloo collectives through the host), the render
under autograd, ``refine`` and ``pipeline.organize_cloud``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import torch

# Graphs kept at once (each holds a private memory pool).
MAX_GRAPHS = 8

_cache: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_streams = {}


def resolve_graph(graph: Optional[bool], device: torch.device) -> bool:
    """The route an entry point takes on tensors of `device`: None -> the
    CUDA graph on the card and eager on the CPU; True on the CPU raises."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("graph=True needs tensors on a CUDA device")
    return bool(graph)


def _counters():
    from .ops import fusion_kernel, raycast_kernel

    return (fusion_kernel.launches, raycast_kernel.launches)


def state_key(vol) -> tuple:
    """The volume's type, config and sizes, and the address, shape, stride
    and dtype of each of its state tensors: what a graph of it depends on."""
    tensors = tuple((f.name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                    for f in dataclasses.fields(vol)
                    if isinstance(t := getattr(vol, f.name), torch.Tensor))
    return (type(vol).__name__, vol.config, getattr(vol, "brick_size", 0),
            getattr(vol, "capacity", 0), tensors)


def _side_stream(device) -> torch.cuda.Stream:
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


class _Captured:
    """`program` warmed up and captured: ``warm`` is the warm-up's result,
    ``out`` the graph's static outputs. Records the capture's wall ms, the
    bytes of its private memory pool (device memory reserved by the
    capture) and the kernel launches of one replay."""

    def __init__(self, device, program, generator: Optional[torch.Generator] = None):
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.warm = program()
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        reserved = torch.cuda.memory_reserved(device)
        before = [dict(c) for c in _counters()]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # capture_begin/end, not the torch.cuda.graph context: that one
        # empties the allocator's cache, and every later allocation of the
        # process would wait on cudaMalloc again
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin()
                try:
                    self.out = program()
                finally:
                    self.graph.capture_end()
        finally:
            # the capture launched nothing: the wrappers' counts go back
            self.launches = [{k: c[k] - b[k] for k in c} for c, b in zip(_counters(), before)]
            for c, b in zip(_counters(), before):
                c.update(b)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        for c, n in zip(_counters(), self.launches):
            for k, v in n.items():
                c[k] += v


def _lookup(key):
    entry = _cache.get(key)
    if entry is not None:
        _cache.move_to_end(key)
    return entry


def _keep(key, entry) -> None:
    _cache[key] = entry
    while len(_cache) > MAX_GRAPHS:
        _cache.popitem(last=False)


def clear() -> None:
    """Drop every graph (their memory pools go with them)."""
    _cache.clear()


def stats() -> list:
    """Each kept graph's kind, capture ms, pool MB and launches a replay,
    least recently used first."""
    return [dict(kind=key[0], capture_ms=e.captured.capture_ms,
                 pool_mb=e.captured.pool_bytes / 2 ** 20,
                 launches={k: v for n in e.captured.launches for k, v in n.items() if v})
            for key, e in _cache.items()]


class _FrameGraph:
    """The graph of ``bricks.fuse_frame`` on one volume, with its static
    inputs. Built by the first frame, which runs as its warm-up."""

    def __init__(self, vol, depth, pose, rgb, update_budget, kernel, split_generator):
        from .bricks import fuse_frame

        dev = vol.device
        self.depth = torch.empty(depth.shape, dtype=torch.float32, device=dev)
        self.pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
        self.rgb = None if rgb is None else torch.empty(rgb.shape, dtype=torch.float32,
                                                        device=dev)
        jitter = vol.config.num_random_splits > 1
        self.own_generator = None
        if jitter and split_generator is None:
            split_generator = self.own_generator = torch.Generator(device=dev).manual_seed(0)
        self._inputs(depth, pose, rgb)
        self.captured = _Captured(
            dev, lambda: fuse_frame(vol, self.depth, self.pose, self.rgb, update_budget,
                                    kernel, split_generator),
            split_generator if jitter else None)

    def _inputs(self, depth, pose, rgb) -> None:
        self.depth.copy_(depth)
        self.pose.copy_(pose)
        if self.rgb is not None:
            self.rgb.copy_(rgb)

    def run(self, depth, pose, rgb, reseed: bool) -> None:
        self._inputs(depth, pose, rgb)
        if self.own_generator is not None and reseed:
            self.own_generator.manual_seed(0)
        self.captured.replay()


def integrate_graphed(vol, depth, pose, rgb, update_budget: int, kernel: bool,
                      split_generator: Optional[torch.Generator], reseed: bool = True) -> None:
    """One frame of ``bricks.integrate_bricks`` through its graph, in place
    (the first frame of a key captures the graph and runs as its warm-up).
    reseed: seed the graph's own split generator 0 before this frame."""
    dev = vol.device
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    if vol.color is None:
        rgb = None
    if rgb is not None:
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    jitter = vol.config.num_random_splits > 1
    key = ("frame", dev, state_key(vol), tuple(depth.shape),
           None if rgb is None else tuple(rgb.shape), update_budget, kernel,
           split_generator if jitter else None)
    entry = _lookup(key)
    if entry is None:
        _keep(key, _FrameGraph(vol, depth, pose, rgb, update_budget, kernel, split_generator))
    else:
        entry.run(depth, pose, rgb, reseed)


class _RenderGraph:
    """The graph of ``ops.raycast._render`` of one volume, with its static
    pose. Built by the first render, which runs as its warm-up."""

    def __init__(self, vol, pose, downsample_by, max_steps, colored, kernel):
        from .ops.raycast import _render

        self.pose = pose.clone()
        self.captured = _Captured(vol.device, lambda: _render(
            vol, self.pose, downsample_by, max_steps, colored, kernel))

    def run(self, pose):
        self.pose.copy_(pose)
        self.captured.replay()
        return self.captured.out


def render_graphed(vol, pose, downsample_by: int, max_steps: int, colored: bool,
                   kernel: bool):
    """``ops.raycast.render_view`` through its graph: a RenderResult of
    fresh tensors (the graph's outputs are overwritten by its next
    replay)."""
    from .ops.raycast import fresh_result

    key = ("render", vol.device, state_key(vol), downsample_by, max_steps, colored, kernel)
    entry = _lookup(key)
    if entry is None:
        entry = _RenderGraph(vol, pose, downsample_by, max_steps, colored, kernel)
        _keep(key, entry)
        out, entry.captured.warm = entry.captured.warm, None
        return fresh_result(out)
    return fresh_result(entry.run(pose))
