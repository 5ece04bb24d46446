"""CUDA graphs of the port's fixed-shape programs: its counterparts of the
JAX package's compiled programs.

The JAX package runs a frame as one jitted program with the volume donated
(``cpu_tsdf_tpu/bricks.py::_integrate_bricks_jit``), a trajectory as one
``lax.scan`` program (``_integrate_bricks_seq_jit``), a render as one
jitted program (``cpu_tsdf_tpu/ops/raycast.py::_render_view_jit``), an
extraction as one jitted program a chunk, its start traced
(``cpu_tsdf_tpu/ops/marching_cubes.py::_extract_chunk_compact``; the brick
stats as a ``lax.scan``, ``_brick_stats_scan``), the
refine step and residual jitted (``cpu_tsdf_tpu/refine.py::
refine_pose_step``, ``_residual_jit``) and the reprojection of a cloud
jitted (``cpu_tsdf_tpu/pipeline.py::_organize_jit``). Here a frame
(``bricks.fuse_frame``), a render (``ops.raycast._render``), an unchecked
extraction (``ops.marching_cubes._extract_unchecked``), the checked
extraction's brick stats and chunk program of one chunk
(``_chunk_stats``, ``_extract_chunk``, the chunk's start on the device;
the caller reads a batch of chunks' counts in one host sync, as the JAX
package does), a refine step and
residual (``refine._step``, ``refine._residual``) and a reprojection
(``pipeline._organize``) are programs of fixed shapes with no host sync
(``tests/test_torch_graph.py`` records their ops), so on the card each is
captured once into a ``torch.cuda.CUDAGraph`` and replayed: the
hand-written kernels and their glue run with no per-op host dispatch.

* **Static inputs.** A graph reads its inputs (a frame's depth, pose and
  rgb; a render's pose; a refine step's pose, depth and step scale; a
  cloud's points and colors) from buffers of its own; a call copies its
  inputs into them on the device and replays. A graph addresses the
  volume's state tensors directly: every state update of the frame is in
  place.
* **Warm-up and capture.** The first call of a graph runs the program
  eagerly on a side stream (the real frame or render: it loads the
  kernel libraries and the stream's cuBLAS workspace, neither of which may
  happen during a capture), then captures it on that stream. A frame
  graph's warm-up, and with tracing on every graph's, runs on the
  caller's stream instead, and one small matrix product on the side
  stream gives cuBLAS that stream's workspace: on the H100 hosts measured
  (PERF.md) the warm-up's burst of launches on the side stream slows
  every graph replay on the caller's stream by ~0.26 us a node for the
  next 2-36 s, which a scan's frames would pay and the traced replays
  would read as stage time. Such a capture first empties the allocator's
  cache: otherwise the card tests' captures ran out of memory with the
  card full of the caller's cached blocks. The other graphs' warm-ups
  stay on the side stream and leave the cache as it is.
* **Cache.** Graphs are kept by the device, the address, shape and type of
  every state tensor of the volume, the config, the brick size, the input
  shapes and the program's settings (a frame's budget, color, kernel route
  and split generator; an extraction's chunks and budgets); a changed key
  (a new or reloaded volume, other settings) captures anew. Every key
  holds the tracing state (``tracing.enabled()``): a graph captured with
  its device stages' stamps is replayed only while tracing is on, one
  without them only while it is off. The checked
  extraction's graphs of a volume and settings share one key: the brick
  stats' graph and one chunk graph a budget triple, each replayed once a
  chunk, the chunk's start filled into a static device buffer (chunks of
  equal budgets share a graph).
  At most :data:`MAX_GRAPHS` keys are kept, the least recently used
  dropped; a checked extraction's key keeps at most
  :data:`MAX_CHECKED_GRAPHS` graphs, the least recently used chunk graph
  dropped (its brick stats' graph stays).
* **Random draws.** With ``num_random_splits > 1`` the jitter draws from a
  generator registered with the graph, so each replay draws where the
  generator stands, as an eager draw would. Without a split generator a
  graph has its own, seeded 0 before every single frame (the JAX package's
  ``PRNGKey(0)`` each frame) and once before a sequence (fresh jitter each
  frame).
* **Launch counts.** The kernels a capture records are counted at every
  replay in the wrappers' counters (``activation_kernel.launches``,
  ``fusion_kernel.launches``, ``raycast_kernel.launches``,
  ``marching_cubes.launches``); the capture
  itself launches nothing. The tracing counters :data:`counts` count
  captures, replays, lookups that found no graph (misses) and graphs
  dropped from the cache (evictions).
* **Spans.** A capture is the host span ``graph.capture`` (``capture_ms``
  is its duration); a frame's and a program's call through its graph open
  ``graph.lookup`` (the key and the cache), ``graph.inputs`` and
  ``graph.replay`` (``tracing``).

A capture or replay that fails raises: nothing falls back to the eager
route. Out of the graphs: the sharded paths (gloo collectives through the
host), the render under autograd and the dense integrate (one kernel
launch, ``ops.fusion_kernel.fuse_dense``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from . import tracing

# Keys kept at once (each graph holds a private memory pool, and keeps the
# tensors of its volume alive).
MAX_GRAPHS = 8
# Graphs a checked extraction's key keeps: its brick stats' and one a
# budget triple of its chunk programs (the hints of a 4^3 volume give more
# than ten triples, retries from small budgets more than fifteen).
MAX_CHECKED_GRAPHS = 32

_cache: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_streams = {}
counts = tracing.counters("graph", {"captures": 0, "replays": 0, "misses": 0, "evictions": 0})


def resolve_graph(graph: Optional[bool], device: torch.device) -> bool:
    """The route an entry point takes on tensors of `device`: None -> the
    CUDA graph on the card and eager on the CPU; True on the CPU raises."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("graph=True needs tensors on a CUDA device")
    return bool(graph)


def _counters():
    from .ops import activation_kernel, fusion_kernel, marching_cubes, raycast_kernel

    return (activation_kernel.launches, fusion_kernel.launches, raycast_kernel.launches,
            marching_cubes.launches)


def state_key(vol) -> tuple:
    """The volume's type, config and sizes, the address, shape, stride and
    dtype of each of its state tensors, and the tracing state: what a graph
    of it depends on."""
    tensors = tuple((f.name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                    for f in dataclasses.fields(vol)
                    if isinstance(t := getattr(vol, f.name), torch.Tensor))
    return (type(vol).__name__, vol.config, getattr(vol, "brick_size", 0),
            getattr(vol, "capacity", 0), tensors, tracing.enabled())


def _side_stream(device) -> torch.cuda.Stream:
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


class _Captured:
    """`program` warmed up and captured: ``warm`` is the warm-up's result,
    ``out`` the graph's static outputs; warm_here: warm up on the caller's
    stream (with tracing on, always). Records the capture's wall ms, the
    bytes of its private memory pool (device memory reserved by the
    capture) and the kernel launches of one replay."""

    def __init__(self, device, program, generator: Optional[torch.Generator] = None,
                 warm_here: bool = False):
        stream = _side_stream(device)
        warm_here = warm_here or tracing.enabled()
        if warm_here:
            self.warm = program()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            if warm_here:
                one = torch.ones((2, 2), device=device)
                one @ one                   # cuBLAS's workspace for this stream
            else:
                self.warm = program()
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        if warm_here:
            # a capture cannot hand cached blocks back to the card when its
            # pool needs memory; a warm-up on the side stream that runs short
            # hands them back itself, one on the caller's stream reuses that
            # stream's blocks and may leave the card full of them
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = [dict(c) for c in _counters()]
        with tracing.timed("graph.capture") as span:
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            # capture_begin/end, not the torch.cuda.graph context: that one
            # empties the allocator's cache, and every later allocation of
            # the process would wait on cudaMalloc again
            try:
                with torch.cuda.stream(stream):
                    self.graph.capture_begin()
                    try:
                        self.out = program()
                    finally:
                        self.graph.capture_end()
            finally:
                # the capture launched nothing: the wrappers' counts go back
                self.launches = [{k: c[k] - b[k] for k in c}
                                 for c, b in zip(_counters(), before)]
                for c, b in zip(_counters(), before):
                    c.update(b)
        counts["captures"] += 1
        self.capture_ms = span.ms
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        counts["replays"] += 1
        for c, n in zip(_counters(), self.launches):
            for k, v in n.items():
                c[k] += v


def _lookup(key):
    entry = _cache.get(key)
    if entry is None:
        counts["misses"] += 1
    else:
        _cache.move_to_end(key)
    return entry


def _keep(key, entry) -> None:
    _cache[key] = entry
    while len(_cache) > MAX_GRAPHS:
        _cache.popitem(last=False)
        counts["evictions"] += 1


def clear() -> None:
    """Drop every graph (their memory pools go with them)."""
    _cache.clear()


def stats() -> list:
    """Each kept graph's kind, capture ms, pool MB and launches a replay,
    least recently used first."""
    return [dict(kind=kind, capture_ms=c.capture_ms, pool_mb=c.pool_bytes / 2 ** 20,
                 launches={k: v for n in c.launches for k, v in n.items() if v})
            for key, e in _cache.items()
            for kind, c in (e.captures() if isinstance(e, _CheckedGraphs)
                            else [(key[0], e.captured)])]


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
            split_generator if jitter else None, warm_here=True)

    def _inputs(self, depth, pose, rgb) -> None:
        self.depth.copy_(depth)
        self.pose.copy_(pose)
        if self.rgb is not None:
            self.rgb.copy_(rgb)

    def run(self, depth, pose, rgb, reseed: bool) -> dict:
        with tracing.span("graph.inputs"):
            self._inputs(depth, pose, rgb)
            if self.own_generator is not None and reseed:
                self.own_generator.manual_seed(0)
        with tracing.span("graph.replay"):
            self.captured.replay()
        return self.captured.out


def integrate_graphed(vol, depth, pose, rgb, update_budget: int, kernel: bool,
                      split_generator: Optional[torch.Generator], reseed: bool = True) -> dict:
    """One frame of ``bricks.integrate_bricks`` through its graph, in place
    (the first frame of a key captures the graph and runs as its warm-up).
    reseed: seed the graph's own split generator 0 before this frame.
    Returns the frame's limits (``bricks.fuse_frame``), the graph's outputs,
    which its next replay overwrites. The host span ``frame``."""
    with tracing.span("frame"):
        dev = vol.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        if vol.color is None:
            rgb = None
        if rgb is not None:
            rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
        jitter = vol.config.num_random_splits > 1
        with tracing.span("graph.lookup"):
            key = ("frame", dev, state_key(vol), tuple(depth.shape),
                   None if rgb is None else tuple(rgb.shape), update_budget, kernel,
                   split_generator if jitter else None)
            entry = _lookup(key)
        if entry is None:
            entry = _FrameGraph(vol, depth, pose, rgb, update_budget, kernel, split_generator)
            _keep(key, entry)
            out, entry.captured.warm = entry.captured.warm, None
            return out
        return entry.run(depth, pose, rgb, reseed)


class _ProgramGraph:
    """The graph of ``program(*inputs)`` with its static input buffers
    (copies of the first call's inputs). Built by the first call, which
    runs as its warm-up."""

    def __init__(self, device, program, inputs):
        self.inputs = [t.clone() for t in inputs]
        self.captured = _Captured(device, lambda: program(*self.inputs))

    def run(self, inputs):
        with tracing.span("graph.inputs"):
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
        with tracing.span("graph.replay"):
            self.captured.replay()
        return self.captured.out


def _run_graphed(make_key, device, program, inputs):
    """program(*inputs) through the graph kept under the key ``make_key()``
    builds (in the span ``graph.lookup``): the first call of a key captures
    it and returns its warm-up's result; a later call copies `inputs` into
    the static buffers and replays, and returns the graph's outputs, which
    its next replay overwrites."""
    with tracing.span("graph.lookup"):
        key = make_key()
        entry = _lookup(key)
    if entry is None:
        entry = _ProgramGraph(device, program, inputs)
        _keep(key, entry)
        out, entry.captured.warm = entry.captured.warm, None
        return out
    return entry.run(inputs)


def render_graphed(vol, pose, downsample_by: int, max_steps: int, colored: bool,
                   kernel: bool):
    """``ops.raycast.render_view`` through its graph: a RenderResult of
    fresh tensors."""
    from .ops.raycast import _render, fresh_result

    out = _run_graphed(lambda: ("render", vol.device, state_key(vol), downsample_by,
                                max_steps, colored, kernel),
                       vol.device, lambda p: _render(vol, p, downsample_by, max_steps,
                                                     colored, kernel), [pose])
    with tracing.span("render.fresh_result"):
        return fresh_result(out)


def extract_graphed(bv, min_weight: float, color_by_rgb: bool, color_by_confidence: bool,
                    kernel: bool, chunk_slots: int, live_chunks: tuple, budgets: tuple):
    """``ops.marching_cubes.extract_soup_bricks(check=False)`` through its
    graph (the chunk programs of these live chunks and budgets): a MeshSoup
    of fresh tensors."""
    from .ops.marching_cubes import _extract_unchecked

    args = (float(min_weight), color_by_rgb, color_by_confidence, kernel, chunk_slots,
            live_chunks, budgets)
    soup = _run_graphed(lambda: ("extract", bv.device, state_key(bv)) + args, bv.device,
                        lambda: _extract_unchecked(bv, *args), [])
    return dataclasses.replace(soup, **{
        f.name: t.clone() for f in dataclasses.fields(soup)
        if isinstance(t := getattr(soup, f.name), torch.Tensor)})


class _CheckedGraphs:
    """The checked extraction's graphs on one volume and settings, in the
    JAX package's shape (``_brick_stats_scan``'s body and
    ``_extract_chunk_compact``, with the chunk's start traced): the brick
    stats of a chunk, replayed a live chunk into static (min, max)
    buffers, and the chunk program, one graph a (cube, brick, tri) budget
    triple, replayed a chunk. Each reads the chunk's start from a static
    device buffer that a call fills before the replay (a fill kernel: no
    copy from the host). ``graphs`` runs from the least to the most
    recently used, at most :data:`MAX_CHECKED_GRAPHS` of them; a capture
    past that drops the least recently used chunk graph."""

    def __init__(self, bv, settings, chunk_slots: int):
        dev = bv.device
        self.bv, self.settings, self.chunk_slots = bv, settings, chunk_slots
        self.dmin = torch.empty((bv.capacity + 1,), dtype=torch.float32, device=dev)
        self.dmax = torch.empty_like(self.dmin)
        self.slot0 = torch.zeros((), dtype=torch.int32, device=dev)
        self.graphs: "collections.OrderedDict[object, _Captured]" = collections.OrderedDict()

    def captures(self):
        return [("extract_checked_" + ("stats" if k == "stats" else "chunk"), c)
                for k, c in self.graphs.items()]

    def _run(self, key, program):
        """program through the graph of key at the current slot0: the first
        run warms up (its result returned) and captures; later runs replay
        (the graph's outputs returned, which its next replay overwrites).
        Returns (result, replayed)."""
        c = self.graphs.get(key)
        if c is None:
            counts["misses"] += 1
            c = self.graphs[key] = _Captured(self.bv.device, program)
            while len(self.graphs) > MAX_CHECKED_GRAPHS:
                del self.graphs[next(k for k in self.graphs if k != "stats")]
                counts["evictions"] += 1
            out, c.warm = c.warm, None
            return out, False
        self.graphs.move_to_end(key)
        c.replay()
        return c.out, True

    def stats(self, live_chunks: tuple) -> None:
        from .ops.marching_cubes import _chunk_stats

        self.dmin.fill_(float("inf"))
        self.dmax.fill_(float("-inf"))
        for s0 in live_chunks:
            self.slot0.fill_(s0)
            self._run("stats", lambda: _chunk_stats(self.bv, self.dmin, self.dmax, self.slot0,
                                                    self.chunk_slots, self.settings[0]))

    def chunk(self, s0: int, cube_budget: int, brick_budget: int, tri_budget: int):
        """The chunk program from slot s0 at these budgets: (vertices,
        colors or None, tri_valid, out) in fresh tensors."""
        from .ops.marching_cubes import _extract_chunk

        min_weight, color_by_rgb, color_by_confidence, kernel = self.settings
        self.slot0.fill_(s0)
        out, replayed = self._run(("chunk", cube_budget, brick_budget, tri_budget),
                                  lambda: _extract_chunk(
                                      self.bv, (self.dmin, self.dmax), self.slot0,
                                      self.chunk_slots, cube_budget, brick_budget, tri_budget,
                                      min_weight, color_by_rgb, color_by_confidence, kernel))
        if not replayed:
            return out
        return tuple(None if t is None else t.clone() for t in out)


def checked_extraction(bv, min_weight: float, color_by_rgb: bool, color_by_confidence: bool,
                       kernel: bool, chunk_slots: int, live_chunks: tuple):
    """The checked extraction's chunk programs on the card
    (``ops.marching_cubes._extract`` with check=True): the brick stats of
    the live chunks through their graph, then a function (s0, cube, brick,
    tri budget) -> the chunk program's (vertices, colors or None,
    tri_valid, out) in fresh tensors, through the graph of its budgets.
    The graphs of a volume and settings are kept together under one key."""
    settings = (float(min_weight), color_by_rgb, color_by_confidence, kernel)
    key = ("extract_checked", bv.device, state_key(bv), chunk_slots) + settings
    entry = _lookup(key)
    if entry is None:
        entry = _CheckedGraphs(bv, settings, chunk_slots)
        _keep(key, entry)
    entry.stats(live_chunks)
    return entry.chunk


def refine_graphed(kind: str, vol, inputs, downsample_by: int):
    """``refine._step`` (kind "step": inputs pose, depth, step scale;
    returns (pose, loss)) or ``refine._residual`` ("residual": pose, depth;
    returns the loss) through its graph, in fresh tensors."""
    from .refine import _residual, _step

    program = _step if kind == "step" else _residual
    out = _run_graphed(lambda: ("refine_" + kind, vol.device, state_key(vol),
                                tuple(inputs[1].shape), downsample_by), vol.device,
                       lambda *xs: program(vol, *xs, downsample_by=downsample_by), inputs)
    return tuple(t.clone() for t in out) if kind == "step" else out.clone()


def organize_graphed(cfg, points, rgb):
    """``pipeline.organize_cloud`` through the graph of its padded length:
    the cloud padded with NaN points up to a power of two (a NaN point lands
    nowhere, so neither the depth nor a pixel's winner changes), the result
    in fresh tensors."""
    from .pipeline import _organize

    n, dev = points.shape[0], points.device
    npad = 1 << max(n - 1, 0).bit_length()
    pts = torch.full((npad, 3), float("nan"), dtype=torch.float32, device=dev)
    pts[:n] = points
    inputs = [pts]
    if rgb is not None:
        cols = torch.zeros((npad, 3), dtype=torch.float32, device=dev)
        cols[:n] = rgb
        inputs.append(cols)
    depth, rgb_img = _run_graphed(
        lambda: ("organize", dev, cfg.image_width, cfg.image_height, cfg.focal_length_x,
                 cfg.focal_length_y, cfg.principal_point_x, cfg.principal_point_y, npad,
                 rgb is None, tracing.enabled()),
        dev, lambda *xs: _organize(cfg, *xs), inputs)
    return depth.clone(), None if rgb_img is None else rgb_img.clone()
