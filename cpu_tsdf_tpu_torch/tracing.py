"""Spans, device stages and counters inside the port; off by default.

A profiler's kernel names cannot say how a CUDA graph's replay divides
among the program's stages (every kernel of a replay carries the graph
launch's correlation id), how long the host spends inside an entry point,
or how much of a window the card waits for the host. This module measures
them from inside the program:

* **Host spans** (:func:`span`, :func:`timed`): name, start and end on the
  host clock (``time.perf_counter_ns``), the enclosing span, and a request
  id shared by every span under one outermost span (one public call).
  While ``torch.profiler`` is active each recorded span is also a
  ``record_function`` range, so the program's spans lie on the profiler's
  timeline beside the device operations.
* **Device stages** (:func:`stage`): a stamp of the device clock
  (``%globaltimer``) that a one-thread kernel (``csrc/trace.cu``) writes
  into a ring on the card, on the current stream, with no host sync. Inside
  a captured CUDA graph the stamp is a node of the graph, so every replay
  stamps. A stage runs from its stamp to the next stamp: one stamp is the
  boundary of two stages, and ``stage(None, dev)`` ends a stage without
  opening one. On CPU tensors a stamp reads the host clock.
* **Calls** (:func:`call`): a public entry point's span; the outermost call
  also stamps ``call.begin`` as its first device operation and
  ``call.end`` as its last. Device time between one call's end and the next
  call's begin is the card waiting for its caller; device time inside a
  call outside its stages is put down to the innermost host span open when
  it began.
* **Counters** (:func:`counters`): dicts of integers registered by name,
  which their owners increment whether tracing is on or not (the kernel
  wrappers' launch counts, the graphs' captures and replays).
* **Device counts** (:func:`count`): integers the device computed (a
  list's length), each beside its budget, copied by a one-thread kernel
  (``csrc/trace.cu``) into a ring of rows on the card with no host sync,
  so that a captured graph records them at every replay; :func:`report`
  gives each count's mean and maximum over the rows. On CPU tensors the
  values are kept as tensors and read at the report.

Off, an entry point pays one test of a module-level boolean: :func:`span`,
:func:`call` and :func:`stage` return at once, and nothing is created or
stamped. Graph keys hold :func:`enabled` (``graph.state_key``), so a graph
captured with stamps is never replayed with tracing off, nor the reverse.

:func:`enable` allocates the buffers: the host spans' (bounded, its oldest
records dropped and counted when full) and, once a process, a ring of
:data:`RING_STAMPS` stamps and one of :data:`COUNT_ROWS` count rows on each
card (graphs captured with stamps keep their addresses, so they are never
freed), then takes one calibration point a
card (a sync, then the host and device clocks read together), so that
stages and host spans lie on one timeline. :func:`report` reads the
records (one host sync), returns their summary and starts the next window;
spans are written out through it alone. One thread: the stack of open
spans is the process's.
"""

from __future__ import annotations

import bisect
import collections
import ctypes
import statistics
import time
from typing import Optional

import torch

# Stamps a card's ring holds (16 bytes each); older ones are overwritten and
# counted as dropped.
RING_STAMPS = 1 << 20
# Host spans the buffer holds by default.
SPAN_CAPACITY = 1 << 18
# Rows of device counts a card's ring holds (COUNT_ROW int32 each: the
# label, the number of counts, MAX_COUNTS counts, MAX_COUNTS budgets).
COUNT_ROWS = 1 << 16
MAX_COUNTS = 7
COUNT_ROW = 2 + 2 * MAX_COUNTS
CALL_BEGIN, CALL_END = "call.begin", "call.end"

_on = False
_now = time.perf_counter_ns
_tracer: Optional["_Tracer"] = None
_registry: dict = {}
# label ids are baked into captured graphs, so they never change
_labels: dict = {"": 0, CALL_BEGIN: 1, CALL_END: 2}
_names: list = ["", CALL_BEGIN, CALL_END]
# per card index: (ring tensor [RING_STAMPS, 2] int64, head tensor [1] int64)
_rings: dict = {}
# per card index: the ring's and the head's addresses, as the stamp takes them
_ptrs: dict = {}
_stamp_fn = None
# per card index: (count rows [COUNT_ROWS, COUNT_ROW] int32, head [1] int64)
_count_rings: dict = {}
_count_fn = None
# label -> (group, count names) of the device counts
_count_groups: dict = {}


class _CountSpec(ctypes.Structure):
    """Mirror of ``struct CountSpec`` in csrc/trace.cu."""

    _fields_ = [("src", ctypes.c_void_p * MAX_COUNTS), ("budget", ctypes.c_int * MAX_COUNTS),
                ("k", ctypes.c_int), ("label", ctypes.c_int)]


def enabled() -> bool:
    return _on


def counters(group: str, counts: dict) -> dict:
    """Register ``counts`` (name -> int, incremented by its owner) as the
    counter group ``group`` and return the same dict; :func:`report` gives
    each counter's change since the window began, as ``group.name``."""
    _registry[group] = counts
    return counts


def _counts() -> dict:
    return {f"{g}.{k}": v for g, c in _registry.items() for k, v in c.items()}


class _Tracer:
    """The host-side buffers of one enabled tracing."""

    def __init__(self, capacity: int):
        self.spans = collections.deque(maxlen=capacity)
        self.n_spans = 0
        self.stack: list = []
        self.next_id = 0
        self.next_request = 0
        self.call_depth = 0
        self.cpu_stamps = collections.deque(maxlen=RING_STAMPS)
        self.n_cpu_stamps = 0
        self.cpu_counts = collections.deque(maxlen=COUNT_ROWS)
        self.n_cpu_counts = 0
        self.offsets: dict = {}        # card index -> device ns minus host ns
        self.counts0 = _counts()

    def window(self) -> None:
        self.spans.clear()
        self.n_spans = 0
        self.cpu_stamps.clear()
        self.n_cpu_stamps = 0
        self.cpu_counts.clear()
        self.n_cpu_counts = 0
        for _, head in list(_rings.values()) + list(_count_rings.values()):
            head.zero_()
        self.counts0 = _counts()


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def enable(capacity: int = SPAN_CAPACITY, devices=None) -> None:
    """Turn tracing on with fresh buffers: host spans up to ``capacity``,
    a stamp ring and a count ring on each of ``devices`` (default: every
    visible card) and one calibration point each (a host sync: call it outside a timed
    region and outside any graph capture)."""
    global _on, _tracer, _stamp_fn, _count_fn
    _tracer = _Tracer(capacity)
    for dev in _cuda_devices() if devices is None else [torch.device(d) for d in devices]:
        if dev.type != "cuda":
            continue
        idx = _index(dev)
        if idx not in _rings:
            if _stamp_fn is None:
                from ._build import function

                _stamp_fn = function("trace", "tsdf_trace_stamp",
                                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_void_p])
                _count_fn = function("trace", "tsdf_trace_counts",
                                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p, ctypes.c_void_p])
            ring, head = _rings[idx] = (
                torch.zeros((RING_STAMPS, 2), dtype=torch.int64, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev))
            _ptrs[idx] = (ring.data_ptr(), head.data_ptr())
            _count_rings[idx] = (
                torch.zeros((COUNT_ROWS, COUNT_ROW), dtype=torch.int32, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev))
        _tracer.offsets[idx] = _calibrate(dev)
    _tracer.window()
    _on = True


def disable() -> None:
    """Turn tracing off; the records stay for :func:`report`."""
    global _on
    _on = False


def reset() -> None:
    """Drop the records and start a new window (counters from here on)."""
    if _tracer is not None:
        _tracer.window()


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


# the address of a card's current stream: torch's raw accessor where the
# build has it (a Stream object costs microseconds a stamp)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda idx: torch.cuda.current_stream(idx).cuda_stream)


def _launch_stamp(idx: int, label: int) -> None:
    ring, head = _ptrs[idx]
    err = _stamp_fn(ring, head, RING_STAMPS, label, _raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"tracing stamp: CUDA error {err} at launch")


def _calibrate(dev: torch.device, tries: int = 5) -> int:
    """Device ns minus host ns on `dev`: of `tries` stamps, each between
    two syncs, the one whose host interval was shortest, against that
    interval's midpoint."""
    idx = _index(dev)
    ring, head = _rings[idx]
    best = None
    for _ in range(tries):
        head.zero_()
        torch.cuda.synchronize(dev)
        h0 = _now()
        _launch_stamp(idx, 0)
        torch.cuda.synchronize(dev)
        h1 = _now()
        d = int(ring[0, 0])
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, d - (h0 + h1) // 2)
    head.zero_()
    return best[1]


def _label(name: Optional[str]) -> int:
    name = name or ""
    lab = _labels.get(name)
    if lab is None:
        lab = _labels[name] = len(_names)
        _names.append(name)
    return lab


def _stamp(device: torch.device, name: Optional[str]) -> None:
    if device.type != "cuda":
        t = _tracer
        t.cpu_stamps.append((_now(), _label(name)))
        t.n_cpu_stamps += 1
        return
    idx = _index(device)
    if idx not in _ptrs:
        raise RuntimeError(f"tracing: no stamp ring on {device}; enable() was called "
                           f"without it")
    _launch_stamp(idx, _label(name))


def stage(name: Optional[str], device: torch.device) -> None:
    """Stamp the boundary where device stage `name` begins (None: where the
    stage before it ends and none begins) on `device`'s current stream."""
    if _on:
        _stamp(device, name)


def count(group: str, device: torch.device, counts: dict) -> None:
    """Record device counts of the counter group `group` on `device`'s
    current stream: ``counts`` maps each name to (a 0-dim int32 tensor on
    `device`, its budget), at most MAX_COUNTS of them. No host sync; a
    capture records the copy as a node of its graph. :func:`report` gives
    ``group.name``'s mean and maximum over the rows recorded in the
    window, beside its budget."""
    if not _on:
        return
    names = tuple(counts)
    if not 0 < len(names) <= MAX_COUNTS:
        raise ValueError(f"tracing.count: 1 to {MAX_COUNTS} counts, got {len(names)}")
    label = _label(f"{group}({','.join(names)})")
    _count_groups[label] = (group, names)
    values = [v for v, _ in counts.values()]
    budgets = [int(b) for _, b in counts.values()]
    for name, v in zip(names, values):
        if v.dtype != torch.int32 or v.numel() != 1 or v.device.type != device.type:
            raise ValueError(f"tracing.count: {group}.{name} must be one int32 on {device}")
    if device.type != "cuda":
        t = _tracer
        t.cpu_counts.append((label, torch.stack([v.reshape(()) for v in values]), budgets))
        t.n_cpu_counts += 1
        return
    idx = _index(device)
    if idx not in _count_rings:
        raise RuntimeError(f"tracing: no count ring on {device}; enable() was called "
                           f"without it")
    rows, head = _count_rings[idx]
    spec = _CountSpec(k=len(names), label=label)
    for j, (v, b) in enumerate(zip(values, budgets)):
        spec.src[j], spec.budget[j] = v.data_ptr(), b
    err = _count_fn(rows.data_ptr(), head.data_ptr(), COUNT_ROWS, ctypes.byref(spec),
                    _raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"tracing count: CUDA error {err} at launch")


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """A host span: recorded when tracing is on as it opens; its duration
    (``seconds``, ``ms``) is measured either way."""

    __slots__ = ("name", "t0", "t1", "sid", "parent", "request", "owner", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.owner = None
        self._rf = None

    def __enter__(self):
        t = _tracer if _on else None
        if t is not None:
            self.owner = t
            top = t.stack[-1] if t.stack else None
            self.sid, t.next_id = t.next_id, t.next_id + 1
            if top is None:
                self.parent, self.request = -1, t.next_request
                t.next_request += 1
            else:
                self.parent, self.request = top.sid, top.request
            t.stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        self.t1 = _now()
        t = self.owner
        if t is not None:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            if t.stack and t.stack[-1] is self:
                t.stack.pop()
            t.spans.append((self.sid, self.name, self.t0, self.t1, self.parent, self.request))
            t.n_spans += 1
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class _Call(_Span):
    __slots__ = ("device", "outer")

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        t = self.owner
        self.outer = t is not None and t.call_depth == 0
        if t is not None:
            t.call_depth += 1
        if self.outer:
            _stamp(self.device, CALL_BEGIN)
        return self

    def __exit__(self, exc_type, *rest):
        t = self.owner
        if t is not None:
            t.call_depth -= 1
            if self.outer and exc_type is None and _on:
                _stamp(self.device, CALL_END)
        return super().__exit__(exc_type, *rest)


def span(name: str):
    """A host span as a context manager (nothing at all while off)."""
    return _Span(name) if _on else _NULL


def timed(name: str) -> _Span:
    """A host span that measures its duration (``.seconds``, ``.ms``) even
    while tracing is off, and is recorded while it is on."""
    return _Span(name)


def call(name: str, device: torch.device):
    """The span of a public entry point on `device` (nothing while off);
    the outermost call stamps ``call.begin`` and ``call.end``."""
    return _Call(name, torch.device(device)) if _on else _NULL


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _read_ring(idx: int) -> tuple:
    """The card's stamps in the order they were written, as (device ns,
    label) pairs, and the number overwritten."""
    ring, head = _rings[idx]
    torch.cuda.synchronize(ring.device)
    n = int(head.item())
    k = min(n, RING_STAMPS)
    rows = ring[:k].tolist()
    if n > RING_STAMPS:
        start = n % RING_STAMPS
        rows = rows[start:] + rows[:start]
    return [(int(a), int(b)) for a, b in rows], n - k


def stamp_summary(stamps: list) -> dict:
    """Stages, calls and gaps of stamps in device order, each (ns, name):
    a stage runs from its stamp to the next; a call from ``call.begin`` to
    ``call.end``; ``between`` lists the intervals from one call's end to
    the next call's begin, ``inside`` the intervals inside a call outside
    its stages (a call without stages is inside from begin to end)."""
    stages = collections.defaultdict(list)
    calls, between, inside = [], [], []
    # open_stage: (name, start); begin: the open call's start; edge: since
    # when the open call has been outside any stage
    open_stage = begin = edge = last_end = None
    for t, name in stamps:
        if open_stage is not None:
            stages[open_stage[0]].append(t - open_stage[1])
            open_stage = None
        elif edge is not None and t > edge:
            inside.append((edge, t))
        edge = None
        if name == CALL_BEGIN:
            if last_end is not None:
                between.append((last_end, t))
            begin = edge = t
        elif name == CALL_END:
            if begin is not None:
                calls.append((begin, t))
                last_end = t
            begin = None
        elif name:
            open_stage = (name, t)
        elif begin is not None:
            edge = t
    return dict(stages=dict(stages), calls=calls, between=between, inside=inside)


def _innermost(spans: list, starts: list, t: int) -> Optional[str]:
    """The innermost host span open at host time t: the latest-opened span
    that has not closed by t (spans sorted by start; one thread's spans
    nest)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][3] > t:
            return spans[i][1]
        i -= 1
    return None


def _read_counts(t: "_Tracer") -> tuple:
    """The window's device count rows, each (label, counts, budgets), and
    the number overwritten."""
    out = [(lab, v.tolist(), b) for lab, v, b in t.cpu_counts]
    dropped = t.n_cpu_counts - len(t.cpu_counts)
    for rows, head in _count_rings.values():
        torch.cuda.synchronize(rows.device)
        n = int(head.item())
        k = min(n, COUNT_ROWS)
        dropped += n - k
        for r in rows[:k].tolist():
            m = r[1]
            out.append((r[0], r[2:2 + m], r[2 + MAX_COUNTS:2 + MAX_COUNTS + m]))
    return out, dropped


def _count_summary(rows: list) -> dict:
    """``group.name`` -> the rows' count, mean and maximum of the value, and
    its budget (the largest recorded), of rows (label, counts, budgets)."""
    values = collections.defaultdict(list)
    budgets = collections.defaultdict(list)
    for lab, vals, bud in rows:
        group, names = _count_groups[lab]
        for name, v, b in zip(names, vals, bud):
            values[f"{group}.{name}"].append(v)
            budgets[f"{group}.{name}"].append(b)
    return {k: {"count": len(v), "mean": sum(v) / len(v), "max": max(v),
                "budget": max(budgets[k])} for k, v in values.items()}


def _stats(values: list) -> dict:
    return {"count": len(values), "total_ms": sum(values) * 1e-6,
            "mean_ms": sum(values) / len(values) * 1e-6,
            "median_ms": statistics.median(values) * 1e-6}


def report() -> dict:
    """The window's summary (a host sync), and a new window:

    * ``spans``: each host span's name -> count, total, mean and median ms,
      and its mean self ms (its duration less its children's);
    * ``requests``: outermost spans (public calls and other roots);
    * ``stages``: each device stage -> count, total, mean, median ms;
    * ``calls``: count; ``window_ms`` from the first ``call.begin`` to the
      last ``call.end`` (summed over cards); ``call_ms`` the calls' device
      time; ``between_ms`` the device time from a call's end to the next
      call's begin, and ``idle_share`` = between_ms / window_ms (None
      without two calls); ``inside_ms`` the device time inside calls
      outside their stages; ``gaps_ms``: between_ms under ``caller``, and
      each inside interval under the innermost host span open when it
      began;
    * ``counters``: each counter's change in the window, and each device
      count's (:func:`count`) rows, mean, maximum and budget under
      ``group.name``;
    * ``dropped``: host spans, and stamps and device count rows, lost to
      full buffers."""
    t = _tracer
    if t is None:
        raise RuntimeError("tracing.report(): tracing was never enabled")
    stamp_sets, dropped = [], t.n_cpu_stamps - len(t.cpu_stamps)
    if t.cpu_stamps:
        stamp_sets.append(([(ns, _names[lab]) for ns, lab in t.cpu_stamps], 0))
    for idx, off in t.offsets.items():
        rows, lost = _read_ring(idx)
        dropped += lost
        if rows:
            stamp_sets.append(([(ns, _names[lab]) for ns, lab in rows], off))
    spans = sorted(t.spans, key=lambda s: s[2])
    starts = [s[2] for s in spans]
    child = collections.Counter()
    for s in spans:
        if s[4] >= 0:
            child[s[4]] += s[3] - s[2]
    by_name = collections.defaultdict(list)
    self_ns = collections.defaultdict(list)
    for s in spans:
        by_name[s[1]].append(s[3] - s[2])
        self_ns[s[1]].append(s[3] - s[2] - child[s[0]])
    out_spans = {n: dict(_stats(v), self_ms=sum(self_ns[n]) / len(v) * 1e-6)
                 for n, v in by_name.items()}

    stages = collections.defaultdict(list)
    window = call_ns = between_ns = inside_ns = n_calls = 0
    gaps = collections.Counter()
    for stamps, off in stamp_sets:
        s = stamp_summary(stamps)
        for name, v in s["stages"].items():
            stages[name] += v
        if s["calls"]:
            window += s["calls"][-1][1] - s["calls"][0][0]
            call_ns += sum(b - a for a, b in s["calls"])
            n_calls += len(s["calls"])
        for a, b in s["between"]:
            between_ns += b - a
            gaps["caller"] += b - a
        for a, b in s["inside"]:
            inside_ns += b - a
            gaps[_innermost(spans, starts, a - off) or "caller"] += b - a
    calls = {"count": n_calls, "window_ms": window * 1e-6, "call_ms": call_ns * 1e-6,
             "between_ms": between_ns * 1e-6,
             "idle_share": between_ns / window if n_calls > 1 and window > 0 else None,
             "inside_ms": inside_ns * 1e-6,
             "gaps_ms": {k: v * 1e-6 for k, v in gaps.most_common()}}
    counts = _counts()
    count_rows, counts_dropped = _read_counts(t)
    result = {"spans": out_spans, "requests": len({s[5] for s in spans}),
              "stages": {n: _stats(v) for n, v in stages.items()}, "calls": calls,
              "counters": {**{k: v - t.counts0.get(k, 0) for k, v in counts.items()},
                           **_count_summary(count_rows)},
              "dropped": {"spans": t.n_spans - len(t.spans),
                          "stamps": dropped + counts_dropped}}
    t.window()
    return result
