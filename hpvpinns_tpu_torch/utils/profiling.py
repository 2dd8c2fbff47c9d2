"""Tracing and timing utilities.

Counterpart of hpvpinns_tpu/utils/profiling.py:

  * `trace(logdir)`: a context manager around torch.profiler that writes a
    TensorBoard/Perfetto-loadable trace of the host and, on the card, the
    device;
  * `time_fn`: steady-state timing of any callable, after a warm-up, with a
    device sync after each call where CUDA is in use (none on the CPU);
  * `device_memory_stats`: the CUDA caching allocator's counters.

and the program's recorder, off by default (`enable`, `disable`):

  * spans: `span(name, **attrs)` records a name, host start and end
    (`time.perf_counter_ns`, CLOCK_MONOTONIC, one clock for every process
    of a host), the enclosing span and attributes.  The program opens
    `kernels.load` (ops/cuda_build.py), `chunk.capture` with `capture.warmup`
    and `capture.graph`, `chunk` with `chunk.launch`, `phase` and
    `chunk.read` (training/).  While a torch.profiler runs, each span also
    opens a `record_function` of its name, so `trace(...)` shows them;
  * per-chunk device events: a chunk of CUDA graphs records one CUDA event
    before its first replay and one after its metrics replay
    (`Recorder.chunk_begin`, `chunk_end`).
    Their times are resolved in `records()`, after a sync, and mapped onto
    the host clock linearly between two anchors (`map_clock`);
  * per-graph counters (`capture_counts`): a graph captured while the
    recorder is on keeps its nodes and kernel nodes, the kernel wrappers' launches
    made during its capture (the B1, B2 and block-sum nodes in it) and its
    replays.

`records()` returns everything as plain numbers; `export_chrome(path)` writes
it as Chrome-trace JSON (Perfetto loads it).  Off, `span` returns one shared
no-op and a chunk tests one flag: nothing is allocated or recorded.  The
recorder serves one thread, and its device events one device a process (a
mesh runs one rank a process).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import time
from array import array
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile into `logdir` (view with TensorBoard or Perfetto);
    yields the torch.profiler.profile object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 100, warmup: int = 5) -> dict:
    """Steady-state timing of `fn(*args)`, each call ended by a device sync
    when CUDA is in use (the host clock then spans the device's work).

    Returns {'mean_s', 'p50_s', 'best_s', 'iters_per_sec'}.
    """
    for _ in range(warmup):
        fn(*args)
    _sync()

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    mean = sum(times) / len(times)
    return {
        "mean_s": mean,
        "p50_s": times[len(times) // 2],
        "best_s": times[0],
        "iters_per_sec": 1.0 / mean,
    }


def device_memory_stats() -> dict:
    """The caching allocator's counters on the current CUDA device
    (torch.cuda.memory_stats: allocated, reserved, peak bytes, ...); {} with
    no CUDA device."""
    return dict(torch.cuda.memory_stats()) if torch.cuda.is_available() else {}


# ---------------------------------------------------------------- the recorder

EVENT_BLOCK = 128  # CUDA events made at once when the pool runs dry
ANCHOR_TRIES = 5  # an anchor keeps the try whose record-and-sync took least host time


def map_clock(device_ms: float, anchors) -> float:
    """The host time (ns) of a device time (ms since the first anchor's
    event), by the line through the two anchors ((host ns, device ms) each):
    the device's clock may run at another rate than the host's, so two
    anchors, one at each end of the recording, hold the alignment over it."""
    (h0, d0), (h1, d1) = anchors
    return h0 + (device_ms - d0) * (h1 - h0) / (d1 - d0)


class _Null:
    """The span `span()` returns while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


class Span:
    """An open span of the recorder; `set` adds attributes before it ends."""

    __slots__ = ("_rec", "_name", "_attrs", "_index")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec, self._name, self._attrs, self._index = rec, name, attrs, -1

    def __enter__(self):
        self._index = self._rec._open(self._name, self._attrs)
        return self

    def __exit__(self, *exc):
        self._rec._close(self._index)
        return False

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)


class GraphCounts:
    """The counters of one graph captured while the recorder was on: its
    nodes and kernel nodes, the kernel wrappers' launches made during its
    capture, and its replays (the replay function the trainer builds for it
    adds them)."""

    __slots__ = ("name", "nodes", "kernel_nodes", "launches", "replays")

    def __init__(self, name: str, nodes: int, kernel_nodes: int, launches: dict):
        self.name, self.nodes, self.kernel_nodes, self.launches, self.replays = name, nodes, kernel_nodes, launches, 0

    def as_dict(self) -> dict:
        return {"name": self.name, "nodes": self.nodes, "kernel_nodes": self.kernel_nodes,
                "launches": dict(self.launches), "replays": self.replays}


class Recorder:
    """Spans, chunks with their device events, and graph counters, kept in
    memory until `records()`.  A chunk costs the host three clock reads,
    appends to flat integer arrays and, for a chunk of graphs, two event
    records: no object the garbage collector has to walk, since the recorder
    runs beside the timed loop."""

    def __init__(self):
        self.on = False
        self.clear()

    def clear(self) -> None:
        self._names: list = []  # each span's name
        self._times = array("q")  # each span's start and end ns (end -1 while open)
        self._parents = array("q")  # each span's enclosing span (-1: none)
        self._attrs: dict = {}  # span index -> attributes, for spans that have any
        self._stack: list = []  # the open spans
        self._profiled: list = []  # torch.profiler record_functions of the open spans, while one runs
        self._chunks = array("q")  # each chunk's n, chunk span, launch span and whether it has events
        self._events: list = []  # the start and end event of every chunk with events, in record order
        self._device: dict = {}  # chunk -> [start ns, end ns] on the host clock, once resolved
        self._resolved = 0  # the chunks before this one are resolved
        self._graphs: list = []
        self._pool: list = []
        self._anchor = None  # (host ns, event) of the first chunk with events since the last records()
        self._anchors: list = []
        self._open_chunk = None  # what chunk_begin keeps for chunk_end
        self._stream = self._raw_stream = None

    def _open(self, name: str, attrs) -> int:
        index = len(self._names)
        self._names.append(name)
        self._times.append(time.perf_counter_ns())
        self._times.append(-1)
        self._parents.append(self._stack[-1] if self._stack else -1)
        if attrs:
            self._attrs[index] = attrs
        self._stack.append(index)
        if torch._C._autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._profiled.append((index, rf))
        return index

    def _close(self, index: int) -> None:
        if self._profiled and self._profiled[-1][0] == index:
            self._profiled.pop()[1].__exit__(None, None, None)
        self._times[2 * index + 1] = time.perf_counter_ns()
        if self._stack and self._stack[-1] == index:
            self._stack.pop()

    def _event(self):
        if not self._pool:
            self._pool = [torch.cuda.Event(enable_timing=True) for _ in range(EVENT_BLOCK)]
        return self._pool.pop()

    def _take_anchor(self):
        """(host ns, event): an event recorded on an idle device and waited
        for; the host time is the middle of the record and the wait, from the
        try that took least."""
        torch.cuda.synchronize()
        best = None
        for _ in range(ANCHOR_TRIES):
            event = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            event.record()
            event.synchronize()
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, event)
        return (best[0] + best[1]) / 2, best[2]

    def _stream_now(self):
        """The current CUDA stream, its Python object kept while the raw
        stream stays the same (torch.cuda.current_stream() makes a new one
        each call, several µs of host time)."""
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        if raw != self._raw_stream:
            self._stream, self._raw_stream = torch.cuda.current_stream(), raw
        return self._stream

    def chunk_begin(self, n: int, events: bool) -> None:
        """Open a chunk of n steps, as little as possible before the caller
        enqueues it, since the device waits for the host there: its start
        time and, with `events` (a chunk of CUDA graphs), an event on the
        current stream.  The first such chunk since the last `records()`
        takes the first anchor (a device sync) before that."""
        if events and self._anchor is None:
            self._anchor = self._take_anchor()
        rfs = ()
        if torch._C._autograd._profiler_enabled():
            rfs = (torch.profiler.record_function("chunk"), torch.profiler.record_function("chunk.launch"))
            for rf in rfs:
                rf.__enter__()
        start = None
        t0 = time.perf_counter_ns()
        if events:
            start = self._event()
            start.record(self._stream_now())
        self._open_chunk = (n, t0, start, rfs)

    def chunk_end(self) -> None:
        """Close the chunk `chunk_begin` opened: its end event, then its
        spans `chunk` and its child `chunk.launch` (from the start time to
        the end event's record; `chunk` to the end of this bookkeeping)."""
        n, t0, start, rfs = self._open_chunk
        if start is not None:
            end = self._event()
            end.record(self._stream)
            self._events += (start, end)
        t1 = time.perf_counter_ns()
        for rf in reversed(rfs):
            rf.__exit__(None, None, None)
        outer = len(self._names)
        self._names += ("chunk", "chunk.launch")
        self._times.extend((t0, -1, t0, t1))
        self._parents.extend((self._stack[-1] if self._stack else -1, outer))
        self._chunks.extend((n, outer, outer + 1, start is not None))
        self._times[2 * outer + 1] = time.perf_counter_ns()

    def capture_counts(self, name: str, graph, launches: dict) -> GraphCounts:
        """Count `graph`'s nodes (captured with keep_graph=True) and keep
        them with the wrapper `launches` made during its capture."""
        nodes, kernels = graph_nodes(graph)
        counts = GraphCounts(name, nodes, kernels, launches)
        self._graphs.append(counts)
        return counts

    def _resolve(self) -> None:
        """Time every pending chunk's events on the host clock: the device
        times chained from event to event in record order (each difference
        small, so float32 milliseconds lose nothing), then mapped between
        the first anchor and one taken now.  A chunk without events (one
        that ran eagerly) gets no device times."""
        chunks = len(self._chunks) // 4
        timed = [i for i in range(self._resolved, chunks) if self._chunks[4 * i + 3]]
        self._resolved = chunks
        if not timed:
            return
        h_last, last = self._take_anchor()
        h_first, first = self._anchor
        events, self._events = self._events, []
        chain = [first, *events, last]
        device = [0.0]
        for a, b in zip(chain, chain[1:]):
            device.append(device[-1] + a.elapsed_time(b))
        anchors = ((h_first, 0.0), (h_last, device[-1]))
        for j, i in enumerate(timed):
            self._device[i] = [map_clock(device[1 + 2 * j], anchors), map_clock(device[2 + 2 * j], anchors)]
        self._pool += events
        self._anchors.append({"host_ns": [h_first, h_last], "device_ms": [0.0, device[-1]]})
        self._anchor = None

    def records(self) -> dict:
        """Everything recorded so far, as plain numbers: "spans" (name,
        start_ns, end_ns (None while open), parent, attrs, self_ns: the
        duration less its children's), "chunks" (n, the indices of its
        `chunk` and `chunk.launch` spans, device_ns: its start and end events
        on the host clock, None for a chunk without events), "graphs" (name,
        nodes, kernel_nodes, launches, replays) and "anchors"."""
        self._resolve()
        t, n_spans = self._times, len(self._names)
        children = [0] * n_spans
        for i in range(n_spans):
            if self._parents[i] >= 0 and t[2 * i + 1] >= 0:
                children[self._parents[i]] += t[2 * i + 1] - t[2 * i]
        chunks = [{"n": self._chunks[k], "span": self._chunks[k + 1], "launch": self._chunks[k + 2],
                   "device_ns": self._device.get(k // 4)} for k in range(0, len(self._chunks), 4)]
        attrs = dict(self._attrs)
        for c in chunks:
            attrs[c["span"]] = {"n": c["n"]}
        spans = []
        for i, name in enumerate(self._names):
            start, end = t[2 * i], t[2 * i + 1]
            spans.append({"name": name, "start_ns": start, "end_ns": None if end < 0 else end,
                          "parent": None if self._parents[i] < 0 else self._parents[i],
                          "attrs": dict(attrs.get(i, {})),
                          "self_ns": None if end < 0 else end - start - children[i]})
        return {"spans": spans, "chunks": chunks, "graphs": [g.as_dict() for g in self._graphs],
                "anchors": list(self._anchors)}


RECORDER = Recorder()


def enable() -> None:
    """Start recording, from nothing: what an earlier recording kept goes."""
    RECORDER.clear()
    RECORDER.on = True


def disable() -> None:
    """Stop recording; what was recorded stays for `records()`."""
    RECORDER.on = False


def enabled() -> bool:
    return RECORDER.on


def span(name: str, /, **attrs):
    """A context manager recording a span while the recorder is on; the
    shared no-op otherwise.  Both give `set(**attrs)`."""
    return Span(RECORDER, name, attrs) if RECORDER.on else NULL


def capture_counts(name: str, graph, launches: dict) -> GraphCounts:
    return RECORDER.capture_counts(name, graph, launches)


def records() -> dict:
    return RECORDER.records()


def export_chrome(path: str) -> dict:
    """Write `records()` as Chrome-trace JSON (Perfetto, chrome://tracing):
    the spans on a host track, each chunk's device interval on a device
    track, in µs from the first span; the graph counters under
    "otherData".  Returns the records written."""
    rec = records()
    starts = [s["start_ns"] for s in rec["spans"]]
    origin = min(starts) if starts else 0
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": label}}
              for tid, label in ((0, "host"), (1, "device (chunk events)"))]
    for i, s in enumerate(rec["spans"]):
        if s["end_ns"] is None:
            continue
        events.append({"name": s["name"], "ph": "X", "pid": pid, "tid": 0, "ts": (s["start_ns"] - origin) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"id": i, "parent": s["parent"], "self_us": s["self_ns"] / 1e3, **s["attrs"]}})
    for c in rec["chunks"]:
        if c["device_ns"] is not None:
            a, b = c["device_ns"]
            events.append({"name": "chunk (device)", "ph": "X", "pid": pid, "tid": 1, "ts": (a - origin) / 1e3,
                           "dur": (b - a) / 1e3, "args": {"n": c["n"], "span": c["span"]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns",
                   "otherData": {"origin_ns": origin, "graphs": rec["graphs"], "anchors": rec["anchors"]}}, f)
    return rec


# ---------------------------------------------------------------- graph nodes

_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPE_GRAPH = 4  # a child graph
_LIBCUDA: Optional[ctypes.CDLL] = None


def _libcuda() -> ctypes.CDLL:
    """The CUDA driver library the process already runs on (torch loaded
    it), with the three graph queries declared."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, size_p, int_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)
        for fn, args in (("cuGraphGetNodes", [vp, vp, size_p]), ("cuGraphNodeGetType", [vp, int_p]),
                         ("cuGraphChildGraphNodeGetGraph", [vp, ctypes.POINTER(vp)])):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def _checked(fn: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{fn} failed: CUresult {code}")


def _node_types(lib: ctypes.CDLL, handle, counts: dict) -> dict:
    n = ctypes.c_size_t(0)
    _checked("cuGraphGetNodes", lib.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * max(1, n.value))()
    _checked("cuGraphGetNodes", lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kind = ctypes.c_int()
    for node in nodes[: n.value]:
        _checked("cuGraphNodeGetType", lib.cuGraphNodeGetType(node, ctypes.byref(kind)))
        if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _checked("cuGraphChildGraphNodeGetGraph", lib.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)))
            _node_types(lib, child, counts)
        else:
            counts[kind.value] = counts.get(kind.value, 0) + 1
    return counts


def node_types(graph) -> dict:
    """{CUgraphNodeType: count} of a torch.cuda.CUDAGraph captured with
    keep_graph=True, child graphs counted through (0 kernel, 1 copy, 2 set)."""
    return _node_types(_libcuda(), ctypes.c_void_p(graph.raw_cuda_graph()), {})


def graph_nodes(graph) -> tuple:
    """(nodes, kernel nodes) of a kept graph, as `node_types` counts them."""
    counts = node_types(graph)
    return sum(counts.values()), counts.get(_CU_GRAPH_NODE_TYPE_KERNEL, 0)
