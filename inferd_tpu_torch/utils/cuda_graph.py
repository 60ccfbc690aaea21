"""Captured CUDA graphs over static buffers, with the kernel wrappers' launch
counters kept true (the port's own helper; the JAX package's counterpart is
a jitted program with its buffers donated).

A `GraphCache` holds a bounded LRU of captured steps, each keyed by a
hashable signature. `run(key, fn, inputs)`:

  * on a miss, copies `inputs` into fresh static buffers (on the cache's
    `device`, or each input's own when it has none), runs `fn` on them
    once for real on a side stream (the warm-up: kernels load, the
    allocator and the libraries set up, and its result is this call's
    result), then captures `fn` once into a graph over the same buffers;
  * on a hit, copies `inputs` into the entry's static buffers and replays
    the graph on the current stream; the result is the entry's static
    outputs, valid until the cache's next capture or replay.

Memory: one memory pool serves all of a cache's graphs (CudaBackend): a
capture allocates its intermediates where an earlier graph's were and
takes no pool of its own, so a graph holds little more than its static
buffers. And every warm-up of a backend runs on ONE side stream: a new
stream per warm-up leaves memory allocated for each stream of torch's
32-stream pool (a cuBLAS workspace per stream), ~1 GiB on an H100
(tools/graph_memory measures each way; PERF.md has the numbers). With one
pool, a graph's outputs may be overwritten by ANY later replay of the
same cache: the caller reads them (or copies them, as
models/qwen3.run_window does) before its next step, and runs one step of
a cache at a time (the executors hold a lock around a step and its read).

An input is a device tensor or a host tensor staged for the device
(core.cache.host_staged: pinned on a card): a host input goes to its static
buffer in one non-blocking copy, with no device copy in between. `run_step`
is the one front end of the executors: a replay, or with no cache the same
`fn` eagerly on the inputs uploaded.

`fn` must read its inputs only through the static buffers it is given,
write nothing outside the buffers it owns or is handed (a KV cache
written in place is such a buffer, and its slots must be the same at every
replay), never read a device value on the host (no `.item()`, `nonzero`,
`int(tensor)`), and copy nothing from the host (`host_to_device` would
re-read its host buffer at every replay). A capture that fails raises; no
call falls back to running `fn` eagerly.

Launch counters: the kernel wrappers count the launches they make. During
a capture their Python runs but nothing launches, so the helper takes the
counters' change over the capture back out, keeps it with the entry, and
adds it again at every replay: the counts stay exact per replay, as if each
replay had been the eager call. The warm-up's launches are real and count
once, as they happened.

The wrappers' checks (shapes, dtypes, alignment, the launch plan) run only
while `fn` is captured: a replay re-runs none of them.

Dropping entries: a graph keeps every buffer it reads by address alive (the
entry holds `fn`, which closes over them), so whoever frees such a buffer
drops its graphs with it (`drop(pred)`, counted in `evictions` as the LRU's
own evictions are).

Capture beside other threads: a node captures while its other threads may
touch the card (an HTTP thread's `.cpu()`, a pinned upload, an adapter
hot-load outside the device lock). CudaBackend therefore captures with
`capture_error_mode="thread_local"`: only the capturing thread is barred
from the calls that would break a capture, and another thread's copy or
allocation neither invalidates it nor is refused. The capturing thread
itself holds the executor's device lock (or the node's compute lock), so
no other capture or replay of the same executor runs meanwhile. The
capture stream is a non-blocking stream, so work another thread enqueues
on the default stream does not join the graph.

No garbage collection inside a capture: a dead graph that a cyclic
collection frees there (an executor dropped with its graphs) resets its
graph while the stream captures, which CUDA refuses, and the capture
fails. CudaBackend holds the collector off until the capture ends; what
it would have freed is freed at a later collection.

Several caches in one process (a node migrating between stages holds the
old stage's executor and the new one's for a while): captures are
serialized process-wide by CAPTURE_LOCK, which a cache holds from the
warm-up through the capture to the LRU's eviction, and under which `drop`
frees graphs. torch.cuda.graph empties the caching allocator as a capture
begins, which the allocator refuses while another capture is underway, so
two captures must never overlap; `release_device_memory` (gc, then the
allocator's unused blocks back to the card, after an executor is dropped)
takes the same lock. Every warm-up runs on the process's one side stream
(`side_stream`), so a new cache adds no stream, and no cuBLAS workspace
with it.
"""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from inferd_tpu_torch.utils.profiling import span

Counter = Tuple[Any, str]  # (wrapper function, attribute name)

# one capture at a time in this process, and no release of the caching
# allocator's blocks during one (see the module docstring)
CAPTURE_LOCK = threading.RLock()
_side: List[Any] = []  # the process's warm-up stream, made at the first warm-up


def side_stream():
    """The stream every CudaBackend warm-up of this process runs on (one
    card per process, as every node)."""
    if not _side:
        _side.append(torch.cuda.Stream())
    return _side[0]


def release_device_memory() -> None:
    """After an executor was dropped: a cyclic collection (an executor and
    its graphs and buffers form cycles), then the caching allocator's unused
    blocks back to the card, under CAPTURE_LOCK. A no-op for the card when
    CUDA was never initialized in this process."""
    with CAPTURE_LOCK:
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def kernel_counters() -> List[Counter]:
    """Every kernel wrapper's launch and route counters."""
    from inferd_tpu_torch.ops import attention, lora, qmatmul

    return ([(attention.flash_gqa, a) for a in ("launches", "split_launches", "mma_launches")]
            + [(attention.paged_decode_gqa, a) for a in ("launches", "split_launches")]
            + [(w, a) for w in (qmatmul.w8a16_matmul, qmatmul.w4a16_matvec)
               for a in ("launches", "mma_launches", "simt_launches")]
            + [(lora.fused_lane_delta, "launches")])


class CudaBackend:
    """Warm-up and capture on the card (torch.cuda.graphs); every graph it
    captures shares one memory pool, and every warm-up runs on the
    process's side stream (`side_stream`)."""

    def __init__(self):
        self.pool = None
        self.side = None

    def warmup(self, fn: Callable[[], Any]) -> Any:
        cur = torch.cuda.current_stream()
        if self.side is None:
            self.side = side_stream()
        side = self.side
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, used on this one
            t.record_stream(cur)
        return out

    def capture(self, fn: Callable[[], Any]) -> Tuple[Any, Any]:
        enabled = gc.isenabled()
        gc.disable()
        try:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                out = fn()
        finally:
            if enabled:
                gc.enable()
        return graph, out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


class _Entry:
    # `fn` keeps what the graph reads by address (a KV buffer it closes
    # over) alive as long as the graph
    __slots__ = ("graph", "fn", "inputs", "outputs", "delta")

    def __init__(self, graph, fn, inputs, outputs, delta):
        self.graph, self.fn, self.inputs, self.outputs, self.delta = (
            graph, fn, inputs, outputs, delta)


class GraphCache:
    """A bounded LRU of captured graphs (see the module docstring)."""

    def __init__(self, max_graphs: int = 32, counters: Optional[Sequence[Counter]] = None,
                 backend=None, device=None):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        self.device = None if device is None else torch.device(device)
        self._counters = list(kernel_counters() if counters is None else counters)
        self._backend = backend or CudaBackend()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        # guards _entries and the counters: drop() may come from another
        # thread than the one that runs the steps
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.evictions = 0

    def _snapshot(self) -> List[int]:
        return [getattr(obj, attr) for obj, attr in self._counters]

    def _add(self, delta: Sequence[int], sign: int = 1) -> None:
        for (obj, attr), d in zip(self._counters, delta):
            if d:
                setattr(obj, attr, getattr(obj, attr) + sign * d)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "resident": len(self._entries), "evictions": self.evictions,
                    "max_graphs": self.max_graphs}

    def run(self, key: Hashable, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor]):
        """fn(**static inputs) -> outputs, replayed from a graph keyed by
        `key` (captured on the first call for the key)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            with span("graph.capture"):
                return self._capture(key, fn, inputs)
        with span("graph.replay"):
            for name, value in inputs.items():
                entry.inputs[name].copy_(value, non_blocking=True)
            return self.replay(entry)

    def replay(self, entry: _Entry):
        entry.graph.replay()
        self._add(entry.delta)
        with self._lock:
            self.replays += 1
        return entry.outputs

    def drop(self, pred: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose key satisfies `pred` (their graphs, static
        buffers and what `fn` closes over go with them); returns how many,
        each counted in `evictions`."""
        with CAPTURE_LOCK, self._lock:
            dead = [k for k in self._entries if pred(k)]
            for k in dead:
                del self._entries[k]
            self.evictions += len(dead)
        return len(dead)

    def _capture(self, key: Hashable, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor]):
        static = {name: (value.clone() if self.device is None
                         else value.to(self.device, copy=True))
                  for name, value in inputs.items()}
        with CAPTURE_LOCK:
            result = self._backend.warmup(lambda: fn(**static))
            before = self._snapshot()
            graph, outputs = self._backend.capture(lambda: fn(**static))
            delta = [a - b for a, b in zip(self._snapshot(), before)]
            self._add(delta, -1)  # the capture launched nothing
            with self._lock:
                self._entries[key] = _Entry(graph, fn, static, outputs, delta)
                self.captures += 1
                while len(self._entries) > self.max_graphs:
                    self._entries.popitem(last=False)
                    self.evictions += 1
        return result

    def capture_only(self, key: Hashable, fn: Callable[..., Any],
                     inputs: Dict[str, torch.Tensor]) -> _Entry:
        """Warm up and capture `fn` under `key` (or find it) and return the
        entry, for callers that time `replay(entry)` themselves."""
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            self._capture(key, fn, inputs)
            with self._lock:
                entry = self._entries[key]
        return entry


def run_step(graphs: Optional[GraphCache], key: Hashable, fn: Callable[..., Any],
             inputs: Dict[str, torch.Tensor], device):
    """fn(**inputs) on `device`: a replay of the graph keyed by `key` from
    `graphs` (host inputs copied once, into its static buffers), or eager
    when `graphs` is None (host inputs uploaded first: the reference the
    graphs are held to)."""
    if graphs is None:
        return fn(**{name: value.to(device, non_blocking=True)
                     for name, value in inputs.items()})
    return graphs.run(key, fn, inputs)


def graph_stats(graphs: Optional[GraphCache]) -> Dict[str, int]:
    """A GraphCache's stats, zeros for None (steps that run eagerly)."""
    if graphs is None:
        return {"captures": 0, "replays": 0, "resident": 0, "evictions": 0, "max_graphs": 0}
    return graphs.stats()
