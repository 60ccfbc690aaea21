"""Captured CUDA graphs over static buffers, with the kernel wrappers' launch
counters kept true (the port's own helper; the JAX package's counterpart is
a jitted program with its buffers donated).

A `GraphCache` holds a bounded LRU of captured steps, each keyed by a
hashable signature. `run(key, fn, inputs)`:

  * on a miss, copies `inputs` into fresh static buffers, runs `fn` on them
    once for real on a side stream (the warm-up: kernels load, the
    allocator and the libraries set up, and its result is this call's
    result), then captures `fn` once into a graph over the same buffers;
  * on a hit, copies `inputs` into the entry's static buffers and replays
    the graph on the current stream; the result is the entry's static
    outputs, which the next replay of that entry overwrites.

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
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

Counter = Tuple[Any, str]  # (wrapper function, attribute name)


def kernel_counters() -> List[Counter]:
    """Every kernel wrapper's launch and route counters."""
    from inferd_tpu_torch.ops import attention, lora, qmatmul

    return ([(attention.flash_gqa, a) for a in ("launches", "split_launches", "mma_launches")]
            + [(attention.paged_decode_gqa, a) for a in ("launches", "split_launches")]
            + [(w, a) for w in (qmatmul.w8a16_matmul, qmatmul.w4a16_matvec)
               for a in ("launches", "mma_launches", "simt_launches")]
            + [(lora.fused_lane_delta, "launches")])


class CudaBackend:
    """Warm-up and capture on the card (torch.cuda.graphs)."""

    def warmup(self, fn: Callable[[], Any]) -> Any:
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, used on this one
            t.record_stream(cur)
        return out

    def capture(self, fn: Callable[[], Any]) -> Tuple[Any, Any]:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
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
                 backend=None):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        self._counters = list(kernel_counters() if counters is None else counters)
        self._backend = backend or CudaBackend()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
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
        return {"captures": self.captures, "replays": self.replays,
                "resident": len(self._entries), "evictions": self.evictions,
                "max_graphs": self.max_graphs}

    def run(self, key: Hashable, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor]):
        """fn(**static inputs) -> outputs, replayed from a graph keyed by
        `key` (captured on the first call for the key)."""
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, fn, inputs)
        self._entries.move_to_end(key)
        for name, value in inputs.items():
            entry.inputs[name].copy_(value)
        return self.replay(entry)

    def replay(self, entry: _Entry):
        entry.graph.replay()
        self._add(entry.delta)
        self.replays += 1
        return entry.outputs

    def _capture(self, key: Hashable, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor]):
        static = {name: value.clone() for name, value in inputs.items()}
        result = self._backend.warmup(lambda: fn(**static))
        before = self._snapshot()
        graph, outputs = self._backend.capture(lambda: fn(**static))
        delta = [a - b for a, b in zip(self._snapshot(), before)]
        self._add(delta, -1)  # the capture launched nothing
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
        if key not in self._entries:
            self._capture(key, fn, inputs)
        return self._entries[key]
