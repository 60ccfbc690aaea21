"""Timing harnesses (port of the measurement half of
inferd_tpu/utils/profiling.py).

`interleaved_pair_times` and `paired_delta_stats` are pure Python, copied
so the port imports nothing of the JAX package: a fixed-length decode is
timed at a short and a long step count in interleaved pairs, and the
per-pair difference gives the steady per-step time with the fixed
overhead (prefill, set-up, the final read) cancelled. `chained_attention_
rate` times an attention callable as n chained calls with one
synchronisation per rep.

`Profiler` captures a torch.profiler trace on demand (a node's `POST
/profile`): host activity on every thread of the process and, on a card,
the device's kernels, as a Chrome trace in a directory confined under
`base_dir`. While one runs, `span(name)` labels a stretch of host work in
it (the node, the executor, the model's layers and the kernel wrappers
label theirs); with none running `span` costs one global read.
`host_time_split` reads such a trace back into where the host's time went.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from typing import Any, Dict, List, Optional


def chained_attention_rate(fn, q, k, v, n: int, reps: int = 3) -> float:
    """calls/s of `fn(q, k, v) -> out`: n calls chained per rep (each
    query takes a negligible but real contribution from the previous
    output, q + 1e-6 * out, as the reference's scan does), one
    torch.cuda.synchronize per rep on a card, min over reps."""
    import torch

    def loop():
        qc, o = q, None
        for _ in range(n):
            o = fn(qc, k, v)
            qc = q + 1e-6 * o.reshape(q.shape)
        return o

    def sync():
        if q.device.type == "cuda":
            torch.cuda.synchronize(q.device)

    loop()  # warm-up: builds and loads kernels
    sync()
    ts = []
    for _ in range(reps):  # min of reps: one disturbed rep must not decide
        t0 = time.perf_counter()
        loop()
        sync()
        ts.append(time.perf_counter() - t0)
    return n / min(ts)


def interleaved_pair_times(time_short, time_long, pairs: int):
    """Interleaved paired measurement of two timing callables: each pair
    runs one SHORT and one LONG window back to back, alternating which goes
    first, so a linear drift biases half the pairs up and half down and a
    median over per-pair quantities cancels it. Returns (t_shorts, t_longs),
    seconds."""
    ts, tl = [], []
    for i in range(pairs):
        if i % 2 == 0:
            a = time_short()
            b = time_long()
        else:
            b = time_long()
            a = time_short()
        ts.append(a)
        tl.append(b)
    return ts, tl


def paired_delta_stats(ts, tl, n_short: int, n_long: int):
    """Per-pair differenced per-iteration seconds from interleaved
    (short, long) window times.

    A pair is valid iff 0 < (tl - ts) and tl <= (n_long / n_short) * ts:
    the first drops pairs where a disturbance made the long window finish
    faster, the second the pairs that imply a negative fixed overhead. Each
    valid pair's steady per-iteration time is then <= its own end-to-end
    per-iteration time.

    Returns (per_iter_s, n_valid, spread_pt, ts_valid): the median
    per-iteration seconds over valid pairs (median(tl) / n_long when none
    is valid); how many pairs were valid; half the IQR of the per-pair
    times as a percentage of the median (range-based under 3 pairs); the
    valid pairs' short-window times (median(ts_valid) / n_short is then
    >= per_iter_s)."""
    per, ts_valid = [], []
    for a, b in zip(ts, tl):
        d = b - a
        if d > 0 and b <= (n_long / n_short) * a:
            per.append(d / (n_long - n_short))
            ts_valid.append(a)
    if not per:
        return statistics.median(tl) / n_long, 0, 0.0, list(ts)
    med = statistics.median(per)
    if len(per) >= 3:
        qs = statistics.quantiles(per, n=4)
        spread = (qs[2] - qs[0]) / 2
    else:
        spread = (max(per) - min(per)) / 2
    spread_pt = round(spread / med * 100, 1) if med > 0 else 0.0
    return med, len(per), spread_pt, ts_valid


# -- on-demand traces ------------------------------------------------------------

_TRACING = 0  # Profilers running in this process: `span` records only then


def span(name: str):
    """A labelled stretch of host work in a running trace (a
    torch.profiler record_function); a no-op context when none runs."""
    if not _TRACING:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


TRACE_FILE = "trace.json"


class Profiler:
    """Serialized start/stop around a torch.profiler trace (port of
    inferd_tpu/utils/profiling.Profiler, which wraps jax.profiler).

    The trace records host activity on EVERY thread of the process
    (torch.profiler's profile_all_threads: a node serves each request on
    its own thread) and, when a card is present, its kernels (CUPTI). It
    lands in `<dir>/trace.json` (a Chrome trace) at `stop`.

    `device_lock` (optional) is held for the whole start..stop window, so
    another user of the device that try-acquires it (a live anatomy tick)
    never interleaves with a capture; `start` waits up to 10 s for it.
    Releasing a threading.Lock from another thread is legal, which `stop`
    relies on (start and stop arrive on different request threads)."""

    def __init__(self, base_dir: str = "profiles", device_lock=None):
        self.base_dir = base_dir
        self.device_lock = device_lock
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._prof = None
        self._holds_device = False

    @property
    def active_dir(self) -> Optional[str]:
        return self._active_dir

    def start(self, name: Optional[str] = None) -> str:
        """Begin a trace; returns the directory it will land in. `name` is
        a RELATIVE label under base_dir, never an arbitrary path: a network
        endpoint exposes this and must not hand out a write-anywhere."""
        global _TRACING
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._active_dir is not None:
                raise RuntimeError(f"profile already running -> {self._active_dir}")
            label = name or time.strftime("%Y%m%d-%H%M%S")
            d = os.path.normpath(os.path.join(self.base_dir, label))
            base = os.path.normpath(self.base_dir)
            if os.path.isabs(label) or not (d == base or d.startswith(base + os.sep)):
                raise ValueError(f"trace name {label!r} escapes profile dir")
            if self.device_lock is not None:
                if not self.device_lock.acquire(timeout=10.0):
                    raise RuntimeError("device busy (its lock was held for > 10 s): retry the "
                                       "profile start")
                self._holds_device = True
            try:
                os.makedirs(d, exist_ok=True)
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities,
                               experimental_config=_ExperimentalConfig(profile_all_threads=True))
                prof.start()
            except BaseException:
                self._release_device()
                raise
            self._prof = prof
            self._active_dir = d
            _TRACING += 1
            return d

    def _release_device(self) -> None:
        if self._holds_device:
            self._holds_device = False
            self.device_lock.release()

    def stop(self) -> str:
        """End the trace and write it; returns its directory. A failing
        stop or export never leaves the profiler marked as running."""
        global _TRACING
        with self._lock:
            if self._active_dir is None:
                raise RuntimeError("no profile running")
            d, prof = self._active_dir, self._prof
            try:
                prof.stop()
                tmp = os.path.join(d, TRACE_FILE + ".tmp")
                prof.export_chrome_trace(tmp)
                os.replace(tmp, os.path.join(d, TRACE_FILE))
            finally:
                self._active_dir = None
                self._prof = None
                _TRACING -= 1
                self._release_device()
            return d


# The labels of host work in a node's trace (span names), and what each
# category of host_time_split sums. A labelled span's time counts once, to
# the innermost label around it.
HOST_SPLIT_LABELS = {
    "http.request": "http",  # socket read, handler, reply write (what no inner label covers)
    "wire.unpack": "wire",
    "wire.pack": "wire",
    "window.wait": "window_waits",  # a decode step waiting in the arrival window
    "node.lock_wait": "lock_waits",  # waiting for the one-session node's compute lock
    "executor.process": "executor",  # the stage step outside the layers and wrappers
    "results.cpu": "results_cpu",  # the results' .cpu(): device wait + the copy
    "graph.replay": "graph_replay",  # a captured step: its inputs' copies and the replay
    "graph.capture": "graph_capture",  # a step's warm-up and capture, outside its layers
    "qwen3.layer": "layers",  # one decoder layer's host time (its torch ops included)
    "kernel.flash_gqa": "wrappers",  # a kernel wrapper: its checks, plan and launch
    "kernel.paged_decode_gqa": "wrappers",
    "kernel.qgemv": "wrappers",
    "kernel.fused_lane_delta": "wrappers",
}


def _trace_events(trace: Any) -> List[Dict[str, Any]]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))]


def host_time_split(trace) -> Dict[str, Any]:
    """Where a node's host time went, from its torch.profiler Chrome trace
    (a path or the loaded JSON): ms per HOST_SPLIT_LABELS category, each
    span's time minus the labelled spans nested in it, so the categories
    partition the requests' time; `*_python_ms` for the layers and the
    wrappers, their time outside any torch op or CUDA runtime call; the
    number of requests (http.request spans) and `per_request`, the same
    split for each request in the order they came (`ms` its whole time,
    `compute` whether it ran the executor); and, when the trace holds device
    kernels, their count and summed ms."""
    events = _trace_events(trace)
    # the device's timeline (kernels, copies, the labels mirrored onto it)
    # is not host time
    host = [e for e in events if e.get("cat") != "kernel" and not
            str(e.get("cat", "")).startswith("gpu_")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    cats = sorted(set(HOST_SPLIT_LABELS.values())) + ["layers_python", "wrappers_python"]

    def empty() -> Dict[str, float]:
        return {c: 0.0 for c in cats}

    total, requests = empty(), []
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for e in host:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []
        labelled = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            e["_child"] = 0.0  # time in direct children of any kind
            e["_labelled"] = 0.0  # time in the nearest labelled descendants
            e["_request"] = None
            if stack:
                stack[-1]["_child"] += e["dur"]
                e["_request"] = stack[-1]["_request"]
            if e["name"] in HOST_SPLIT_LABELS:
                owner = next((p for p in reversed(stack) if p["name"] in HOST_SPLIT_LABELS), None)
                if owner is not None:
                    owner["_labelled"] += e["dur"]
                if e["name"] == "http.request":
                    e["_request"] = dict(empty(), ts=e["ts"], ms=e["dur"] / 1e3, compute=False)
                    requests.append(e["_request"])
                labelled.append(e)
            stack.append(e)
        for e in labelled:
            cat = HOST_SPLIT_LABELS[e["name"]]
            parts = {cat: (e["dur"] - e["_labelled"]) / 1e3}
            if cat in ("layers", "wrappers"):
                parts[f"{cat}_python"] = (e["dur"] - e["_child"]) / 1e3
            for split in (total, e["_request"]):
                if split is not None:
                    for k, v in parts.items():
                        split[k] += v
            if cat == "executor" and e["_request"] is not None:
                e["_request"]["compute"] = True

    def rounded(split: Dict[str, Any]) -> Dict[str, Any]:
        return {f"{k}_ms": round(split[k], 4) for k in cats}

    out = rounded(total)
    out["requests"] = len(requests)
    out["per_request"] = [dict(rounded(r), ms=round(r["ms"], 4), compute=r["compute"])
                          for r in sorted(requests, key=lambda r: r["ts"])]
    out["device_kernels"] = len(kernels)
    out["device_kernel_ms"] = round(sum(e["dur"] for e in kernels) / 1e3, 4)
    return out
