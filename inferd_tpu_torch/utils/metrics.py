"""In-process metrics: counters and latency histograms (port of
inferd_tpu/utils/metrics.py's counter and histogram registry), and a
trailing window of one series.

The node keeps its overload-plane counters here (`deadline.expired`,
`admission.shed`, `sessions.rescue_relay`, `hedge.fired`, ...), its
gauges (the standby plane's `repl.lag_tokens`, ...) and its hop latencies
(`hop.relay_ms`); `/stats` reports `Metrics.snapshot()` under `metrics`. Standard library only; thread-safe.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque
from typing import Callable, Dict, List, Optional

_DEFAULT_BOUNDS_MS = [
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
]


class Histogram:
    """Fixed-bucket latency histogram (milliseconds) with quantile estimates."""

    def __init__(self, bounds_ms: Optional[List[float]] = None):
        self.bounds = list(_DEFAULT_BOUNDS_MS if bounds_ms is None else bounds_ms)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum_ms = 0.0
        self._lock = threading.Lock()

    def observe(self, value_ms: float) -> None:
        idx = bisect_right(self.bounds, value_ms)
        with self._lock:
            self.counts[idx] += 1
            self.total += 1
            self.sum_ms += value_ms

    @staticmethod
    def _quantile_from(
        bounds: List[float], counts: List[int], total: int, q: float
    ) -> float:
        """Upper-bound q-quantile estimate over a bucket snapshot."""
        if total == 0:
            return 0.0
        target = q * total
        run = 0
        for i, c in enumerate(counts):
            run += c
            if run >= target:
                return bounds[i] if i < len(bounds) else float("inf")
        return float("inf")

    def state(self) -> tuple:
        """One-lock snapshot of (bounds, counts, total, sum_ms)."""
        with self._lock:
            return list(self.bounds), list(self.counts), self.total, self.sum_ms

    def summary(self) -> Dict[str, float]:
        # one lock for the whole summary: a lock per quantile would let a
        # concurrent observe land between them
        bounds, counts, total, sum_ms = self.state()
        return {
            "count": total,
            "mean_ms": (sum_ms / total) if total else 0.0,
            "p50_ms": self._quantile_from(bounds, counts, total, 0.5),
            "p90_ms": self._quantile_from(bounds, counts, total, 0.9),
            "p99_ms": self._quantile_from(bounds, counts, total, 0.99),
        }


class Metrics:
    """Named counters, gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value_ms: float,
                bounds_ms: Optional[List[float]] = None) -> None:
        """`bounds_ms` applies when this call creates the histogram: a long
        interval (a stage migration's seconds) takes wider buckets than the
        default 10 s cap, or its quantiles would saturate to inf."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(bounds_ms)
        h.observe(value_ms)

    def snapshot(self) -> Dict[str, object]:
        """{"counters", "histograms"} and, once any gauge is set, "gauges"
        (a node that sets none reports what it did before gauges existed)."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.histograms)
        return {
            "counters": counters,
            **({"gauges": gauges} if gauges else {}),
            "histograms": {k: h.summary() for k, h in hists.items()},
        }


class TrailingWindow:
    """The last `cap` observations of one series with their times, and a
    quantile over those of the trailing `horizon_s`, estimated from
    Histogram's buckets the way Histogram estimates it: given the same
    observations it is the same bucket bound as the reference's windowed
    quantile, which reads the reference's obs/tsdb rings (not ported yet:
    ROADMAP A9). `clock` is injectable for tests."""

    def __init__(self, horizon_s: float = 60.0, cap: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.horizon_s = horizon_s
        self._clock = clock
        self._ring: deque = deque(maxlen=cap)
        self._lock = threading.Lock()

    def observe(self, value_ms: float) -> None:
        with self._lock:
            self._ring.append((self._clock(), float(value_ms)))

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile's bucket bound over the trailing window, or None
        when no observation falls inside it."""
        cutoff = self._clock() - self.horizon_s
        with self._lock:
            values = [v for t, v in self._ring if t >= cutoff]
        if not values:
            return None
        counts = [0] * (len(_DEFAULT_BOUNDS_MS) + 1)
        for v in values:
            counts[bisect_right(_DEFAULT_BOUNDS_MS, v)] += 1
        return Histogram._quantile_from(_DEFAULT_BOUNDS_MS, counts, len(values), q)
