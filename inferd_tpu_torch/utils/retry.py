"""Overload-containment primitives: backoff, budgets, deadlines (port of
inferd_tpu/utils/retry.py, whole).

  * `backoff_delay`: capped exponential backoff with FULL JITTER, so N
    clients whose retries would fire in lock-step decorrelate into a
    uniform smear. Deterministic under a seeded `random.Random`.
  * `RetryBudget`: a token-bucket retry budget. Retries spend tokens that
    refill at a fixed rate, so a hard-down dependency produces a BOUNDED
    retry rate instead of multiplying every client's traffic by
    (1 + retries). Shared per process across sessions; the node's rescue
    loop draws from one of its own.
  * `RatioBudget`: a work-ratio budget for hedged requests: hedges are
    capped at a fraction of primary sends.
  * deadline helpers: requests carry an ABSOLUTE `deadline_ms` (wall-clock
    epoch milliseconds) in the wire envelope; every hop derives its
    remaining budget locally (`remaining_s`) and fails fast once it is
    gone instead of relaying dead work down the chain.

Standard library only: clients, the node and the control plane import it.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

#: wire envelope key carrying the absolute deadline (epoch milliseconds).
#: Attached only when a caller set one — envelopes without deadlines stay
#: byte-identical to the pre-deadline format, and old peers that don't
#: know the key simply ignore it (msgpack dicts carry unknown keys).
#:
#: CLOCK CAVEAT: an absolute wall-clock deadline assumes the fleet's
#: clocks agree (NTP). A node whose clock runs AHEAD shortens every riding
#: budget by its skew, and skew beyond the budget fails deadline-carrying
#: requests with the non-retryable 408 while deadline-less traffic keeps
#: working: if `/stats` `metrics` shows `deadline.expired` climbing on ONE
#: node whose peers are quiet, check its clock first.
DEADLINE_KEY = "deadline_ms"


def deadline_ms_from_now(timeout_s: float, now: Optional[float] = None) -> float:
    """Absolute epoch-ms deadline `timeout_s` from now."""
    base = time.time() if now is None else now
    return (base + float(timeout_s)) * 1e3


def remaining_s(
    deadline_ms: Optional[float], now: Optional[float] = None
) -> Optional[float]:
    """Seconds left until an absolute epoch-ms deadline; None when no
    deadline rides (the caller then applies its static timeout), and
    <= 0.0 once the budget is spent. Malformed values (an old peer
    echoing garbage) count as no deadline — fail open, never fail a
    request on an unparseable hint."""
    if deadline_ms is None:
        return None
    try:
        d = float(deadline_ms)
    except (TypeError, ValueError):
        return None
    base = time.time() if now is None else now
    return d / 1e3 - base


def backoff_delay(
    attempt: int,
    base_s: float = 1.0,
    cap_s: float = 8.0,
    rng: Optional[random.Random] = None,
) -> float:
    """Full-jitter capped exponential backoff for retry `attempt` (1-based):
    uniform(0, min(cap_s, base_s * 2^(attempt-1))). Pass a seeded
    `random.Random` for deterministic schedules in tests."""
    if attempt < 1:
        return 0.0
    ceiling = min(float(cap_s), float(base_s) * (2.0 ** (attempt - 1)))
    r = rng if rng is not None else random
    return r.uniform(0.0, max(0.0, ceiling))


class RetryBudget:
    """Token-bucket retry budget: `try_acquire()` spends one token when
    available; tokens refill at `rate_per_s` up to `burst`. Thread-safe
    (clients retry from asyncio tasks, the node's rescue loop from its
    handler threads, tests from anywhere). `clock` is injectable for
    deterministic tests; defaults to time.monotonic."""

    def __init__(
        self, rate_per_s: float = 5.0, burst: int = 32, clock=time.monotonic
    ):
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()
        self.granted = 0
        self.denied = 0

    def _refill_locked(self) -> None:
        now = self._clock()
        dt = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate_per_s)

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                self.granted += 1
                return True
            self.denied += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def stats(self) -> dict:
        return {
            "granted": self.granted,
            "denied": self.denied,
            "tokens": round(self.tokens(), 3),
        }


class RatioBudget:
    """Work-ratio budget: extra sends (hedges) are allowed while
    `fired <= ratio * primary + burst`. `note()` counts a primary send;
    `try_acquire()` admits-and-counts a hedge. The burst floor lets the
    first few hedges fire before enough primaries have accumulated to
    amortize them (without it a cold node could never hedge at all)."""

    def __init__(self, ratio: float = 0.05, burst: int = 2):
        self.ratio = float(ratio)
        self.burst = int(burst)
        self.primary = 0
        self.fired = 0
        self._lock = threading.Lock()

    def note(self, n: int = 1) -> None:
        with self._lock:
            self.primary += n

    def try_acquire(self) -> bool:
        with self._lock:
            if self.fired + 1 <= self.ratio * self.primary + self.burst:
                self.fired += 1
                return True
            return False

    def extra_frac(self) -> float:
        with self._lock:
            return self.fired / self.primary if self.primary else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "primary": self.primary,
                "fired": self.fired,
                "extra_frac": round(
                    self.fired / self.primary if self.primary else 0.0, 4
                ),
            }


#: per-process retry budget shared by every generation client in this
#: process (the "shared across sessions" bucket): a down stage makes N
#: concurrent generations retry, and this bucket bounds their COMBINED
#: retry rate. Generous enough that healthy failure recovery (a node
#: death, a TTL window) never notices it; a sustained storm drains it
#: and surfaces the original error instead of amplifying.
DEFAULT_RETRY_BUDGET = RetryBudget(rate_per_s=5.0, burst=32)
