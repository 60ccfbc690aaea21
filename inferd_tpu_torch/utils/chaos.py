"""Fault injection for the swarm's reliability paths (port of the forward-
path faults of inferd_tpu/utils/chaos.py).

A Chaos spec makes a node misbehave on purpose (drop requests, add
latency, stall, or die) so that recovery and containment (deadlines,
hedging, retry budgets, session rescue) are tested properties.

Spec string (run_node --chaos, or env INFERD_CHAOS): comma-separated

  drop=P         fail forwards with HTTP 500, probability P
  delay_ms=D     sleep D ms before serving each forward
  block_ms=D     the same as delay_ms on this node: it serves each request
                 on its own thread, so a sleep there blocks that request
                 only (the reference's event-loop stall has no
                 counterpart here)
  jitter_ms=A:B  sleep an extra uniform(A, B) ms per forward (seeded)
  stall_p=P      slow-loris, probability P: accept the request, then never
                 answer (until stop() or crash() releases it). The fault
                 that exercises deadline expiry and hedging: a drop answers
                 at once, a stall does not answer at all
  drop_after=N   serve the first N forwards normally, then drop every one
  die_after=N    hard-exit the process after N forwards
  crash_after=N  abrupt node death after N forwards: the on_crash hook
                 (the node wires its crash(): no tombstone, sockets closed,
                 KV lost) fires and the forward that tripped it fails
  seed=S         seed of the one stream every probabilistic key draws from:
                 a given (spec, request sequence) replays

Keys compose ("drop=0.2,jitter_ms=5:50,stall_p=0.1,seed=3"). Order per
forward: die_after, crash_after, drop_after, delay_ms, block_ms,
jitter_ms, stall_p, drop. Concurrent forwards take their draws in the
order they reach each draw.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Optional, Tuple

#: How long a stall_p slow-loris holds a request when nothing releases it.
STALL_S = 3600.0


class ChaosDrop(Exception):
    pass


@dataclasses.dataclass
class Chaos:
    drop: float = 0.0
    delay_ms: float = 0.0
    block_ms: float = 0.0
    jitter_ms: Tuple[float, float] = (0.0, 0.0)  # uniform(A, B) extra ms
    stall_p: float = 0.0
    drop_after: int = 0  # 0 = never; N = drop everything after N forwards
    die_after: int = 0  # 0 = never
    crash_after: int = 0  # 0 = never; N = abrupt node death (on_crash hook)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._served = 0
        self._lock = threading.Lock()  # the count and the draws, across handler threads
        # crash_after's teardown hook: the node wires it to its crash()
        self.on_crash = None
        self._crashed = False
        self._released = threading.Event()  # set by cancel_stalls: no sleep outlives it
        self._stalled = 0

    @staticmethod
    def parse(spec: Optional[str]) -> Optional["Chaos"]:
        """Parse "k=v,k=v"; None or empty -> None (no chaos)."""
        if not spec:
            return None
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k in ("die_after", "drop_after", "crash_after", "seed"):
                kw[k] = int(v)
            elif k in ("drop", "delay_ms", "block_ms", "stall_p"):
                kw[k] = float(v)
            elif k == "jitter_ms":
                lo, sep, hi = v.partition(":")
                if not sep:
                    raise ValueError(f"jitter_ms wants A:B (uniform range), got {v!r}")
                kw[k] = (float(lo), float(hi))
            else:
                raise ValueError(f"unknown chaos key {k!r}")
        c = Chaos(**kw)
        if c.jitter_ms[1] < c.jitter_ms[0]:
            raise ValueError(f"jitter_ms range inverted: {c.jitter_ms}")
        return c

    def _draw(self) -> float:
        with self._lock:
            return self._rng.random()

    def _sleep(self, seconds: float) -> None:
        """Sleep on the handler thread; a released chaos fails the forward."""
        if self._released.wait(seconds):
            raise ChaosDrop("chaos released: the node is stopping")

    def before_forward(self) -> None:
        """Apply chaos ahead of serving one forward, on its handler thread.
        Raises ChaosDrop to fail the request; may stall (stall_p) until
        released, or hard-exit the process (die_after)."""
        with self._lock:
            self._served += 1
            served = self._served
            crash = self.crash_after and served > self.crash_after and not self._crashed
            if crash:
                self._crashed = True
        if self.die_after and served > self.die_after:
            os._exit(17)  # a crash, not a shutdown: no tombstone gossip
        if self.crash_after and served > self.crash_after:
            if crash and self.on_crash is not None:
                self.on_crash()
            raise ChaosDrop(f"chaos crash_after (served {served})")
        if self.drop_after and served > self.drop_after:
            raise ChaosDrop(f"chaos drop_after (served {served})")
        if self.delay_ms > 0:
            self._sleep(self.delay_ms / 1e3)
        if self.block_ms > 0:
            self._sleep(self.block_ms / 1e3)
        lo, hi = self.jitter_ms
        if hi > 0:
            with self._lock:
                extra = self._rng.uniform(lo, hi)
            self._sleep(extra / 1e3)
        if self.stall_p > 0 and self._draw() < self.stall_p:
            with self._lock:
                self._stalled += 1
            try:
                self._sleep(STALL_S)
            finally:
                with self._lock:
                    self._stalled -= 1
        if self.drop > 0 and self._draw() < self.drop:
            raise ChaosDrop(f"chaos drop (p={self.drop})")

    def cancel_stalls(self) -> int:
        """Release every forward held in a chaos sleep (each fails with
        ChaosDrop), and every later one at once: the node's stop() and
        crash() call it, so no stalled handler thread outlives the node.
        Returns how many were stalled."""
        with self._lock:
            n = self._stalled
        self._released.set()
        return n
