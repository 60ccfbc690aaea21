"""Simulator engine: virtual clock, ordered event heap, datagram network
(port of inferd_tpu/sim/core.py).

Everything that makes the control plane non-deterministic is owned here
and seeded: time (a virtual clock the event heap advances), the RNG (one
root `random.Random` plus stable per-actor children), and the network (an
in-process datagram fabric with a seeded latency and loss model that plugs
into SwarmDHT's `transport` seam). The control-plane modules under test run
unmodified: they read the injected clock and rng.

Event ordering is total: the heap orders by (virtual time, insertion
sequence), callbacks scheduled at equal times run in scheduling order, and
no wall-clock read exists anywhere on the path, so `same seed + same
scenario -> byte-identical trace` is a property the tests assert.

Two differences from the reference, both of idiom. The port's control
plane is synchronous (`Balancer.rebalance_once`, `adopt_stage` and
`_migrate` are plain methods), so the simulator calls it directly and has
no `run_coro`. And `SimNet` parses frames with the port's
`utils/msgpack_lite`, which reads the reference's msgpack frames to the
same structures.
"""

from __future__ import annotations

import heapq
import itertools
import random
from typing import Any, Callable, Dict, List, Tuple

from inferd_tpu_torch.utils import msgpack_lite

#: Virtual epoch: a fixed wall-clock-looking origin, so record timestamps
#: resemble production values and never depend on the host.
SIM_EPOCH = 1_700_000_000.0


class SimTimer:
    """Cancellation handle for a scheduled callback."""

    __slots__ = ("when", "cancelled")

    def __init__(self, when: float):
        self.when = when
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class SimLoop:
    """Virtual-clock discrete-event loop."""

    def __init__(self, seed: int, start_time: float = SIM_EPOCH):
        self.seed = int(seed)
        self.now = float(start_time)
        self.rng = random.Random(f"inferd-sim:{seed}")
        self._heap: List[Tuple[float, int, SimTimer, Callable, tuple]] = []
        self._seq = itertools.count()
        self.fired = 0

    def child_rng(self, name: str) -> random.Random:
        """Stable per-actor RNG: independent of scheduling order, fully
        determined by (seed, actor name)."""
        return random.Random(f"inferd-sim:{self.seed}:{name}")

    def time(self) -> float:
        """Injected in place of time.time() and time.monotonic(): one
        virtual clock for the whole fleet (no skew)."""
        return self.now

    def call_at(self, when: float, fn: Callable, *args: Any) -> SimTimer:
        t = SimTimer(max(when, self.now))
        heapq.heappush(self._heap, (t.when, next(self._seq), t, fn, args))
        return t

    def call_after(self, delay: float, fn: Callable, *args: Any) -> SimTimer:
        return self.call_at(self.now + max(0.0, delay), fn, *args)

    def run_until(self, t_end: float, max_events: int = 5_000_000) -> None:
        """Advance virtual time, firing every event due up to t_end.
        `max_events` is a runaway backstop against a zero-delay
        self-rescheduling loop spinning at one instant."""
        fired = 0
        while self._heap and self._heap[0][0] <= t_end:
            when, _, timer, fn, args = heapq.heappop(self._heap)
            if timer.cancelled:
                continue
            self.now = when
            fired += 1
            self.fired += 1
            if fired > max_events:
                raise RuntimeError(f"sim exceeded {max_events} events before t={t_end}")
            fn(*args)
        self.now = max(self.now, t_end)


class SimNet:
    """In-process datagram fabric behind SwarmDHT's `transport` seam.

    `sendto(src_dht, data, addr)` mirrors the UDP sendto contract: the
    frame's bytes (the msgpack bytes SwarmDHT packed, so a serialization
    fault stays observable) go in, a seeded latency sample and loss roll
    decide delivery, and the destination's `_on_message` runs at the
    delivery instant with the sender's (host, port). Zones model
    partitions: a blocked zone pair drops every datagram between them."""

    def __init__(
        self,
        loop: SimLoop,
        latency_ms: Tuple[float, float] = (2.0, 20.0),
        drop_p: float = 0.0,
    ):
        self.loop = loop
        self.latency_ms = (float(latency_ms[0]), float(latency_ms[1]))
        self.drop_p = float(drop_p)
        self._rng = loop.child_rng("net")
        self._dhts: Dict[Tuple[str, int], Any] = {}
        self._zone: Dict[Tuple[str, int], int] = {}
        self._blocked: set = set()
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.bytes_sent = 0
        # parse-once memo: a fanout round sends ONE frame to K targets, and
        # parsing it K times is the main cost of a large fleet (the more so
        # with a pure-Python codec). Receivers only read the parsed message
        # (the merge copies what it keeps), so sharing it is safe. Keyed by
        # the bytes (CPython caches their hash), a bounded FIFO.
        self._parsed: "dict[bytes, Any]" = {}

    def register(self, dht: Any, zone: int = 0) -> None:
        self._dhts[(dht.host, dht.port)] = dht
        self._zone[(dht.host, dht.port)] = int(zone)

    def set_partition(self, zone_a: int, zone_b: int, blocked: bool = True) -> None:
        key = (min(zone_a, zone_b), max(zone_a, zone_b))
        if blocked:
            self._blocked.add(key)
        else:
            self._blocked.discard(key)

    def _latency_s(self) -> float:
        lo, hi = self.latency_ms
        return (lo + (hi - lo) * self._rng.random()) / 1e3

    def sendto(self, src_dht: Any, data: bytes, addr: Tuple[str, int]) -> None:
        self.sent += 1
        self.bytes_sent += len(data)
        dst = self._dhts.get(tuple(addr))
        src_addr = (src_dht.host, src_dht.port)
        if dst is None or not dst._started:
            self.dropped += 1
            return
        za = self._zone.get(src_addr, 0)
        zb = self._zone.get(tuple(addr), 0)
        if (min(za, zb), max(za, zb)) in self._blocked:
            self.dropped += 1
            return
        if self.drop_p > 0.0 and self._rng.random() < self.drop_p:
            self.dropped += 1
            return
        self.loop.call_after(self._latency_s(), self._deliver, data, src_addr, dst)

    def _deliver(self, data: bytes, src_addr: Tuple[str, int], dst: Any) -> None:
        if not dst._started:
            self.dropped += 1
            return
        msg = self._parsed.get(data)
        if msg is None:
            try:
                msg = msgpack_lite.unpackb(data)
            except Exception:
                self.dropped += 1
                return
            if len(self._parsed) >= 64:
                self._parsed.pop(next(iter(self._parsed)))
            self._parsed[data] = msg
        self.delivered += 1
        dst._on_message(msg, src_addr)
