"""Load-driven elasticity: self-migration between pipeline stages (port of
inferd_tpu/control/balance.py).

Periodically a node reads the whole gossip map and, if its stage is among
the min-load stages while another stage carries the max load and its own
stage keeps another serving replica, migrates there through the node's
`change_stage` (load the target stage's checkpoint from the shared parts
store, warm it up, swap the executor, re-announce).

`adopt_stage` is empty-stage adoption: the node's PathFinder calls it as
its `on_empty_stage` hook when a stage has no live replica (node-failure
recovery), on the caller's thread.

Migrations are cost-aware: a stage swap reloads a checkpoint, captures the
new stage's graphs and strands every resident session's KV, so a move must
buy a projected imbalance improvement larger than `migration_cost` (in
load/cap-ratio units), and moves are spaced by `min_dwell_s`. Every
migration strictly shrinks the projected imbalance by more than the debt it
creates, so a ping-pong pair can never both qualify.

Threads, not tasks: `start()` runs the loop on a daemon thread, and
`_migrating` is a `threading.Lock` taken without blocking, so a second
migration while one runs returns False. `on_event(etype, **attrs)` is the
decision's record (the node counts `stage.adopt.<reason>`); a hook that
raises is ignored. `clock` and `rng` are injectable for deterministic
tests (defaults: time.monotonic and the process RNG).
"""

from __future__ import annotations

import logging
import math
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

log = logging.getLogger(__name__)

Snapshot = Dict[int, Dict[str, Dict[str, Any]]]


def serving_nodes(stage_map: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """The replicas of one stage that serve: a `draining` one (POST /drain:
    finishing residents, admitting nothing) is left out of load accounting,
    or a drain wave would inflate its stage's apparent load and attract a
    migration toward capacity that is about to leave."""
    return {nid: v for nid, v in stage_map.items() if not v.get("draining")}


def stage_loads(snapshot: Snapshot) -> Dict[int, float]:
    """Total load/cap ratio per stage over its serving replicas; a stage with
    no serving capacity (empty, or all draining) reads infinitely starved."""
    out: Dict[int, float] = {}
    for stage, nodes in snapshot.items():
        serving = serving_nodes(nodes)
        cap = sum(max(int(v.get("cap", 1)), 1) for v in serving.values())
        load = sum(float(v.get("load", 0)) for v in serving.values())
        out[stage] = load / cap if cap else float("inf")
    return out


class Balancer:
    """Periodic self-rebalancing for one node."""

    def __init__(
        self,
        dht,
        num_stages: int,
        get_own_stage: Callable[[], int],
        change_stage: Callable[[int], None],
        period_s: float = 10.0,
        imbalance_threshold: float = 0.5,
        min_load_tol: float = 0.01,
        migration_cost: float = 0.25,
        min_dwell_s: float = 30.0,
        on_event: Optional[Callable[..., Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        self.dht = dht
        self.num_stages = num_stages
        self.get_own_stage = get_own_stage
        self.change_stage = change_stage
        self.period_s = period_s
        self.imbalance_threshold = imbalance_threshold
        # a node is migration-eligible when its stage sits within
        # min_load_tol of the min-load stage: exact equality would let two
        # near-equal min stages deadlock while a hot stage starves
        self.min_load_tol = min_load_tol
        self.migration_cost = migration_cost
        self.min_dwell_s = min_dwell_s
        self.on_event = on_event
        self._clock = clock
        self._rng: Any = rng if rng is not None else random
        self._last_migrate_ts = -math.inf
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._migrating = threading.Lock()

    def _emit(self, etype: str, **attrs: Any) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(etype, **attrs)
        except Exception:
            pass  # the record must never fail the decision it records

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="balancer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the loop; a migration it runs finishes first (bounded by the
        join's timeout: the thread is a daemon)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30)

    def _loop(self) -> None:
        # a jittered period, so replicas do not all decide in lockstep
        while not self._stop.wait(self.period_s * (0.75 + 0.5 * self._rng.random())):
            try:
                self.rebalance_once()
            except Exception:
                log.exception("rebalance iteration failed")

    # -- decisions ------------------------------------------------------------

    def _adopt_allowed(self, snapshot: Snapshot, own_stage: int, stage: int) -> bool:
        """The guard of every empty-stage adoption (the periodic sweep and
        the PathFinder hook): `stage` is empty in this view, this node's
        stage keeps another serving replica, and this node is the
        lexicographically smallest of every stage's eligible donors
        fleet-wide (a per-stage min would let one replica of each donor
        stage adopt at once). Every check reads the same snapshot, so a
        peer that still sees the adopter's old record sees it as the min
        donor too, and one that sees its new record sees the stage served."""
        if stage == own_stage:
            return False
        if snapshot.get(stage):
            return False  # someone else already serves it
        own_serving = serving_nodes(snapshot.get(own_stage, {}))
        if len(own_serving) <= 1:
            return False
        own_id = getattr(self.dht, "node_id", None)
        if own_id is not None:
            donors = [
                nid
                for s, stage_map in snapshot.items()
                if s != stage
                for serving in (serving_nodes(stage_map),)
                if len(serving) > 1
                for nid in serving
            ]
            if donors and own_id != min(donors):
                return False
        return True

    def _projected_gain(self, snapshot: Snapshot, loads: Dict[int, float],
                        own_stage: int, target: int) -> float:
        """The imbalance improvement (before minus after, in load/cap-ratio
        units) of moving this node's capacity from its stage to `target`,
        projected conservatively: its stage keeps its whole load on the
        remaining capacity, the target's load spreads over its capacity plus
        this node's. A starved target projects an infinite gain; starved
        stages elsewhere are left out of the spread (adoption's business),
        or an unrelated all-draining stage would make every gain infinite."""
        def spread(vals: Dict[int, float]) -> float:
            finite = [v for v in vals.values() if not math.isinf(v)]
            return (max(finite) - min(finite)) if finite else 0.0

        if math.isinf(loads.get(target, 0.0)):
            return math.inf
        own_id = getattr(self.dht, "node_id", None)
        own_rec = snapshot.get(own_stage, {}).get(own_id, {}) if own_id else {}
        own_cap = max(int(own_rec.get("cap", 1)), 1)

        def totals(stage: int):
            serving = serving_nodes(snapshot.get(stage, {}))
            cap = sum(max(int(v.get("cap", 1)), 1) for v in serving.values())
            load = sum(float(v.get("load", 0)) for v in serving.values())
            return load, cap

        load_own, cap_own = totals(own_stage)
        load_tgt, cap_tgt = totals(target)
        rem = cap_own - own_cap
        if rem <= 0:
            return -math.inf  # the move would abandon its stage's capacity
        after = dict(loads)
        after[own_stage] = load_own / rem
        after[target] = load_tgt / (cap_tgt + own_cap)
        return spread(loads) - spread(after)

    def rebalance_once(self) -> bool:
        """One decision step; True if this node migrated."""
        if self._migrating.locked():
            return False
        snapshot = self.dht.get_all(self.num_stages)
        own_stage = self.get_own_stage()
        own_serving = serving_nodes(snapshot.get(own_stage, {}))
        if len(own_serving) <= 1:
            return False  # never abandon a stage (it would break the pipeline)

        loads = stage_loads(snapshot)
        # a stage with no live replica is adopted, through the same min-id
        # tie-break as the PathFinder hook
        for s in range(self.num_stages):
            if not snapshot.get(s) and self._adopt_allowed(snapshot, own_stage, s):
                self._emit("stage.adopt", stage=s, reason="empty_stage", own_stage=own_stage)
                return self._migrate(s)

        # starved stages (empty, or all draining) read inf and belong to the
        # adoption path alone: winning the max-load pick, they would draw
        # every replica's tick into the hole at once
        finite = {s: v for s, v in loads.items() if not math.isinf(v)}
        if len(finite) < 2 or own_stage not in finite:
            return False
        smax = max(finite, key=finite.get)
        smin = min(finite, key=finite.get)
        if smax == own_stage:
            return False
        # only from a (tolerance-)min-load stage toward the max-load stage,
        # and only when the imbalance is material
        if loads[own_stage] - loads[smin] > self.min_load_tol:
            return False
        imbalance = loads[smax] - loads[own_stage]
        if imbalance < self.imbalance_threshold:
            return False
        # anti-herd: only the lexicographically smallest serving replica of
        # the stage moves per round
        own_id = getattr(self.dht, "node_id", None)
        if own_id is not None and own_id != min(own_serving):
            return False
        # cost-aware: worth its debt, and recent movers sit out
        if self._clock() - self._last_migrate_ts < self.min_dwell_s:
            return False
        gain = self._projected_gain(snapshot, loads, own_stage, smax)
        if gain <= self.migration_cost:
            return False
        self._emit("stage.adopt", stage=smax, reason="rebalance", own_stage=own_stage,
                   imbalance=round(imbalance, 3),
                   gain=None if math.isinf(gain) else round(gain, 3))
        return self._migrate(smax)

    def adopt_stage(self, stage: int) -> bool:
        """The empty-stage hook for PathFinder: move this node to `stage` if
        the adoption guard allows it. Losers return False, and their retry
        loop re-reads gossip, which soon shows the stage served."""
        snapshot = self.dht.get_all(self.num_stages)
        own_stage = self.get_own_stage()
        if not self._adopt_allowed(snapshot, own_stage, stage):
            return False
        self._emit("stage.adopt", stage=stage, reason="path_finder_empty_stage",
                   own_stage=own_stage)
        return self._migrate(stage)

    def _migrate(self, target_stage: int) -> bool:
        if not self._migrating.acquire(blocking=False):
            return False  # a migration is running: this one is not needed
        try:
            own = self.get_own_stage()
            if target_stage == own:
                return False
            log.info("balancer: migrating stage %d -> %d", own, target_stage)
            self.change_stage(target_stage)
            self._last_migrate_ts = self._clock()
            return True
        finally:
            self._migrating.release()
