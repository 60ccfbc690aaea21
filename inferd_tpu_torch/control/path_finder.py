"""Routing over the gossip store (port of inferd_tpu/control/path_finder.py):
the min-load node of a stage, with a retry loop over an empty stage and a
dead-peer cooldown, and the whole-chain route of a new session from the
long-lived D*-Lite planner (control/dstar.py).

Reads are local merges on the gossip store (control/dht.py): a pick or a
plan costs no network round trip. While a stage has no live replica,
find_best_node calls `on_empty_stage(stage)` before each retry; the node
passes its balancer's `adopt_stage` (control/balance.py), which may migrate
the node itself to that stage. The hook runs on the caller's thread, and
the caller must hold no lock that the migration takes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from inferd_tpu_torch.control.dstar import SwarmChainPlanner, node_cost
from inferd_tpu_torch.obs.canary import (
    ADMISSION_PENALTY, CACHE_AFFINITY_BONUS, OUTLIER_PENALTY, under_admission_watermark,
)

log = logging.getLogger(__name__)


class NoNodeForStage(Exception):
    pass


def node_addr(value: Dict[str, Any]) -> Tuple[str, int]:
    return (value["host"], int(value["port"]))


def _rank_key(value: Dict[str, Any], affinity: Any = None):
    """Sort key of one gossip record: load/cap plus the outlier penalty,
    load as the tie-break. `affinity` (an object with `depth_frac(value)`,
    new-session picks only) discounts a candidate holding the prompt's
    prefix by up to CACHE_AFFINITY_BONUS, unless it is shedding (then
    ADMISSION_PENALTY is added instead) or draining (no bonus)."""
    cap = max(int(value.get("cap", 1)), 1)
    load = float(value.get("load", 0))
    ratio = load / cap
    if value.get("outlier"):
        ratio += OUTLIER_PENALTY
    if affinity is not None:
        if under_admission_watermark(value):
            ratio += ADMISSION_PENALTY
        elif not value.get("draining"):
            try:
                ratio -= CACHE_AFFINITY_BONUS * float(affinity.depth_frac(value))
            except Exception:
                pass  # a malformed digest must never break routing
    return (ratio, load)


def ranked_nodes(
    stage_map: Dict[str, Dict[str, Any]], exclude: Optional[set] = None,
    affinity: Any = None,
) -> List[Tuple[str, Dict[str, Any]]]:
    """Every live candidate for a stage, best first. A `draining` replica is
    left out unless the stage has nothing else live; an `outlier` is
    penalized, never left out."""
    live = [
        (nid, value)
        for nid, value in stage_map.items()
        if not (exclude and nid in exclude)
    ]
    serving = [(nid, v) for nid, v in live if not v.get("draining")]
    pool = serving or live
    return sorted(pool, key=lambda item: _rank_key(item[1], affinity))


def min_load_node(
    stage_map: Dict[str, Dict[str, Any]], exclude: Optional[set] = None,
    affinity: Any = None,
):
    """The (node_id, value) of least load/cap (ranked_nodes' order)."""
    ranked = ranked_nodes(stage_map, exclude, affinity=affinity)
    if not ranked:
        raise NoNodeForStage("no live node for stage")
    return ranked[0]


def _ranked_view(value: Dict[str, Any], held: int, new_session: bool) -> Dict[str, Any]:
    """The record as find_best_node ranks it and find_best_chain plans over
    it: `held` sessions added to its load and, for a new session, a
    shedding replica's ADMISSION_PENALTY added in load/cap units."""
    extra = float(held)
    if new_session and under_admission_watermark(value):
        extra += ADMISSION_PENALTY * max(int(value.get("cap", 1)), 1)
    return dict(value, load=float(value.get("load", 0)) + extra) if extra else value


class PathFinder:
    """Routing decisions over the swarm store."""

    def __init__(
        self,
        dht,
        num_stages: int,
        on_empty_stage: Optional[Callable[[int], Any]] = None,
        retries: int = 3,
        retry_delay_s: float = 0.5,
        dead_cooldown_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.dht = dht
        self.num_stages = num_stages
        self.on_empty_stage = on_empty_stage
        self.retries = retries
        self.retry_delay_s = retry_delay_s
        self.dead_cooldown_s = dead_cooldown_s
        self._clock = clock
        self._sleep = sleep
        self._dead_until: Dict[str, float] = {}
        # the long-lived D*-Lite planner behind find_best_chain (gossip drift
        # between calls replans incrementally), and the lock its refresh,
        # chain and kill_node, and the cooldown map, are used under: the
        # relay's threads share them
        self.planner: Optional[SwarmChainPlanner] = None
        self._plan_lock = threading.Lock()

    def note_peer_dead(self, node_id: str) -> None:
        """A relay just saw `node_id` transport-dead: hold a cooldown so a
        stale gossip record cannot route into it until it expires, and fold
        the death into the live plan now (planner.kill_node)."""
        with self._plan_lock:
            self._dead_until[node_id] = self._clock() + self.dead_cooldown_s
            if self.planner is None:
                return
            try:
                self.planner.kill_node(node_id)
            except Exception:
                # the plan is advisory: a failed increment must not break the
                # relay; the next plan starts from a fresh build
                log.exception("planner kill_node failed; dropping the planner")
                self.planner = None

    def planner_stats(self) -> Optional[Dict[str, int]]:
        """The live planner's `stats` (a copy), or None before the first plan."""
        with self._plan_lock:
            return None if self.planner is None else dict(self.planner.stats)

    def cooling(self) -> set:
        """The replicas inside their dead-peer cooldown now."""
        now = self._clock()
        with self._plan_lock:
            self._dead_until = {n: t for n, t in self._dead_until.items() if t > now}
            return set(self._dead_until)

    def _without_cooling(
        self, snapshot: Dict[int, Dict[str, Dict[str, Any]]]
    ) -> Dict[int, Dict[str, Dict[str, Any]]]:
        """The snapshot less the replicas inside their cooldown, except where
        that would empty a stage (availability beats steering)."""
        cooling = self.cooling()
        if not cooling:
            return snapshot
        out: Dict[int, Dict[str, Dict[str, Any]]] = {}
        for s, stage_map in snapshot.items():
            n_cooling = sum(1 for n in stage_map if n in cooling)
            if n_cooling and n_cooling < len(stage_map):
                out[s] = {n: v for n, v in stage_map.items() if n not in cooling}
            else:
                out[s] = stage_map
        return out

    def find_ranked(
        self, stage: int, exclude: Optional[set] = None
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """Ranked live candidates for `stage`, best first: a pure gossip
        read, no retry loop."""
        return ranked_nodes(self.dht.get_stage(stage), exclude)

    def find_best_node(
        self, stage: int, exclude: Optional[set] = None,
        held: Optional[Dict[str, int]] = None, new_session: bool = False,
    ) -> Tuple[str, Dict[str, Any]]:
        """The min-load live node for `stage`, and its record. `held` (node
        id -> sessions the caller routed there and has not ended) is added
        to each record's gossiped load for the ranking: the caller's own
        picks are news the gossip has not carried yet. For a `new_session`
        a replica under its admission watermark (it would shed the session)
        ranks ADMISSION_PENALTY worse. While the stage has no node, call
        `on_empty_stage(stage)` (if set) and retry after retry_delay_s, up
        to `retries` times; then raise NoNodeForStage. A hook that returns
        True moved the caller itself to the stage: it is not called again,
        and the remaining attempts run without the waits (the caller, when
        it excludes itself, then serves the request; the reference waits
        them out)."""
        adopted = False
        for attempt in range(self.retries + 1):
            stage_map = self.dht.get_stage(stage)
            view = {n: _ranked_view(v, held.get(n, 0) if held else 0, new_session)
                    for n, v in stage_map.items()}
            try:
                nid, _ = min_load_node(view, exclude)
                return nid, stage_map[nid]
            except NoNodeForStage:
                if attempt == self.retries:
                    raise NoNodeForStage(f"no live node for stage {stage}") from None
                if self.on_empty_stage is not None and not adopted:
                    adopted = self.on_empty_stage(stage) is True
                if not adopted:
                    self._sleep(self.retry_delay_s)
        raise NoNodeForStage(f"stage {stage}")  # unreachable

    def find_best_chain(
        self, start_stage: int = 0, affinity: Any = None,
        held: Optional[Dict[str, int]] = None, new_session: bool = False,
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """The whole route start_stage..last, [(node_id, record), ...], from
        the long-lived D*-Lite planner over the layered stage graph (node
        cost: dstar.node_cost), outside the dead-peer cooldown where a stage
        allows. Each record is the one the store holds now.

        The planner plans over the records as find_best_node ranks them:
        `held` sessions added to each replica's load and, for a
        `new_session`, a shedding replica's ADMISSION_PENALTY (_ranked_view).
        Without either it plans over the gossip as is, as the reference
        does. When the planner fails on a degenerate graph, the greedy
        min-load pick per stage is the route (and the planner is rebuilt
        at the next call); an empty stage raises NoNodeForStage either way.

        `affinity` (an object with `depth_frac(record)`) re-ranks the ENTRY
        stage only, by node_cost with the affinity term: the layered graph
        is complete between layers, so the chain's cost decomposes per
        stage, and this is the optimum of the affinity-weighted graph
        without touching the planner's edges per session."""
        snapshot = self._without_cooling(self.dht.get_all(self.num_stages))
        view = snapshot
        if held or new_session:
            view = {s: {n: _ranked_view(v, held.get(n, 0) if held else 0, new_session)
                        for n, v in stage_map.items()}
                    for s, stage_map in snapshot.items()}
        with self._plan_lock:
            try:
                if self.planner is None or self.planner.start_stage != start_stage:
                    self.planner = SwarmChainPlanner(view, start_stage, self.num_stages)
                else:
                    self.planner.refresh(view)
                chain = [(nid, snapshot[s][nid]) for s, nid, _ in self.planner.chain()]
            except NoNodeForStage:
                raise
            except Exception as e:
                log.warning("D*-Lite chain planning failed (%s); greedy fallback", e)
                self.planner = None
                chain = []
                for stage in range(start_stage, self.num_stages):
                    if not view.get(stage):
                        raise NoNodeForStage(f"stage {stage}") from None
                    nid, _ = min_load_node(
                        view[stage], affinity=affinity if stage == start_stage else None)
                    chain.append((nid, snapshot[stage][nid]))
                return chain
        if affinity is not None and chain:
            entry = view.get(start_stage, {})
            if len(entry) > 1:
                best = min(entry, key=lambda n: node_cost(entry[n], affinity=affinity))
                if (best != chain[0][0]
                        and node_cost(entry[best], affinity=affinity)
                        < node_cost(entry[chain[0][0]], affinity=affinity)):
                    chain[0] = (best, snapshot[start_stage][best])
        return chain
