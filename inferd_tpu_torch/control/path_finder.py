"""Next-hop routing: the min-load node of a stage, with a retry loop over an
empty stage and a dead-peer cooldown (port of the min-load half of
inferd_tpu/control/path_finder.py).

Reads are local merges on the gossip store (control/dht.py): a pick costs
no network round trip. The whole-chain D*-Lite router (`find_best_chain`)
and the empty-stage adoption hook that the balancer supplies wait for the
port's elasticity slice; here `on_empty_stage` is whatever the caller
passes (the node passes none).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from inferd_tpu_torch.obs.canary import (
    ADMISSION_PENALTY, CACHE_AFFINITY_BONUS, OUTLIER_PENALTY, under_admission_watermark,
)


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
    """The record as find_best_node ranks it: `held` sessions added to its
    load and, for a new session, a shedding replica's ADMISSION_PENALTY
    added in load/cap units."""
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

    def note_peer_dead(self, node_id: str) -> None:
        """A relay just saw `node_id` transport-dead: hold a cooldown so a
        stale gossip record cannot route into it until it expires."""
        self._dead_until[node_id] = self._clock() + self.dead_cooldown_s

    def cooling(self) -> set:
        """The replicas inside their dead-peer cooldown now."""
        now = self._clock()
        self._dead_until = {n: t for n, t in self._dead_until.items() if t > now}
        return set(self._dead_until)

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
        ranks ADMISSION_PENALTY worse, as the reference's route planner
        charges it. While the stage has no node, call `on_empty_stage(stage)`
        (if set) and retry after retry_delay_s, up to `retries` times; then
        raise NoNodeForStage."""
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
                if self.on_empty_stage is not None:
                    self.on_empty_stage(stage)
                self._sleep(self.retry_delay_s)
        raise NoNodeForStage(f"stage {stage}")  # unreachable
