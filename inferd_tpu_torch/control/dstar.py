"""D*-Lite incremental shortest paths over the layered stage graph (port of
inferd_tpu/control/dstar.py).

States are (stage, node) pairs in a DAG from stage k to stage k+1, between a
START and a GOAL state; the cost of an edge is the cost of routing into its
destination node (`node_cost`: the hop, load/cap, the announced service
time and the flags a record gossips). `DStarLite` is Koenig and Likhachev's
D*-Lite (a backward search with g/rhs values and the km offset) over a
mutable graph: `update_edge` + `compute` replan after cost changes without
solving from scratch. `SwarmChainPlanner` keeps one such search alive
across gossip snapshots, so drifting costs, deaths, joins and a session
walking its chain are all increments; `best_chain_over_swarm` solves one
snapshot once.

Pure Python on the standard library. The priority queue is heapq with lazy
invalidation and an insertion counter as its tie-break, so for the same
snapshots and updates the port expands the same states in the same order
as the reference, and gives the same chain and the same `stats`.
"""

from __future__ import annotations

import heapq
import itertools
import math
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

from inferd_tpu_torch.obs.canary import (
    ADMISSION_PENALTY, CACHE_AFFINITY_BONUS, DRAINING_PENALTY, OUTLIER_PENALTY,
    under_admission_watermark,
)

State = Hashable
INF = math.inf


class MinPriorityQueue:
    """Heap with O(log n) insert/update/remove via lazy invalidation."""

    def __init__(self):
        self._heap: List[Tuple[Tuple[float, float], int, State]] = []
        self._entries: Dict[State, int] = {}  # state -> seq of its live entry
        self._seq = itertools.count()

    def insert(self, state: State, key: Tuple[float, float]) -> None:
        seq = next(self._seq)
        self._entries[state] = seq
        heapq.heappush(self._heap, (key, seq, state))

    update = insert

    def remove(self, state: State) -> None:
        self._entries.pop(state, None)

    def __contains__(self, state: State) -> bool:
        return state in self._entries

    def _prune(self) -> None:
        while self._heap:
            key, seq, state = self._heap[0]
            if self._entries.get(state) == seq:
                return
            heapq.heappop(self._heap)

    def top_key(self) -> Tuple[float, float]:
        self._prune()
        if not self._heap:
            return (INF, INF)
        return self._heap[0][0]

    def pop(self) -> Optional[Tuple[State, Tuple[float, float]]]:
        """Pop the min entry: (state, the key it was queued with)."""
        self._prune()
        if not self._heap:
            return None
        key, _, state = heapq.heappop(self._heap)
        self._entries.pop(state, None)
        return state, key

    def __len__(self) -> int:
        return len(self._entries)


class Graph:
    """Mutable directed graph with per-edge costs."""

    def __init__(self):
        self._succ: Dict[State, Dict[State, float]] = {}
        self._pred: Dict[State, Dict[State, float]] = {}

    def add_edge(self, u: State, v: State, cost: float) -> None:
        self._succ.setdefault(u, {})[v] = cost
        self._pred.setdefault(v, {})[u] = cost
        self._succ.setdefault(v, {})
        self._pred.setdefault(u, {})

    def set_cost(self, u: State, v: State, cost: float) -> None:
        self.add_edge(u, v, cost)

    def cost(self, u: State, v: State) -> float:
        return self._succ.get(u, {}).get(v, INF)

    def succ(self, u: State) -> Iterable[Tuple[State, float]]:
        return self._succ.get(u, {}).items()

    def pred(self, v: State) -> Iterable[Tuple[State, float]]:
        return self._pred.get(v, {}).items()

    def states(self) -> Iterable[State]:
        return self._succ.keys()


class DStarLite:
    """Incremental shortest path start -> goal under edge-cost updates.

    compute() establishes the solution; update_edge() + compute() replan,
    touching only the affected states; advance_start() moves the agent
    along, the km offset keeping the queued keys comparable."""

    def __init__(self, graph: Graph, start: State, goal: State,
                 heuristic: Optional[Callable[[State, State], float]] = None):
        self.graph = graph
        self.start = start
        self.goal = goal
        self.h = heuristic or (lambda a, b: 0.0)
        self.km = 0.0
        self.g: Dict[State, float] = {}
        self.rhs: Dict[State, float] = {}
        self.U = MinPriorityQueue()
        self._last_start = start
        # vertex expansions over every compute(), and in the latest one: what
        # tells an incremental replan from a solve from scratch
        self.expansions = 0
        self.last_compute_expansions = 0
        self.rhs[goal] = 0.0
        self.U.insert(goal, self._key(goal))

    def _g(self, s: State) -> float:
        return self.g.get(s, INF)

    def _rhs(self, s: State) -> float:
        return self.rhs.get(s, INF)

    def _key(self, s: State) -> Tuple[float, float]:
        m = min(self._g(s), self._rhs(s))
        return (m + self.h(self.start, s) + self.km, m)

    def _update_vertex(self, u: State) -> None:
        if u != self.goal:
            # the replan's hot loop: a plain min over the successors
            g = self.g
            best = INF
            for v, c in self.graph.succ(u):
                val = c + g.get(v, INF)
                if val < best:
                    best = val
            self.rhs[u] = best
        if u in self.U:
            self.U.remove(u)
        if self._g(u) != self._rhs(u):
            self.U.insert(u, self._key(u))

    def compute(self) -> None:
        """ComputeShortestPath: relax over- and under-consistent states until
        the start is consistent and no queued key is below its own."""
        guard = 0
        limit = 10_000_000
        self.last_compute_expansions = 0
        while (self.U.top_key() < self._key(self.start)
               or self._rhs(self.start) != self._g(self.start)):
            guard += 1
            if guard > limit:
                raise RuntimeError("D*-Lite failed to converge")
            popped = self.U.pop()
            if popped is None:
                break
            u, k_old = popped
            k_new = self._key(u)
            if k_old < k_new:  # a stale key (km advanced since it was queued)
                self.U.insert(u, k_new)
                continue
            self.expansions += 1
            self.last_compute_expansions += 1
            if self._g(u) > self._rhs(u):
                self.g[u] = self._rhs(u)
                for p, _ in self.graph.pred(u):
                    self._update_vertex(p)
            else:
                self.g[u] = INF
                self._update_vertex(u)
                for p, _ in self.graph.pred(u):
                    self._update_vertex(p)

    def update_edge(self, u: State, v: State, new_cost: float) -> None:
        """Change the cost of edge (u, v) and mark what it affects; call
        compute() afterwards (after as many updates as you like)."""
        self.graph.set_cost(u, v, new_cost)
        self._update_vertex(u)

    def advance_start(self, new_start: State) -> None:
        """Move the agent (the km offset keeps the queued keys comparable)."""
        self.km += self.h(self._last_start, new_start)
        self._last_start = new_start
        self.start = new_start

    def path(self) -> List[State]:
        """Greedy extraction start -> goal over cost + g; empty when the goal
        is unreachable."""
        if self._g(self.start) == INF:
            return []
        out = [self.start]
        cur = self.start
        seen = {cur}
        while cur != self.goal:
            nxt = None
            best = INF
            for v, c in self.graph.succ(cur):
                val = c + self._g(v)
                if val < best:
                    best, nxt = val, v
            if nxt is None or nxt in seen:
                return []
            out.append(nxt)
            seen.add(nxt)
            cur = nxt
        return out


# -- the swarm's layered graph --------------------------------------------------

START = ("start",)
GOAL = ("goal",)

#: `hop_p99_ms` this many milliseconds weighs like one extra hop. Looser
#: than svc_ms's 100 ms: a relay's trailing p99 includes the downstream
#: stage's compute and queueing, a tail and not a mean, and at full weight
#: beside svc_ms one slow window would outweigh every load term.
HOP_P99_NORM_MS = 200.0


def node_cost(value: Dict[str, Any], lat_norm_ms: float = 100.0,
              affinity: Any = None) -> float:
    """The cost of routing INTO a node: 1 (the hop) + load/cap + svc_ms /
    lat_norm_ms (its announced service-time EWMA; lat_norm_ms of it weighs
    like one more hop) + hop_p99_ms / HOP_P99_NORM_MS (a trailing relay p99,
    which the port gossips from A9 on), + OUTLIER_PENALTY for a self-flagged
    outlier. A record without the latency keys costs load only.

    `affinity` (an object with `depth_frac(record)`, per-session entry
    routing only: find_best_chain re-ranks the entry stage with it, never
    the long-lived planner's edges) discounts a candidate holding the
    session's prefix by up to CACHE_AFFINITY_BONUS, unless it is under its
    admission watermark (then ADMISSION_PENALTY is added instead) or
    draining (no bonus). A draining replica costs DRAINING_PENALTY more:
    finite, so a stage whose every replica drains still yields a chain. The
    base cost is >= 1 and the bonus at most 0.5, so every edge stays
    positive, as D*-Lite needs."""
    cap = max(int(value.get("cap", 1)), 1)
    c = 1.0 + float(value.get("load", 0)) / cap
    svc = value.get("svc_ms")
    if svc is not None:
        c += float(svc) / lat_norm_ms
    hop99 = value.get("hop_p99_ms")
    if hop99 is not None:
        c += float(hop99) / HOP_P99_NORM_MS
    if value.get("outlier"):
        c += OUTLIER_PENALTY
    if affinity is not None:
        if under_admission_watermark(value):
            c += ADMISSION_PENALTY
        elif not value.get("draining"):
            try:
                c -= CACHE_AFFINITY_BONUS * float(affinity.depth_frac(value))
            except Exception:
                pass  # a malformed digest must never break routing
    if value.get("draining"):
        c += DRAINING_PENALTY
    return c


def build_layered_graph(
    snapshot: Dict[int, Dict[str, Dict[str, Any]]], start_stage: int, num_stages: int
) -> Graph:
    """The layered DAG of a swarm snapshot: START -> the nodes of
    start_stage -> ... -> the last stage's nodes -> GOAL. An empty stage
    stops it short of GOAL."""
    g = Graph()
    prev: List[Tuple[State, Dict[str, Any]]] = [(START, {})]
    for s in range(start_stage, num_stages):
        cur = []
        for node_id, value in snapshot.get(s, {}).items():
            st = ("s", s, node_id)
            for p, _ in prev:
                g.add_edge(p, st, node_cost(value))
            cur.append((st, value))
        if not cur:
            return g  # unreachable: the caller finds no path
        prev = cur
    for p, _ in prev:
        g.add_edge(p, GOAL, 0.0)
    return g


def best_chain_over_swarm(
    snapshot: Dict[int, Dict[str, Dict[str, Any]]], start_stage: int, num_stages: int
) -> List[Tuple[str, Dict[str, Any]]]:
    """The cheapest chain over stages start_stage..num_stages-1 of one
    snapshot, [(node_id, record), ...]; raises NoNodeForStage when a stage
    is empty."""
    from inferd_tpu_torch.control.path_finder import NoNodeForStage

    g = build_layered_graph(snapshot, start_stage, num_stages)
    planner = DStarLite(g, START, GOAL)
    planner.compute()
    p = planner.path()
    if not p:
        raise NoNodeForStage(f"no complete chain from stage {start_stage}")
    out = []
    for st in p:
        if st in (START, GOAL):
            continue
        _, s, node_id = st
        out.append((node_id, snapshot[s][node_id]))
    return out


class SwarmChainPlanner:
    """A long-lived incremental chain planner over live swarm snapshots: ONE
    DStarLite kept consistent as the gossip view changes.

      * cost drift (load, svc_ms) -> `update_edge` on the edges into the
        changed node and an incremental compute();
      * a node's death or expiry -> the same with cost INF (a flapper's
        return is a cost update too); `kill_node` applies it the moment a
        relay sees the peer dead, before its record expires;
      * a new node on a stage that was live at build -> `_add_node` splices
        its state and edges in; only a node that brings back a stage EMPTY
        at build rebuilds (the graph never reached GOAL through it);
      * a session walking its chain -> `advance(stage, node_id)` moves the
        agent, so replans touch only the stages ahead.

    `stats` counts builds, refreshes, cost updates, node additions, kills,
    computes, and the expansions of builds against those of replans.

    Not safe to share between threads: its heap and g/rhs maps change on
    every call (PathFinder serializes its planner under a lock)."""

    def __init__(
        self,
        snapshot: Dict[int, Dict[str, Dict[str, Any]]],
        start_stage: int,
        num_stages: int,
    ):
        self.start_stage = start_stage
        self.num_stages = num_stages
        self.stats: Dict[str, int] = {
            "builds": 0,
            "refreshes": 0,
            "cost_updates": 0,
            "node_adds": 0,
            "kills": 0,
            "computes": 0,
            "expansions_build": 0,
            "expansions_replan": 0,
        }
        self._agent: State = START
        self._build(snapshot)

    def _build(self, snapshot) -> None:
        self._snapshot = {s: dict(m) for s, m in snapshot.items()}
        self._costs: Dict[Tuple[int, str], float] = {
            (s, nid): node_cost(v)
            for s, m in self._snapshot.items()
            for nid, v in m.items()
            if self.start_stage <= s < self.num_stages
        }
        g = build_layered_graph(snapshot, self.start_stage, self.num_stages)
        # a stage empty at build stops the graph short of GOAL: there is no
        # layer to splice a new node onto, so refresh() rebuilds until the
        # graph is connected again
        self._connected = any(True for _ in g.pred(GOAL))
        self.planner = DStarLite(g, self._agent, GOAL)
        self.planner.compute()
        self.stats["builds"] += 1
        self.stats["computes"] += 1
        self.stats["expansions_build"] += self.planner.last_compute_expansions

    def _add_node(self, s: int, nid: str, value: Dict[str, Any]) -> None:
        """Splice one new node into the live graph: edges in from every state
        of stage s-1 (or START), out to every state of stage s+1 (or GOAL),
        then one _update_vertex; compute() relaxes only as far as the
        addition improves the plan."""
        g = self.planner.graph
        st = ("s", s, nid)
        c = node_cost(value)
        if s == self.start_stage:
            preds: List[State] = [START]
        else:
            preds = [("s", s - 1, p) for p in self._snapshot.get(s - 1, {})]
        for p in preds:
            g.add_edge(p, st, c)
        if s == self.num_stages - 1:
            g.add_edge(st, GOAL, 0.0)
        else:
            for nid2 in self._snapshot.get(s + 1, {}):
                g.add_edge(st, ("s", s + 1, nid2), self._costs[(s + 1, nid2)])
        self._costs[(s, nid)] = c
        self._snapshot.setdefault(s, {})[nid] = value
        self.planner._update_vertex(st)
        self.stats["node_adds"] += 1

    def kill_node(self, node_id: str) -> bool:
        """A relay just saw `node_id` transport-dead: INF on its in-edges now,
        the update a later refresh() would apply once its record expired.
        True when the node was in the plan's remaining stages."""
        agent_stage = -1 if self._agent == START else self._agent[1]
        hit = False
        for (s, nid), old in self._costs.items():
            if nid != node_id or s <= agent_stage or old == INF:
                continue
            st = ("s", s, nid)
            for u, _ in list(self.planner.graph.pred(st)):
                self.planner.update_edge(u, st, INF)
                self.stats["cost_updates"] += 1
            self._costs[(s, nid)] = INF
            hit = True
        if hit:
            self.stats["kills"] += 1
            self.planner.compute()
            self.stats["computes"] += 1
            self.stats["expansions_replan"] += self.planner.last_compute_expansions
        return hit

    def refresh(self, snapshot: Dict[int, Dict[str, Dict[str, Any]]]) -> bool:
        """Fold a fresh gossip snapshot into the plan; True when a cost
        changed (compute() ran again)."""
        self.stats["refreshes"] += 1
        agent_stage = -1 if self._agent == START else self._agent[1]
        new_nodes = sorted(
            (s, nid)
            for s, m in snapshot.items()
            if self.start_stage <= s < self.num_stages and s > agent_stage
            for nid in m
            if (s, nid) not in self._costs
        )
        dirty = False
        if new_nodes:
            if not self._connected or any(not self._snapshot.get(s) for s, _ in new_nodes):
                # a node that brings back a stage empty at build: nothing to
                # splice onto, rebuild (the agent's state exists in the new
                # graph too)
                self._build(snapshot)
                return True
            # ascending stages: a join at stage s-1 in the same refresh is in
            # _snapshot before stage s wires its in-edges
            for s, nid in new_nodes:
                self._add_node(s, nid, snapshot[s][nid])
            dirty = True
        for (s, nid), old in list(self._costs.items()):
            if s <= agent_stage:
                continue  # committed hops: their costs no longer matter
            value = snapshot.get(s, {}).get(nid)
            new = INF if value is None else node_cost(value)
            if new != old:
                st = ("s", s, nid)
                for u, _ in list(self.planner.graph.pred(st)):
                    self.planner.update_edge(u, st, new)
                    self.stats["cost_updates"] += 1
                self._costs[(s, nid)] = new
                if value is not None:
                    self._snapshot.setdefault(s, {})[nid] = value
                dirty = True
        if dirty:
            self.planner.compute()
            self.stats["computes"] += 1
            self.stats["expansions_replan"] += self.planner.last_compute_expansions
        return dirty

    def advance(self, stage: int, node_id: str) -> None:
        """The session committed its hop into `node_id` at `stage` (its KV
        lives there now): move the agent, so replans touch only the stages
        ahead."""
        self._agent = ("s", stage, node_id)
        self.planner.advance_start(self._agent)
        # consistent again from the new start: nothing to do when the agent
        # stayed on the plan, a bounded solve when it was sent elsewhere
        self.planner.compute()
        self.stats["expansions_replan"] += self.planner.last_compute_expansions

    def chain(self) -> List[Tuple[int, str, Dict[str, Any]]]:
        """The remaining chain from the agent, [(stage, node_id, record),
        ...]; raises NoNodeForStage when no complete chain exists."""
        from inferd_tpu_torch.control.path_finder import NoNodeForStage

        p = self.planner.path()
        out = []
        for st in p:
            if st in (START, GOAL) or st == self._agent:
                continue
            _, s, nid = st
            value = self._snapshot.get(s, {}).get(nid)
            if value is None:
                raise NoNodeForStage(f"planned node {nid} for stage {s} vanished")
            out.append((s, nid, value))
        first = self.start_stage if self._agent == START else self._agent[1] + 1
        if [s for s, _, _ in out] != list(range(first, self.num_stages)):
            raise NoNodeForStage(
                f"no complete chain from stage {first} "
                f"(got stages {[s for s, _, _ in out]})"
            )
        return out
