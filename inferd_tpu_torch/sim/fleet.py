"""Virtual fleet: replicas, routers, workload, with the port's control
code inside (port of inferd_tpu/sim/fleet.py).

A `SimReplica` owns a REAL `SwarmDHT` (over the in-process SimNet
transport) and a REAL `Balancer`; a `SimRouter` owns a real `PathFinder`
whose long-lived D*-Lite `SwarmChainPlanner` replans incrementally as
gossip drifts; the optional controller runs the real `AutoScaler`; retry
pacing draws from the real `utils.retry` budgets. Every one of them runs
on the loop's virtual clock and seeded RNGs; none is started (no thread,
no socket). What the simulator
models — service times, KV block pools, wire latency, churn — is the
ENVIRONMENT those components act on; every decision under test
(merge/TTL/anti-entropy, migrate/adopt, plan/replan, scale) is
production code.

Load/latency model (deliberately simple, as the reference's):
a replica's per-step service time is `base_svc_ms * degrade * (1 +
load/cap)`; a session occupies one load unit and `blocks` KV blocks on
every replica of its chain for its whole duration; session duration is
(prefill-chunks + new tokens) x the chain's per-step latency sampled at
admission. Simple, but it closes the loop that matters: load shifts
gossip, gossip shifts routing and balancing, and those shift load.
"""

from __future__ import annotations

import heapq as _heapq
import json
import math
from collections import OrderedDict, defaultdict, deque
from hashlib import blake2b
from typing import Any, Dict, List, Optional, Tuple

from inferd_tpu_torch.control import balance as balancelib
from inferd_tpu_torch.control import dstar as dstarlib
from inferd_tpu_torch.control.autoscale import Action, AutoScaler, AutoscaleConfig
from inferd_tpu_torch.control.dht import SwarmDHT
from inferd_tpu_torch.control.path_finder import NoNodeForStage, PathFinder
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.obs import canary as canarylib
from inferd_tpu_torch.runtime.adapters import (
    ADA_GOSSIP_MAX, AdapterAffinity, combine_affinity,
)
from inferd_tpu_torch.sim.core import SIM_EPOCH, SimLoop, SimNet
from inferd_tpu_torch.utils import retry as retrylib

BLOCK_TOKENS = 32  # KV block granularity (mirrors core.cache defaults)

DEFAULTS: Dict[str, Any] = {
    "stages": 2,
    "replicas": 3,            # int (per stage) or per-stage list
    "zones": 1,
    "routers": 1,
    "duration_s": 60.0,
    "cap": 8,
    "base_svc_ms": 20.0,
    "kv_blocks": 256,
    "admission_reserve": 0.05,
    "wire_ms": (1.0, 5.0),
    "net": {"latency_ms": (2.0, 20.0), "drop_p": 0.0},
    "gossip_period_s": 1.0,
    "ttl_s": 15.0,
    "fanout": 3,
    "anti_entropy_every": 1,
    "quality_sample_every": 1,
    # gossip-convergence runway before the scenario clock starts
    # (arrivals + churn events): a fresh fleet bootstraps through one
    # seed, and judging routing during its first hellos is noise
    "warmup_s": 5.0,
    "balancer": {
        "period_s": 10.0,
        "imbalance_threshold": 0.5,
        "min_load_tol": 0.01,
        "migration_cost": 0.25,
        "min_dwell_s": 30.0,
    },
    "migrate_warmup_s": 2.0,
    "drain_s": 3.0,
    "outlier_check_s": 0.0,   # 0 = off
    "workload": {
        "arrival_per_s": 2.0,
        "arrive_until_s": None,   # default: duration - deadline
        "prompt_tokens": 128,
        "new_tokens": 32,
        "deadline_s": 20.0,
        "max_attempts": 8,
        "retry_base_s": 0.25,
        "retry_cap_s": 4.0,
        "retry_rate_per_s": 5.0,
        "retry_burst": 32,
    },
    "autoscale": None,        # AutoscaleConfig kwargs + {"period_s", "provision_s"}
    # memory-plane model: None = off (existing
    # scenarios' gossip and traces stay byte-identical). A dict enables
    # per-ENTRY-replica prefix caches driven by the SAME `pfx` digest
    # field and core.prefix.AffinityProbe scoring the real routers use:
    #   {"groups": N,        # distinct shared prompt prefixes offered
    #    "capacity": K,      # digest keys a replica retains (LRU)
    #    "affinity": bool}   # routers pass the probe (False = the
    #                        # digest-off baseline the fixtures compare)
    "prefix_cache": None,
    # multi-tenant adapter model: None = off (existing
    # scenarios' gossip and traces stay byte-identical). A dict enables
    # per-ENTRY-replica resident-adapter sets driven by the SAME `ada`
    # field and runtime/adapters.AdapterAffinity scoring the real
    # routers use:
    #   {"tenants": N,       # distinct tenant adapters in play
    #    "capacity": K,      # adapters a replica keeps resident (LRU)
    #    "load_units": U,    # hot-load cost of a cache miss, work units
    #    "affinity": bool}   # routers pass the adapter affinity (False
    #                        # = the residency-blind baseline fixtures)
    "adapter_cache": None,
    # crash-tolerance model (async standby KV replication):
    # None = off (existing scenarios' traces stay byte-identical; no
    # extra rng draws even when on — the standby pick is deterministic).
    # A dict enables entry-stage standby promotion: a session whose
    # ENTRY replica is killed resumes on a surviving same-stage standby,
    # redoing only the work past the replication frontier instead of
    # the whole prompt+decode — the sim mirror of the reference's runtime/repl:
    #   {"lag_units": L}     # work units past the frontier at the kill
    #                        # (the RPO: tick interval + partial block)
    "standby_repl": None,
}


def _merge_cfg(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_cfg(out[k], v)
        else:
            out[k] = v
    return out


def dijkstra_chain_cost(
    snapshot: Dict[int, Dict[str, Dict[str, Any]]], num_stages: int
) -> float:
    """Offline-optimal whole-chain cost over a snapshot: a from-scratch
    Dijkstra on the same layered graph / node_cost the D*-Lite planner
    uses — the router-quality yardstick (chosen cost / this <= gate)."""
    g = dstarlib.build_layered_graph(snapshot, 0, num_stages)
    dist = {dstarlib.START: 0.0}
    pq: List[Tuple[float, int, Any]] = [(0.0, 0, dstarlib.START)]
    seq = 1
    seen = set()
    while pq:
        d, _, u = _heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        if u == dstarlib.GOAL:
            return d
        for v, c in g.succ(u):
            nd = d + c
            if nd < dist.get(v, math.inf):
                dist[v] = nd
                _heapq.heappush(pq, (nd, seq, v))
                seq += 1
    return math.inf


class Session:
    __slots__ = (
        "sid", "t_arrive", "deadline", "prompt", "tokens", "blocks",
        "attempts", "done", "chain", "timer", "router", "group",
        "t_route", "step_ms", "units", "resume_units", "resume_node",
        "tenant",
    )

    def __init__(self, sid, t_arrive, deadline, prompt, tokens, group=0,
                 tenant=None):
        self.sid = sid
        self.t_arrive = t_arrive
        self.deadline = deadline
        self.prompt = prompt
        self.tokens = tokens
        self.blocks = max(1, -(-(prompt + tokens) // BLOCK_TOKENS))
        self.attempts = 0
        self.done = False
        self.chain: List[str] = []
        self.timer = None
        self.router: Optional["SimRouter"] = None
        # shared-prefix family (memory-plane model): sessions of one
        # group start with the same synthetic prompt prefix
        self.group = group
        # tenant adapter (multi-tenant model): the session decodes with
        # this named adapter; None = the base model
        self.tenant = tenant
        # crash-tolerance model (standby_repl): progress bookkeeping for
        # the promotion math — t_route/step_ms/units stamp the LAST
        # routing; resume_units/resume_node carry a standby promotion
        # into the next attempt (work already replicated there)
        self.t_route = 0.0
        self.step_ms = 0.0
        self.units = 0.0
        self.resume_units = 0.0
        self.resume_node: Optional[str] = None


class SimReplica:
    """One virtual serving replica wrapping a real SwarmDHT + Balancer."""

    def __init__(self, fleet: "Fleet", name: str, stage: int, zone: int):
        cfg = fleet.cfg
        self.fleet = fleet
        self.name = name
        self.stage = stage
        self.zone = zone
        caps = cfg.get("caps")  # optional per-stage capacity list
        self.cap = int(caps[stage]) if caps else int(cfg["cap"])
        self.base_svc_ms = float(cfg["base_svc_ms"])
        self.degrade = 1.0
        self.kv_total = int(cfg["kv_blocks"])
        self.kv_free = self.kv_total
        self.reserve = max(1, int(cfg["admission_reserve"] * self.kv_total))
        self.static_load = 0
        self.sessions: Dict[str, Session] = {}
        self.alive = True
        self.draining = False
        self.outlier = False
        self.warm_until = -math.inf
        self.migrations = 0
        self.rng = fleet.loop.child_rng(f"replica:{name}")
        self._hops: deque = deque(maxlen=256)       # (t, latency_ms)
        self._sli: deque = deque(maxlen=1024)       # (t, ok)
        # memory-plane model (fleet.prefix_cfg): truncated prefix keys
        # this replica "holds" (LRU; the sim mirror of core.cache
        # BlockPool.digest_keys), gossiped as the same `pfx` field the
        # real node announces
        self.pfx: "OrderedDict[str, None]" = OrderedDict()
        # multi-tenant model (fleet.adapter_cfg): resident adapter names
        # (LRU; the sim mirror of runtime/adapters.AdapterRegistry),
        # gossiped as the same `ada` field the real node announces
        self.ada: "OrderedDict[str, None]" = OrderedDict()
        host, port = fleet.alloc_addr()
        self.dht = SwarmDHT(
            name, port,
            bootstrap=fleet.bootstrap_for(name),
            ttl_s=cfg["ttl_s"], gossip_period_s=cfg["gossip_period_s"],
            host=host, clock=fleet.loop.time,
            rng=fleet.loop.child_rng(f"dht:{name}"),
            transport=fleet.net, fanout=cfg["fanout"],
            anti_entropy_every=cfg["anti_entropy_every"],
        )
        bal = cfg["balancer"]
        self.balancer = balancelib.Balancer(
            self.dht, fleet.num_stages,
            get_own_stage=lambda: self.stage,
            change_stage=self._change_stage,
            period_s=bal["period_s"],
            imbalance_threshold=bal["imbalance_threshold"],
            min_load_tol=bal["min_load_tol"],
            migration_cost=bal["migration_cost"],
            min_dwell_s=bal["min_dwell_s"],
            on_event=self._on_balance_event,
            clock=fleet.loop.time,
            rng=fleet.loop.child_rng(f"bal:{name}"),
        )

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        loop = self.fleet.loop
        self.fleet.net.register(self.dht, self.zone)
        self.dht.start_local()
        self.announce(urgent=True)
        period = self.dht.gossip_period_s
        loop.call_after(self.rng.random() * period, self._gossip_tick)
        bal_period = self.balancer.period_s
        loop.call_after(
            bal_period * (0.75 + 0.5 * self.rng.random()), self._balance_tick
        )
        if self.fleet.cfg["outlier_check_s"]:
            loop.call_after(
                self.fleet.cfg["outlier_check_s"] * (0.5 + self.rng.random()),
                self._outlier_tick,
            )

    def _gossip_tick(self) -> None:
        if not self.alive:
            return
        # keep the gossiped record's load/telemetry current before the
        # fanout push (the node's tsdb tick does the same re-announce)
        self.announce(urgent=False)
        self.dht.gossip_tick()
        self.fleet.loop.call_after(self.dht.gossip_period_s, self._gossip_tick)

    def _balance_tick(self) -> None:
        if self.alive and not self.draining:
            self.balancer.rebalance_once()
        if self.alive:
            self.fleet.loop.call_after(
                self.balancer.period_s * (0.75 + 0.5 * self.rng.random()),
                self._balance_tick,
            )

    def _outlier_tick(self) -> None:
        if not self.alive:
            return
        stage_map = {
            nid: dict(rec)
            for nid, rec in self.dht.get_stage(self.stage).items()
        }
        own = stage_map.setdefault(self.name, {})
        p99 = self.hop_p99_ms()
        if p99 is not None:
            own["hop_p99_ms"] = p99
        info = canarylib.detect_outliers(stage_map).get(self.name)
        was = self.outlier
        self.outlier = info is not None
        if self.outlier != was:
            self.fleet.trace(
                "replica.outlier" if self.outlier else "replica.outlier_cleared",
                node=self.name, stage=self.stage,
            )
            self.announce(urgent=True)
        self.fleet.loop.call_after(
            self.fleet.cfg["outlier_check_s"], self._outlier_tick
        )

    # ------------------------------------------------------------- behavior

    @property
    def load(self) -> int:
        return len(self.sessions) + self.static_load

    def svc_ms(self) -> float:
        return self.base_svc_ms * self.degrade * (1.0 + self.load / self.cap)

    def hop_p99_ms(self, window_s: float = 60.0) -> Optional[float]:
        now = self.fleet.loop.now
        vals = sorted(ms for t, ms in self._hops if now - t <= window_s)
        if not vals:
            return None
        return round(vals[min(len(vals) - 1, int(0.99 * len(vals)))], 3)

    def burn(self, window_s: float = 60.0, objective: float = 99.9) -> Optional[float]:
        now = self.fleet.loop.now
        oks = [ok for t, ok in self._sli if now - t <= window_s]
        if not oks:
            return None
        bad = sum(1 for ok in oks if not ok)
        return round((bad / len(oks)) / (1.0 - objective / 100.0), 2)

    def announce(self, urgent: bool = True) -> None:
        if not self.alive:
            return
        v: Dict[str, Any] = {
            "stage": self.stage, "load": self.load, "cap": self.cap,
            "host": self.dht.host, "port": self.dht.port,
        }
        p99 = self.hop_p99_ms()
        if p99 is not None:
            v["hop_p99_ms"] = p99
        if self.kv_total:
            v["kvfree"] = round(self.kv_free / self.kv_total, 4)
        b = self.burn()
        if b is not None:
            v["burn"] = b
        if self.draining:
            v["draining"] = 1
        if self.outlier:
            v["outlier"] = 1
        if self.fleet.prefix_cfg and self.stage == 0:
            # memory-plane gossip, mirroring runtime/node.announce:
            # the digest (MRU slice, same wire shape as
            # core.prefix.make_digest) + the admission-watermark flag
            # routers suppress the affinity bonus on. Gated on the model
            # so every pre-existing scenario's gossip stays byte-exact.
            if self.pfx:
                v["pfx"] = {
                    "bs": BLOCK_TOKENS,
                    "k": list(self.pfx)[-prefixlib.DIGEST_GOSSIP_KEYS:],
                }
        if self.fleet.adapter_cfg and self.stage == 0:
            # multi-tenant gossip, mirroring runtime/node.announce: the
            # resident-adapter list routers score AdapterAffinity
            # against — present even when EMPTY (key presence is the
            # capability marker, exactly like the real node). Gated on
            # the model so every pre-existing scenario's gossip stays
            # byte-exact.
            v["ada"] = list(self.ada)[-ADA_GOSSIP_MAX:]
        if (
            (self.fleet.prefix_cfg or self.fleet.adapter_cfg)
            and self.stage == 0 and self.kv_free <= self.reserve
        ):
            # ONE admission-watermark flag for both memory-plane models
            # (the real node's shed is independent of adapter residency
            # — a watermarked replica with an empty registry must still
            # shed the affinity bonus)
            v["shed"] = 1
        self.dht.announce(v, urgent=urgent)

    def admit_check(self, blocks: int) -> Optional[str]:
        if self.draining:
            return "draining"
        if self.kv_free - blocks < self.reserve:
            return "busy"
        return None

    # --------------------------------------------------- memory-plane model

    def cache_depth(self, keys: List[str]) -> int:
        """Deepest held key index + 1 over a prompt's truncated chain
        keys — chained keys mean the deepest match names the whole
        covered prefix (the sim mirror of BlockPool.map_prefix)."""
        depth = 0
        for j, k in enumerate(keys):
            if k in self.pfx:
                depth = j + 1
        return depth

    def cache_learn(self, keys: List[str], capacity: int) -> None:
        """Register a completed prefill's keys (MRU refresh), evicting
        LRU beyond `capacity` — evictions book the fleet's
        prefix_evictions counter, the sim face of `prefix.evict`."""
        for k in keys:
            if k in self.pfx:
                self.pfx.move_to_end(k)
            else:
                self.pfx[k] = None
        while len(self.pfx) > capacity:
            self.pfx.popitem(last=False)
            self.fleet.m["prefix_evictions"] += 1

    def attach(self, sess: Session) -> None:
        self.sessions[sess.sid] = sess
        self.kv_free -= sess.blocks
        self.announce(urgent=False)

    def release(self, sess: Session) -> None:
        if self.sessions.pop(sess.sid, None) is None:
            return
        self.kv_free += sess.blocks
        if self.alive:
            self.announce(urgent=False)
            if self.draining and not self.sessions and not self.static_load:
                self._drain_finish()

    def observe(self, latency_ms: float, ok: bool) -> None:
        now = self.fleet.loop.now
        self._hops.append((now, latency_ms))
        self._sli.append((now, ok))

    # --------------------------------------------------------------- events

    def _change_stage(self, stage: int) -> None:
        old = self.stage
        # residents are stranded by a stage swap (the executor and its KV
        # are replaced): fail them over through the router rescue path —
        # migration cost is real, which is why the balancer prices it
        for sess in list(self.sessions.values()):
            self.fleet.fail_session(sess, self, "migrate")
        self.stage = stage
        self.migrations += 1
        self.warm_until = self.fleet.loop.now + self.fleet.cfg["migrate_warmup_s"]
        self.fleet.m["migrations"] += 1
        self.fleet.m[f"migrate_dst.{stage}"] += 1
        self.fleet.trace(
            "stage.migrate", node=self.name, src=old, dst=stage
        )
        self.announce(urgent=True)

    def _on_balance_event(self, etype: str, **attrs: Any) -> None:
        self.fleet.m[f"adopt.{attrs.get('reason', 'unknown')}"] += 1
        self.fleet.trace(etype, node=self.name, **attrs)

    def kill(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self.dht.kill()
        self.fleet.trace("node.kill", node=self.name, stage=self.stage)
        for sess in list(self.sessions.values()):
            self.fleet.fail_session(sess, self, "peer_dead")
        self.sessions.clear()

    def drain(self) -> None:
        if self.draining or not self.alive:
            return
        self.draining = True
        self.fleet.m["drains"] += 1
        self.fleet.trace("node.draining", node=self.name, stage=self.stage)
        self.announce(urgent=True)
        if not self.sessions and not self.static_load:
            self._drain_finish()
        else:
            # residents get a bounded settle window, then hand off
            self.fleet.loop.call_after(
                self.fleet.cfg["drain_s"], self._drain_deadline
            )

    def _drain_deadline(self) -> None:
        if self.alive and self.draining:
            for sess in list(self.sessions.values()):
                self.fleet.fail_session(sess, self, "drain_handoff")
            self._drain_finish()

    def _drain_finish(self) -> None:
        if not self.alive or not self.draining:
            return
        self.fleet.trace("node.drained", node=self.name, stage=self.stage)
        self.dht.withdraw()
        self.alive = False


class SimRouter:
    """Session entry point: a real PathFinder (D*-Lite planner inside)
    over its own gossip view, with real retry budgets."""

    def __init__(self, fleet: "Fleet", name: str):
        cfg = fleet.cfg
        self.fleet = fleet
        self.name = name
        self.rng = fleet.loop.child_rng(f"router:{name}")
        host, port = fleet.alloc_addr()
        self.dht = SwarmDHT(
            name, port, bootstrap=fleet.bootstrap_for(name),
            ttl_s=cfg["ttl_s"], gossip_period_s=cfg["gossip_period_s"],
            host=host, clock=fleet.loop.time,
            rng=fleet.loop.child_rng(f"dht:{name}"),
            transport=fleet.net, fanout=cfg["fanout"],
            anti_entropy_every=cfg["anti_entropy_every"],
        )
        self.pf = PathFinder(
            self.dht, fleet.num_stages, clock=fleet.loop.time
        )
        w = cfg["workload"]
        self.retry_budget = retrylib.RetryBudget(
            rate_per_s=w["retry_rate_per_s"], burst=w["retry_burst"],
            clock=fleet.loop.time,
        )

    def start(self) -> None:
        self.fleet.net.register(self.dht, zone=0)
        self.dht.start_local()
        period = self.dht.gossip_period_s
        self.fleet.loop.call_after(self.rng.random() * period, self._gossip_tick)

    def _gossip_tick(self) -> None:
        self.dht.gossip_tick()
        self.fleet.loop.call_after(self.dht.gossip_period_s, self._gossip_tick)

    # -------------------------------------------------------------- session

    def submit(self, sess: Session) -> None:
        sess.router = self
        self.fleet.open_sessions += 1
        self.fleet.m["arrived"] += 1
        self.fleet.trace("session.arrive", sid=sess.sid, router=self.name)
        self._attempt(sess)

    def _attempt(self, sess: Session) -> None:
        fleet = self.fleet
        if sess.done:
            return
        sess.attempts += 1
        if fleet.loop.now >= sess.deadline:
            sess.done = True
            fleet.open_sessions -= 1
            fleet.m["expired"] += 1
            fleet.trace(
                "session.expired", sid=sess.sid, attempts=sess.attempts
            )
            return
        snap = self.dht.get_all(fleet.num_stages)
        try:
            # memory-plane + multi-tenant routing: the prompt's
            # AffinityProbe and/or the tenant's AdapterAffinity (None
            # when the models are off or the scenario pins
            # affinity=False — the blind baselines) ride into the REAL
            # router, which applies the bounded affinity bonus to the
            # entry pick (runtime/adapters.combine_affinity caps the
            # composition at one bonus)
            chain = self.pf.find_best_chain(
                0, affinity=combine_affinity(
                    fleet.affinity_probe(sess),
                    fleet.adapter_affinity(sess),
                )
            )
        except NoNodeForStage as e:
            fleet.m["route_fail"] += 1
            fleet.trace(
                "route.fail", sid=sess.sid, error=str(e)[:60]
            )
            self._retry(sess, "no_chain")
            return
        reps = [fleet.replicas.get(nid) for nid, _ in chain]
        stale = [
            nid for (nid, _), r in zip(chain, reps)
            if r is None or not r.alive
        ]
        if stale:
            # gossip hasn't TTL'd the corpse yet: the relay would observe
            # transport death — fold it into the planner NOW (peer.dead
            # increment) and retry
            for nid in stale:
                self.pf.note_peer_dead(nid)
            fleet.m["route_stale"] += 1
            self._retry(sess, "stale")
            return
        self._sample_quality(snap, chain)
        if fleet.standby_cfg and sess.resume_units > 0:
            # standby promotion (crash-tolerance model): the session's
            # replicated prefix lives on resume_node — route THROUGH it
            # (the entry stage holds the prompt KV) or, if the standby
            # died too, fall back to a full redo. Substituted AFTER the
            # quality sample: the promotion is a rescue constraint, not
            # a router choice to judge against offline-optimal.
            rb = fleet.replicas.get(sess.resume_node or "")
            if (
                rb is not None and rb.alive and not rb.draining
                and rb.stage == 0
            ):
                reps[0] = rb
            else:
                fleet.m["standby_stale"] += 1
                fleet.trace(
                    "standby.stale", sid=sess.sid,
                    node=sess.resume_node or "?",
                )
                sess.resume_units = 0.0
                sess.resume_node = None
        shed_code = None
        shed_node = None
        for r in reps:
            shed_code = r.admit_check(sess.blocks)
            if shed_code:
                shed_node = r.name
                break
        if shed_code:
            fleet.m["shed"] += 1
            fleet.trace(
                "session.shed", sid=sess.sid, node=shed_node, code=shed_code
            )
            self._retry(sess, shed_code)
            return
        step_ms = 0.0
        wire_lo, wire_hi = fleet.cfg["wire_ms"]
        for r in reps:
            warm_ms = max(0.0, r.warm_until - fleet.loop.now) * 1e3
            step_ms += r.svc_ms() + min(warm_ms, 2000.0)
            step_ms += wire_lo + (wire_hi - wire_lo) * self.rng.random()
        # memory-plane hit/miss: prefix tokens the ENTRY replica already
        # holds are skipped (fewer prefill chunks — the routing win is a
        # latency/load win, not bookkeeping); the replica then learns
        # this prompt's keys. 0 with the model off.
        hit_tokens = fleet.cache_admit(sess, reps[0])
        chunks = max(1.0, (sess.prompt - hit_tokens) / 16.0)
        units = chunks + sess.tokens
        # multi-tenant hit/miss: a session landing on a replica NOT
        # holding its adapter HOT-LOADS it (extra work units — disk +
        # host->device upload), never a reject; residency-affinity
        # routing is what makes this cost rare. 0 with the model off.
        units += fleet.adapter_admit(sess, reps[0])
        if fleet.standby_cfg and sess.resume_units > 0:
            # resume on the standby: only the work past the replication
            # frontier is redone (bounded RPO) — the promoted prefix is
            # already KV on resume_node. At least one unit always runs
            # (the resumed chunk itself recomputes).
            skipped = min(sess.resume_units, max(0.0, units - 1.0))
            units -= skipped
            fleet.m["standby_resumed_units"] += skipped
            fleet.trace(
                "standby.resume", sid=sess.sid, node=reps[0].name,
                units=round(skipped, 3),
            )
            sess.resume_units = 0.0
            sess.resume_node = None
        duration_s = units * step_ms / 1e3
        sess.t_route = fleet.loop.now
        sess.step_ms = step_ms
        sess.units = units
        for r in reps:
            r.attach(sess)
        sess.chain = [r.name for r in reps]
        fleet.trace(
            "session.route", sid=sess.sid, chain=",".join(sess.chain),
            eta_ms=round(duration_s * 1e3, 3),
        )
        # deadline enforcement (the relay's typed 408, simulated): a route
        # that cannot finish inside the deadline stops AT the deadline —
        # resources release and the expiry books — instead of grinding
        # to a completion nobody is waiting for
        fire_in = min(duration_s, max(0.0, sess.deadline - fleet.loop.now) + 1e-3)
        sess.timer = fleet.loop.call_after(
            fire_in, self._complete, sess, step_ms
        )

    def _complete(self, sess: Session, step_ms: float) -> None:
        fleet = self.fleet
        if sess.done:
            return
        sess.done = True
        fleet.open_sessions -= 1
        ok = fleet.loop.now <= sess.deadline
        for nid in sess.chain:
            r = fleet.replicas.get(nid)
            if r is not None:
                r.release(sess)
                r.observe(step_ms, ok)
        if ok:
            fleet.m["ok"] += 1
            fleet.m["goodput_tokens"] += sess.tokens
            fleet.trace(
                "session.done", sid=sess.sid, attempts=sess.attempts,
                wall_ms=round((fleet.loop.now - sess.t_arrive) * 1e3, 3),
            )
        else:
            fleet.m["expired"] += 1
            fleet.trace(
                "session.expired", sid=sess.sid, attempts=sess.attempts
            )

    def _retry(self, sess: Session, reason: str) -> None:
        fleet = self.fleet
        w = fleet.cfg["workload"]
        if sess.attempts >= w["max_attempts"]:
            sess.done = True
            fleet.open_sessions -= 1
            fleet.m["failed"] += 1
            fleet.trace(
                "session.fail", sid=sess.sid, reason="max_attempts",
                last=reason,
            )
            return
        if not self.retry_budget.try_acquire():
            # the retry budget's containment at fleet scale: a dead stage produces a
            # BOUNDED retry rate; the overflow surfaces as failures
            # instead of multiplying load
            sess.done = True
            fleet.open_sessions -= 1
            fleet.m["retry_denied"] += 1
            fleet.m["failed"] += 1
            fleet.trace("session.fail", sid=sess.sid, reason="retry_budget")
            return
        fleet.m["retries"] += 1
        delay = retrylib.backoff_delay(
            sess.attempts, base_s=w["retry_base_s"], cap_s=w["retry_cap_s"],
            rng=self.rng,
        )
        fleet.trace(
            "session.retry", sid=sess.sid, reason=reason,
            delay_ms=round(delay * 1e3, 3),
        )
        fleet.loop.call_after(delay, self._attempt, sess)

    def _sample_quality(
        self, snap: Dict[int, Dict[str, Dict[str, Any]]], chain
    ) -> None:
        fleet = self.fleet
        # the yardstick Dijkstra is O(stages x replicas^2 / stage) per
        # sample; big sweeps subsample (every Kth routing decision)
        fleet.m["route_decisions"] += 1
        every = int(fleet.cfg["quality_sample_every"])
        if every > 1 and int(fleet.m["route_decisions"]) % every != 1:
            return
        chosen = 0.0
        for s, (nid, value) in enumerate(chain):
            rec = snap.get(s, {}).get(nid, value)
            chosen += dstarlib.node_cost(rec)
        optimal = dijkstra_chain_cost(snap, fleet.num_stages)
        if not (optimal > 0.0) or math.isinf(optimal):
            return
        ratio = chosen / optimal
        fleet.m["route_samples"] += 1
        fleet._quality_sum += ratio
        fleet._quality_max = max(fleet._quality_max, ratio)


class Fleet:
    """Scenario world: builds actors, schedules churn, collects metrics."""

    def __init__(self, cfg: Dict[str, Any], seed: int):
        self.cfg = _merge_cfg(DEFAULTS, cfg or {})
        self.seed = int(seed)
        self.loop = SimLoop(seed)
        net = self.cfg["net"]
        self.net = SimNet(
            self.loop, latency_ms=tuple(net["latency_ms"]),
            drop_p=net["drop_p"],
        )
        self.num_stages = int(self.cfg["stages"])
        self.replicas: Dict[str, SimReplica] = {}
        self.routers: List[SimRouter] = []
        self.controller: Optional[AutoScaler] = None
        self._ctl_dht: Optional[SwarmDHT] = None
        self.m: Dict[str, float] = defaultdict(float)
        self._quality_sum = 0.0
        self._quality_max = 0.0
        self._hash = blake2b(digest_size=16)
        self.trace_events = 0
        self.capture_trace = False
        self.trace_lines: List[str] = []
        self._addr_seq = 0
        self._join_seq = 0
        self._seed_addr: Optional[Tuple[str, int]] = None
        # sessions not yet terminal (done/expired/failed): drives the
        # adaptive grace drain at the end of run()
        self.open_sessions = 0
        # memory-plane model (DEFAULTS["prefix_cache"]): per-group probes
        # and truncated key chains are derived ONCE from deterministic
        # synthetic prompt ids (no rng — group membership is sid modulo,
        # so enabling the model never perturbs other draws)
        self.prefix_cfg: Optional[Dict[str, Any]] = (
            dict(self.cfg["prefix_cache"])
            if self.cfg.get("prefix_cache") else None
        )
        self._group_keys: Dict[int, List[str]] = {}
        self._group_probes: Dict[int, Any] = {}
        # multi-tenant adapter model (DEFAULTS["adapter_cache"]): off =
        # None; tenant assignment is sid modulo (deterministic, no rng —
        # enabling the model never perturbs other scenarios' draws)
        self.adapter_cfg: Optional[Dict[str, Any]] = (
            dict(self.cfg["adapter_cache"])
            if self.cfg.get("adapter_cache") else None
        )
        self._tenant_affinity: Dict[str, Any] = {}
        # crash-tolerance model (DEFAULTS["standby_repl"]): off = None;
        # the standby pick is deterministic (min load, then name) so
        # enabling the model never perturbs any rng stream
        self.standby_cfg: Optional[Dict[str, Any]] = (
            dict(self.cfg["standby_repl"])
            if self.cfg.get("standby_repl") else None
        )

    # ------------------------------------------------------------- plumbing

    def alloc_addr(self) -> Tuple[str, int]:
        i = self._addr_seq
        self._addr_seq += 1
        return (f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}", 7000)

    def bootstrap_for(self, name: str) -> List[Tuple[str, int]]:
        return [self._seed_addr] if self._seed_addr else []

    # ------------------------------------------------- memory-plane model

    def _group_prompt_ids(self, group: int) -> List[int]:
        """Deterministic synthetic prompt for one shared-prefix group:
        same group => identical leading tokens (the shared system
        prompt), distinct groups => disjoint chains."""
        n = int(self.cfg["workload"]["prompt_tokens"])
        return [(group * 7919 + i * 13 + 5) % 4096 for i in range(n)]

    def group_keys(self, group: int) -> List[str]:
        """Truncated chained block keys for a group's prompt — derived
        through the REAL core.prefix pipeline (block_keys -> digest_key)
        so the sim's digests and the routers' probes can never use a
        different identity than production."""
        keys = self._group_keys.get(group)
        if keys is None:
            keys = [
                prefixlib.digest_key(k) for k in prefixlib.block_keys(
                    self._group_prompt_ids(group), BLOCK_TOKENS,
                    n_blocks=prefixlib.DIGEST_MAX_KEYS,
                )
            ]
            self._group_keys[group] = keys
        return keys

    def affinity_probe(self, sess: Session):
        """The session's core.prefix.AffinityProbe for router scoring, or
        None (model off / scenario pins affinity=False — the digest-off
        baseline fixtures compare against). Cached per group."""
        pc = self.prefix_cfg
        if not pc or not pc.get("affinity", True):
            return None
        probe = self._group_probes.get(sess.group)
        if probe is None:
            probe = prefixlib.AffinityProbe(
                self._group_prompt_ids(sess.group)
            )
            self._group_probes[sess.group] = probe
        return probe

    def adapter_affinity(self, sess: Session):
        """The session's runtime/adapters.AdapterAffinity for router
        scoring, or None (model off / no tenant / scenario pins
        affinity=False — the residency-blind baseline). Cached per
        tenant."""
        ac = self.adapter_cfg
        if not ac or sess.tenant is None or not ac.get("affinity", True):
            return None
        aff = self._tenant_affinity.get(sess.tenant)
        if aff is None:
            aff = AdapterAffinity(sess.tenant)
            self._tenant_affinity[sess.tenant] = aff
        return aff

    def adapter_admit(self, sess: Session, entry: SimReplica) -> float:
        """Residency resolution at admission: 0 extra units on a HIT
        (the entry replica already holds the tenant's adapter), the
        configured hot-load cost on a MISS — which also LRU-learns the
        adapter (evicting past capacity, booking the eviction counter:
        the sim face of `adapter.load`/`adapter.evict`)."""
        ac = self.adapter_cfg
        if not ac or sess.tenant is None:
            return 0.0
        cap = max(1, int(ac.get("capacity", 4)))
        if sess.tenant in entry.ada:
            entry.ada.move_to_end(sess.tenant)
            self.m["adapter_hits"] += 1
            self.trace(
                "adapter.hit", sid=sess.sid, node=entry.name,
                tenant=sess.tenant,
            )
            return 0.0
        self.m["adapter_misses"] += 1
        entry.ada[sess.tenant] = None
        while len(entry.ada) > cap:
            entry.ada.popitem(last=False)
            self.m["adapter_evictions"] += 1
        self.trace(
            "adapter.load", sid=sess.sid, node=entry.name,
            tenant=sess.tenant,
        )
        return float(ac.get("load_units", 4.0))

    def cache_admit(self, sess: Session, entry: SimReplica) -> int:
        """Hit/miss resolution at admission: tokens of `sess`'s prompt
        the entry replica's cache covers (skipped from prefill), books
        the fleet hit/prefill counters, and teaches the replica this
        prompt's keys. 0 with the model off."""
        if not self.prefix_cfg:
            return 0
        keys = self.group_keys(sess.group)
        depth = entry.cache_depth(keys)
        hit = min(depth * BLOCK_TOKENS, max(0, sess.prompt - 1))
        if hit:
            self.m["prefix_hit_tokens"] += hit
            self.trace(
                "prefix.hit", sid=sess.sid, node=entry.name, tokens=hit
            )
        self.m["prefill_tokens"] += sess.prompt - hit
        entry.cache_learn(keys, int(self.prefix_cfg.get("capacity", 256)))
        return hit

    def trace(self, etype: str, **attrs: Any) -> None:
        line = (
            f"{self.loop.now - SIM_EPOCH:12.4f} {etype} "
            + json.dumps(attrs, sort_keys=True, separators=(",", ":"))
        )
        self._hash.update(line.encode())
        self._hash.update(b"\n")
        self.trace_events += 1
        if self.capture_trace:
            self.trace_lines.append(line)

    # ---------------------------------------------------------------- build

    def add_replica(
        self, stage: int, zone: Optional[int] = None, name: Optional[str] = None
    ) -> SimReplica:
        if name is None:
            name = f"j{self._join_seq:03d}"
            self._join_seq += 1
        if zone is None:
            zone = len(self.replicas) % int(self.cfg["zones"])
        r = SimReplica(self, name, stage, zone)
        self.replicas[name] = r
        if self._seed_addr is None:
            self._seed_addr = (r.dht.host, r.dht.port)
        r.start()
        self.trace("node.join", node=name, stage=stage, zone=zone)
        return r

    def build(self) -> None:
        reps = self.cfg["replicas"]
        counts = (
            list(reps) if isinstance(reps, (list, tuple))
            else [int(reps)] * self.num_stages
        )
        zones = int(self.cfg["zones"])
        i = 0
        for stage, n in enumerate(counts):
            for k in range(int(n)):
                self.add_replica(stage, zone=i % zones, name=f"s{stage}r{k:03d}")
                i += 1
        for ri in range(int(self.cfg["routers"])):
            router = SimRouter(self, f"router{ri}")
            self.routers.append(router)
            router.start()
        auto = self.cfg.get("autoscale")
        if auto:
            auto = dict(auto)
            self._auto_period = float(auto.pop("period_s", 15.0))
            self._auto_provision = float(auto.pop("provision_s", 5.0))
            ctl_host, ctl_port = self.alloc_addr()
            self._ctl_dht = SwarmDHT(
                "autoscaler", ctl_port, bootstrap=self.bootstrap_for("ctl"),
                ttl_s=self.cfg["ttl_s"],
                gossip_period_s=self.cfg["gossip_period_s"],
                host=ctl_host, clock=self.loop.time,
                rng=self.loop.child_rng("dht:ctl"), transport=self.net,
                fanout=self.cfg["fanout"],
                anti_entropy_every=self.cfg["anti_entropy_every"],
            )
            self.net.register(self._ctl_dht, zone=0)
            self._ctl_dht.start_local()
            self.controller = AutoScaler(
                self.num_stages, AutoscaleConfig(**auto),
                clock=self.loop.time,
                on_event=lambda etype, **attrs: self.trace(etype, **attrs),
            )
            self.loop.call_after(
                self.cfg["gossip_period_s"], self._ctl_gossip_tick
            )
            self.loop.call_after(self._auto_period, self._autoscale_tick)

    def _ctl_gossip_tick(self) -> None:
        self._ctl_dht.gossip_tick()
        self.loop.call_after(self.cfg["gossip_period_s"], self._ctl_gossip_tick)

    # ------------------------------------------------------------ autoscale

    def _autoscale_tick(self) -> None:
        snap = self._ctl_dht.get_all(self.num_stages)
        for act in self.controller.decide(snap):
            self._apply_autoscale(act)
        self.loop.call_after(self._auto_period, self._autoscale_tick)

    def _serving_of(self, stage: int) -> List[SimReplica]:
        return sorted(
            (
                r for r in self.replicas.values()
                if r.alive and not r.draining and r.stage == stage
            ),
            key=lambda r: r.name,
        )

    def _apply_autoscale(self, act: Action) -> None:
        self.m[f"autoscale.{act.kind}"] += 1
        if act.kind == "scale_up":
            for _ in range(act.count):
                self.loop.call_after(
                    self._auto_provision, self._provision, act.stage
                )
        elif act.kind == "scale_down":
            pool = self._serving_of(act.stage)
            for r in sorted(pool, key=lambda r: (r.load, r.name))[: act.count]:
                if len(self._serving_of(act.stage)) > 1:
                    r.drain()
        elif act.kind == "repartition":
            pool = self._serving_of(act.src_stage)
            if len(pool) > 1:
                mover = min(pool, key=lambda r: (r.load, r.name))
                mover._change_stage(act.stage)

    def _provision(self, stage: int) -> None:
        self.add_replica(stage)

    # ------------------------------------------------------------- workload

    def _schedule_arrivals(self) -> None:
        w = self.cfg["workload"]
        rate = float(w["arrival_per_s"])
        if rate <= 0:
            return
        horizon = w["arrive_until_s"]
        if horizon is None:
            horizon = max(1.0, self.cfg["duration_s"] - w["deadline_s"])
        rng = self.loop.child_rng("arrivals")
        t = 0.0
        sid = 0
        while True:
            t += rng.expovariate(rate)
            if t >= horizon:
                break
            sess = Session(
                f"u{sid:05d}", self.loop.now + t, self.loop.now + t + w["deadline_s"],
                int(w["prompt_tokens"]), int(w["new_tokens"]),
                # shared-prefix family by round-robin (deterministic, no
                # rng draw — enabling the memory-plane model must not
                # shift any other scenario's random sequence)
                group=(
                    sid % max(1, int(self.prefix_cfg.get("groups", 4)))
                    if self.prefix_cfg else 0
                ),
                # tenant adapter by round-robin (deterministic, no rng
                # draw — same discipline as `group`)
                tenant=(
                    f"ada{sid % max(1, int(self.adapter_cfg.get('tenants', 4)))}"
                    if self.adapter_cfg else None
                ),
            )
            router = self.routers[sid % len(self.routers)]
            self.loop.call_at(sess.t_arrive, router.submit, sess)
            sid += 1
        self.m["offered_sessions"] = sid
        self.m["offered_tokens"] = sid * int(w["new_tokens"])

    def fail_session(self, sess: Session, at: SimReplica, reason: str) -> None:
        """A chain replica failed under a live session (death, migrate,
        drain hand-off): release everywhere, fold the death into the
        owning router's planner, and retry against the remaining
        deadline."""
        if sess.done:
            return
        if sess.timer is not None:
            sess.timer.cancel()
            sess.timer = None
        pre_chain = set(sess.chain)
        for nid in sess.chain:
            r = self.replicas.get(nid)
            if r is not None and r is not at:
                r.release(sess)
        if at.sessions.pop(sess.sid, None) is not None:
            at.kv_free += sess.blocks
        sess.chain = []
        self.m["rescues"] += 1
        self.trace(
            "session.rescue", sid=sess.sid, node=at.name, reason=reason
        )
        if self.standby_cfg and reason == "peer_dead" and at.stage == 0:
            # crash-tolerance model (the sim mirror of the reference's runtime/repl): a
            # surviving same-stage standby (anti-affinity: never a chain
            # member — the session was being SERVED there) holds the
            # session's replicated prefix up to `done - lag` work units.
            # The retry resumes there, redoing only the tail past the
            # frontier; no standby (or nothing replicated yet) books
            # standby.stale and degrades to the full redo — exactly the
            # production fallback contract.
            lag = float(self.standby_cfg.get("lag_units", 8.0))
            done = 0.0
            if sess.step_ms > 0 and sess.units > 0:
                done = min(
                    sess.units,
                    (self.loop.now - sess.t_route) * 1e3 / sess.step_ms,
                )
            standby = min(
                (
                    r for r in self._serving_of(0)
                    if r.name != at.name and r.name not in pre_chain
                ),
                key=lambda r: (r.load, r.name),
                default=None,
            )
            resume = max(0.0, done - lag)
            if standby is not None and resume > 0:
                sess.resume_units = resume
                sess.resume_node = standby.name
                self.m["standby_promotions"] += 1
                self.m["standby_promoted_units"] += resume
                self.trace(
                    "standby.promote", sid=sess.sid, node=standby.name,
                    units=round(resume, 3),
                )
            else:
                self.m["standby_stale"] += 1
                self.trace("standby.stale", sid=sess.sid, node=at.name)
        if reason == "peer_dead" and sess.router is not None:
            sess.router.pf.note_peer_dead(at.name)
        if sess.router is not None:
            sess.router._retry(sess, reason)

    # ---------------------------------------------------------------- churn

    def _apply_event(self, ev: Dict[str, Any]) -> None:
        op = ev["op"]
        self.trace("scenario.event", **{k: v for k, v in ev.items() if k != "t"})
        if op == "kill":
            r = self.replicas.get(ev["node"])
            if r is not None:
                r.kill()
        elif op == "kill_zone":
            for r in sorted(self.replicas.values(), key=lambda r: r.name):
                if r.zone == int(ev["zone"]) and r.alive:
                    r.kill()
        elif op == "kill_stage":
            keep = int(ev.get("keep", 0))
            pool = self._serving_of(int(ev["stage"]))
            for r in pool[keep:]:
                r.kill()
        elif op == "kill_random":
            rng = self.loop.child_rng(f"churn:{ev.get('tag', ev['t'])}")
            pool = sorted(
                (r for r in self.replicas.values() if r.alive),
                key=lambda r: r.name,
            )
            # never empty a stage outright: churn models independent
            # failures, zonal/stage wipes have their own ops
            by_stage: Dict[int, int] = {}
            for r in pool:
                by_stage[r.stage] = by_stage.get(r.stage, 0) + 1
            for r in rng.sample(pool, min(int(ev["count"]), len(pool))):
                if by_stage.get(r.stage, 0) > 1:
                    by_stage[r.stage] -= 1
                    r.kill()
        elif op == "join":
            for _ in range(int(ev.get("count", 1))):
                self.add_replica(int(ev["stage"]))
        elif op == "drain":
            r = self.replicas.get(ev["node"])
            if r is not None:
                r.drain()
        elif op == "drain_stage":
            pool = self._serving_of(int(ev["stage"]))
            n = int(ev.get("count", 0)) or int(len(pool) * float(ev.get("frac", 0.5)))
            for r in pool[:n]:
                if len(self._serving_of(int(ev["stage"]))) > 1:
                    r.drain()
        elif op == "degrade":
            r = self.replicas.get(ev["node"])
            if r is not None:
                r.degrade = float(ev.get("factor", 4.0))
                self.trace("node.degrade", node=r.name, factor=r.degrade)
        elif op == "degrade_random":
            rng = self.loop.child_rng(f"degrade:{ev.get('tag', ev['t'])}")
            pool = sorted(
                (r for r in self.replicas.values() if r.alive),
                key=lambda r: r.name,
            )
            for r in rng.sample(pool, min(int(ev["count"]), len(pool))):
                r.degrade = float(ev.get("factor", 4.0))
                self.trace("node.degrade", node=r.name, factor=r.degrade)
        elif op == "set_load":
            r = self.replicas.get(ev["node"])
            if r is not None:
                r.static_load = int(ev["load"])
                r.announce(urgent=False)
        elif op == "set_stage_load":
            for r in self._serving_of(int(ev["stage"])):
                r.static_load = int(ev["load"])
                r.announce(urgent=False)
        elif op == "partition":
            zones = ev["zones"]
            self.net.set_partition(int(zones[0]), int(zones[1]), True)
            if ev.get("heal_after"):
                self.loop.call_after(
                    float(ev["heal_after"]), self.net.set_partition,
                    int(zones[0]), int(zones[1]), False,
                )
        else:
            raise ValueError(f"unknown scenario op {op!r}")

    # ------------------------------------------------------------------ run

    def run(self) -> Dict[str, Any]:
        self.build()
        self.loop.run_until(self.loop.now + float(self.cfg["warmup_s"]))
        for ev in self.cfg.get("events", []):
            self.loop.call_at(self.loop.now + float(ev["t"]), self._apply_event, ev)
        self._schedule_arrivals()
        t0 = self.loop.now
        self.loop.run_until(t0 + float(self.cfg["duration_s"]))
        # grace drain: let in-flight sessions reach a terminal state
        # (done/expired/failed) so `hung` counts truly-stuck work, not
        # work the horizon merely cut off mid-retry. Adaptive: stop the
        # moment every session is terminal — a 1000-node fleet gossiping
        # through an empty grace window is pure wasted wall time
        w = self.cfg["workload"]
        grace_end = (
            t0 + float(self.cfg["duration_s"])
            + float(w["deadline_s"]) + 2.0 * float(w["retry_cap_s"]) + 1.0
        )
        while self.open_sessions > 0 and self.loop.now < grace_end:
            self.loop.run_until(min(self.loop.now + 1.0, grace_end))
        return self.finalize()

    def finalize(self) -> Dict[str, Any]:
        m = self.m
        duration = float(self.cfg["duration_s"])
        goodput = m.get("goodput_tokens", 0)
        offered = m.get("offered_tokens", 0)
        planner_stats: Dict[str, int] = {}
        for router in self.routers:
            p = router.pf.planner
            if p is None:
                continue
            for k, v in p.stats.items():
                planner_stats[k] = planner_stats.get(k, 0) + v
        builds = max(1, planner_stats.get("builds", 0))
        replans = max(
            1,
            planner_stats.get("computes", 0) - builds
        )
        mig_per_node = [r.migrations for r in self.replicas.values()]
        stage_counts = [
            len(self._serving_of(s)) for s in range(self.num_stages)
        ]
        per_build = planner_stats.get("expansions_build", 0) / builds
        per_replan = planner_stats.get("expansions_replan", 0) / replans
        sessions = {
            k: int(m.get(k, 0))
            for k in (
                "arrived", "ok", "failed", "expired", "shed",
                "retries", "retry_denied", "rescues",
                "route_fail", "route_stale",
            )
        }
        sessions["hung"] = (
            sessions["arrived"] - sessions["ok"] - sessions["failed"]
            - sessions["expired"]
        )
        out = {
            "scenario": self.cfg.get("name", ""),
            "seed": self.seed,
            "duration_s": duration,
            "sessions": sessions,
            "goodput_tokens": int(goodput),
            "goodput_per_s": round(goodput / duration, 6) if duration else 0.0,
            "goodput_ratio": round(goodput / offered, 6) if offered else None,
            "route_quality": {
                "samples": int(m.get("route_samples", 0)),
                "cost_ratio_mean": round(
                    self._quality_sum / m["route_samples"], 6
                ) if m.get("route_samples") else None,
                "cost_ratio_max": round(self._quality_max, 6)
                if m.get("route_samples") else None,
            },
            "planner": dict(
                planner_stats,
                expansions_per_build=round(per_build, 3),
                expansions_per_replan=round(per_replan, 3),
                # the incremental-replan headline: mean expansions per
                # replan as a fraction of mean expansions per from-scratch
                # build — "<< 1" is D*-Lite earning its keep
                replan_frac=round(per_replan / per_build, 4)
                if per_build > 0 else None,
            ),
            "balance": {
                "migrations": int(m.get("migrations", 0)),
                "max_migrations_per_node": max(mig_per_node, default=0),
                "adoptions": {
                    k[len("adopt."):]: int(v)
                    for k, v in sorted(m.items()) if k.startswith("adopt.")
                },
                "migrate_dst": {
                    k[len("migrate_dst."):]: int(v)
                    for k, v in sorted(m.items())
                    if k.startswith("migrate_dst.")
                },
                "drains": int(m.get("drains", 0)),
            },
            "autoscale": {
                k[len("autoscale."):]: int(v)
                for k, v in sorted(m.items()) if k.startswith("autoscale.")
            },
            "fleet": {
                "replicas_final": stage_counts,
                "replicas_total": len(self.replicas),
                "alive": sum(1 for r in self.replicas.values() if r.alive),
            },
            "net": {
                "sent": self.net.sent,
                "delivered": self.net.delivered,
                "dropped": self.net.dropped,
                "bytes_sent": self.net.bytes_sent,
            },
            "trace": {
                "events": self.trace_events,
                "hash": self._hash.hexdigest(),
            },
        }
        if self.standby_cfg:
            out["standby"] = {
                "promotions": int(m.get("standby_promotions", 0)),
                "promoted_units": round(
                    m.get("standby_promoted_units", 0.0), 3
                ),
                "resumed_units": round(
                    m.get("standby_resumed_units", 0.0), 3
                ),
                "stale": int(m.get("standby_stale", 0)),
            }
        if self.prefix_cfg:
            hit = m.get("prefix_hit_tokens", 0.0)
            pre = m.get("prefill_tokens", 0.0)
            out["cache"] = {
                "hit_tokens": int(hit),
                "prefill_tokens": int(pre),
                "hit_frac": (
                    round(hit / (hit + pre), 6) if (hit + pre) > 0 else None
                ),
                "evictions": int(m.get("prefix_evictions", 0)),
            }
        if self.adapter_cfg:
            ah = m.get("adapter_hits", 0.0)
            am = m.get("adapter_misses", 0.0)
            out["adapters"] = {
                "hits": int(ah),
                "misses": int(am),
                # resident-hit rate: the adapter-affinity routing claim —
                # sessions landing where their adapter already lives
                "hit_frac": (
                    round(ah / (ah + am), 6) if (ah + am) > 0 else None
                ),
                "evictions": int(m.get("adapter_evictions", 0)),
            }
        return out
