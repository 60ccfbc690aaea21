"""Scenario catalog (port of inferd_tpu/sim/scenarios.py, the same 13
entries; docs/CONTROL.md §5 tells each one's story).

Every entry is a builder returning a plain config dict for
`sim.scenario.run_scenario`; committed fixtures (tests/data/sim/) bind a
catalog name + seed + gates. Scenarios deliberately target one
control-plane behavior each — a failing gate should point at a policy,
not at a soup.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def _hysteresis() -> Dict[str, Any]:
    """Regression for the min-load float-equality deadlock
    (control/balance rebalance_once): stage 0 (one replica, cap 7) sits
    at ratio 2/7=0.2857 — the EXACT min — but can never migrate (single
    replica); stage 1 (three replicas, cap 8) sits at 7/24=0.2917, within
    the 0.01 tolerance of min but not equal to it; stage 2 is hot. The
    pre-fix equality check left NOBODY eligible; the tolerance-based min
    check lets a stage-1 replica close the gap."""
    return {
        "name": "hysteresis",
        "stages": 3,
        "replicas": [1, 3, 2],
        "caps": [7, 8, 8],
        "duration_s": 30.0,
        "balancer": {"period_s": 5.0, "min_dwell_s": 60.0},
        "workload": {"arrival_per_s": 0.0},
        "events": [
            {"t": 0.1, "op": "set_load", "node": "s0r000", "load": 2},
            {"t": 0.1, "op": "set_load", "node": "s1r000", "load": 3},
            {"t": 0.1, "op": "set_load", "node": "s1r001", "load": 2},
            {"t": 0.1, "op": "set_load", "node": "s1r002", "load": 2},
            {"t": 0.1, "op": "set_stage_load", "stage": 2, "load": 8},
        ],
    }


def _adopt_race() -> Dict[str, Any]:
    """Empty-stage adoption under gossip lag: 50 stage-0 replicas all
    observe stage 1 die (one replica, killed without a tombstone — pure
    TTL expiry) within a gossip period of each other. The lexicographic
    min-id tie-break must produce EXACTLY ONE adoption and never abandon
    stage 0 — the pre-PR-12 rebalance sweep would pile every replica in."""
    return {
        "name": "adopt_race",
        "stages": 2,
        "replicas": [50, 1],
        "duration_s": 30.0,
        "gossip_period_s": 0.5,
        "ttl_s": 4.0,
        "net": {"latency_ms": (50.0, 200.0)},
        "balancer": {"period_s": 2.0},
        "workload": {"arrival_per_s": 0.0},
        "events": [{"t": 5.0, "op": "kill", "node": "s1r000"}],
    }


def _drain_wave() -> Dict[str, Any]:
    """Drain-wave load accounting (control/balance stage_loads): two of
    stage 1's four replicas drain while carrying heavy resident load.
    Excluding draining capacity keeps the stage's apparent ratio at its
    SERVING replicas' (idle) level, so no spurious migration chases
    capacity that is about to leave — pre-fix the inflated ratio pulled
    a stage-0 replica across."""
    return {
        "name": "drain_wave",
        "stages": 2,
        "replicas": [3, 4],
        "duration_s": 30.0,
        "drain_s": 12.0,
        "balancer": {"period_s": 4.0},
        "workload": {"arrival_per_s": 0.0},
        "events": [
            {"t": 1.0, "op": "set_load", "node": "s1r000", "load": 12},
            {"t": 1.0, "op": "set_load", "node": "s1r001", "load": 12},
            {"t": 5.0, "op": "drain", "node": "s1r000"},
            {"t": 5.5, "op": "drain", "node": "s1r001"},
        ],
    }


def _hot_stage_skew() -> Dict[str, Any]:
    """Organic rebalancing under live traffic: stage 1 has 2 replicas to
    its neighbors' 5, so per-session pipeline load runs it hot. The
    cost-aware balancer must migrate capacity in (converging, never
    oscillating) while D*-Lite keeps chains near offline-optimal."""
    return {
        "name": "hot_stage_skew",
        "stages": 3,
        "replicas": [5, 2, 5],
        "duration_s": 90.0,
        "balancer": {"period_s": 8.0},
        "workload": {
            "arrival_per_s": 4.0,
            "prompt_tokens": 96,
            "new_tokens": 24,
            "deadline_s": 25.0,
        },
    }


def _retry_storm() -> Dict[str, Any]:
    """The retry budgets replayed at fleet scale: stage 1 loses two
    of three replicas at once; the survivor saturates, sessions shed and
    die on deadlines — and the token-bucket budget must keep total
    retries BOUNDED (rate*horizon + burst) instead of multiplying the
    storm."""
    return {
        "name": "retry_storm",
        "stages": 2,
        "replicas": [3, 3],
        "cap": 6,
        "kv_blocks": 96,
        "duration_s": 60.0,
        "balancer": {"period_s": 6.0, "min_dwell_s": 20.0},
        "workload": {
            "arrival_per_s": 6.0,
            "prompt_tokens": 96,
            "new_tokens": 24,
            "deadline_s": 15.0,
        },
        "events": [{"t": 10.0, "op": "kill_stage", "stage": 1, "keep": 1}],
    }


def _zonal_failure() -> Dict[str, Any]:
    """A whole zone (2 replicas of each of 3 stages) dies mid-traffic:
    sessions on the dead replicas rescue through the routers' peer.dead
    increments, chains re-plan around the hole, goodput holds."""
    return {
        "name": "zonal_failure",
        "stages": 3,
        "replicas": [6, 6, 6],
        "zones": 3,
        "duration_s": 75.0,
        "balancer": {"period_s": 8.0},
        "workload": {
            "arrival_per_s": 3.0,
            "prompt_tokens": 96,
            "new_tokens": 24,
            "deadline_s": 25.0,
        },
        "events": [{"t": 15.0, "op": "kill_zone", "zone": 1}],
    }


def _autoscale_elastic() -> Dict[str, Any]:
    """Elastic scaling end to end: a 2x2 fleet takes sustained overload
    (load + kvfree watermark both fire), the AutoScaler provisions
    replicas (whose joins the D*-Lite planner SPLICES in incrementally),
    then scales back down once arrivals stop. Gates pin at least one up
    AND one down decision, incremental node adds, and a served-load
    floor."""
    return {
        "name": "autoscale_elastic",
        "stages": 2,
        "replicas": [2, 2],
        "cap": 4,
        "kv_blocks": 64,
        "duration_s": 100.0,
        "balancer": {"period_s": 10.0},
        "workload": {
            "arrival_per_s": 4.0,
            "arrive_until_s": 50.0,
            "prompt_tokens": 96,
            "new_tokens": 24,
            "deadline_s": 25.0,
        },
        "autoscale": {
            "period_s": 6.0,
            "provision_s": 3.0,
            "cooldown_s": 15.0,
            "load_hi": 0.7,
            "load_lo": 0.15,
            "min_replicas": 2,
        },
    }


def _gossip_partition() -> Dict[str, Any]:
    """Zone partition, then heal: gossip between zones 0 and 1 blackholes
    for 20 s. Routers keep serving from their reachable view (records
    TTL out, chains re-plan), and the fleet reconverges after the heal
    with no hung sessions."""
    return {
        "name": "gossip_partition",
        "stages": 2,
        "replicas": [4, 4],
        "zones": 2,
        "duration_s": 70.0,
        "ttl_s": 8.0,
        "workload": {
            "arrival_per_s": 2.0,
            "prompt_tokens": 64,
            "new_tokens": 16,
            "deadline_s": 20.0,
        },
        "events": [
            {"t": 15.0, "op": "partition", "zones": [0, 1], "heal_after": 20.0},
        ],
    }


def _cache_affinity() -> Dict[str, Any]:
    """Memory-plane routing rehearsal: one entry stage of 6
    replicas serving 4 shared-prefix session families under KV pressure
    (small pools — the admission watermark is LIVE, not decorative).
    With digest gossip + the AffinityProbe bonus, each family converges
    onto the replica already holding its blocks, so the fleet hit rate
    climbs toward (prompt - first-visit) levels; the affinity=False
    override is the digest-off baseline fixture pinning that min-load
    alone scatters families across replicas (lower hit rate). Gates also
    hold the watermark story: a shedding digest-holder must LOSE the
    pick, so sessions keep completing instead of herding into 503s."""
    return {
        "name": "cache_affinity",
        "stages": 1,
        "replicas": [6],
        "cap": 8,
        "kv_blocks": 32,
        "base_svc_ms": 80.0,
        "duration_s": 60.0,
        # capacity 8 keys ~ 2 of the 4 families' chains: a replica can
        # NOT hold everything, so scattered placement (the digest-off
        # baseline) keeps re-learning and evicting while affinity
        # placement converges one-family-per-replica
        "prefix_cache": {"groups": 4, "capacity": 8, "affinity": True},
        "workload": {
            "arrival_per_s": 4.0,
            "prompt_tokens": 128,
            "new_tokens": 16,
            "deadline_s": 20.0,
        },
    }


def _cache_affinity_1000() -> Dict[str, Any]:
    """The 1000-node flavor: 4 stages x 250 replicas,
    16 prefix families routed by digest affinity at the entry stage,
    steady traffic. Holds at scale what the small fixture holds at 6
    replicas: families converge onto digest-holders (fleet hit rate
    floor) while the admission watermark keeps winning (bounded sheds,
    zero hung). Marked slow (fixture `"slow": true`)."""
    return {
        "name": "cache_affinity_1000",
        "stages": 4,
        "replicas": 250,
        "zones": 4,
        "routers": 2,
        "duration_s": 20.0,
        "warmup_s": 10.0,
        "gossip_period_s": 2.0,
        "ttl_s": 8.0,
        "anti_entropy_every": 4,
        "quality_sample_every": 4,
        "cap": 16,
        "prefix_cache": {"groups": 16, "capacity": 16, "affinity": True},
        "workload": {
            "arrival_per_s": 6.0,
            "arrive_until_s": 14.0,
            "prompt_tokens": 64,
            "new_tokens": 16,
            "deadline_s": 8.0,
        },
    }


def _adapter_affinity() -> Dict[str, Any]:
    """Multi-tenant placement rehearsal: one entry stage of 6
    replicas serving 8 tenants' adapter sessions, each replica keeping
    only 2 adapters device-resident (LRU) — the fleet CANNOT hold every
    tenant everywhere, so placement decides whether admissions hit a
    resident adapter or pay a hot-load. With `ada` residency gossip +
    the AdapterAffinity bonus (the real routers' scoring), tenants
    converge onto replicas already holding their adapter and the
    resident-hit rate climbs; the affinity=False override is the
    residency-blind baseline fixture pinning that min-load alone keeps
    thrashing the slots (loads + evictions up, hit rate down). Gates
    also pin the serving story: zero hung sessions, goodput floor —
    a miss HOT-LOADS (bounded extra units), never rejects."""
    return {
        "name": "adapter_affinity",
        "stages": 1,
        "replicas": [6],
        "cap": 8,
        "base_svc_ms": 60.0,
        "duration_s": 60.0,
        # capacity 2 of 8 tenants per replica: blind placement misses
        # ~constantly while affinity placement pins tenant->replica
        "adapter_cache": {
            "tenants": 8, "capacity": 2, "load_units": 6.0,
            "affinity": True,
        },
        "workload": {
            "arrival_per_s": 4.0,
            "prompt_tokens": 64,
            "new_tokens": 16,
            "deadline_s": 20.0,
        },
    }


def _standby_failover() -> Dict[str, Any]:
    """Crash-tolerant sessions at fleet scale: one entry
    stage of 6 replicas under steady long-session traffic, then two
    kill-churn waves take out 3 of them with live residents. With the
    standby model on (the sim mirror of runtime/repl's async KV
    replication), each stranded session PROMOTES onto a surviving
    standby and redoes only the work past the replication frontier
    (lag_units) instead of its whole prompt+decode — gates pin
    promotions actually happening, zero hung sessions, and a goodput
    floor a full-restart fleet under the same kills would miss. The
    `standby_repl: None` override is the replication-off twin."""
    return {
        "name": "standby_failover",
        "stages": 1,
        "replicas": [6],
        "cap": 8,
        "base_svc_ms": 40.0,
        "duration_s": 50.0,
        "standby_repl": {"lag_units": 8.0},
        "workload": {
            "arrival_per_s": 4.0,
            "prompt_tokens": 256,
            "new_tokens": 64,
            "deadline_s": 30.0,
        },
        "events": [
            {"t": 8.0, "op": "kill_random", "count": 2, "tag": "crash1"},
            {"t": 10.0, "op": "join", "stage": 0, "count": 2},
            {"t": 18.0, "op": "kill_random", "count": 2, "tag": "crash2"},
            {"t": 20.0, "op": "join", "stage": 0, "count": 2},
            {"t": 28.0, "op": "kill_random", "count": 1, "tag": "crash3"},
        ],
    }


def _churn_1000() -> Dict[str, Any]:
    """The 1000-node rehearsal: 8 stages x 125 replicas across 4 zones,
    steady traffic, then 60 random deaths, 30 joins, and 10 degraded
    replicas inside a 6-second window. Gates hold the whole story at
    once: routing within 5% of offline-optimal, incremental replans far
    under build cost, bounded migrations, zero hung sessions, goodput
    floor. Marked slow (fixture `"slow": true`): minutes of wall time."""
    return {
        "name": "churn_1000",
        "stages": 8,
        "replicas": 125,
        "zones": 4,
        "routers": 2,
        "duration_s": 24.0,
        "warmup_s": 10.0,
        "gossip_period_s": 2.0,
        "ttl_s": 8.0,
        "anti_entropy_every": 4,
        "quality_sample_every": 4,
        "cap": 16,
        "balancer": {"period_s": 6.0, "min_dwell_s": 15.0},
        "workload": {
            "arrival_per_s": 6.0,
            "arrive_until_s": 16.0,
            "prompt_tokens": 64,
            "new_tokens": 16,
            "deadline_s": 8.0,
            "retry_rate_per_s": 10.0,
        },
        "events": [
            {"t": 6.0, "op": "kill_random", "count": 60, "tag": "churn"},
            {"t": 8.0, "op": "join", "stage": 1, "count": 10},
            {"t": 8.5, "op": "join", "stage": 4, "count": 10},
            {"t": 9.0, "op": "join", "stage": 6, "count": 10},
            {"t": 9.5, "op": "degrade_random", "count": 10, "factor": 5.0,
             "tag": "deg"},
        ],
    }


CATALOG: Dict[str, Callable[[], Dict[str, Any]]] = {
    "hysteresis": _hysteresis,
    "adopt_race": _adopt_race,
    "drain_wave": _drain_wave,
    "hot_stage_skew": _hot_stage_skew,
    "retry_storm": _retry_storm,
    "zonal_failure": _zonal_failure,
    "autoscale_elastic": _autoscale_elastic,
    "gossip_partition": _gossip_partition,
    "cache_affinity": _cache_affinity,
    "cache_affinity_1000": _cache_affinity_1000,
    "adapter_affinity": _adapter_affinity,
    "standby_failover": _standby_failover,
    "churn_1000": _churn_1000,
}


def scenario(name: str, overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """Catalog lookup + shallow-per-key override merge (nested dicts
    merge one level down, mirroring fleet._merge_cfg semantics)."""
    if name not in CATALOG:
        raise KeyError(
            f"unknown scenario {name!r}: want one of {sorted(CATALOG)}"
        )
    cfg = CATALOG[name]()
    for k, v in (overrides or {}).items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            merged = dict(cfg[k])
            merged.update(v)
            cfg[k] = merged
        else:
            cfg[k] = v
    return cfg
