"""The routing signals of the reference's canary plane (port of the part of
inferd_tpu/obs/canary.py that control/path_finder, control/dstar and the
fleet simulator read): the penalties and bonus a gossip record's flags add
to its min-load rank or its planned cost, in load/cap units, the
admission-watermark test, and `detect_outliers`, the stage-relative p99
test that sets a replica's `outlier` flag. The canary prober waits for the
port's obs plane.
"""

from __future__ import annotations

from statistics import median
from typing import Any, Dict, List, Tuple

#: Extra cost of an outlier-flagged replica: any healthy peer beats it, and
#: a stage whose every replica is flagged stays routable.
OUTLIER_PENALTY = 2.0

#: Extra cost, in the chain planner, of a `draining` replica: orders of
#: magnitude above any load or latency term, so a plan goes through one only
#: when its stage has nothing else live (finite, so the stage stays routable).
DRAINING_PENALTY = 1e6

#: The most a candidate holding a prompt's prefix blocks is discounted,
#: scaled by the matched depth: a quarter of OUTLIER_PENALTY, so a cache
#: hit never outweighs overload.
CACHE_AFFINITY_BONUS = 0.5

#: Extra cost, on affinity-scored picks only, of a replica under its paged
#: KV admission watermark (it would shed the new session); dominates the
#: bonus.
ADMISSION_PENALTY = 2.0

#: For peers that gossip `kvfree` but not `shed`: at or below this free
#: fraction the replica counts as shedding.
ADMISSION_KVFREE_FLOOR = 0.02


def under_admission_watermark(value) -> bool:
    """Does this gossip record advertise an admission shed? The `shed` flag
    decides where it is gossiped; otherwise `kvfree` at or below the floor.
    A record with neither key never sheds."""
    if value.get("shed"):
        return True
    kvfree = value.get("kvfree")
    return (
        isinstance(kvfree, (int, float))
        and float(kvfree) <= ADMISSION_KVFREE_FLOOR
    )


#: Default MAD multiplier: flag when a replica's p99 exceeds its stage's
#: median by at least 4 median absolute deviations.
OUTLIER_K = 4.0

#: Fewest replicas carrying the compared field before a MAD means anything
#: (with 2 values every point is exactly 1 MAD out).
OUTLIER_MIN_PEERS = 3

#: MAD floor, max(floor_ms, rel * median): a stage whose replicas sit within
#: a millisecond of each other must not flag jitter.
OUTLIER_MAD_FLOOR_MS = 2.0
OUTLIER_MAD_FLOOR_REL = 0.10


def detect_outliers(
    stage_map: Dict[str, Dict[str, Any]],
    field: str = "hop_p99_ms",
    fallback_field: str = "svc_p99_ms",
    k: float = OUTLIER_K,
    min_peers: int = OUTLIER_MIN_PEERS,
) -> Dict[str, Dict[str, float]]:
    """{node_id: {"value", "median", "mad", "field"}} of every replica whose
    trailing p99 sits at least k*MAD above its stage's median (one-sided: a
    fast replica is no problem). Records without the field do not vote; when
    fewer than `min_peers` carry `field`, the test retries on
    `fallback_field`, then gives up (an empty result)."""
    for fld in (field, fallback_field):
        if not fld:
            continue
        vals: List[Tuple[str, float]] = [
            (nid, float(rec[fld]))
            for nid, rec in stage_map.items()
            if isinstance(rec.get(fld), (int, float))
        ]
        if len(vals) < max(min_peers, 2):
            continue
        med = median(v for _, v in vals)
        mad = median(abs(v - med) for _, v in vals)
        mad = max(mad, OUTLIER_MAD_FLOOR_MS, OUTLIER_MAD_FLOOR_REL * med)
        return {
            nid: {"value": v, "median": med, "mad": mad, "field": fld}
            for nid, v in vals
            if v - med >= k * mad
        }
    return {}
