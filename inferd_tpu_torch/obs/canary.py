"""The routing signals of the reference's canary plane (port of the part of
inferd_tpu/obs/canary.py that control/path_finder and control/dstar read):
the penalties and bonus a gossip record's flags add to its min-load rank or
its planned cost, in load/cap units, and the admission-watermark test. The
probing and outlier detection that set those flags wait for the port's obs
plane.
"""

from __future__ import annotations

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
