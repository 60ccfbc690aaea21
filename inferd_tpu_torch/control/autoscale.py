"""Elastic fleet autoscaling: a stage scale-up/down and re-partitioning
policy (port of inferd_tpu/control/autoscale.py).

The balancer (control/balance) moves existing capacity between stages; it
can do nothing when the fleet as a whole is too small or too large. This
module is a pure, deterministic policy over the signals the gossip records
carry:

  * per-stage load/cap ratio (balance.stage_loads: serving replicas only,
    draining capacity left out);
  * `kvfree`, a replica's paged-KV block-pool free fraction: a stage whose
    tightest replica is under the low watermark is about to shed new
    sessions whatever its load ratio says;
  * `burn`, a replica's short-window availability burn rate.

A replica that gossips no `kvfree` or `burn` does not vote for it (a mixed
fleet degrades to load-only scaling). The port's records carry neither key
until its observability plane lands (ROADMAP A9), so a live swarm's advice
comes from load alone.

`AutoScaler.decide` returns `Action`s: scale_up / scale_down per stage, and
`repartition` advice (move one replica from the coldest over-provisioned
stage to the hottest) when capacity is adequate but misplaced. It executes
nothing: a fleet simulator or a collector applies or shows the advice.
Stateless but for per-stage dwell stamps (a cooldown between actions, so a
noisy signal cannot flap capacity); `clock` is injectable.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from inferd_tpu_torch.control.balance import serving_nodes, stage_loads


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs, in the units the gossip fields carry."""

    load_hi: float = 0.75  # stage load/cap ratio that demands capacity
    load_lo: float = 0.20  # ratio under which capacity is idle
    kvfree_lo: float = 0.10  # block-pool free fraction demanding capacity
    burn_hi: float = 14.0  # availability burn rate demanding capacity
    min_replicas: int = 1  # never scale a stage below this
    max_replicas: int = 64  # never scale a stage above this
    cooldown_s: float = 60.0  # per-stage dwell between actions
    max_step: int = 4  # the most replicas added in one decision
    repartition_ratio: float = 2.0  # hottest/coldest ratio that moves one


@dataclasses.dataclass(frozen=True)
class Action:
    """One decision. kind: "scale_up" | "scale_down" | "repartition"
    (src_stage -> stage). `reason` names the signal that fired."""

    kind: str
    stage: int
    count: int = 1
    src_stage: Optional[int] = None
    reason: str = ""

    def render(self) -> str:
        if self.kind == "repartition":
            return f"repartition {self.src_stage}->{self.stage} x{self.count} ({self.reason})"
        sign = "+" if self.kind == "scale_up" else "-"
        return f"{self.kind} stage {self.stage} {sign}{self.count} ({self.reason})"


def stage_signals(snapshot: Dict[int, Dict[str, Dict[str, Any]]]) -> Dict[int, Dict[str, Any]]:
    """Per-stage inputs from a gossip snapshot: serving replica count,
    load/cap ratio, the worst (min) `kvfree`, the worst (max) `burn`."""
    loads = stage_loads(snapshot)
    out: Dict[int, Dict[str, Any]] = {}
    for stage in sorted(snapshot):
        serving = serving_nodes(snapshot[stage])
        kvfrees = [float(v["kvfree"]) for v in serving.values()
                   if isinstance(v.get("kvfree"), (int, float))]
        burns = [float(v["burn"]) for v in serving.values()
                 if isinstance(v.get("burn"), (int, float))]
        out[stage] = {
            "replicas": len(serving),
            "load": loads.get(stage, math.inf),
            "kvfree_min": min(kvfrees) if kvfrees else None,
            "burn_max": max(burns) if burns else None,
        }
    return out


class AutoScaler:
    """Dwell-gated decisions over `stage_signals`."""

    def __init__(self, num_stages: int, cfg: Optional[AutoscaleConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable[..., Any]] = None):
        self.num_stages = num_stages
        self.cfg = cfg or AutoscaleConfig()
        self._clock = clock
        self.on_event = on_event
        self._last_action_ts: Dict[int, float] = {}
        self.decisions = 0

    def _emit(self, etype: str, **attrs: Any) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(etype, **attrs)
        except Exception:
            pass

    def _dwelling(self, stage: int, now: float) -> bool:
        last = self._last_action_ts.get(stage)
        return last is not None and now - last < self.cfg.cooldown_s

    def decide(self, snapshot: Dict[int, Dict[str, Dict[str, Any]]]) -> List[Action]:
        """Actions for one tick over one snapshot, stages in order: the same
        snapshot and dwell state give the same actions. At most one action
        per stage per tick; repartition advice only when no stage needed
        scaling."""
        cfg = self.cfg
        now = self._clock()
        self.decisions += 1
        signals = stage_signals(snapshot)
        actions: List[Action] = []
        for stage in range(self.num_stages):
            sig = signals.get(stage)
            if sig is None or self._dwelling(stage, now):
                continue
            reasons: List[str] = []
            load = sig["load"]
            if math.isinf(load):
                # no serving capacity: the balancer's adoption borrows a
                # replica from a sibling stage, a scale-up repays it
                reasons.append("starved")
            elif load >= cfg.load_hi:
                reasons.append(f"load {load:.2f}>={cfg.load_hi:g}")
            if sig["kvfree_min"] is not None and sig["kvfree_min"] <= cfg.kvfree_lo:
                reasons.append(f"kvfree {sig['kvfree_min']:.3f}<={cfg.kvfree_lo:g}")
            if sig["burn_max"] is not None and sig["burn_max"] >= cfg.burn_hi:
                reasons.append(f"burn {sig['burn_max']:.1f}>={cfg.burn_hi:g}")
            if reasons and sig["replicas"] < cfg.max_replicas:
                if math.isinf(load):
                    count = 1
                else:
                    # proportional: 50% over the high watermark asks for
                    # ~50% more replicas, capped by max_step
                    over = max(1.0, load / cfg.load_hi)
                    count = int(math.ceil(sig["replicas"] * (over - 1.0))) or 1
                count = max(1, min(count, cfg.max_step, cfg.max_replicas - sig["replicas"]))
                act = Action("scale_up", stage, count, reason="; ".join(reasons))
                actions.append(act)
                self._last_action_ts[stage] = now
                self._emit("autoscale.up", stage=stage, count=count, reason=act.reason)
                continue
            if (not reasons and not math.isinf(load) and load <= cfg.load_lo
                    and sig["replicas"] > cfg.min_replicas
                    and (sig["kvfree_min"] is None or sig["kvfree_min"] > 2 * cfg.kvfree_lo)
                    and (sig["burn_max"] is None or sig["burn_max"] < 1.0)):
                act = Action("scale_down", stage, 1, reason=f"load {load:.2f}<={cfg.load_lo:g}")
                actions.append(act)
                self._last_action_ts[stage] = now
                self._emit("autoscale.down", stage=stage, count=1, reason=act.reason)
        if not actions:
            act = self._repartition(signals, now)
            if act is not None:
                actions.append(act)
        return actions

    def _repartition(self, signals: Dict[int, Dict[str, Any]], now: float) -> Optional[Action]:
        """Move advice when capacity is adequate but misplaced: the hottest
        stage runs at least repartition_ratio x the coldest's load ratio
        while the coldest can spare a replica."""
        cfg = self.cfg
        eligible = {s: sig for s, sig in signals.items() if not math.isinf(sig["load"])}
        if len(eligible) < 2:
            return None
        hot = max(eligible, key=lambda s: (eligible[s]["load"], -s))
        cold_pool = {s: sig for s, sig in eligible.items()
                     if s != hot and sig["replicas"] > cfg.min_replicas}
        if not cold_pool:
            return None
        cold = min(cold_pool, key=lambda s: (cold_pool[s]["load"], s))
        hot_load, cold_load = eligible[hot]["load"], cold_pool[cold]["load"]
        if hot_load < cfg.repartition_ratio * max(cold_load, 1e-9):
            return None
        if hot_load - cold_load < 0.25:
            return None  # the ratio met on noise-level absolute skew
        if self._dwelling(hot, now) or self._dwelling(cold, now):
            return None
        self._last_action_ts[hot] = self._last_action_ts[cold] = now
        act = Action("repartition", hot, 1, src_stage=cold,
                     reason=f"load {hot_load:.2f} vs {cold_load:.2f}")
        self._emit("autoscale.repartition", stage=hot, src_stage=cold, reason=act.reason)
        return act
