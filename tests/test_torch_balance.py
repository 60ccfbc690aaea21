"""The port's elasticity policies against the JAX package's, on seeded gossip
snapshots: control/balance (stage_loads, serving_nodes, every Balancer
decision and projected gain, the empty-stage adoption race) and
control/autoscale (AutoScaler.decide with its dwell, and the repartition
advice). The reference's Balancer is asyncio: its decisions run under
asyncio.run with an async change_stage; the port's are plain calls.
"""

import asyncio
import math
import random
import threading
import time

import pytest

from inferd_tpu.control import autoscale as jauto
from inferd_tpu.control import balance as jbal
from inferd_tpu_torch.control import autoscale as pauto
from inferd_tpu_torch.control import balance as pbal


class FakeDHT:
    def __init__(self, snap, node_id=None):
        self.snap = snap
        self.node_id = node_id

    def get_all(self, num_stages):
        return self.snap


def _random_snapshot(rng: random.Random, stages=None, max_replicas=4):
    """{stage: {node_id: record}}: 2-4 stages of 0-4 replicas each, loads,
    caps (some absent), draining flags."""
    stages = stages or rng.randint(2, 4)
    snap = {}
    for s in range(stages):
        recs = {}
        for i in range(rng.randint(0 if rng.random() < 0.15 else 1, max_replicas)):
            rec = {"stage": s, "load": rng.choice([0, 0, 1, 2, 3, 5, 8, 13])}
            if rng.random() < 0.8:
                rec["cap"] = rng.choice([1, 2, 4, 8, 16])
            if rng.random() < 0.12:
                rec["draining"] = 1
            recs[f"10.0.{s}.{rng.randint(0, 99)}:{6000 + i}"] = rec
        snap[s] = recs
    return snap


# -- stage_loads and serving_nodes ------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_stage_loads_and_serving_nodes_equal_reference(seed):
    rng = random.Random(seed)
    for _ in range(300):
        snap = _random_snapshot(rng)
        assert pbal.stage_loads(snap) == jbal.stage_loads(snap)
        for stage_map in snap.values():
            assert pbal.serving_nodes(stage_map) == jbal.serving_nodes(stage_map)


# -- Balancer decisions -----------------------------------------------------------------


def _decide_both(snap, num_stages, own_stage, node_id, clock_script=(0.0,), **kw):
    """Run rebalance_once on a port and a reference Balancer over the same
    snapshot at each time of `clock_script`; returns both runs' (migrated,
    targets moved to, events) per tick."""
    out = []
    for mod in (pbal, jbal):
        now = [0.0]
        moved, events = [], []
        stage = [own_stage]
        if mod is pbal:
            def change(s):
                moved.append(s)
                stage[0] = s
        else:
            async def change(s):
                moved.append(s)
                stage[0] = s
        b = mod.Balancer(FakeDHT(snap, node_id), num_stages, get_own_stage=lambda: stage[0],
                         change_stage=change, clock=lambda: now[0],
                         on_event=lambda etype, **a: events.append((etype, a)), **kw)
        ticks = []
        for t in clock_script:
            now[0] = t
            stage[0] = own_stage  # each tick decides from the same place
            r = b.rebalance_once()
            ticks.append((asyncio.run(r) if mod is jbal else r, list(moved), list(events)))
        out.append(ticks)
    return out


TEST_NODE_E2E_CASES = [
    # the reference's test_balancer_decision_logic: a hot stage 0, two idle
    # stage-1 replicas -> one moves; the stage's only replica never leaves;
    # balanced -> no move
    ({0: {"a": {"load": 8, "cap": 1}},
      1: {"b": {"load": 0, "cap": 1}, "c": {"load": 0, "cap": 1}}}, 1, None, True),
    ({0: {"a": {"load": 8, "cap": 1}}, 1: {"b": {"load": 0, "cap": 1}}}, 1, None, False),
    ({0: {"a": {"load": 1, "cap": 1}},
      1: {"b": {"load": 1, "cap": 1}, "c": {"load": 1, "cap": 1}}}, 1, None, False),
]


@pytest.mark.parametrize("snap, own_stage, node_id, want", TEST_NODE_E2E_CASES)
def test_reference_e2e_decisions(snap, own_stage, node_id, want):
    port, ref = _decide_both(snap, 2, own_stage, node_id)
    assert port == ref and port[0][0] is want
    if want:
        assert port[0][1] == [0]


def test_tolerance_min_stage_is_eligible():
    """Two near-equal min stages: a replica of either, within min_load_tol
    of the min, may move to the hot stage (exact float equality would
    deadlock them)."""
    snap = {
        0: {"a0": {"load": 40, "cap": 4}},
        1: {"b0": {"load": 1, "cap": 100}, "b1": {"load": 0, "cap": 100}},  # 0.005
        2: {"c0": {"load": 0, "cap": 4}, "c1": {"load": 0, "cap": 4}},  # 0.0
    }
    port, ref = _decide_both(snap, 3, 1, "b0")
    assert port == ref and port[0][0] is True and port[0][1] == [0]
    port, ref = _decide_both(snap, 3, 1, "b0", min_load_tol=0.001)
    assert port == ref and port[0][0] is False


def test_all_draining_stage_reads_starved_and_is_left_to_adoption():
    snap = {
        0: {"a0": {"load": 9, "cap": 4, "draining": 1}},
        1: {"b0": {"load": 0, "cap": 4}, "b1": {"load": 0, "cap": 4}},
    }
    assert math.isinf(pbal.stage_loads(snap)[0])
    port, ref = _decide_both(snap, 2, 1, "b0")
    # starved but not empty: not adopted, and not the max-load pick either
    assert port == ref and port[0][0] is False and port[0][2] == []
    # once its last record goes, the min-id donor adopts it
    del snap[0]["a0"]
    port, ref = _decide_both(snap, 2, 1, "b0")
    assert port == ref and port[0][1] == [0]
    assert port[0][2] == [("stage.adopt", {"stage": 0, "reason": "empty_stage", "own_stage": 1})]


def test_dwell_spaces_migrations():
    """A mover sits out min_dwell_s after a move: the clock script 0, 10,
    29.9, 30, 45 moves at 0, 30 (30 after the first) and not between."""
    snap = {0: {"a": {"load": 8, "cap": 1}},
            1: {"b": {"load": 0, "cap": 1}, "c": {"load": 0, "cap": 1}}}
    port, ref = _decide_both(snap, 2, 1, "b", clock_script=(0.0, 10.0, 29.9, 30.0, 45.0))
    assert port == ref
    assert [t[0] for t in port] == [True, False, False, True, False]


def test_cost_gate_and_projected_gain_to_the_float():
    """The reference's unrelated-starved-stage case: a swap of the 0.5/0.25
    ratios gains 0 (no move); a starved target gains inf; and over seeded
    snapshots every (own stage, target) gain equals the reference's bit for
    bit."""
    snap = {
        0: {"a0": {"load": 2, "cap": 4}},
        1: {"b0": {"load": 1, "cap": 4}, "b1": {"load": 1, "cap": 4}},
        2: {"c0": {"load": 9, "cap": 4, "draining": 1}},
    }
    loads = pbal.stage_loads(snap)
    p = pbal.Balancer(FakeDHT(snap, "b0"), 3, get_own_stage=lambda: 1, change_stage=None)
    j = jbal.Balancer(FakeDHT(snap, "b0"), 3, get_own_stage=lambda: 1, change_stage=None)
    assert p._projected_gain(snap, loads, 1, 0) == j._projected_gain(snap, loads, 1, 0) == 0.0
    assert p._projected_gain(snap, loads, 1, 2) == math.inf
    port, ref = _decide_both(snap, 3, 1, "b0")
    assert port == ref and port[0][0] is False
    rng = random.Random(11)
    compared = 0
    for _ in range(400):
        snap = _random_snapshot(rng)
        loads = pbal.stage_loads(snap)
        for own_stage, stage_map in snap.items():
            for nid in stage_map:
                p = pbal.Balancer(FakeDHT(snap, nid), len(snap), get_own_stage=lambda: own_stage,
                                  change_stage=None)
                j = jbal.Balancer(FakeDHT(snap, nid), len(snap), get_own_stage=lambda: own_stage,
                                  change_stage=None)
                for target in snap:
                    if target == own_stage:
                        continue
                    a = p._projected_gain(snap, loads, own_stage, target)
                    b = j._projected_gain(snap, loads, own_stage, target)
                    assert a == b or (math.isnan(a) and math.isnan(b))
                    compared += 1
    assert compared > 1000


def test_anti_herd_moves_only_the_min_id_replica():
    snap = {0: {"a": {"load": 8, "cap": 1}},
            1: {"m": {"load": 0, "cap": 1}, "k": {"load": 0, "cap": 1}, "z": {"load": 0, "cap": 1}}}
    moved = {}
    for nid in snap[1]:
        port, ref = _decide_both(snap, 2, 1, nid)
        assert port == ref
        moved[nid] = port[0][0]
    assert moved == {"k": True, "m": False, "z": False}


@pytest.mark.parametrize("seed", range(3))
def test_random_snapshots_decide_as_the_reference(seed):
    """Every replica of every seeded snapshot decides as the reference does,
    over one clock script (its moves, events and their attributes)."""
    rng = random.Random(100 + seed)
    decided = moves = 0
    for _ in range(120):
        snap = _random_snapshot(rng)
        for own_stage, stage_map in snap.items():
            for nid in stage_map:
                port, ref = _decide_both(snap, len(snap), own_stage, nid,
                                         clock_script=(0.0, 5.0, 31.0))
                assert port == ref, (snap, own_stage, nid)
                decided += 1
                moves += bool(port[-1][1])
    assert decided > 500 and moves > 20


# -- the adoption race ------------------------------------------------------------------


@pytest.mark.parametrize("path", ["rebalance", "hook"])
def test_exactly_one_replica_adopts_an_empty_stage(path):
    """60 replicas of two donor stages see stage 2 empty in one snapshot:
    exactly one adopts it, the fleet-wide min-id donor, on the periodic
    sweep and through the PathFinder hook alike; the reference agrees."""
    rng = random.Random(7)
    snap = {0: {}, 1: {}, 2: {}}
    for s in (0, 1):
        for i in range(30):
            snap[s][f"10.1.{rng.randint(0, 255)}.{rng.randint(0, 255)}:{7000 + 30 * s + i}"] = {
                "stage": s, "load": rng.randint(0, 4), "cap": 4}
    donors = [nid for s in (0, 1) for nid in snap[s]]
    adopters = {"port": [], "ref": []}
    for own_stage in (0, 1):
        for nid in snap[own_stage]:
            for name, mod in (("port", pbal), ("ref", jbal)):
                moved = []
                if mod is pbal:
                    def change(s, moved=moved):
                        moved.append(s)
                else:
                    async def change(s, moved=moved):
                        moved.append(s)
                b = mod.Balancer(FakeDHT(snap, nid), 3, get_own_stage=lambda s=own_stage: s,
                                 change_stage=change)
                r = b.rebalance_once() if path == "rebalance" else b.adopt_stage(2)
                r = asyncio.run(r) if mod is jbal else r
                if r:
                    assert moved == [2]
                    adopters[name].append(nid)
    assert adopters["port"] == adopters["ref"] == [min(donors)]


# -- the port's threads -----------------------------------------------------------------


def test_loop_thread_ticks_logs_failures_and_stops():
    ticks = []

    class Flaky(FakeDHT):
        def get_all(self, n):
            ticks.append(time.monotonic())
            if len(ticks) == 2:
                raise RuntimeError("a broken view")
            return {0: {}, 1: {}}

    b = pbal.Balancer(Flaky(None, "x"), 2, get_own_stage=lambda: 0, change_stage=None,
                      period_s=0.02, rng=random.Random(0))
    b.start()
    deadline = time.monotonic() + 5
    while len(ticks) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    b.stop()
    n = len(ticks)
    assert n >= 4  # a tick that raised did not end the loop
    time.sleep(0.1)
    assert len(ticks) == n and b._thread is None


def test_a_migration_while_one_runs_returns_false():
    """_migrating is taken without blocking: a second decision while a
    migration runs does not migrate (the reference's locked() check)."""
    snap = {0: {}, 1: {"a": {"load": 0, "cap": 1}, "b": {"load": 0, "cap": 1}}}
    entered, release = threading.Event(), threading.Event()
    moves = []

    def slow_change(s):
        moves.append(s)
        entered.set()
        release.wait(5)

    b = pbal.Balancer(FakeDHT(snap, "a"), 2, get_own_stage=lambda: 1, change_stage=slow_change)
    results = []
    t = threading.Thread(target=lambda: results.append(b.adopt_stage(0)))
    t.start()
    assert entered.wait(5)
    assert b.rebalance_once() is False and b.adopt_stage(0) is False
    release.set()
    t.join(5)
    assert results == [True] and moves == [0]


# -- AutoScaler ---------------------------------------------------------------------------


def _actions(mod, scaler_args, snaps_and_times, **cfg):
    now = [0.0]
    events = []
    a = mod.AutoScaler(*scaler_args, cfg=mod.AutoscaleConfig(**cfg), clock=lambda: now[0],
                       on_event=lambda etype, **kw: events.append((etype, kw)))
    out = []
    for t, snap in snaps_and_times:
        now[0] = t
        out.append([(x.kind, x.stage, x.count, x.src_stage, x.reason, x.render())
                    for x in a.decide(snap)])
    return out, events, a.decisions


def _snap(load0, kvfree=None, burn=None, n0=2, load1=1, n1=2):
    s0 = {f"a{i}": {"load": load0, "cap": 4, **({"kvfree": kvfree} if kvfree is not None else {}),
                    **({"burn": burn} if burn is not None else {})} for i in range(n0)}
    return {0: s0, 1: {f"b{i}": {"load": load1, "cap": 4} for i in range(n1)}}


AUTOSCALE_CASES = {
    # the reference's test_autoscale_policy_triggers_and_dwell, in one script
    "load_and_dwell": ([(0.0, _snap(4)), (1.0, _snap(4)), (31.0, _snap(4))], {"cooldown_s": 30.0}),
    "kvfree": ([(100.0, _snap(1, kvfree=0.05))], {}),
    "burn": ([(100.0, _snap(1, burn=20.0))], {}),
    "idle": ([(100.0, _snap(0, load1=0))], {}),
    "idle_min_replicas": ([(100.0, _snap(0, load1=0))], {"min_replicas": 2}),
    # test_autoscale_repartition_advice
    "repartition": ([(0.0, {0: {f"a{i}": {"load": 2, "cap": 4} for i in range(2)},
                            1: {f"b{i}": {"load": 1, "cap": 4} for i in range(2)}})], {}),
    "starved": ([(0.0, {0: {"a": {"load": 1, "cap": 4, "draining": 1}},
                        1: {"b": {"load": 1, "cap": 4}}})], {}),
}


@pytest.mark.parametrize("case", sorted(AUTOSCALE_CASES))
def test_autoscale_cases_equal_reference(case):
    script, cfg = AUTOSCALE_CASES[case]
    got = _actions(pauto, (2,), script, **cfg)
    assert got == _actions(jauto, (2,), script, **cfg)
    kinds = [[a[0] for a in tick] for tick in got[0]]
    want = {"load_and_dwell": [["scale_up"], [], ["scale_up"]], "kvfree": [["scale_up"]],
            "burn": [["scale_up"]], "idle": [["scale_down", "scale_down"]],
            "idle_min_replicas": [[]], "repartition": [["repartition"]],
            "starved": [["scale_up"]]}[case]
    assert kinds == want
    if case == "repartition":
        assert "repartition 1->0" in got[0][0][0][5]


@pytest.mark.parametrize("seed", range(3))
def test_autoscale_random_snapshots_equal_reference(seed):
    """Seeded snapshots with load, kvfree, burn and draining, over a clock
    that crosses the dwell: the same actions, events and decision count."""
    rng = random.Random(200 + seed)
    script, t = [], 0.0
    for _ in range(150):
        snap = _random_snapshot(rng, stages=3)
        for recs in snap.values():
            for rec in recs.values():
                if rng.random() < 0.5:
                    rec["kvfree"] = rng.choice([0.02, 0.1, 0.15, 0.5, 1.0])
                if rng.random() < 0.4:
                    rec["burn"] = rng.choice([0.0, 0.5, 3.0, 14.0, 30.0])
        t += rng.choice([1.0, 5.0, 20.0, 61.0])
        script.append((t, snap))
    got = _actions(pauto, (3,), script)
    assert got == _actions(jauto, (3,), script)
    kinds = {a[0] for tick in got[0] for a in tick}
    assert {"scale_up", "scale_down"} <= kinds


def test_stage_signals_equal_reference():
    rng = random.Random(5)
    for _ in range(200):
        snap = _random_snapshot(rng)
        for recs in snap.values():
            for rec in recs.values():
                if rng.random() < 0.5:
                    rec["kvfree"] = rng.random()
                if rng.random() < 0.5:
                    rec["burn"] = rng.random() * 20
        assert pauto.stage_signals(snap) == jauto.stage_signals(snap)
