"""The port's D*-Lite chain planner (inferd_tpu_torch/control/dstar.py) and
PathFinder.find_best_chain against the reference's:

  * `node_cost` equals the reference's on drawn records: load/cap, svc_ms,
    hop_p99_ms, outlier, draining, shed and kvfree, with and without an
    AffinityProbe scoring a `pfx` digest;
  * SwarmChainPlanner gives the reference's chain and `stats` after every
    step of the same seeded scripts (build, cost drift, join, death, flap,
    kill_node, advance, an empty stage's rebuild), and best_chain_over_swarm
    the reference's chain, raising NoNodeForStage on an empty stage;
  * after drawn update sequences the incremental plan costs what a solve
    from scratch costs (the property of tests/test_dstar_fuzz.py);
  * find_best_chain equals the reference's through cooling, the greedy
    fallback and the entry stage's affinity re-rank; with `held` and
    `new_session` it plans over the records as find_best_node ranks them
    and returns the gossiped records; threads share one planner safely.
"""

import copy
import heapq
import math
import random
import sys
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu.control import dstar as rdstar
from inferd_tpu.control import path_finder as rpf
from inferd_tpu.core import prefix as rprefix
from inferd_tpu_torch.control import dstar
from inferd_tpu_torch.control import path_finder as pf
from inferd_tpu_torch.core import prefix
from inferd_tpu_torch.obs.canary import ADMISSION_PENALTY

PROMPT = list(range(3, 3 + 96))  # three 32-token blocks
DIGESTS = [prefix.make_digest(prefix.block_keys(PROMPT[:n], 32), 32) for n in (32, 96)]


# -- node_cost -------------------------------------------------------------------------

records = st.fixed_dictionaries(
    {"load": st.integers(0, 12)},
    optional={"cap": st.integers(0, 8),
              "svc_ms": st.floats(0.0, 500.0, allow_nan=False),
              "hop_p99_ms": st.floats(0.0, 3000.0, allow_nan=False),
              "outlier": st.sampled_from([0, 1]), "draining": st.sampled_from([0, 1]),
              "shed": st.sampled_from([0, 1]),
              "kvfree": st.sampled_from([0.0, 0.01, 0.02, 0.5]),
              "pfx": st.sampled_from(DIGESTS + [{"bs": 32, "k": "bad"}])},
)


@settings(max_examples=300, deadline=None)
@given(records, st.sampled_from([None, 32, 64, 96]), st.floats(10.0, 400.0))
def test_node_cost_equals_the_reference(value, probe_len, lat_norm_ms):
    ours = theirs = None
    if probe_len is not None:
        ours = prefix.AffinityProbe(PROMPT[:probe_len])
        theirs = rprefix.AffinityProbe(PROMPT[:probe_len])
    got = dstar.node_cost(value, lat_norm_ms, affinity=ours)
    assert got == rdstar.node_cost(value, lat_norm_ms, affinity=theirs)
    assert got > 0  # D*-Lite needs positive edges


def test_node_cost_terms():
    base = {"load": 2, "cap": 4}
    assert dstar.node_cost(base) == 1.5
    assert dstar.node_cost(dict(base, svc_ms=50.0, hop_p99_ms=100.0)) == 1.5 + 0.5 + 0.5
    assert dstar.node_cost(dict(base, draining=1)) == 1.5 + dstar.DRAINING_PENALTY
    probe = prefix.AffinityProbe(PROMPT)
    assert dstar.node_cost(dict(base, pfx=DIGESTS[1]), affinity=probe) == 1.0
    assert dstar.node_cost(dict(base, pfx=DIGESTS[1], shed=1), affinity=probe) == 3.5
    assert dstar.node_cost(dict(base, shed=1)) == 1.5  # no affinity: the plan ignores shed


# -- SwarmChainPlanner against the reference on seeded scripts ---------------------------


def _value(rng):
    v = {"load": rng.randint(0, 12), "cap": rng.choice([1, 2, 4, 8])}
    if rng.random() < 0.5:
        v["svc_ms"] = round(rng.uniform(1.0, 400.0), 3)
    if rng.random() < 0.3:
        v["hop_p99_ms"] = round(rng.uniform(1.0, 2000.0), 3)
    if rng.random() < 0.1:
        v["outlier"] = 1
    if rng.random() < 0.05:
        v["draining"] = 1
    return v


def _script(name, seed):
    """(num_stages, first snapshot, steps) of one seeded script; a step is
    ("refresh", snapshot) or ("kill", node_id). "build" refreshes with the
    snapshot unchanged; "advance" drifts costs while the test walks."""
    rng = random.Random(seed)
    num_stages = rng.randint(2, 4)
    snap = {s: {f"s{s}n{i}": _value(rng) for i in range(rng.randint(2, 3))}
            for s in range(num_stages)}
    if name == "empty_stage_rebuild":
        snap[num_stages - 1] = {}
    first = copy.deepcopy(snap)
    steps, next_id, graveyard = [], [100], []
    for _ in range(12):
        if name in ("drift", "build"):
            s = rng.randrange(num_stages)
            nid = rng.choice(sorted(snap[s]))
            snap[s][nid] = _value(rng) if name == "drift" else snap[s][nid]
        elif name in ("join", "empty_stage_rebuild"):
            s = num_stages - 1 if name == "empty_stage_rebuild" else rng.randrange(num_stages)
            snap[s][f"s{s}n{next_id[0]}"] = _value(rng)
            next_id[0] += 1
        elif name in ("death", "flap", "kill_node"):
            if graveyard and (name == "flap" or rng.random() < 0.3):
                s, nid, v = graveyard.pop()
                snap[s][nid] = v
            else:
                s = rng.randrange(num_stages)
                if len(snap[s]) > 1:
                    nid = rng.choice(sorted(snap[s]))
                    graveyard.append((s, nid, snap[s].pop(nid)))
                    if name == "kill_node":
                        steps.append(("kill", nid))
        elif name == "advance":
            s = rng.randrange(num_stages)
            nid = rng.choice(sorted(snap[s]))
            snap[s][nid] = _value(rng)
        steps.append(("refresh", copy.deepcopy(snap)))
    return num_stages, first, steps


def _outcome(planner, exc):
    try:
        return planner.chain()
    except exc as e:
        return ("no chain", str(e))


SCRIPTS = ("build", "drift", "join", "death", "flap", "kill_node", "advance",
           "empty_stage_rebuild")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", SCRIPTS)
def test_planner_chain_and_stats_equal_the_reference(name, seed):
    num_stages, first, steps = _script(name, seed)
    ours = dstar.SwarmChainPlanner(copy.deepcopy(first), 0, num_stages)
    theirs = rdstar.SwarmChainPlanner(copy.deepcopy(first), 0, num_stages)
    walked = 0
    for i, step in enumerate(steps):
        if step[0] == "refresh":
            assert ours.refresh(copy.deepcopy(step[1])) == theirs.refresh(copy.deepcopy(step[1]))
        else:
            assert ours.kill_node(step[1]) == theirs.kill_node(step[1])
        got = _outcome(ours, pf.NoNodeForStage)
        assert got == _outcome(theirs, rpf.NoNodeForStage), (name, i)
        assert ours.stats == theirs.stats, (name, i)
        if name == "advance" and walked < num_stages - 1 and i % 4 == 3:
            s, nid, _ = got[0]  # the session commits its next hop
            ours.advance(s, nid)
            theirs.advance(s, nid)
            walked += 1
            assert ours.chain() == theirs.chain() and ours.stats == theirs.stats
    if name == "empty_stage_rebuild":
        assert ours.stats["builds"] == 2  # the stage came back: one rebuild, then splices
    elif name in ("join", "drift", "death", "flap", "kill_node"):
        assert ours.stats["builds"] == 1
    if name == "kill_node":
        assert ours.stats["kills"] >= 1


@pytest.mark.parametrize("seed", range(5))
def test_best_chain_over_swarm_equals_the_reference(seed):
    num_stages, snap, _ = _script("drift", seed)
    assert (dstar.best_chain_over_swarm(snap, 0, num_stages)
            == rdstar.best_chain_over_swarm(snap, 0, num_stages))
    assert (dstar.best_chain_over_swarm(snap, 1, num_stages)
            == rdstar.best_chain_over_swarm(snap, 1, num_stages))
    snap[num_stages - 1] = {}
    with pytest.raises(pf.NoNodeForStage, match="no complete chain"):
        dstar.best_chain_over_swarm(snap, 0, num_stages)


# -- the incremental property -----------------------------------------------------------


def _scratch_cost(snapshot, num_stages):
    g = dstar.build_layered_graph(snapshot, 0, num_stages)
    dist, seen, pq, seq = {dstar.START: 0.0}, set(), [(0.0, 0, dstar.START)], 1
    while pq:
        d, _, u = heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        if u == dstar.GOAL:
            return d
        for v, c in g.succ(u):
            if d + c < dist.get(v, math.inf):
                dist[v] = d + c
                heapq.heappush(pq, (d + c, seq, v))
                seq += 1
    return math.inf


ops = st.lists(st.tuples(st.sampled_from(["drift", "dead", "kill", "join", "revive"]),
                         st.integers(0, 3), st.integers(0, 2**16), st.integers(0, 12),
                         st.floats(0.0, 400.0)), max_size=14)


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 4), st.integers(1, 3), ops)
def test_incremental_plan_costs_what_a_solve_from_scratch_costs(num_stages, width, seq):
    snap = {s: {f"s{s}x{i}": {"load": i, "cap": 4} for i in range(width)}
            for s in range(num_stages)}
    planner = dstar.SwarmChainPlanner(copy.deepcopy(snap), 0, num_stages)
    graveyard, joined = [], 0
    for op, stage, pick, load, svc in seq:
        s = stage % num_stages
        names = sorted(snap[s])
        if op == "drift":
            snap[s][names[pick % len(names)]] = {"load": load, "cap": 4, "svc_ms": svc}
        elif op in ("dead", "kill") and len(names) > 1:
            nid = names[pick % len(names)]
            graveyard.append((s, nid, snap[s].pop(nid)))
            if op == "kill":
                planner.kill_node(nid)
        elif op == "join":
            snap[s][f"s{s}j{joined}"] = {"load": load, "cap": 4}
            joined += 1
        elif op == "revive" and graveyard:
            s, nid, v = graveyard.pop(pick % len(graveyard))
            snap[s][nid] = v
        planner.refresh(copy.deepcopy(snap))
        got = sum(dstar.node_cost(snap[st_][nid]) for st_, nid, _ in planner.chain())
        assert abs(got - _scratch_cost(snap, num_stages)) < 1e-6
    assert planner.stats["builds"] == 1  # every stage stayed live: splices, no rebuild


# -- find_best_chain ---------------------------------------------------------------------


class Store:
    """A gossip store stand-in: its records and a clock for the cooldown."""

    def __init__(self, snap):
        self.snap = snap

    def get_all(self, num_stages=None):
        out = copy.deepcopy(self.snap)
        for s in range(num_stages or 0):
            out.setdefault(s, {})
        return out

    def get_stage(self, stage):
        return copy.deepcopy(self.snap.get(stage, {}))


def _rec(load, cap=4, **kw):
    return {"load": load, "cap": cap, "host": "127.0.0.1", "port": 1, **kw}


def test_find_best_chain_equals_the_reference_through_cooling_fallback_and_affinity():
    now = [0.0]
    snap = {0: {"e0": _rec(0), "e1": _rec(1, pfx=DIGESTS[1])},
            1: {"a": _rec(0, svc_ms=30.0), "b": _rec(0, svc_ms=10.0)},
            2: {"z": _rec(2)}}
    store = Store(snap)
    ours = pf.PathFinder(store, 3, clock=lambda: now[0])
    theirs = rpf.PathFinder(store, 3, clock=lambda: now[0])

    def both(start=0, probe_len=None):
        a = b = None
        if probe_len:
            a = prefix.AffinityProbe(PROMPT[:probe_len])
            b = rprefix.AffinityProbe(PROMPT[:probe_len])
        got = ours.find_best_chain(start, affinity=a)
        assert got == theirs.find_best_chain(start, affinity=b)
        assert ours.planner_stats() == (None if theirs.planner is None
                                        else theirs.planner.stats)
        return [n for n, _ in got]

    assert both() == ["e0", "b", "z"]
    assert both(probe_len=96) == ["e1", "b", "z"]  # the digest holder wins the entry
    snap[1]["b"]["load"] = 8  # drift: an incremental replan
    assert both() == ["e0", "a", "z"]
    for planner in (ours, theirs):
        planner.note_peer_dead("a")  # cooling: out of the plan while b is left
    assert both() == ["e0", "b", "z"]
    assert ours.planner.stats["kills"] == 1
    now[0] = 11.0  # the cooldown is over
    assert both() == ["e0", "a", "z"]
    snap[1]["a"]["svc_ms"] = "bad"  # a malformed record fails the planner: greedy
    assert both() == ["e0", "a", "z"] and ours.planner is None
    snap[1]["a"]["svc_ms"] = 1.0
    assert both(1) == ["a", "z"]  # another start stage: a new planner
    snap[2] = {}
    with pytest.raises(pf.NoNodeForStage):
        ours.find_best_chain(0)
    with pytest.raises(rpf.NoNodeForStage):
        theirs.find_best_chain(0)


def test_find_best_chain_plans_over_held_sessions_and_shedding():
    snap = {1: {"a": _rec(0), "b": _rec(1), "c": _rec(0, shed=1)}}
    view = {1: {"a": _rec(2), "b": _rec(1), "c": _rec(ADMISSION_PENALTY * 4, shed=1)}}
    ours = pf.PathFinder(Store(snap), 2)
    got = ours.find_best_chain(1, held={"a": 2}, new_session=True)
    want = rdstar.best_chain_over_swarm(view, 1, 2)
    assert [n for n, _ in got] == [n for n, _ in want] == ["b"]
    assert got == [("b", snap[1]["b"])]  # the gossiped record, not the view
    # a shedding replica costs ADMISSION_PENALTY more for a new session only
    assert ours.find_best_chain(1, held={"a": 4, "b": 4}, new_session=True)[0][0] != "c"
    assert ours.find_best_chain(1, held={"a": 4, "b": 4})[0][0] == "c"
    # as the fresh pick ranks them
    assert ours.find_best_node(1, held={"a": 2}, new_session=True)[0] == "b"


def test_threads_share_the_planner():
    """Twelve threads plan, each with its own held counts, while another
    kills and revives a replica, the switch interval short: every call
    folds exactly one build or refresh into the planner's stats (a lost
    update of its maps or counters would break the count or the chain)."""
    snap = {0: {f"n{i}": _rec(i % 3) for i in range(4)},
            1: {f"m{i}": _rec(i % 2) for i in range(4)}}
    now = [0.0]
    finder = pf.PathFinder(Store(snap), 2, clock=lambda: now[0], dead_cooldown_s=0.0)
    calls, errors, saved = 12 * 20, [], sys.getswitchinterval()

    def plan(i):
        try:
            for k in range(20):
                chain = finder.find_best_chain(0, held={f"n{k % 4}": i})
                assert [n[0] for n, _ in chain] == ["n", "m"]
        except Exception as e:  # reported below
            errors.append(e)

    def kill():
        for _ in range(50):
            finder.note_peer_dead("m0")

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=plan, args=(i,)) for i in range(12)]
        threads.append(threading.Thread(target=kill))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads) and not errors
    stats = finder.planner_stats()
    assert stats["builds"] + stats["refreshes"] == calls
