"""The port's next-hop routing (inferd_tpu_torch/control/path_finder.py and
the node's `_pick_next`) against the reference's: the ranked and min-load
picks equal the reference's on drawn gossip records, the empty-stage retry
loop gives up with NoNodeForStage, the dead-peer cooldown steers fresh
picks, and a session sticks to its replica whatever the loads do."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu.control import path_finder as ref
from inferd_tpu_torch.control import path_finder as port
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime.executor import make_executor
from inferd_tpu_torch.runtime.node import Node

records = st.fixed_dictionaries(
    {"stage": st.just(1), "load": st.integers(0, 12), "host": st.just("127.0.0.1"),
     "port": st.integers(1, 65535)},
    optional={"cap": st.integers(0, 8), "outlier": st.sampled_from([0, 1]),
              "shed": st.sampled_from([0, 1]), "draining": st.sampled_from([0, 1]),
              "kvfree": st.sampled_from([0.0, 0.01, 0.02, 0.5, 1.0]),
              "depth": st.sampled_from([0.0, 0.25, 1.0, "bad"])},
)
stage_maps = st.dictionaries(st.sampled_from([f"n{i}" for i in range(6)]), records, max_size=6)


class Probe:
    """An affinity probe scoring a record by its `depth` key (a bad one raises)."""

    def depth_frac(self, value):
        return float(value.get("depth", 0.0))


@settings(max_examples=300, deadline=None)
@given(stage_maps, st.sets(st.sampled_from([f"n{i}" for i in range(6)]), max_size=3),
       st.booleans())
def test_ranked_and_min_load_equal_the_reference(stage_map, exclude, with_affinity):
    affinity = Probe() if with_affinity else None
    assert (port.ranked_nodes(stage_map, exclude, affinity=affinity)
            == ref.ranked_nodes(stage_map, exclude, affinity=affinity))
    try:
        want = ref.min_load_node(stage_map, exclude, affinity=affinity)
    except ref.NoNodeForStage:
        with pytest.raises(port.NoNodeForStage):
            port.min_load_node(stage_map, exclude, affinity=affinity)
    else:
        assert port.min_load_node(stage_map, exclude, affinity=affinity) == want


class Store:
    def __init__(self, recs):
        self.recs = recs
        self.reads = 0

    def get_stage(self, stage):
        self.reads += 1
        return dict(self.recs)


def test_find_best_node_retries_then_raises():
    store, sleeps, empty = Store({}), [], []
    pf = port.PathFinder(store, 2, on_empty_stage=empty.append, retries=3, retry_delay_s=0.25,
                         sleep=sleeps.append)
    with pytest.raises(port.NoNodeForStage, match="stage 1"):
        pf.find_best_node(1)
    assert store.reads == 4 and sleeps == [0.25] * 3 and empty == [1, 1, 1]


def test_find_best_node_finds_a_replica_that_appears_while_it_waits():
    rec = {"stage": 1, "load": 0, "cap": 1, "host": "h", "port": 1}
    store = Store({})
    pf = port.PathFinder(store, 2, retries=3, retry_delay_s=0.0,
                         sleep=lambda _s: store.recs.update(A=rec))
    assert pf.find_best_node(1) == ("A", rec)
    assert pf.find_ranked(1) == [("A", rec)]


def test_held_sessions_count_as_load():
    """The caller's own live sessions on each replica join its gossiped load,
    and the record returned is the gossiped one."""
    recs = {"A": {"stage": 1, "load": 0, "cap": 2, "host": "h", "port": 1},
            "B": {"stage": 1, "load": 1, "cap": 2, "host": "h", "port": 2}}
    pf = port.PathFinder(Store(recs), 2)
    assert pf.find_best_node(1) == ("A", recs["A"])
    assert pf.find_best_node(1, held={"A": 2}) == ("B", recs["B"])
    assert pf.find_best_node(1, held={"A": 1}) == ("A", recs["A"])  # a tie keeps the order
    assert recs["A"]["load"] == 0


def test_dead_peer_cooldown_expires():
    now = [0.0]
    pf = port.PathFinder(Store({}), 2, dead_cooldown_s=10.0, clock=lambda: now[0])
    pf.note_peer_dead("A")
    assert pf.cooling() == {"A"}
    now[0] = 10.5
    assert pf.cooling() == set()


@pytest.fixture
def node():
    n = Node(make_executor(None, StageSpec(0, 2, 0, 0), backend="counter"))
    n.path_finder.retry_delay_s = 0.0
    n.start()
    yield n
    n.stop()


def test_session_affinity_sticky_across_load_changes(node):
    """Once a session lands on a replica, later chunks follow it even when
    the other replica becomes less loaded (its KV lives there)."""
    rec_a = {"stage": 1, "load": 0, "cap": 1, "host": "127.0.0.1", "port": 1}
    rec_b = {"stage": 1, "load": 5, "cap": 1, "host": "127.0.0.1", "port": 2}
    node.dht.get_stage = Store({"A": rec_a, "B": rec_b}).get_stage
    nid1, _ = node._pick_next("sess", 1)
    assert nid1 == "A"  # min load
    rec_a["load"] = 100  # A becomes heavily loaded; the session still routes to A
    assert node._pick_next("sess", 1)[0] == "A"
    assert node._pick_next("sess2", 1)[0] == "B"  # a NEW session picks the lighter B
    # if A disappears, the affinity entry is dropped and re-picked
    node.dht.get_stage = Store({"B": rec_b}).get_stage
    assert node._pick_next("sess", 1)[0] == "B"


def test_fresh_picks_steer_around_a_cooling_peer_unless_it_is_the_last(node):
    rec_a = {"stage": 1, "load": 0, "cap": 1, "host": "127.0.0.1", "port": 1}
    rec_b = {"stage": 1, "load": 3, "cap": 1, "host": "127.0.0.1", "port": 2}
    node.dht.get_stage = Store({"A": rec_a, "B": rec_b}).get_stage
    node._note_peer_failure("A")
    assert node._pick_next("s1", 1)[0] == "B"
    node.dht.get_stage = Store({"A": rec_a}).get_stage  # availability beats steering
    assert node._pick_next("s2", 1)[0] == "A"
    with pytest.raises(port.NoNodeForStage):
        node._pick_next("s4", 1, exclude={"A"})


def test_concurrent_fresh_picks_spread_over_the_replicas(node):
    """Sixteen threads pick new sessions at once, the switch interval short:
    each pick counts the sessions held before it, so the two equally loaded
    replicas end up holding 8 each (a lost update would skew them)."""
    import sys
    import threading

    recs = {n: {"stage": 1, "load": 0, "cap": 4, "host": "127.0.0.1", "port": i}
            for i, n in enumerate(("A", "B"))}
    node.dht.get_stage = Store(recs).get_stage
    picks, saved = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: picks.append(node._pick_next(f"s{i}", 1)[0]))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert sorted(picks) == ["A"] * 8 + ["B"] * 8
    assert node._held(1) == {"A": 8, "B": 8}
