"""The port's gossip store (inferd_tpu_torch/control/dht.py) against the
reference's (inferd_tpu/control/dht.py): the reference's loopback UDP
cases on the port (propagation over three nodes, owner-only writes, TTL
expiry, tombstone, late joiner, bootstrap retry); one seeded script of
announces, ticks and deliveries over an in-process transport run on both,
frame for frame and view for view; a reference store and a port store
gossiping over UDP; and the merge, held to the reference's merge on the
same frames and to the properties the reference passes."""

import asyncio
import random
import socket
import time

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu.control import dht as ref
from inferd_tpu_torch.control import dht as port
from inferd_tpu_torch.utils import msgpack_lite


def _mk(node_id, bootstrap=None, ttl=5.0, period=0.05):
    return port.SwarmDHT(node_id, 0, bootstrap=bootstrap or [], ttl_s=ttl,
                         gossip_period_s=period, host="127.0.0.1")


def _seed_of(store):
    return [("127.0.0.1", store.port)]


def _wait_for(cond, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def stores():
    made = []

    def make(*args, **kw):
        s = _mk(*args, **kw)
        made.append(s)
        return s

    yield make
    threads = [s._thread for s in made if s._thread is not None]
    for s in made:
        s.stop()
    assert not any(t.is_alive() for t in threads)


def test_gossip_propagation_three_nodes(stores):
    a = stores("a")
    a.start()
    b, c = stores("b", _seed_of(a)), stores("c", _seed_of(a))
    b.start()
    c.start()
    a.announce({"stage": 0, "load": 0, "cap": 1})
    b.announce({"stage": 1, "load": 2, "cap": 1})
    c.announce({"stage": 1, "load": 0, "cap": 1})
    assert _wait_for(lambda: len(a.get_stage(1)) == 2 and len(b.get_stage(0)) == 1
                     and len(c.get_stage(0)) == 1 and len(b.get_stage(1)) == 2), \
        "gossip did not converge"
    assert a.get_stage(1)["b"]["load"] == 2
    allmap = c.get_all(3)
    assert set(allmap) == {0, 1, 2} and allmap[2] == {}


def test_owner_only_writes_no_clobber(stores):
    a = stores("a")
    a.start()
    b = stores("b", _seed_of(a))
    b.start()
    for i in range(20):  # interleaved rapid announces
        a.announce({"stage": 0, "load": i, "cap": 1})
        b.announce({"stage": 0, "load": 100 + i, "cap": 1})
    assert _wait_for(lambda: a.get_stage(0).get("b", {}).get("load") == 119
                     and b.get_stage(0).get("a", {}).get("load") == 19)
    assert set(a.get_stage(0)) == {"a", "b"}


def test_ttl_expires_dead_node(stores):
    a, = [stores("a", ttl=0.6)]
    a.start()
    b = stores("b", _seed_of(a), ttl=0.6)
    b.start()
    a.announce({"stage": 0, "load": 0, "cap": 1})
    b.announce({"stage": 1, "load": 0, "cap": 1})
    assert _wait_for(lambda: len(a.get_stage(1)) == 1)
    b.kill()  # dies silently (no tombstone)
    assert _wait_for(lambda: len(a.get_stage(1)) == 0, timeout=3.0)


def test_withdraw_tombstone(stores):
    a = stores("a")
    a.start()
    b = stores("b", _seed_of(a))
    b.start()
    a.announce({"stage": 0, "load": 0, "cap": 1})
    b.announce({"stage": 1, "load": 0, "cap": 1})
    assert _wait_for(lambda: len(a.get_stage(1)) == 1)
    b.withdraw()
    assert _wait_for(lambda: len(a.get_stage(1)) == 0, timeout=3.0)


def test_late_joiner_bootstrap_state(stores):
    a = stores("a")
    a.start()
    a.announce({"stage": 0, "load": 3, "cap": 2})
    late = stores("late", _seed_of(a))
    late.start()
    assert _wait_for(lambda: late.get_stage(0).get("a", {}).get("load") == 3)


def test_bootstrap_retry_when_seed_starts_late(stores):
    """A node whose first hello is lost (the seed is not up) knocks again
    every period and converges once the seed appears."""
    hold = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    hold.bind(("127.0.0.1", 0))
    seed_port = hold.getsockname()[1]
    hold.close()  # the seed's port, unbound until the seed starts
    late = stores("late", [("127.0.0.1", seed_port)])
    late.start()  # the hello goes nowhere
    late.announce({"stage": 0, "load": 0, "cap": 1, "name": "late"})
    time.sleep(0.3)
    seed = port.SwarmDHT("seed", seed_port, host="127.0.0.1", gossip_period_s=0.05, ttl_s=5.0)
    try:
        seed.start()
        seed.announce({"stage": 1, "load": 0, "cap": 1, "name": "seed"})
        assert _wait_for(lambda: late.get_stage(1) and seed.get_stage(0))
    finally:
        seed.stop()


def test_start_adopts_the_ephemeral_port_and_a_taken_port_raises(stores):
    a = stores("a")
    a.announce({"stage": 0})  # before start: the record's addr has port 0
    a.start()
    assert a.port != 0 and a._records["a"].addr == ("127.0.0.1", a.port)
    clash = port.SwarmDHT("b", a.port, host="127.0.0.1")
    with pytest.raises(OSError):
        clash.start()
    assert clash._sock is None and clash._thread is None


def test_an_oversize_frame_is_logged_not_raised(stores, caplog):
    a = stores("a")
    a.start()
    b = stores("b", _seed_of(a))
    b.start()
    b.announce({"stage": 1, "blob": "x" * 70000}, urgent=False)
    with caplog.at_level("WARNING", logger=port.__name__):
        b.gossip_tick()
    assert any("gossip send" in r.getMessage() for r in caplog.records)
    assert b._thread.is_alive()


# -- the determinism seams: one script, both stores --------------------------------


class _Net:
    """An in-process datagram network: sends queue up, `deliver` hands the
    oldest to its destination through the store's own codec."""

    def __init__(self, unpack):
        self.unpack = unpack
        self.stores = {}
        self.frames = []
        self.queue = []

    def sendto(self, src, data, addr):
        self.frames.append((src.node_id, tuple(addr), bytes(data)))
        self.queue.append((src, data, tuple(addr)))

    def deliver(self, n):
        for _ in range(min(n, len(self.queue))):
            src, data, addr = self.queue.pop(0)
            dst = self.stores.get(addr)
            if dst is not None and dst._started:
                dst._on_message(self.unpack(data), (src.host, src.port))


def _script(seed, n_stores=4, steps=160):
    rng = random.Random(seed)
    ops = []
    for _ in range(steps):
        i = rng.randrange(n_stores)
        kind = rng.choice(["announce", "announce", "tick", "tick", "deliver", "deliver",
                           "advance", "withdraw" if rng.random() < 0.1 else "tick"])
        if kind == "announce":
            value = {"name": f"n{i}", "stage": i % 2, "load": rng.randrange(4), "cap": 4,
                     "host": f"10.0.0.{i}", "port": 6050, "model": "qwen3-0.6b"}
            if rng.random() < 0.3:
                value["svc_ms"] = round(rng.uniform(1, 50), 3)
            ops.append(("announce", i, value, rng.random() < 0.5))
        elif kind == "deliver":
            ops.append(("deliver", i, rng.randrange(1, 6), None))
        elif kind == "advance":
            ops.append(("advance", i, rng.choice([0.3, 1.0, 7.5, 20.0]), None))
        else:
            ops.append((kind, i, None, None))
    return ops


def _run(mod, unpack, ops, seed, n_stores=4):
    now = [1000.0]
    net = _Net(unpack)
    stores = []
    for i in range(n_stores):
        s = mod.SwarmDHT(f"n{i}", 7050, bootstrap=[("10.0.0.0", 7050)] if i else [],
                         ttl_s=15.0, host=f"10.0.0.{i}", clock=lambda: now[0],
                         rng=random.Random(seed * 31 + i), transport=net, fanout=2,
                         anti_entropy_every=2)
        net.stores[(s.host, s.port)] = s
        stores.append(s)
    for s in stores:
        s.start_local()
    for kind, i, arg, urgent in ops:
        if kind == "announce":
            stores[i].announce(arg, urgent=urgent)
        elif kind == "tick":
            stores[i].gossip_tick()
        elif kind == "deliver":
            net.deliver(arg)
        elif kind == "advance":
            now[0] += arg
        elif kind == "withdraw":
            stores[i].withdraw()
    views = [(s.get_all(2), sorted(s.peers()),
              {o: (r.version, r.ts, r.value, r.addr) for o, r in s._records.items()})
             for s in stores]
    return net.frames, views


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_gives_the_reference_frames_and_views(seed):
    ops = _script(seed)
    ref_frames, ref_views = _run(ref, lambda d: msgpack.unpackb(d, raw=False), ops, seed)
    got_frames, got_views = _run(port, msgpack_lite.unpackb, ops, seed)
    assert len(ref_frames) > 50 and any(v[0][1] for v in ref_views)
    assert got_frames == ref_frames
    assert got_views == ref_views


@pytest.mark.asyncio
async def test_a_reference_store_and_a_port_store_gossip_over_udp():
    r = ref.SwarmDHT("ref", 0, ttl_s=5.0, gossip_period_s=0.05, host="127.0.0.1")
    await r.start()
    p = _mk("port", [("127.0.0.1", r.port)])
    p.start()
    try:
        r.announce({"stage": 0, "load": 1, "cap": 4, "host": "127.0.0.1", "port": 1})
        p.announce({"stage": 1, "load": 2, "cap": 4, "host": "127.0.0.1", "port": 2,
                    "svc_ms": 3.5, "sess": ["00ff00ff00ff00ff"]})
        for _ in range(250):
            if r.get_stage(1) and p.get_stage(0):
                break
            await asyncio.sleep(0.02)
        assert r.get_stage(1) == {"port": p.get_stage(1)["port"]}
        assert r.get_stage(1)["port"]["sess"] == ["00ff00ff00ff00ff"]
        assert p.get_stage(0)["ref"]["load"] == 1
        p.withdraw()
        for _ in range(250):
            if not r.get_stage(1):
                break
            await asyncio.sleep(0.02)
        assert r.get_stage(1) == {}
    finally:
        p.stop()
        await r.stop()


# -- the merge ----------------------------------------------------------------------

OWNERS = [f"10.0.0.{i}:7050" for i in range(1, 5)]
wires = st.builds(
    lambda owner, version, ts, load, addr0: {
        "owner": owner, "value": {"stage": version % 3, "load": load},
        "version": version, "ts": float(ts), "addr": [addr0, 7050]},
    st.sampled_from(OWNERS), st.integers(0, 5), st.integers(0, 3), st.integers(0, 3),
    st.sampled_from(["10.0.0.1", "0.0.0.0"]),
)


def _state(store):
    return ({o: (r.version, r.ts, r.value, r.addr) for o, r in store._records.items()},
            dict(store._peers))


@settings(max_examples=150, deadline=None)
@given(st.lists(st.lists(wires, max_size=4), max_size=8),
       st.lists(st.sampled_from(OWNERS + [None]), min_size=8, max_size=8))
def test_merge_behaves_as_the_reference_merge(frames, senders):
    """Frame by frame, ties with different values included: the port's
    store holds what the reference's holds after the same merges."""
    a = ref.SwarmDHT("127.0.0.9:9", 0, host="127.0.0.1")
    b = port.SwarmDHT("127.0.0.9:9", 0, host="127.0.0.1")
    for frame, sender_id in zip(frames, senders):
        a._merge(frame, ("10.9.9.9", 7050), sender_id=sender_id)
        b._merge(frame, ("10.9.9.9", 7050), sender_id=sender_id)
        assert _state(b) == _state(a)


def _honest(wire_list):
    """The protocol's invariant: one value per (owner, version, ts)."""
    return [dict(w, value={"stage": w["version"] % 3, "load": w["version"] * 10 + int(w["ts"])})
            for w in wire_list]


@settings(max_examples=100, deadline=None)
@given(st.lists(wires, max_size=10))
def test_merge_idempotent(recs):
    recs = _honest(recs)
    a = port.SwarmDHT("127.0.0.9:9", 0, host="127.0.0.1")
    a._merge(recs, ("10.0.0.1", 7050))
    snap = {o: (r.version, r.ts, r.value) for o, r in a._records.items()}
    a._merge(recs, ("10.0.0.1", 7050))
    a._merge(list(reversed(recs)), ("10.0.0.1", 7050))
    assert {o: (r.version, r.ts, r.value) for o, r in a._records.items()} == snap


@settings(max_examples=100, deadline=None)
@given(st.lists(wires, min_size=1, max_size=10))
def test_highest_version_wins(recs):
    recs = _honest(recs)
    a = port.SwarmDHT("127.0.0.9:9", 0, host="127.0.0.1")
    a._merge(recs, ("10.0.0.1", 7050))
    for owner in {r["owner"] for r in recs}:
        best = max((r for r in recs if r["owner"] == owner), key=lambda r: (r["version"], r["ts"]))
        got = a._records[owner]
        assert (got.version, got.ts) == (best["version"], best["ts"])


def test_own_record_never_overwritten():
    a = port.SwarmDHT("127.0.0.9:9", 0, host="127.0.0.1")
    a._merge([{"owner": a.node_id, "value": {"stage": 9}, "version": 99, "ts": 9e9,
               "addr": ["1.2.3.4", 1]}], ("10.0.0.1", 7050))
    assert a.node_id not in a._records
