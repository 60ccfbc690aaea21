"""The adapter plane across nodes: the gossiped `ada` field, the tenant
affinity scorers held to the reference's, and tenant-aware planned routes.

  * `AdapterAffinity`, `combine_affinity`, `registry_can_serve` and
    `AdapterRegistry.resident_names` give the reference's answers on the same
    records, executors and registry histories;
  * a `--adapters` node announces `ada` in the reference's key order (`[]`
    with nothing resident) and a node without a registry the record it
    announced before the key existed;
  * a tenant session entering the swarm is planned to the stage replica that
    holds its adapter, a base session by cost alone;
  * find_best_chain charges a shedding replica ADMISSION_PENALTY once;
  * run_node's adapter flags default to their environment variables.
"""

import asyncio
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core import prefix as jprefix
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime import adapters as jadapters
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control import path_finder
from inferd_tpu_torch.control.dstar import node_cost
from inferd_tpu_torch.core import prefix as tprefix
from inferd_tpu_torch.obs.canary import ADMISSION_PENALTY, CACHE_AFFINITY_BONUS
from inferd_tpu_torch.runtime import adapters as tadapters
from inferd_tpu_torch.tools import run_node
from inferd_tpu_torch.utils import msgpack_lite

torch.set_num_threads(2)

PROMPT = [3, 17, 42, 9, 5, 8, 2, 11, 60, 1, 77, 13]
STEPS = 3
N_TENANTS = tadapters.ADA_GOSSIP_MAX + 2  # enough residents to meet the gossip cap


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """N_TENANTS rank-1 q_proj tenants (cheap to load), written by the JAX
    save_adapter."""
    root = tmp_path_factory.mktemp("plane_adapters")
    g = np.random.default_rng(7)
    cfg = jcfg.TINY
    out = []
    for i in range(N_TENANTS):
        layers = {"q_proj": (g.normal(0, 0.25, (cfg.num_layers, cfg.hidden_size, 1)),
                             g.normal(0, 0.25, (cfg.num_layers, 1, cfg.q_dim)))}
        out.append(jlora.save_adapter(str(root / f"ten{i}"), layers, alpha=2, r=1))
    return out


# -- the scorers -------------------------------------------------------------------------


RECORDS = [
    {}, {"ada": []}, {"ada": ["ten0"]}, {"ada": ("ten1", "ten0")}, {"ada": ["ten10"]},
    {"ada": "ten0"}, {"ada": None}, {"ada": {"ten0": 1}}, {"ada": [0, "ten0"]},
]


def test_adapter_affinity_scores_equal_the_reference():
    assert tadapters.ADA_GOSSIP_MAX == jadapters.ADA_GOSSIP_MAX == 32
    for name in ("ten0", "ten1", 0):
        t, j = tadapters.AdapterAffinity(name), jadapters.AdapterAffinity(name)
        assert t.name == j.name
        for rec in RECORDS:
            assert t.depth_frac(rec) == j.depth_frac(rec), (name, rec)


def test_combine_affinity_equals_the_reference():
    assert tadapters.combine_affinity() is None and tadapters.combine_affinity(None) is None
    ta = tadapters.AdapterAffinity("ten0")
    assert tadapters.combine_affinity(None, ta) is ta
    prompt = list(range(1, 70))
    tp, jp = tprefix.AffinityProbe(prompt), jprefix.AffinityProbe(prompt)
    digest = tprefix.make_digest(tprefix.block_keys(prompt, 8)[:3], 8)
    assert digest == jprefix.make_digest(jprefix.block_keys(prompt, 8)[:3], 8)

    class Broken:
        def depth_frac(self, rec):
            raise ValueError("malformed")

    records = [dict(r) for r in RECORDS] + [
        {"pfx": digest}, {"pfx": digest, "ada": ["ten0"]}, {"pfx": {"bs": 8, "k": "x"}},
        {"pfx": {"bs": 0, "k": []}, "ada": ["ten9"]},
    ]
    pairs = [
        (tadapters.combine_affinity(tp, ta), jadapters.combine_affinity(
            jp, jadapters.AdapterAffinity("ten0"))),
        (tadapters.combine_affinity(Broken(), ta, None), jadapters.combine_affinity(
            Broken(), jadapters.AdapterAffinity("ten0"), None)),
        (tadapters.combine_affinity(tp), jadapters.combine_affinity(jp)),
    ]
    assert isinstance(pairs[0][0], tadapters._MaxAffinity)
    for t, j in pairs:
        for rec in records:
            assert t.depth_frac(rec) == j.depth_frac(rec), rec
    # the max composition: never more than one bonus
    assert pairs[0][0].depth_frac({"pfx": digest, "ada": ["ten0"]}) == 1.0


def test_registry_can_serve_equals_the_reference():
    reg = SimpleNamespace(catalog={"ten0": "/a", "7": "/b"})
    cases = [(SimpleNamespace(adapters=reg), n) for n in (None, "ten0", "ten1", 7)]
    cases += [(SimpleNamespace(adapters=None), "ten0"), (SimpleNamespace(), "ten0"),
              (SimpleNamespace(), None), (object(), None)]
    got = [tadapters.registry_can_serve(ex, n) for ex, n in cases]
    assert got == [jadapters.registry_can_serve(ex, n) for ex, n in cases]
    assert got == [True, True, False, True, False, False, True, True]


def _registries(catalog, slots):
    t = tadapters.AdapterRegistry(tcfg.TINY, catalog, slots=slots)
    j = jadapters.AdapterRegistry(jcfg.TINY, catalog, slots=slots)
    return t, j


def test_resident_names_order_after_touches_equals_the_reference(catalog):
    t, j = _registries(catalog[:4], slots=4)  # three tenant slots
    assert t.resident_names() == j.resident_names() == []
    assert t.resident_count() == j.resident_count() == 0
    ops = [("acquire", "ten0"), ("acquire", "ten1"), ("release", "ten0"), ("acquire", "ten2"),
           ("release", "ten1"), ("acquire", "ten0"), ("release", "ten2"), ("pin", "ten1"),
           ("release", "ten0"), ("acquire", "ten3"),  # evicts the oldest idle unpinned: ten2
           ("release", "ten3"), ("acquire", "ten1"), ("release", "ten1")]
    for op, name in ops:
        getattr(t, op)(name)
        getattr(j, op)(name)
        assert t.resident_names() == j.resident_names(), (op, name)
        assert t.resident_count() == j.resident_count()
    assert t.resident_names() == ["ten0", "ten3", "ten1"]


def test_resident_names_gossip_cap_keeps_the_most_recent(catalog):
    t, j = _registries(catalog, slots=N_TENANTS + 1)
    for reg in (t, j):
        for i in range(N_TENANTS):
            reg.acquire(f"ten{i}")
            reg.release(f"ten{i}")
        reg.acquire("ten0")  # touched last: survives the cap
    names = t.resident_names()
    assert names == j.resident_names()
    assert len(names) == tadapters.ADA_GOSSIP_MAX and t.resident_count() == N_TENANTS
    assert names[-1] == "ten0" and "ten1" not in names and "ten2" not in names
    assert names[0] == "ten3"


# -- the announced record ----------------------------------------------------------------


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    out = {}
    for n in (1, 2):
        path = str(tmp_path_factory.mktemp(f"plane_parts{n}"))
        jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", n), path)
        out[n] = path
    return out


def _args(parts, *extra):
    return run_node.build_parser().parse_args(
        ["--parts", parts, "--port", "0", "--gossip-port", "0", "--device", "cpu",
         "--max-len", "64", "--rebalance-period", "600", *extra])


LANES = ("--stage-lanes", "4", "--paged-kv", "8", "--prefill-chunk", "8", "--window-ms", "2")
BASE_KEYS = ["name", "stage", "load", "cap", "host", "port", "model"]


def _serve(addrs, adapter=None, client=ChainClient, prompt=PROMPT):
    async def go():
        async with client(addrs, sampling=SamplingConfig(temperature=0.0), prefill_chunk=8,
                          adapter=adapter) as c:
            return await c.generate_ids(prompt, max_new_tokens=STEPS)

    return asyncio.run(go())


def _own(node):
    node.announce()
    return node.dht.get_stage(node.spec.stage)[node.node_id]


def test_announced_record_carries_ada_in_the_reference_key_order(parts, catalog):
    node = run_node.make_node(_args(parts[1], *LANES, "--adapters", ",".join(catalog[:3]),
                                    "--name", "tenants")).start()
    try:
        rec = _own(node)
        assert list(rec) == BASE_KEYS + ["ada"] and rec["ada"] == []  # the capability marker
        assert _serve([(node.host, node.port)], adapter="ten1")
        rec = _own(node)
        # pfx before ada before shed and sess: the reference's order
        assert list(rec) == BASE_KEYS + ["svc_ms", "pfx", "ada"] and rec["ada"] == ["ten1"]
        node._pool_under_reserve = lambda ex=None: (0, 1, 1)
        rec = _own(node)
        assert list(rec) == BASE_KEYS + ["svc_ms", "pfx", "ada", "shed"]
        assert tadapters.AdapterAffinity("ten1").depth_frac(rec) == 1.0
        assert jadapters.AdapterAffinity("ten1").depth_frac(rec) == 1.0
    finally:
        node.stop()


@pytest.mark.parametrize("extra", [(), LANES], ids=["dense", "lanes"])
def test_a_node_without_adapters_announces_the_bytes_it_did_before(parts, extra):
    node = run_node.make_node(_args(parts[2], "--stage", "1", *extra)).start()
    try:
        rec = _own(node)
        before = {"name": node.node_id, "stage": 1, "load": 0, "cap": 4, "host": node.host,
                  "port": node.port, "model": node.model_name}
        assert msgpack_lite.packb(rec) == msgpack_lite.packb(before)
        assert node._adapter_digest(node.executor) is None
    finally:
        node.stop()


# -- tenant-aware planned routes ---------------------------------------------------------


def _wait(cond, what, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _swarm_node(parts, stage, seed, *extra):
    argv = ["--stage", str(stage), *extra]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(_args(parts, *argv))
    node.dht.gossip_period_s = 0.05
    return node.start()


def _level(entry, replicas):
    """Announce each replica with the service time given (None: no svc_ms)
    and wait until the entry's store shows them so, idle: the plan then
    weighs the replicas' records as they stand, not a gossip period late."""
    for node, svc in replicas:
        node._svc_ewma = svc
        node.announce(urgent=True)

    def seen():
        view = entry.dht.get_stage(1)
        return all(view.get(n.node_id, {}).get("load") == 0
                   and view[n.node_id].get("svc_ms") == svc for n, svc in replicas)

    _wait(seen, "records not gossiped")


def test_a_tenant_session_is_planned_to_the_replica_holding_its_adapter(parts, catalog):
    """entry (stage 0), A and B (stage 1): ten0 warmed on B through a fixed
    chain, then new ten0 sessions through the entry are planned to B, whose
    record is A's but for `ada`, while A loads nothing; a base session is
    planned by cost alone (to A, whose record has no svc_ms). The lane delta
    runs its plain version here: tensors on the CPU."""
    cat = ("--adapters", ",".join(catalog[:3]), *LANES)
    entry = _swarm_node(parts[2], 0, None, *cat)
    a = _swarm_node(parts[2], 1, entry, *cat)
    b = _swarm_node(parts[2], 1, entry, *cat)
    nodes = [entry, a, b]
    try:
        _wait(lambda: all(len(n.dht.get_stage(1)) == 2 and n.dht.get_stage(0) for n in nodes),
              "gossip did not converge")
        warm = _serve([(entry.host, entry.port), (b.host, b.port)], adapter="ten0")
        _level(entry, [(a, 10.0), (b, 10.0)])
        view = entry.dht.get_stage(1)
        assert view[b.node_id]["ada"] == ["ten0"] and view[a.node_id]["ada"] == []
        for _ in range(3):
            assert _serve([(entry.host, entry.port)], adapter="ten0", client=SwarmClient) == warm
            _level(entry, [(a, 10.0), (b, 10.0)])
        routes = [r["route"] for r in entry.stats()["routes"]["recent"]]
        assert routes == [{"1": b.node_id}] * 3
        assert a.executor.adapters.stats()["loads"] == 0
        assert b.executor.adapters.stats()["loads"] == 1
        assert entry.metrics.snapshot()["counters"]["route.planned"] == 3
        _level(entry, [(a, None), (b, 10.0)])
        base = _serve([(entry.host, entry.port)], client=SwarmClient)
        assert entry.stats()["routes"]["recent"][-1]["route"] == {"1": a.node_id}
        assert base == _serve([(entry.host, entry.port), (b.host, b.port)])
        assert a.executor.adapters.stats()["loads"] == 0
    finally:
        for n in nodes:
            n.stop()


# -- one shed charge ---------------------------------------------------------------------


class _Store:
    def __init__(self, snap):
        self.snap = snap

    def get_all(self, num_stages=None):
        return {s: dict(m) for s, m in self.snap.items()}

    def get_stage(self, stage):
        return dict(self.snap.get(stage, {}))


def _plan(snap, **kw):
    return path_finder.PathFinder(_Store(snap), 2).find_best_chain(0, **kw)[0][0]


def test_a_shedding_holder_is_charged_admission_penalty_once():
    holder = {"stage": 0, "load": 0, "cap": 4, "ada": ["ten0"], "shed": 1}
    # other's cost sits between the holder's charged once and charged twice
    other = {"stage": 0, "load": 10, "cap": 4, "ada": []}
    tail = {"t": {"stage": 1, "load": 0, "cap": 4}}
    snap = {0: {"holder": holder, "other": other}, 1: tail}
    aff = tadapters.AdapterAffinity("ten0")
    once = node_cost(holder, affinity=aff)
    assert once == 1.0 + ADMISSION_PENALTY
    assert once < node_cost(other, affinity=aff) < once + ADMISSION_PENALTY
    for held in (None, {"t": 1}, {"other": 0}):
        assert _plan(snap, affinity=aff, held=held, new_session=True) == "holder", held
    # a held session on the holder counts in its load (still once charged)
    assert _plan(snap, affinity=aff, held={"holder": 3}, new_session=True) == "other"
    # a non-shedding holder gets the bonus and beats a lighter non-holder
    light = dict(other, load=1)
    warm = dict(holder, load=2)
    del warm["shed"]
    assert node_cost(warm, affinity=aff) == 1.0 + 0.5 - CACHE_AFFINITY_BONUS
    snap = {0: {"holder": warm, "other": light}, 1: tail}
    assert _plan(snap, affinity=aff, held={"t": 1}, new_session=True) == "holder"
    assert _plan(snap, held={"t": 1}, new_session=True) == "other"  # no affinity: load


def test_the_greedy_fallback_charges_the_shed_once(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("degenerate graph")

    monkeypatch.setattr(path_finder, "SwarmChainPlanner", broken)
    holder = {"stage": 0, "load": 0, "cap": 4, "ada": ["ten0"], "shed": 1}
    other = {"stage": 0, "load": 10, "cap": 4}
    snap = {0: {"holder": holder, "other": other}, 1: {"t": {"stage": 1, "load": 0, "cap": 4}}}
    aff = tadapters.AdapterAffinity("ten0")
    assert _plan(snap, affinity=aff, held={"t": 1}, new_session=True) == "holder"


@pytest.mark.parametrize("seed", range(6))
def test_without_held_or_new_session_the_plan_equals_the_reference(seed):
    """The simulator's router passes neither: its plan must stay the
    reference's (random snapshots with shedding, draining and holder flags)."""
    from inferd_tpu.control import path_finder as jpf

    g = np.random.default_rng(seed)
    snap = {}
    for s in range(3):
        snap[s] = {}
        for k in range(int(g.integers(2, 6))):
            rec = {"stage": s, "load": int(g.integers(0, 9)), "cap": 4,
                   "svc_ms": float(g.integers(0, 80))}
            if g.random() < 0.3:
                rec["shed"] = 1
            if g.random() < 0.1:
                rec["draining"] = 1
            if g.random() < 0.5:
                rec["ada"] = ["ten0"]
            snap[s][f"n{s}{k}"] = rec
    for aff in (None, "ten0"):
        t = path_finder.PathFinder(_Store(snap), 3).find_best_chain(
            0, affinity=aff and tadapters.AdapterAffinity(aff))
        j = jpf.PathFinder(_Store(snap), 3).find_best_chain(
            0, affinity=aff and jadapters.AdapterAffinity(aff))
        assert [n for n, _ in t] == [n for n, _ in j]


# -- run_node's environment defaults ------------------------------------------------------


def test_run_node_adapter_flags_default_to_the_environment(monkeypatch):
    for var in ("INFERD_LORA", "INFERD_ADAPTERS"):
        monkeypatch.delenv(var, raising=False)
    args = run_node.build_parser().parse_args([])
    assert (args.lora, args.adapters) == ("", "")
    monkeypatch.setenv("INFERD_LORA", "/lora/x")
    monkeypatch.setenv("INFERD_ADAPTERS", "/a/t0,/a/t1")
    args = run_node.build_parser().parse_args([])
    assert (args.lora, args.adapters) == ("/lora/x", "/a/t0,/a/t1")
    args = run_node.build_parser().parse_args(["--adapters", "/b/t2", "--lora", "/l/y"])
    assert (args.adapters, args.lora) == ("/b/t2", "/l/y")
    helps = {a.dest: a.help for a in run_node.build_parser()._actions}
    assert "INFERD_LORA" in helps["lora"] and "INFERD_ADAPTERS" in helps["adapters"]
