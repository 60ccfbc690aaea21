"""The port's relay topology on the CPU: run_node processes' in-process
counterparts joined by gossip (--gossip-port 0, --bootstrap the seed),
driven by the port's SwarmClient, held to the JAX package and to the
port's own chain topology on the same nodes.

  * a three-stage counter swarm answers state 3, trace [0, 1, 2], entered
    at stage 0 or at a node of the wrong stage;
  * a two-stage Qwen3 swarm (TINY, weights 10x the init so the greedy
    stream moves) whose stage 1 has two replicas: the SwarmClient's greedy
    stream equals the JAX Engine's and the ChainClient's on the same nodes,
    its sampled stream the ChainClient's for the same seed; /end_session
    drops a session on both stages; four concurrent sessions each stay on
    one replica, and both replicas serve;
  * relay-mode paged lane nodes serve four concurrent sessions as the JAX
    Engine does;
  * a tenant session whose adapter the client stamps at the entry only
    equals the chain client's, which stamps every stage;
  * a replica that dies with no tombstone costs a new session one dead hop,
    not the session, and its record expires from the seed's view.
"""

import asyncio
import http.client
import json
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
SAMPLED = SamplingConfig(temperature=0.8, top_k=20, top_p=0.95)
NEW = 10
PROMPT_LENS = (5, 12, 21, 30)  # 1, 2, 3 and 4 prefill chunks of 8


@pytest.fixture(scope="module")
def jp():
    """TINY with every weight but the norms 10x its init: at the init's
    scale a greedy stream repeats one token."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jp):
    out = str(tmp_path_factory.mktemp("swarm_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, jcfg.TINY.vocab_size, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def expected(jp, prompts):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return [engine.generate(p, max_new_tokens=NEW) for p in prompts]


def _node(stage, *args, seed=None, ttl=None):
    """A started node; with `seed`, bootstrapped to its gossip port."""
    # the balancer's period outlasts the test (the reference's test nodes'):
    # a tick under a transient load skew would move a replica mid-test
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", "600", *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    if ttl is not None:
        node.dht.ttl_s = ttl
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _swarm(stages, *args, **kw):
    """One node per entry of `stages`, the first the gossip seed; returns
    them once every node's view holds every record."""
    nodes = [_node(stages[0], *args, **kw)]
    nodes += [_node(s, *args, seed=nodes[0], **kw) for s in stages[1:]]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(sum(len(v) for v in n.dht.get_all().values()) == len(nodes) for n in nodes):
            return nodes
        time.sleep(0.02)
    raise AssertionError("gossip did not converge")


def _stop(nodes):
    threads = [n.dht._thread for n in nodes if n.dht._thread is not None]
    for n in nodes:
        n.stop()
    assert not any(t.is_alive() for t in threads)  # every gossip thread ended


def _post(node, path, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("POST", path, body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _stats(node):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _generate(client, prompts, seed=0, concurrent=False, **kw):
    async def go():
        async with client as c:
            if concurrent:
                return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=NEW, seed=seed,
                                                             **kw) for p in prompts))
            return [await c.generate_ids(p, max_new_tokens=NEW, seed=seed, **kw)
                    for p in prompts]

    return asyncio.run(go())


def _passes(prompt_len):
    return -(-prompt_len // 8) + NEW - 1  # prefill chunks of 8, then a pass per new token


# -- the counter model -----------------------------------------------------------------


def test_counter_swarm_three_stages_and_a_wrong_entry_relays():
    nodes = _swarm([0, 1, 2], "--backend", "counter", "--num-stages", "3")
    try:
        for entry, env in [(nodes[0], {"stage": 0, "payload": {}}),
                           (nodes[2], {"stage": 0, "payload": {}}),
                           (nodes[0], {"stage": 1, "payload": {"state": 1, "trace": [0]}})]:
            status, body = _post(entry, "/forward", dict(env, session_id="c"))
            assert status == 200, body
            assert body["result_for_user"]["state"] == 3
            assert body["result_for_user"]["trace"] == [0, 1, 2]
            assert body["served_by"] == nodes[2].node_id
        st = [_stats(n) for n in nodes]
        assert [s["forward_passes"] for s in st] == [2, 3, 3]  # the last entered at stage 1
        assert [s["relays"] for s in st] == [3, 3, 1]  # the wrong entries' hops too
        assert set(st[1]["dht"]) == {"0", "1", "2"}
        assert st[1]["dht"]["2"][nodes[2].node_id]["model"] == "counter"
    finally:
        _stop(nodes)


@pytest.mark.parametrize("argv, error", [
    (["--backend", "counter", "--parts", "p"], "takes no --parts"),
    (["--backend", "counter", "--num-stages", "2", "--stage", "2"], "outside --num-stages"),
    ([], "--parts is required"),
])
def test_run_node_refuses_bad_swarm_flags(argv, error):
    args = run_node.build_parser().parse_args(
        ["--stage", "0", "--port", "0", "--gossip-port", "0", "--device", "cpu", *argv])
    with pytest.raises(ValueError, match=error):
        run_node.make_node(args)


def test_parse_bootstrap():
    assert run_node.parse_bootstrap("") == []
    assert run_node.parse_bootstrap("10.0.0.1:7050, h:1,") == [("10.0.0.1", 7050), ("h", 1)]
    with pytest.raises(ValueError, match="not host:port"):
        run_node.parse_bootstrap("7050")


def test_a_taken_gossip_port_fails_the_node():
    first = _node(0, "--backend", "counter")
    try:
        args = run_node.build_parser().parse_args(
            ["--stage", "1", "--port", "0", "--gossip-port", str(first.dht.port), "--device",
             "cpu", "--backend", "counter"])
        node = run_node.make_node(args)
        with pytest.raises(OSError):
            node.start()
        node._server.server_close()
    finally:
        _stop([first])


# -- Qwen3, one-session nodes, a replicated stage 1 --------------------------------------


@pytest.fixture(scope="module")
def swarm(parts):
    nodes = _swarm([0, 1, 1], "--parts", parts, "--max-len", "64")
    yield nodes
    _stop(nodes)


def test_relay_stream_equals_jax_engine_and_chain_client(swarm, prompts, expected):
    seed, rep_a, _ = swarm
    relay = _generate(SwarmClient([(seed.host, seed.port)], sampling=GREEDY, prefill_chunk=8),
                      prompts[2:3])
    chain = _generate(ChainClient([(seed.host, seed.port), (rep_a.host, rep_a.port)],
                                  sampling=GREEDY, prefill_chunk=8), prompts[2:3])
    assert relay == chain == expected[2:3]
    assert len(set(relay[0])) > 3  # the stream moves
    relay_s = _generate(SwarmClient([(seed.host, seed.port)], sampling=SAMPLED,
                                    prefill_chunk=8), prompts[1:2], seed=5)
    chain_s = _generate(ChainClient([(seed.host, seed.port), (rep_a.host, rep_a.port)],
                                    sampling=SAMPLED, prefill_chunk=8), prompts[1:2], seed=5)
    assert relay_s == chain_s and relay_s[0] != expected[1]
    for n in swarm:  # every session ended on every stage
        st = _stats(n)
        assert st["executor"]["sessions"] == 0 and st["errors"] == 0 and st["affinity"] == 0


def test_end_session_drops_the_session_on_both_stages(swarm):
    seed = swarm[0]
    env = {"session_id": "x", "stage": 0,
           "payload": {"tokens": np.asarray([[1, 2, 3]], np.int32), "start_pos": 0,
                       "real_len": 3}}
    status, body = _post(seed, "/forward", env)
    assert status == 200 and np.asarray(body["result_for_user"]["logits"]).shape[0] == 1
    holders = [n for n in swarm if "x" in n.executor.sessions]
    assert len(holders) == 2 and holders[0] is seed and seed.stats()["affinity"] == 1
    status, body = _post(seed, "/end_session", {"session_id": "x", "stage": 0})
    assert status == 200 and body == {"ok": True}
    assert not any("x" in n.executor.sessions for n in swarm) and seed.stats()["affinity"] == 0


def test_concurrent_sessions_stay_on_one_replica_and_both_serve(swarm, prompts, expected):
    before = [n.stats()["forward_passes"] for n in swarm[1:]]
    got = _generate(SwarmClient([(swarm[0].host, swarm[0].port)], sampling=GREEDY,
                                prefill_chunk=8), prompts, concurrent=True)
    assert got == expected
    served = [n.stats()["forward_passes"] - b for n, b in zip(swarm[1:], before)]
    per_session = [_passes(len(p)) for p in prompts]
    assert sum(served) == sum(per_session) and all(served)
    # each replica served whole sessions: a session split across replicas
    # would have met a replica without its KV (409) and failed
    sums = {sum(c for i, c in enumerate(per_session) if m >> i & 1) for m in range(16)}
    assert served[0] in sums


# -- relay-mode lane nodes ----------------------------------------------------------------


def test_relay_lane_nodes_serve_concurrent_sessions_as_jax_engine(parts, prompts, expected):
    nodes = _swarm([0, 1], "--parts", parts, "--max-len", "64", "--stage-lanes", "4",
                   "--paged-kv", "16", "--prefill-chunk", "8", "--window-ms", "50")
    try:
        got = _generate(SwarmClient([(nodes[0].host, nodes[0].port)], sampling=GREEDY,
                                    prefill_chunk=16), prompts, concurrent=True)
        assert got == expected
        for n in nodes:
            ex = n.stats()["executor"]
            assert ex["sessions"] == 0 and ex["paged"]["blocks_used"] == 0
            assert ex["batched_tokens"] > ex["batched_steps"] > 0  # co-batched decode
    finally:
        _stop(nodes)


# -- a tenant, stamped at the entry only ------------------------------------------------


def test_tenant_stamped_at_the_entry_equals_the_chain_client(tmp_path, parts, prompts):
    cfg = jcfg.TINY
    g = np.random.default_rng(3)
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "v_proj": (cfg.hidden_size, cfg.kv_dim),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}
    layers = {n: (g.normal(0, 0.25, (cfg.num_layers, din, 4)).astype(np.float32),
                  g.normal(0, 0.25, (cfg.num_layers, 4, dout)).astype(np.float32))
              for n, (din, dout) in dims.items()}
    adapter = jlora.save_adapter(str(tmp_path / "ten0"), layers, alpha=8, r=4)
    nodes = _swarm([0, 1], "--parts", parts, "--max-len", "64", "--stage-lanes", "4",
                   "--paged-kv", "8", "--prefill-chunk", "8", "--window-ms", "2",
                   "--adapters", adapter)
    try:
        addrs = [(n.host, n.port) for n in nodes]
        relay = _generate(SwarmClient(addrs[:1], sampling=GREEDY, prefill_chunk=8,
                                      adapter="ten0"), prompts[2:3])
        chain = _generate(ChainClient(addrs, sampling=GREEDY, prefill_chunk=8,
                                      adapter="ten0"), prompts[2:3])
        base = _generate(SwarmClient(addrs[:1], sampling=GREEDY, prefill_chunk=8), prompts[2:3])
        assert relay == chain and relay != base
        for n in nodes:  # every stage bound the tenant: one load each
            assert n.stats()["executor"]["adapters"]["loads"] == 1
    finally:
        _stop(nodes)


# -- a replica that dies ------------------------------------------------------------------


def test_a_dead_replica_costs_a_hop_not_a_session(parts, prompts, expected):
    nodes = _swarm([0, 1, 1], "--parts", parts, "--max-len", "64", ttl=1.5)
    seed, _, dead = nodes
    try:
        dead._server.shutdown()  # a crash: no tombstone, the record lives on until its TTL
        dead._server.server_close()
        dead.dht.kill()
        got = _generate(SwarmClient([(seed.host, seed.port)], sampling=GREEDY, prefill_chunk=8),
                        prompts[:2], concurrent=True)
        assert got == expected[:2]
        st = seed.stats()
        # one of the two new sessions picked the dead replica first (the other
        # held a session), met a refused connection and went on to the live one
        assert st["dead_hops"] == 1 and st["errors"] == 0
        assert dead.node_id in seed.stats()["dht"]["1"]  # not expired yet
        deadline = time.monotonic() + 1.5 + 1.0
        while dead.node_id in seed.dht.get_stage(1) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dead.node_id not in seed.dht.get_stage(1)
    finally:
        seed.stop()
        nodes[1].stop()
