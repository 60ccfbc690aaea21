"""Planned routes on the port's relay, the routed chain client and
`send --routed` (CPU; in-process nodes joined by gossip every 0.05 s on
`--gossip-port 0`, counter stages or the TINY preset with weights 10x the
init so greedy streams move):

  * a new session entering a stage-0 node gets a D*-Lite route that every
    relay hop follows to the cheap replica (svc_ms skewed), token-exact to
    the JAX Engine; a failed plan falls back to the per-hop pick; a stale
    route (an unknown or dead replica) falls through to the fresh pick; a
    relay's dead peer is folded into the plan at once (INF); new sessions
    entering at once spread over two replicas, and a shedding replica is
    planned for none while another lives; svc_ms counts each forward's
    compute, a lane window's entries each its step's; a `route` envelope
    packs to the reference's bytes in both codecs;
  * RoutedChainClient streams equal the ChainClient's and the JAX Engine's,
    a load spike between hops replans the remaining stage incrementally, an
    empty stage is a retryable 503 `no_chain`, and a committed replica's
    death moves the session to a replica advertising it;
  * `tools/send --routed` prints the JAX stream, and refuses without
    --num-stages or a full view.
"""

import asyncio
import http.client
import threading
import time
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime import wire as jwire
from inferd_tpu_torch.client.base import ServerError
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.routed_client import RoutedChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control.dht import SwarmDHT, sess_hash
from inferd_tpu_torch.control.dstar import INF
from inferd_tpu_torch.control.path_finder import NoNodeForStage
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node, send

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
NEW = 8
PROMPT = [3, 7, 11, 19, 5, 23, 29, 31, 37, 41, 2]  # two prefill chunks of 8
COUNTER2 = ("--backend", "counter", "--num-stages", "2")


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jp):
    out = str(tmp_path_factory.mktemp("route_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def expected(jp):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return engine.generate(PROMPT, max_new_tokens=NEW)


def _node(stage, *args, seed=None):
    # the balancer's period outlasts the test (the reference's test nodes'):
    # a tick under a transient load skew would move a replica mid-test
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", "600", *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _wait(cond, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _swarm(stages, *args):
    nodes = [_node(stages[0], *args)]
    nodes += [_node(s, *args, seed=nodes[0]) for s in stages[1:]]
    _wait(lambda: all(sum(len(v) for v in n.dht.get_all().values()) == len(nodes)
                      for n in nodes), "gossip did not converge")
    return nodes


def _stop(nodes):
    for n in nodes:
        n.stop()


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _counter_env(sid, **kw):
    return {"stage": 0, "session_id": sid, "task_id": "t",
            "payload": {"state": 0, "start_pos": 0, "real_len": 1}, **kw}


def _counters(node):
    return node.metrics.snapshot()["counters"]


def _skew(node, svc_ms, viewers):
    """Announce `svc_ms` for `node` and wait until every viewer sees it."""
    node._svc_ewma = svc_ms
    node.announce()
    _wait(lambda: all(v.get_stage(node.spec.stage).get(node.node_id, {}).get("svc_ms")
                      == svc_ms for v in viewers), "svc_ms not gossiped")


def _generate(client, prompt=PROMPT, **kw):
    async def go():
        async with client as c:
            return await c.generate_ids(prompt, max_new_tokens=NEW, **kw)

    return asyncio.run(go())


def _observer(seed):
    dht = SwarmDHT("observer", 0, bootstrap=[("127.0.0.1", seed.dht.port)], host="127.0.0.1",
                   gossip_period_s=0.05)
    dht.start()
    return dht


# -- planned routes on the relay ---------------------------------------------------------


def test_relay_follows_the_planned_route_to_the_cheap_replica(parts, expected):
    nodes = _swarm([0, 1, 1], "--parts", parts, "--max-len", "64")
    seed, dear, cheap = nodes
    try:
        assert "svc_ms" not in seed.dht.get_stage(1)[dear.node_id]  # nothing computed yet
        _skew(dear, 500.0, [seed.dht])
        got = _generate(SwarmClient([(seed.host, seed.port)], sampling=GREEDY, prefill_chunk=8))
        assert got == expected
        c = _counters(seed)
        assert c["route.planned"] == c["route.followed"] == 1 and "route.stale" not in c
        assert seed.stats()["routes"]["recent"][-1]["route"] == {"1": cheap.node_id}
        assert seed.path_finder.planner_stats()["builds"] == 1
        # the cheap replica served every chunk, the dear one none
        assert "forward.requests" not in _counters(dear)
        assert _counters(cheap)["forward.requests"] == 2 + NEW - 1
        # svc_ms is the EWMA of the cheap replica's forwards, announced
        svc = cheap.stats()["svc_ms"]
        hist = cheap.stats()["metrics"]["histograms"]["stage.compute_ms"]
        assert svc > 0 and hist["count"] == 2 + NEW - 1
        _wait(lambda: seed.dht.get_stage(1)[cheap.node_id].get("svc_ms") == round(svc, 3),
              "svc_ms not announced")
        assert seed.stats()["affinity"] == 0 and not seed._planned  # the session ended
    finally:
        _stop(nodes)


@pytest.mark.parametrize("cause", ["empty_stage", "planner_error"])
def test_a_failed_plan_falls_back_to_the_per_hop_pick(cause):
    nodes = _swarm([0] if cause == "empty_stage" else [0, 1], *COUNTER2)
    seed = nodes[0]
    try:
        if cause == "empty_stage":
            assert seed._plan_route(1, "s") is None
        else:
            def fail(*a, **kw):
                raise RuntimeError("planner broke")

            seed.path_finder.find_best_chain = fail
            status, body = _post(seed, _counter_env("s"))
            assert status == 200 and body["result_for_user"]["trace"] == [0, 1]
        c = _counters(seed)
        assert c["route.plan_failed"] == 1 and "route.planned" not in c
        assert "route.followed" not in c and not seed._planned
    finally:
        _stop(nodes)


@pytest.mark.parametrize("planned", ["unknown", "dead", "cooling"])
def test_a_stale_route_falls_through_to_the_fresh_pick(planned):
    """A route naming a replica the view lacks, one that died since the plan
    (followed, then re-picked on the relay's second attempt), or one a relay
    has since seen dead (not followed: no second dead hop)."""
    nodes = _swarm([0, 1, 1], *COUNTER2)
    seed, live, dead = nodes
    try:
        target = "127.0.0.1:1"
        if planned != "unknown":
            dead.crash()  # no tombstone: its record lives on
            target = dead.node_id
        if planned == "cooling":
            seed._note_peer_failure(dead.node_id)
        status, body = _post(seed, _counter_env("s", route={"1": target}))
        assert status == 200 and body["served_by"] == live.node_id
        c = _counters(seed)
        assert c["route.stale"] == 1 and "route.planned" not in c  # it came with a route
        assert c.get("route.followed", 0) == (planned == "dead")
        assert seed.stats()["dead_hops"] == (planned == "dead")
    finally:
        _stop(nodes)


def test_a_dead_peer_is_folded_into_the_plan():
    nodes = _swarm([0, 1, 1], *COUNTER2)
    seed, a, b = nodes
    try:
        assert _post(seed, _counter_env("s0"))[0] == 200
        first = seed.stats()["routes"]["recent"][-1]["route"]["1"]
        seed._note_peer_failure(first)
        planner = seed.path_finder.planner
        assert planner.stats["kills"] == 1 and planner._costs[(1, first)] == INF
        other = b.node_id if first == a.node_id else a.node_id
        for i in range(3):  # every new session is planned around it
            status, body = _post(seed, _counter_env(f"s{i + 1}"))
            assert status == 200 and body["served_by"] == other
    finally:
        _stop(nodes)


def test_new_sessions_entering_at_once_spread_over_the_replicas():
    nodes = _swarm([0, 1, 1], *COUNTER2)
    seed, a, b = nodes
    try:
        answers = []
        threads = [threading.Thread(target=lambda i=i: answers.append(
            _post(seed, _counter_env(f"s{i}")))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(st for st, _ in answers) == [200] * 4
        served = sorted(body["served_by"] for _, body in answers)
        assert served == sorted([a.node_id] * 2 + [b.node_id] * 2)
        c = _counters(seed)
        assert c["route.planned"] == c["route.followed"] == 4
        assert seed._held(1) == {a.node_id: 2, b.node_id: 2}
    finally:
        _stop(nodes)


def test_a_shedding_replica_is_planned_for_no_new_session():
    nodes = _swarm([0, 1, 1], *COUNTER2)
    seed, shedding, other = nodes
    try:
        shedding.executor.pool = SimpleNamespace(num_blocks=100, blocks_free=0)
        shedding.announce(urgent=True)
        _wait(lambda: seed.dht.get_stage(1)[shedding.node_id].get("shed") == 1,
              "shed not gossiped")
        for i in range(4):
            status, body = _post(seed, _counter_env(f"n{i}"))
            assert status == 200 and body["served_by"] == other.node_id
        routes = [r["route"]["1"] for r in seed.stats()["routes"]["recent"]]
        assert routes == [other.node_id] * 4
    finally:
        _stop(nodes)


@pytest.mark.parametrize("codec", ["native", "python"])
def test_a_route_envelope_packs_to_the_reference_bytes(codec, monkeypatch):
    monkeypatch.setenv("INFERD_NATIVE", "1" if codec == "native" else "0")
    hidden = torch.arange(16, dtype=torch.float32).reshape(1, 1, 16).to(torch.bfloat16)
    route = {"1": "10.0.0.9:6050", "2": "10.0.0.7:6051"}
    env = {"task_id": "t", "session_id": "s", "stage": 1,
           "payload": {"hidden": hidden, "start_pos": 0, "real_len": 1}, "route": route,
           "deadline_ms": 1.7e12}
    ref = dict(env, payload=dict(env["payload"], hidden=hidden.view(torch.int16).numpy().view(
        np.dtype(ml_dtypes.bfloat16))))
    blob = wire.pack(env)
    assert wire.codec_name() == codec and blob == jwire.pack(ref)
    back = wire.unpack(blob)
    assert back["route"] == route and torch.equal(back["payload"]["hidden"], hidden)


def test_svc_ms_counts_each_entry_of_a_lane_window(parts, expected):
    nodes = _swarm([0, 1], "--parts", parts, "--max-len", "64", "--stage-lanes", "4",
                   "--paged-kv", "16", "--prefill-chunk", "8", "--window-ms", "50")
    try:
        async def go():
            async with SwarmClient([(nodes[0].host, nodes[0].port)], sampling=GREEDY,
                                   prefill_chunk=8) as c:
                return await asyncio.gather(*(c.generate_ids(PROMPT, max_new_tokens=NEW)
                                              for _ in range(3)))

        assert asyncio.run(go()) == [expected] * 3
        for n in nodes:
            st = n.stats()
            ex = st["executor"]
            assert ex["batched_tokens"] > ex["batched_steps"]  # windows co-batched
            assert st["metrics"]["histograms"]["stage.compute_ms"]["count"] == st["forward_passes"]
            assert st["svc_ms"] > 0
    finally:
        _stop(nodes)


# -- the routed chain client -------------------------------------------------------------


@pytest.fixture(scope="module")
def model_swarm(parts):
    nodes = _swarm([0, 1, 1], "--parts", parts, "--max-len", "64")
    obs = _observer(nodes[0])
    _wait(lambda: all(obs.get_all(2)[s] for s in range(2)) and len(obs.get_stage(1)) == 2,
          "the observer's view did not fill")
    yield nodes, obs
    obs.stop()
    _stop(nodes)


def test_routed_client_streams_equal_the_chain_client(model_swarm, expected):
    (seed, a, _b), obs = model_swarm
    routed = _generate(RoutedChainClient(obs, 2, sampling=GREEDY, prefill_chunk=8))
    chain = _generate(ChainClient([(seed.host, seed.port), (a.host, a.port)], sampling=GREEDY,
                                  prefill_chunk=8))
    assert routed == chain == expected
    for n in model_swarm[0]:  # the routed session ended on every stage it reached
        assert n.stats()["executor"]["sessions"] == 0


def test_routed_client_replans_on_a_load_spike(model_swarm, expected):
    (seed, a, b), obs = model_swarm
    _skew(b, 50.0, [obs])
    _skew(a, 1.0, [obs])
    seen = {}

    async def spike(session_id, completed_stage):
        if completed_stage == 0:
            seen["before"] = c._plans[session_id].planner.chain()[0][1]
            a._svc_ewma = 5000.0  # the planned stage-1 replica turns dear mid-pass
            a.announce()
            for _ in range(200):
                if obs.get_stage(1)[a.node_id].get("svc_ms") == 5000.0:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError("the spike never reached the observer")

    c = RoutedChainClient(obs, 2, sampling=GREEDY, prefill_chunk=8)
    c.hop_hook = spike
    step = c._step

    async def step_and_look(session_id, tokens, start_pos):
        out = await step(session_id, tokens, start_pos)
        seen.setdefault("stats", c.planner_stats(session_id))
        seen.setdefault("chain", [nid for nid, _ in c._plans[session_id].chain])
        return out

    c._step = step_and_look
    try:
        assert _generate(c) == expected
        assert seen["before"] == a.node_id and seen["chain"] == [seed.node_id, b.node_id]
        st = seen["stats"]
        assert st["builds"] == 1 and st["cost_updates"] >= 1 and st["expansions_replan"] > 0
    finally:
        _skew(a, 1.0, [obs])
        _skew(b, 1.0, [obs])


def test_routed_client_moves_to_an_advertised_holder(parts, expected):
    nodes = _swarm([0, 1, 1], "--parts", parts, "--max-len", "64")
    obs = _observer(nodes[0])
    try:
        _wait(lambda: len(obs.get_stage(1)) == 2 and obs.get_stage(0), "no full view")

        class Mirrored(RoutedChainClient):
            """Sends every stage-1 hop to the other replica too, while
            `mirror` is on: that replica holds the session's KV as well."""

            mirror = True

            async def _hop(self, addr, stage, session_id, payload):
                out = await super()._hop(addr, stage, session_id, payload)
                if stage == 1 and self.mirror:
                    twin = next(n for n in nodes[1:] if (n.host, n.port) != addr)
                    await super()._hop((twin.host, twin.port), stage, session_id, payload)
                return out

        c = Mirrored(obs, 2, sampling=GREEDY, prefill_chunk=8)
        moved = {}

        def on_token(tok):
            if len(moved) or tok is None:
                return
            sid = next(iter(c._plans))
            victim_id = c._plans[sid].chain[1][0]
            victim = next(n for n in nodes[1:] if n.node_id == victim_id)
            twin = next(n for n in nodes[1:] if n is not victim)
            c.mirror = False
            victim.crash()
            _wait(lambda: sess_hash(sid) in obs.get_stage(1)[twin.node_id].get("sess", ()),
                  "the twin's advert never reached the client")
            moved.update(sid=sid, twin=twin.node_id)

        got = _generate(c, session_retries=0, on_token=on_token)
        assert got == expected and moved
        assert not c._plans  # ended
    finally:
        obs.stop()
        _stop(nodes)


def test_routed_client_empty_stage_is_a_retryable_503():
    nodes = _swarm([0], *COUNTER2)
    obs = _observer(nodes[0])
    try:
        _wait(lambda: obs.get_stage(0), "no view")
        with pytest.raises(ServerError) as ei:
            _generate(RoutedChainClient(obs, 2, sampling=GREEDY), session_retries=1,
                      retry_delay_s=0.05)
        assert ei.value.code == "no_chain" and ei.value.retryable and ei.value.status == 503
        assert isinstance(ei.value.__cause__, NoNodeForStage)
    finally:
        obs.stop()
        _stop(nodes)


# -- send --routed -----------------------------------------------------------------------


def test_send_routed_prints_the_jax_stream(model_swarm, expected, capsys):
    (seed, _a, _b), _obs = model_swarm
    argv = ["--routed", f"127.0.0.1:{seed.dht.port}", "--num-stages", "2", "--prompt-ids",
            ",".join(map(str, PROMPT)), "--max-new-tokens", str(NEW), "--temperature", "0",
            "--prefill-chunk", "8"]
    assert send.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[0] == f"generated ids: {expected}"


@pytest.mark.parametrize("argv, rc, message", [
    (["--routed", "127.0.0.1:1"], 2, "--routed needs --num-stages"),
    (["--routed", "127.0.0.1:1", "--num-stages", "2"], 1, "never converged"),
])
def test_send_routed_refusals(argv, rc, message, capsys, monkeypatch):
    monkeypatch.setattr(send, "ROUTED_WAIT_S", 0.3)
    try:
        got = send.main([*argv, "--prompt-ids", "3"])
    except SystemExit as e:
        got = e.code
    assert got == rc and message in capsys.readouterr().err
