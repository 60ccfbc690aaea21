"""The coalesced relay on the port's `--stage-lanes` nodes (CPU, TINY with
every weight but the norms 10x its init, so greedy streams move):

  * two- and three-stage relay-mode lane swarms take four concurrent
    sessions through the SwarmClient: the streams equal the JAX Engine's and
    the ChainClient's on the same nodes; the stage-0 node coalesces decode
    relays (`hop.coalesced`), each receiver counts as many frames
    (`forward.multi_frames`) as its sender coalesced sessions, and the
    middle stage of three coalesces again on its way to the last;
  * a next hop that answers the multi form with 400 (a peer that cannot
    read it) costs a per-session fallback (`hop.coalesced_fallback`), not a
    stream;
  * a multi envelope whose frame carries a spent deadline gets that frame's
    own 408 inside a 200 multi reply, its other frame's logits beside it; a
    malformed one answers 400 "bad multi envelope".
"""

import asyncio
import http.client
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
NEW = 8
PROMPT_LENS = (5, 12, 21, 30)
LANE_ARGS = ["--max-len", "64", "--stage-lanes", "4", "--paged-kv", "16",
             "--prefill-chunk", "8", "--window-ms", "50"]


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, jcfg.TINY.vocab_size, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def expected(jp, prompts):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return [engine.generate(p, max_new_tokens=NEW) for p in prompts]


def _parts(jp, tmp_path_factory, n):
    out = str(tmp_path_factory.mktemp(f"parts{n}"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", n), out)
    return out


def _swarm(parts, num_stages):
    """One lane node per stage, the first the gossip seed; returns them once
    every view holds every record."""
    nodes = []
    for s in range(num_stages):
        argv = ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0",
                "--device", "cpu", *LANE_ARGS]
        if nodes:
            argv += ["--bootstrap", f"127.0.0.1:{nodes[0].dht.port}"]
        node = run_node.make_node(run_node.build_parser().parse_args(argv))
        node.dht.gossip_period_s = 0.05
        node.path_finder.retry_delay_s = 0.05
        nodes.append(node.start())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(sum(len(v) for v in n.dht.get_all().values()) == num_stages for n in nodes):
            return nodes
        time.sleep(0.02)
    raise AssertionError("gossip did not converge")


def _stop(nodes):
    for n in nodes:
        n.stop()


def _generate(client, prompts):
    async def go():
        async with client as c:
            return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=NEW)
                                          for p in prompts))

    return asyncio.run(go())


def _counters(node):
    return node.stats()["metrics"]["counters"]


@pytest.mark.parametrize("num_stages", [2, 3])
def test_lane_relays_coalesce_and_equal_the_chain(jp, tmp_path_factory, prompts, expected,
                                                  num_stages):
    nodes = _swarm(_parts(jp, tmp_path_factory, num_stages), num_stages)
    try:
        addrs = [(n.host, n.port) for n in nodes]
        relayed = _generate(SwarmClient(addrs[:1], sampling=GREEDY, prefill_chunk=16), prompts)
        c = [_counters(n) for n in nodes]
        chained = _generate(ChainClient(addrs, sampling=GREEDY, prefill_chunk=16), prompts)
        assert relayed == expected == chained
        for i in range(num_stages - 1):  # every sender and its receiver agree
            assert c[i].get("hop.coalesced", 0) >= 1, (i, c[i])
            assert c[i + 1]["forward.multi_envelopes"] == c[i]["hop.coalesced"]
            assert c[i + 1]["forward.multi_frames"] == c[i]["hop.coalesced_sessions"]
            assert c[i].get("hop.coalesced_fallback", 0) == 0
            # a POST per single relay and per coalesced group: fewer than relays
            assert c[i]["hop.count"] < nodes[i].stats()["relays"]
        assert "hop.count" not in c[-1]  # the last stage relays nothing
        for n in nodes:
            st = n.stats()
            assert st["errors"] == 0 and st["wire_codec"] == "native"
            assert st["executor"]["sessions"] == 0
    finally:
        _stop(nodes)


def test_a_peer_refusing_multi_costs_a_fallback_not_a_stream(jp, tmp_path_factory, prompts,
                                                            expected):
    nodes = _swarm(_parts(jp, tmp_path_factory, 2), 2)
    old = nodes[1]
    # a peer that cannot read the multi form answers it as a bad envelope
    old._forward_multi = lambda env: old._error(400, "bad envelope: no multi here")
    try:
        got = _generate(SwarmClient([(nodes[0].host, nodes[0].port)], sampling=GREEDY,
                                    prefill_chunk=16), prompts)
        assert got == expected
        c0 = _counters(nodes[0])
        assert c0["hop.coalesced_fallback"] >= 1
        assert c0["hop.coalesced_fallback"] == c0["hop.coalesced"]
        assert "forward.multi_frames" not in _counters(old)
    finally:
        _stop(nodes)


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def test_a_spent_deadline_answers_its_own_frame(jp, tmp_path_factory, prompts):
    nodes = _swarm(_parts(jp, tmp_path_factory, 2), 2)
    try:
        rows = {}
        for sid, p in zip(("x", "y"), prompts[:2]):
            x = {"tokens": np.asarray([p], np.int32), "start_pos": 0, "real_len": len(p)}
            for n in nodes:  # chain mode: each stage's result carried by hand
                status, body = _post(n, {"session_id": sid, "stage": n.spec.stage,
                                         "relay": False, "payload": x})
                assert status == 200, body
                x = dict(body["result"], start_pos=0, real_len=len(p))
            tok = int(np.argmax(np.asarray(body["result"]["logits"])[0]))
            status, body = _post(nodes[0], {"session_id": sid, "stage": 0, "relay": False,
                                            "payload": {"tokens": np.asarray([[tok]], np.int32),
                                                        "start_pos": len(p), "real_len": 1}})
            assert status == 200
            rows[sid] = (body["result"]["hidden"], len(p))
        envs = [{"task_id": sid, "session_id": sid, "stage": 1,
                 "payload": {"hidden": rows[sid][0], "start_pos": rows[sid][1], "real_len": 1}}
                for sid in ("x", "y")]
        envs[0]["deadline_ms"] = time.time() * 1e3 - 1000.0
        status, body = _post(nodes[1], wire.coalesce_forward(envs))
        assert status == 200
        frames = body["multi"]
        assert [f["status"] for f in frames] == [408, 200]
        assert wire.unpack(frames[0]["body"])["code"] == "deadline"
        logits = np.asarray(wire.unpack(frames[1]["body"])["result_for_user"]["logits"])
        assert logits.shape == (1, jcfg.TINY.vocab_size) and np.isfinite(logits).all()
        c1 = _counters(nodes[1])
        assert c1["forward.multi_envelopes"] == 1 and c1["forward.multi_frames"] == 2
        assert c1["deadline.expired.entry"] == 1
        bad = wire.coalesce_forward(envs)
        bad["multi"] = bad["multi"][:1]
        status, body = _post(nodes[1], bad)
        assert status == 400 and "bad multi envelope" in body["error"]
    finally:
        _stop(nodes)
