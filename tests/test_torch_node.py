"""Two port chain nodes on loopback (CPU), serving parts written by the JAX
package, driven by the port's ChainClient: the greedy stream equals the
JAX Engine's on the same full params, token for token."""

import asyncio
import json

import http.client

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.client.base import ServerError
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    parts = str(tmp_path_factory.mktemp("parts"))
    params = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jstages.split_and_save(params, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    nodes = []
    for s in range(2):
        args = run_node.build_parser().parse_args(
            ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0", "--device", "cpu",
             "--max-len", "64"])
        nodes.append(run_node.make_node(args).start())
    yield nodes, params
    for n in nodes:
        n.stop()


def _addrs(nodes):
    return [(n.host, n.port) for n in nodes]


def _get(node, path):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _post(node, path, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("POST", path, body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def test_chain_greedy_stream_equals_jax_engine(chain):
    nodes, params = chain
    prompt = np.random.default_rng(0).integers(0, jcfg.TINY.vocab_size, 21).tolist()
    engine = Engine(jcfg.TINY, params, max_len=64,
                    sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    expected = engine.generate(prompt, max_new_tokens=12)
    passes0 = [n.stats()["forward_passes"] for n in nodes]
    seen = []

    async def go():
        # prefill in chunks of 8: 21 tokens = 8 + 8 + 5, bucket-padded per chunk
        async with ChainClient(_addrs(nodes), sampling=SamplingConfig(temperature=0.0),
                               prefill_chunk=8) as c:
            return await c.generate_ids(prompt, max_new_tokens=12, on_token=seen.append)

    got = asyncio.run(go())
    assert got == expected and seen == got
    for n, p0 in zip(nodes, passes0):
        st = n.stats()
        assert st["forward_passes"] - p0 == 3 + 11  # 3 prefill chunks + 11 decode steps
        assert st["device"] == "cpu" and st["errors"] == 0
        # CPU tensors take the plain version: the kernel never launches here
        assert st["kernels"]["flash_gqa"]["launches"] == 0
        assert st["executor"]["sessions"] == 0  # the client ended its session everywhere


def test_health_and_stats_endpoints(chain):
    nodes, _ = chain
    for s, n in enumerate(nodes):
        status, doc = _get(n, "/health")
        assert status == 200 and doc["status"] == "ok" and doc["stage"] == s
        status, doc = _get(n, "/stats")
        assert status == 200 and doc["num_stages"] == 2
        assert (doc["start_layer"], doc["end_layer"]) == ((0, 1) if s == 0 else (2, 3))
        assert "flash_gqa" in doc["kernels"]


def test_wrong_stage_relay_and_bad_requests_are_typed_errors(chain, monkeypatch):
    nodes, _ = chain
    env = {"session_id": "e", "stage": 1, "relay": False,
           "payload": {"tokens": np.asarray([[1, 2]], np.int32), "start_pos": 0}}
    status, body = _post(nodes[0], "/forward", env)
    assert status == 409 and body["code"] == "wrong_stage"
    # a relaying envelope is served: stage 0 computes, then finds no stage-1
    # record in its gossip store (the chain's nodes share no seed) and, after
    # the PathFinder's retries, answers 503
    monkeypatch.setattr(nodes[0].path_finder, "retry_delay_s", 0.01)
    status, body = _post(nodes[0], "/forward", dict(env, stage=0, relay=True))
    assert status == 503 and body["error"].startswith("no next node")
    status, body = _post(nodes[0], "/forward", dict(env, stage=0, payload={
        "tokens": np.asarray([[1]], np.int32), "start_pos": 5}))
    assert status == 409 and body["code"] == "session_state"
    status, body = _post(nodes[0], "/nowhere", {})
    assert status == 404
    status, body = _post(nodes[0], "/end_session", {"session_id": "e"})
    assert status == 200 and body == {"ok": True}


def test_client_surfaces_overflow_as_server_error(chain):
    nodes, _ = chain

    async def go():
        async with ChainClient(_addrs(nodes), sampling=SamplingConfig(temperature=0.0)) as c:
            return await c.generate_ids(list(range(60)), max_new_tokens=10)

    with pytest.raises(ServerError) as ei:
        asyncio.run(go())
    assert ei.value.status == 409 and ei.value.code == "overflow" and not ei.value.retryable


@pytest.fixture(scope="module")
def lane_chain(tmp_path_factory):
    parts = str(tmp_path_factory.mktemp("lane_parts"))
    params = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jstages.split_and_save(params, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    nodes = []
    for s in range(2):
        # a generous window: the gang target flushes it as soon as every live
        # idle session's step is pending, so it costs little
        args = run_node.build_parser().parse_args(
            ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0", "--device", "cpu",
             "--max-len", "64", "--stage-lanes", "4", "--paged-kv", "16",
             "--prefill-chunk", "8", "--window-ms", "50"])
        nodes.append(run_node.make_node(args).start())
    yield nodes, params
    for n in nodes:
        n.stop()


def test_lane_chain_concurrent_sessions_equal_jax_engine_and_cobatch(lane_chain):
    """Four concurrent greedy sessions through two --stage-lanes --paged-kv
    nodes: every stream equals the JAX Engine's, and each node ran decode
    steps that served more than one session at once."""
    nodes, params = lane_chain
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.TINY.vocab_size, n).tolist() for n in (5, 12, 21, 30)]
    engine = Engine(jcfg.TINY, params, max_len=64,
                    sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    expected = [engine.generate(p, max_new_tokens=10) for p in prompts]

    async def go():
        async with ChainClient(_addrs(nodes), sampling=SamplingConfig(temperature=0.0),
                               prefill_chunk=16) as c:
            return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=10) for p in prompts))

    assert asyncio.run(go()) == expected
    for n in nodes:
        _, st = _get(n, "/stats")
        ex = st["executor"]
        assert st["errors"] == 0 and ex["sessions"] == 0
        assert ex["batched_tokens"] > ex["batched_steps"] > 0  # some step served > 1 session
        assert ex["paged"]["blocks_used"] == 0  # every session's chain went back
        assert st["kernels"]["paged_decode_gqa"]["launches"] == 0  # CPU: the plain version
