"""Deploying the port from a manifest, with the seed and send tools (CPU):

  * a `tools/seed` process bootstraps a three-stage counter swarm whose
    nodes take their stage from a manifest (`run_node --manifest --name`,
    the YAML written by the port's Manifest.to_yaml): the nodes' views fill
    through the seed, their records carry their manifest names, a request
    answers state 3 in trace order, and the seed's view lists every node;
  * `tools/send --entry` and `--chain` against a live TINY swarm started the
    same way print the JAX Engine's greedy ids, streamed or not, with
    logprobs; the flags of later ROADMAP items fail naming their item;
  * a `--kv-dtype float8_e4m3fn` node serves the stream of an in-process
    executor with the same fp8 KV config; the counter backend refuses the
    flag, and a checkpoint that disagrees with its manifest fails the node.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.base import http_post
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.parallel import stages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.executor import make_executor
from inferd_tpu_torch.tools import run_node, send

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 8
PROMPT = [3, 7, 11, 19, 23, 29, 31]


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


def _manifest(tmp_path, num_stages):
    path = tmp_path / f"cluster{num_stages}.yaml"
    path.write_text(stages.Manifest.even_split("tiny", num_stages).to_yaml())
    return str(path)


def _node(argv, seed_port=None):
    argv = ["--port", "0", "--gossip-port", "0", "--device", "cpu", *argv]
    if seed_port is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed_port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _converge(nodes, want, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(sum(len(v) for v in n.dht.get_all().values()) == want for n in nodes):
            return
        time.sleep(0.02)
    raise AssertionError("gossip did not converge")


class _Seed:
    """A tools/seed process on an ephemeral port; its stdout lines collected."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "inferd_tpu_torch.tools.seed", "--port", "0", "--host",
             "127.0.0.1", "--log-level", "WARNING"],
            cwd=REPO, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self.port = self.wait(lambda d: d.get("ready"), 120.0)["port"]

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(json.loads(line))

    def wait(self, pred, timeout_s=15.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            hit = [d for d in self.lines if pred(d)]
            if hit:
                return hit[-1]
            if self.proc.poll() is not None:
                raise AssertionError(f"seed exited with {self.proc.returncode}")
            time.sleep(0.05)
        raise AssertionError(f"seed printed {self.lines}")

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=30)
        self._reader.join(timeout=10)
        return rc


def test_seed_bootstraps_a_manifest_counter_swarm(tmp_path):
    manifest = _manifest(tmp_path, 3)
    seed = _Seed()
    nodes = []
    try:
        for i in range(3):
            nodes.append(_node(["--backend", "counter", "--manifest", manifest, "--name",
                                f"node{i}"], seed_port=seed.port))
        _converge(nodes, 3)  # each node bootstrapped to the seed alone
        assert [n.spec.stage for n in nodes] == [0, 1, 2]
        rec = nodes[0].dht.get_stage(2)[nodes[2].node_id]
        assert rec["name"] == "node2" and rec["model"] == "counter"
        status, raw, _ = http_post(f"http://127.0.0.1:{nodes[0].port}/forward",
                                   wire.pack({"session_id": "c", "stage": 0, "payload": {}}), 30)
        result = wire.unpack(raw)["result_for_user"]
        assert status == 200 and (result["state"], result["trace"]) == (3, [0, 1, 2])
        want = {str(i): [n.node_id] for i, n in enumerate(nodes)}
        assert seed.wait(lambda d: d.get("view") == want)["view"] == want
    finally:
        for n in nodes:
            n.stop()
        assert seed.stop() == 0


@pytest.fixture(scope="module")
def tiny_swarm(jp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deploy")
    parts = str(tmp / "parts")
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    manifest = _manifest(tmp, 2)
    first = _node(["--parts", parts, "--max-len", "64", "--manifest", manifest,
                   "--name", "node0"])
    second = _node(["--parts", parts, "--max-len", "64", "--manifest", manifest,
                    "--name", "node1"], seed_port=first.dht.port)
    _converge([first, second], 2)
    yield first, second, parts, manifest
    first.stop()
    second.stop()


@pytest.fixture(scope="module")
def expected(jp):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return engine.generate(PROMPT, max_new_tokens=NEW)


def _send(capsys, *argv):
    base = ["--prompt-ids", ",".join(map(str, PROMPT)), "--max-new-tokens", str(NEW),
            "--temperature", "0"]
    assert send.main([*argv, *base]) == 0
    return capsys.readouterr().out


def test_send_entry_and_chain_print_the_jax_stream(tiny_swarm, expected, capsys):
    first, second, _, _ = tiny_swarm
    assert (first.spec.stage, second.spec.stage) == (0, 1)
    entry = f"127.0.0.1:{first.port}"
    chain = f"127.0.0.1:{first.port},127.0.0.1:{second.port}"
    for argv in (["--entry", entry], ["--chain", chain]):
        out = _send(capsys, *argv, "--logprobs", "--top-logprobs", "2")
        lines = out.splitlines()
        assert lines[0] == f"generated ids: {expected}"
        lps = json.loads(lines[1].split("logprobs:", 1)[1])
        assert len(lps) == NEW and all(x <= 0 for x in lps)
        assert sum(ln.startswith("top[") for ln in lines) == NEW
        streamed = _send(capsys, *argv, "--stream")
        assert [int(t) for t in streamed.split()] == expected


@pytest.mark.parametrize("argv, item", [
    (["--routed", "127.0.0.1:1", "--num-stages", "2", "--server-side"], "needs --entry"),
    (["--entry", "127.0.0.1:1", "--pin-prefix-ids", "3,7"], "does not start with"),
    (["--chain", "127.0.0.1:1", "--server-side"], "needs --entry"),
])
def test_send_refuses_what_later_items_bring(argv, item, capsys):
    """The flags the JAX package's send checks: --server-side runs only
    through an entry node, and a pin must be a prefix of the prompt
    (both exit 2 before any node is contacted)."""
    assert send.main([*argv, "--prompt-ids", "3"]) == 2
    assert item in capsys.readouterr().err


def test_fp8_kv_node_equals_an_in_process_executor(jp, tmp_path):
    parts = str(tmp_path)
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts)
    node = _node(["--parts", parts, "--max-len", "64", "--kv-dtype", "float8_e4m3fn"])
    cfg = tcfg.TINY.__class__(**dict(vars(tcfg.TINY), kv_dtype="float8_e4m3fn"))
    local = make_executor(cfg, stages.StageSpec(0, 1, 0, cfg.num_layers - 1),
                          convert.params_from_numpy(jax.tree.map(np.asarray, jp), None),
                          max_len=64)
    try:
        assert node.executor.cfg.kv_dtype == "float8_e4m3fn"

        async def go():
            async with ChainClient([(node.host, node.port)],
                                   sampling=SamplingConfig(temperature=0.0)) as c:
                return await c.generate_ids(PROMPT, max_new_tokens=NEW)

        got = asyncio.run(go())
    finally:
        node.stop()
    ids, pos = list(PROMPT), 0
    want = []
    for _ in range(NEW):
        out = local.process("s", {"tokens": [ids[pos:]], "start_pos": pos,
                                  "real_len": len(ids) - pos})
        pos = len(ids)
        ids.append(int(out["logits"][0].argmax()))
        want.append(ids[-1])
    assert got == want


def test_node_refusals(tiny_swarm, tmp_path):
    _, _, parts, _ = tiny_swarm
    with pytest.raises(ValueError, match="keeps no KV"):
        run_node.make_node(run_node.build_parser().parse_args(
            ["--backend", "counter", "--kv-dtype", "float8_e4m3fn", "--port", "0",
             "--gossip-port", "0", "--device", "cpu"]))
    other = tmp_path / "three.yaml"
    other.write_text(stages.Manifest.even_split("tiny", 4).to_yaml())
    with pytest.raises(ValueError, match="the manifest"):
        run_node.make_node(run_node.build_parser().parse_args(
            ["--parts", parts, "--manifest", str(other), "--name", "node1", "--port", "0",
             "--gossip-port", "0", "--device", "cpu"]))
    with pytest.raises(ValueError, match="not --model"):
        run_node.make_node(run_node.build_parser().parse_args(
            ["--parts", parts, "--model", "qwen3-0.6b", "--port", "0", "--gossip-port", "0",
             "--device", "cpu"]))
