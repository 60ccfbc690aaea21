"""The gossiped prefix digest in the port, held to the JAX package's:
`make_digest`, `AffinityProbe.depth_frac` (salted too) and
`BlockPool.digest_keys` (pinned first, then most recently used) on the same
prompts and pool operations; both lane executors' `prefix_digest` after the
same prefills (None on a dense slab, an inner stage and an empty index);
and a whole-model paged lane node whose gossip record carries that digest
as `pfx`, in the reference's key order, which `path_finder.ranked_nodes`
scores with a probe."""

import http.client

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core import prefix as jprefix
from inferd_tpu.core.cache import BlockPool as JPool
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.batch_executor import BatchedExecutor as JBatched
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JLanes
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.control import path_finder
from inferd_tpu_torch.core import prefix
from inferd_tpu_torch.core.cache import BlockPool
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

L = jcfg.TINY.num_layers
RNG = np.random.default_rng(11)
PROMPTS = [RNG.integers(0, jcfg.TINY.vocab_size, n).tolist() for n in (19, 33, 8, 40)]
PROMPTS.append(PROMPTS[1][:17] + [5, 6, 7])  # shares two blocks of 8 with the second


@pytest.fixture(scope="module")
def tiny():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


@pytest.mark.parametrize("bs", [4, 8, 32])
@pytest.mark.parametrize("salt", [None, "tenant0"])
def test_digest_and_probe_equal_reference(bs, salt):
    for p in PROMPTS + [list(range(300))]:
        keys = prefix.block_keys(p, bs, salt=salt)
        assert keys == jprefix.block_keys(p, bs, salt=salt)
        assert prefix.make_digest(keys, bs) == jprefix.make_digest(keys, bs)
    records = [{"pfx": prefix.make_digest(prefix.block_keys(p, b), b)}
               for p in PROMPTS for b in (4, 8, 32)]
    records += [{}, {"pfx": None}, {"pfx": {"bs": "x", "k": ["a"]}}, {"pfx": {"bs": 8, "k": []}},
                {"pfx": {"bs": 0, "k": ["a"]}}, {"pfx": {"bs": 8, "k": [1, None]}},
                {"pfx": prefix.make_digest(prefix.block_keys(PROMPTS[1], bs, salt="tenant0"),
                                           bs)}]
    for p in PROMPTS:
        ours = prefix.AffinityProbe(p, salt=salt)
        theirs = jprefix.AffinityProbe(p, salt=salt)
        for r in records:
            assert ours.depth_frac(r) == theirs.depth_frac(r)
    assert prefix.AffinityProbe(PROMPTS[1]).depth_frac(records[4]) == 1.0
    assert (prefix.DIGEST_MAX_KEYS, prefix.DIGEST_GOSSIP_KEYS) == (
        jprefix.DIGEST_MAX_KEYS, jprefix.DIGEST_GOSSIP_KEYS)
    big = prefix.block_keys(list(range(2000)), 8)
    assert len(prefix.make_digest(big, 8)["k"]) == prefix.DIGEST_MAX_KEYS


def test_digest_keys_pinned_first_then_mru_equal_reference():
    pools = [JPool(jcfg.TINY, L, lanes=3, max_len=96, block_size=16, num_blocks=64),
             BlockPool(tcfg.TINY, L, lanes=3, max_len=96, block_size=16, num_blocks=64)]
    a = prefix.block_keys(list(range(32)), 16)
    b = prefix.block_keys(list(range(100, 132)), 16)
    c = prefix.block_keys(list(range(200, 232)), 16)
    outs = []
    for pool in pools:
        for lane, keys in enumerate((a, b, c)):
            pool.ensure(lane, 32, owner=f"lane{lane}")
            pool.register_prefix(lane, keys)
        pool.pin(b)
        first = pool.digest_keys()
        pool.release_lane(0)
        pool.map_prefix(0, a)  # a hit: `a` becomes the most recently used
        outs.append((first, pool.digest_keys(limit=4), pool.digest_keys(limit=1)))
    assert outs[0] == outs[1]
    assert outs[1][0][:2] == b and set(outs[1][0]) == set(a + b + c)
    assert outs[1][1][:2] == b and set(outs[1][1][2:]) == set(a)


def _prefill(ex, sid, p):
    return ex.process(sid, {"tokens": [p], "start_pos": 0, "real_len": len(p)})


def _whole_pairs(tiny):
    jspec = list(jstages.Manifest.even_split("tiny", 1).stage_specs())[0]
    tspec = tstages.StageSpec(0, 1, 0, L - 1)
    kw = dict(lanes=4, max_len=64, block_size=8)
    return [
        (JLanes(jcfg.TINY, jspec, jstages.extract_stage_params(tiny[0], jcfg.TINY, jspec), **kw),
         BatchedStageExecutor(tcfg.TINY, tspec,
                              tstages.extract_stage_params(tiny[1], tcfg.TINY, tspec), **kw)),
        (JBatched(jcfg.TINY, tiny[0], **kw), BatchedExecutor(tcfg.TINY, tiny[1], **kw)),
    ]


def test_lane_executors_digest_equals_reference(tiny):
    for pair in _whole_pairs(tiny):
        assert [ex.prefix_digest() for ex in pair] == [None, None]  # an empty index
        for i, p in enumerate(PROMPTS):
            for ex in pair:
                _prefill(ex, f"s{i}", p)
                if i % 2:
                    ex.end_session(f"s{i}")  # its blocks stay indexed
        want = pair[0].prefix_digest()
        assert want is not None and want["bs"] == 8 and want["k"]
        assert pair[1].prefix_digest() == want


def test_digest_is_none_dense_and_on_inner_stages(tiny):
    tspec = tstages.StageSpec(0, 1, 0, L - 1)
    dense = BatchedStageExecutor(tcfg.TINY, tspec,
                                 tstages.extract_stage_params(tiny[1], tcfg.TINY, tspec),
                                 lanes=2, max_len=64)
    _prefill(dense, "s", PROMPTS[0])
    assert dense.prefix_digest() is None
    first = tstages.StageSpec(0, 2, 0, L // 2 - 1)
    stage0 = BatchedStageExecutor(tcfg.TINY, first,
                                  tstages.extract_stage_params(tiny[1], tcfg.TINY, first),
                                  lanes=2, max_len=64, block_size=8)
    _prefill(stage0, "s", PROMPTS[0])
    assert stage0.prefix_digest() is None


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def test_paged_lane_node_gossips_the_reference_digest(tiny, tmp_path):
    parts = str(tmp_path)
    jstages.split_and_save(tiny[0], jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts)
    argv = ["--parts", parts, "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--max-len", "64", "--stage-lanes", "4", "--paged-kv", "8", "--name", "lanes-a"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv)).start()
    dense = run_node.make_node(run_node.build_parser().parse_args(
        argv[:-6] + ["--stage-lanes", "4"])).start()
    ref = _whole_pairs(tiny)[0][0]
    try:
        for i, p in enumerate(PROMPTS):
            env = {"session_id": f"s{i}", "stage": 0, "relay": False,
                   "payload": {"tokens": np.asarray([p], np.int32), "start_pos": 0,
                               "real_len": len(p)}}
            for n in (node, dense):
                status, body = _post(n, env)
                assert status == 200, body
            _prefill(ref, f"s{i}", p)
        node.announce()
        dense.announce()
        rec = node.dht.get_stage(0)[node.node_id]
        assert rec["pfx"] == ref.prefix_digest()
        assert list(rec) == ["name", "stage", "load", "cap", "host", "port", "model", "svc_ms",
                             "pfx", "sess"]
        assert rec["name"] == "lanes-a"
        drec = dense.dht.get_stage(0)[dense.node_id]
        assert "pfx" not in drec and drec["name"] == dense.node_id
        probe = prefix.AffinityProbe(PROMPTS[3])
        assert probe.depth_frac(rec) == 1.0 and probe.depth_frac(drec) == 0.0
        cold = dict(drec, load=0)
        warm = dict(rec, load=0)
        picked = path_finder.ranked_nodes({"cold": cold, "warm": warm}, affinity=probe)[0][0]
        assert picked == "warm"
    finally:
        node.stop()
        dense.stop()
