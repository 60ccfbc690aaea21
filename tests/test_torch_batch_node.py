"""Whole-model continuous batching behind a node in the port
(inferd_tpu_torch/runtime/batch_executor.py, `run_node --batch-lanes`)
against the JAX package's BatchedExecutor, on TINY with every weight but
the norms 10x its init (greedy streams vary).

Prefill and decode logits are held to the reference's at f32 atol 1e-4,
dense and paged; greedy K-step tokens equal the reference's K-step items
(its fuse_kstep_group) on BatchedExecutor and on a whole-model
BatchedStageExecutor, and the port's own single-token steps. Co-arriving
threads coalesce in the executor's own window; an evicted session answers
session_state and restarts; quantized lanes equal the port's quantized
Engine; a CPU `run_node --batch-lanes` node answers the ChainClient with
the JAX engine's stream, and 503 `busy` when every lane is in flight."""

import asyncio
import http.client
import threading

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine as JEngine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.batch_executor import BatchedExecutor as JBatched
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JLanes
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.core.generate import Engine
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.ops import quant
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor, CapacityError
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

ATOL = 1e-4
L = jcfg.TINY.num_layers
PROMPTS = [[3, 7, 11, 19], [2, 5, 13, 17, 23, 29, 31, 37, 41, 43, 47, 53], [61, 67]]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX params, port params, a one-stage parts directory)."""
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    parts = str(tmp_path_factory.mktemp("parts1"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None), parts


def _pair(tiny, **kw):
    kw = dict(dict(lanes=4, max_len=64, window_ms=1.0), **kw)
    return JBatched(jcfg.TINY, tiny[0], **kw), BatchedExecutor(tcfg.TINY, tiny[1], **kw)


def _whole_lanes(tiny, **kw):
    """The reference's and the port's whole-model stage lane executors."""
    kw = dict(dict(lanes=4, max_len=64), **kw)
    jspec = list(jstages.Manifest.even_split("tiny", 1).stage_specs())[0]
    tspec = tstages.StageSpec(0, 1, 0, L - 1)
    return (JLanes(jcfg.TINY, jspec, jstages.extract_stage_params(tiny[0], jcfg.TINY, jspec), **kw),
            BatchedStageExecutor(tcfg.TINY, tspec,
                                 tstages.extract_stage_params(tiny[1], tcfg.TINY, tspec), **kw))


def _prefill(ex, sid, prompt):
    return ex.process(sid, {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})


def _step(ex, sid, tok, pos, **kw):
    return ex.process(sid, dict({"tokens": [[tok]], "start_pos": pos, "real_len": 1}, **kw))


@pytest.mark.parametrize("block_size", [0, 8])
def test_prefill_and_decode_logits_equal_reference(tiny, block_size):
    """Three sessions, prefilled in 5-token chunks (paged: blocks of 8, the
    third sharing the first's prefix), then greedy steps one session at a
    time: every prefill's and step's logits at atol 1e-4."""
    pair = _pair(tiny, block_size=block_size, prefill_chunk=5)
    prompts = PROMPTS[:2] + [PROMPTS[1][:9] + [4]]
    nxt = {}
    for i, p in enumerate(prompts):
        outs = [_prefill(ex, f"s{i}", p) for ex in pair]
        np.testing.assert_allclose(_np(outs[1]["logits"]), _np(outs[0]["logits"]), atol=ATOL)
        assert tuple(outs[1]["logits"].shape) == (1, tcfg.TINY.vocab_size)
        nxt[f"s{i}"] = (int(np.argmax(_np(outs[0]["logits"])[0])), len(p))
    if block_size:
        assert outs[1].get("tokens_saved") == 8 == outs[0].get("tokens_saved")
    for _ in range(3):
        for sid, (tok, pos) in list(nxt.items()):
            outs = [_step(ex, sid, tok, pos) for ex in pair]
            np.testing.assert_allclose(_np(outs[1]["logits"]), _np(outs[0]["logits"]),
                                       atol=ATOL)
            nxt[sid] = (int(np.argmax(_np(outs[0]["logits"])[0])), pos + 1)
    st = pair[1].stats()
    assert st["mode"] == "batched" and st["batched_tokens"] == st["batched_steps"] == 9
    assert st["prefill_tokens"] == sum(len(p) for p in prompts) - (8 if block_size else 0)
    for i in range(3):
        pair[1].end_session(f"s{i}")
    assert len(pair[1]) == 0 and sorted(pair[1].free) == [0, 1, 2, 3]


def test_decode_steps_actually_batch(tiny):
    """Decode steps of co-arriving sessions coalesce in the executor's own
    window (threads and a barrier: co-arrival guaranteed): the pending
    high-water mark reaches 2, and each step's logits equal the session's
    solo step."""
    ex = BatchedExecutor(tcfg.TINY, tiny[1], lanes=4, max_len=64, window_ms=200.0)
    solo = BatchedExecutor(tcfg.TINY, tiny[1], lanes=4, max_len=64, window_ms=0.0)
    hwm = {"n": 0}

    class TrackingList(list):
        def append(self, item):
            super().append(item)
            hwm["n"] = max(hwm["n"], len(self))

    ex._batcher._pending = TrackingList(ex._batcher._pending)
    sessions = [f"s{i}" for i in range(3)]
    last = {}
    for i, s in enumerate(sessions):
        p = [3 + i, 7, 11]
        last[s] = int(np.argmax(_np(_prefill(ex, s, p)["logits"])[0]))
        _prefill(solo, s, p)
    barrier = threading.Barrier(len(sessions))
    results = {}

    def step(s):
        barrier.wait()
        results[s] = _step(ex, s, last[s], 3)

    threads = [threading.Thread(target=step, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 3 and hwm["n"] >= 2, hwm
    for s in sessions:
        np.testing.assert_allclose(_np(results[s]["logits"]),
                                   _np(_step(solo, s, last[s], 3)["logits"]), atol=ATOL)
    st = ex.stats()
    assert st["window"]["batched_steps"] < 3 and st["window"]["batched_tokens"] == 3


def test_lane_eviction_and_restart(tiny):
    """More sessions than lanes: the least recently used idle session is
    evicted; it answers its next step with the reference's ValueError
    (session_state on the wire), and its restart equals the reference."""
    pair = _pair(tiny, lanes=2)
    for ex in pair:
        for sid, p in zip("abc", PROMPTS):
            _prefill(ex, sid, p)
        with pytest.raises(ValueError, match="unknown session"):
            _step(ex, "a", 5, len(PROMPTS[0]))
        assert "a" not in ex.sessions and len(ex.sessions) == 2
    outs = [_prefill(ex, "a", PROMPTS[0]) for ex in pair]
    np.testing.assert_allclose(_np(outs[1]["logits"]), _np(outs[0]["logits"]), atol=ATOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_lanes_equal_quantized_engine(tiny, mode):
    """Lanes over --quant weights give the port's solo Engine's greedy
    stream on the same quantized params."""
    qp = quant.apply_quant_mode(mode, tiny[1], tie_word_embeddings=tcfg.TINY.tie_word_embeddings)
    ex = BatchedExecutor(tcfg.TINY, qp, lanes=2, max_len=64, window_ms=1.0)
    eng = Engine(tcfg.TINY, qp, max_len=64, sampling_cfg=tcfg.SamplingConfig(temperature=0.0))
    for i, p in enumerate(PROMPTS[:2]):
        want = eng.generate(p, max_new_tokens=6)
        tok = int(np.argmax(_np(_prefill(ex, f"q{i}", p)["logits"])[0]))
        got = [tok]
        for j in range(5):
            got.append(int(np.argmax(_np(_step(ex, f"q{i}", got[-1], len(p) + j)["logits"])[0])))
        assert got == want


def _kstep_stream(ex, sid, prompt, steps, k):
    """A prompt's prefill (first token its argmax), then decode_steps k
    windows up to `steps` tokens, greedy."""
    out = [int(np.argmax(_np(_prefill(ex, sid, prompt)["logits"])[0]))]
    windows = []
    while len(out) < steps:
        r = _step(ex, sid, out[-1], len(prompt) + len(out) - 1,
                  decode_steps=min(k, steps - len(out)))
        windows.append((r["real_len"], r["decode_steps"]))
        out += [int(t) for t in r["tokens"][0]]
    return out, windows


@pytest.mark.parametrize("kind", ["batch", "stage"])
@pytest.mark.parametrize("block_size", [0, 8])
def test_kstep_items_equal_reference_and_single_steps(tiny, kind, block_size):
    """Greedy decode_steps 4 windows (paged: crossing blocks of 8) give the
    reference's K-step tokens (its fuse_kstep_group) and the port's own
    single-token steps; two sessions' items arriving together run as one
    window."""
    jex, ex = (_pair(tiny, block_size=block_size, window_ms=100.0) if kind == "batch"
               else _whole_lanes(tiny, block_size=block_size))
    for i, p in enumerate(PROMPTS[:2]):
        want, _ = _kstep_stream(jex, f"j{i}", p, 11, 4)
        got, windows = _kstep_stream(ex, f"k{i}", p, 11, 4)
        assert got == want and len(set(got)) > 2
        assert windows == [(4, 4), (4, 4), (2, 2)]
        single = [got[0]]
        for j in range(10):
            single.append(int(np.argmax(_np(_step(ex, f"k{i}", single[-1], len(p) + j)["logits"])[0])))
        assert single == got
    if kind == "stage":
        items = [(f"k{i}", {"tokens": [[1]], "start_pos": len(p) + 10, "real_len": 1,
                            "decode_steps": 3}) for i, p in enumerate(PROMPTS[:2])]
        outs = ex.process_batch(items)
        assert [o["real_len"] for o in outs] == [3, 3]
        st = ex.stats()
    else:
        before = ex.stats()["batched_steps"]
        res = {}
        barrier = threading.Barrier(2)

        def go(i, p):
            barrier.wait()
            res[i] = _step(ex, f"k{i}", 1, len(p) + 10, decode_steps=3)

        ts = [threading.Thread(target=go, args=(i, p)) for i, p in enumerate(PROMPTS[:2])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert [res[i]["real_len"] for i in (0, 1)] == [3, 3]
        st = ex.stats()
        assert st["batched_steps"] == before + 1  # one window for both items
        assert st["window"]["batched_tokens"] == st["batched_tokens"]
    if block_size:
        assert sum(st["decode_widths"].values()) >= st["batched_steps"]


def test_pipeline_stage_refuses_decode_steps(tiny):
    """A first stage of two answers a decode_steps item with the reference's
    ValueError, and the co-batched single-token items beside it are served."""
    jspec, tspec = (list(jstages.Manifest.even_split("tiny", 2).stage_specs())[0],
                    tstages.StageSpec(0, 2, 0, L // 2 - 1))
    ex = BatchedStageExecutor(tcfg.TINY, tspec,
                              tstages.extract_stage_params(tiny[1], tcfg.TINY, tspec),
                              lanes=2, max_len=64)
    jex = JLanes(jcfg.TINY, jspec, jstages.extract_stage_params(tiny[0], jcfg.TINY, jspec),
                 lanes=2, max_len=64)
    for e in (ex, jex):
        for sid in "ab":
            _prefill(e, sid, PROMPTS[0])
    items = [("a", {"tokens": [[1]], "start_pos": 4, "real_len": 1, "decode_steps": 4}),
             ("b", {"tokens": [[1]], "start_pos": 4, "real_len": 1})]
    outs, jouts = ex.process_batch(items), jex.process_batch(items)
    assert isinstance(outs[0], ValueError) and isinstance(jouts[0], ValueError)
    assert "single-stage" in str(outs[0]) and "single-stage" in str(jouts[0])
    np.testing.assert_allclose(_np(outs[1]["hidden"]), _np(jouts[1]["hidden"]), atol=ATOL)


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def test_batch_lanes_node_serves_chain_client_and_busy(tiny):
    """A CPU `run_node --batch-lanes 2` node (no window of the node's: the
    executor owns one): two concurrent ChainClient sessions give the JAX
    engine's greedy streams, and a new session while both lanes are in
    flight answers 503 `busy`. The flags the reference refuses are
    refused: --stage-lanes beside it, a checkpoint of two stages."""
    jp, _, parts = tiny
    base = ["--parts", parts, "--stage", "0", "--port", "0", "--gossip-port", "0",
            "--device", "cpu", "--max-len", "64"]
    node = run_node.make_node(run_node.build_parser().parse_args(
        base + ["--batch-lanes", "2", "--window-ms", "20"])).start()
    try:
        eng = JEngine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
        want = [eng.generate(p, max_new_tokens=8) for p in PROMPTS[:2]]

        async def go():
            async with ChainClient([(node.host, node.port)],
                                   sampling=tcfg.SamplingConfig(temperature=0.0)) as c:
                return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=8)
                                              for p in PROMPTS[:2]))

        assert asyncio.run(go()) == want
        ex = node.executor
        assert isinstance(ex, BatchedExecutor) and node.window is None
        st = ex.stats()
        assert st["batched_tokens"] == 14 and len(ex) == 0
        _prefill(ex, "x", PROMPTS[0])
        _prefill(ex, "y", PROMPTS[2])
        ex._inflight.update(x=1, y=1)  # both lanes mid-request
        try:
            status, body = _post(node, {"session_id": "z", "stage": 0, "relay": False,
                                        "payload": {"tokens": [PROMPTS[1]], "start_pos": 0}})
            assert status == 503 and body["code"] == "busy"
            with pytest.raises(CapacityError):
                _prefill(ex, "w", PROMPTS[1])
        finally:
            ex._inflight.clear()
    finally:
        node.stop()
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_node.make_node(run_node.build_parser().parse_args(
            base + ["--batch-lanes", "2", "--stage-lanes", "2"]))
    parts2 = str(__import__("tempfile").mkdtemp())
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts2)
    with pytest.raises(ValueError, match="single-stage"):
        run_node.make_node(run_node.build_parser().parse_args(
            ["--parts", parts2, "--stage", "0", "--port", "0", "--gossip-port", "0",
             "--device", "cpu", "--batch-lanes", "2"]))


def _delta(ex):  # standby replication (A4d's part d2)
    return ex.export_session_delta("s", 0)


@pytest.mark.parametrize("call,item", [
    (lambda ex: ex.fork_session("c", "p", 4), "A4d"), (lambda ex: ex.export_sessions(), "A4d"),
    (_delta, "A4d"),
    (lambda ex: ex.import_session("s", {}), "A4d"), (lambda ex: ex.anatomy_target(), "A9"),
    (lambda ex: ex.prefix_digest(), "A4b"), (lambda ex: ex.enable_spec(2, 4), "A7"),
])
def test_what_moves_elsewhere_raises_naming_its_item(tiny, call, item):
    ex = BatchedExecutor(tcfg.TINY, tiny[1], lanes=1, max_len=32)
    if item in LANDED:  # ported since: no refusal, a clean miss on an empty executor (a
        # False fork or import, no export or delta, no digest on a dense slab)
        assert not call(ex)
        return
    with pytest.raises(NotImplementedError, match=item):
        call(ex)


LANDED = ("A4b", "A4d")  # ROADMAP items of the cases above that have landed


def test_kstep_window_committing_no_token_fails_its_items(tiny):
    """A window whose active row reports no committed token (a broken
    window) fails its items and leaves the lane's frontier as it was."""
    ex = BatchedExecutor(tcfg.TINY, tiny[1], lanes=2, max_len=64)
    tok = int(np.argmax(_np(_prefill(ex, "s", PROMPTS[0])["logits"])[0]))
    real = ex._decode_k_fn

    def broken(*a, **kw):
        cache, seq, n_new, keys = real(*a, **kw)
        return cache, seq, n_new * 0, keys

    ex._decode_k_fn = broken
    with pytest.raises(RuntimeError, match="committed 0"):
        _step(ex, "s", tok, len(PROMPTS[0]), decode_steps=4)
    assert ex.lengths[ex._sessions["s"]] == len(PROMPTS[0]) and ex.stats()["batched_steps"] == 0
