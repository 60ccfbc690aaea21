"""Fused K-step decode (models/qwen3.decode_k) in the port, and the
one-session executor's `decode_steps` path, against the JAX package's.

Greedy windows are token-exact against the JAX executor and its
decode_k (B = 2, ragged fills, per-row eos, an inactive row). Sampled
windows follow the port's own key (core.sampling), so they are held to
the port's invariants: K fused steps equal K single steps from the same
key, an eos inside a window stops the row there, a replay recomputes the
same window. Mirrors tests/test_multistep.py's solo-executor tests."""

import http.client

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.cache import KVCache as JKVCache
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.core.cache import KVCache, PagedKVCache
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor, kstep_hi, parse_kstep
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

PROMPT = [3, 7, 11, 19]
SAMPLING = {"temperature": 0.8, "top_k": 8, "top_p": 0.95}
L = jcfg.TINY.num_layers


def _scaled(jp):
    """Every weight but the norms 10x its init, so greedy streams vary."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """Whole-model params of both packages and a one-stage parts dir."""
    jp = _scaled(jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)
    parts = str(tmp_path_factory.mktemp("parts1"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts)
    return jp, tp, parts


def _port_solo(solo, max_len=64):
    spec = tstages.StageSpec(0, 1, 0, L - 1)
    return Qwen3StageExecutor(tcfg.TINY, spec, tstages.extract_stage_params(solo[1], tcfg.TINY,
                                                                            spec),
                              max_len=max_len)


def _jax_solo(solo, max_len=64):
    spec = jstages.StageSpec(0, 1, 0, L - 1)
    return JExecutor(jcfg.TINY, spec, jstages.extract_stage_params(solo[0], jcfg.TINY, spec),
                     max_len=max_len)


def _client_loop(process, sid, prompt, steps):
    """The K=1 reference: one token per request, client-side argmax."""
    r = process(sid, {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    out = [int(np.argmax(np.asarray(r["logits"])[0]))]
    while len(out) < steps:
        r = process(sid, {"tokens": [[out[-1]]], "start_pos": len(prompt) + len(out) - 1,
                          "real_len": 1})
        out.append(int(np.argmax(np.asarray(r["logits"])[0])))
    return out


def _kstep_loop(process, sid, prompt, steps, k, eos=None, sampling=None, seed=0, keys=None):
    """decode_steps=k per request, chaining the returned key; `keys`
    collects each window's returned key."""
    r = process(sid, {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    out = [int(np.argmax(np.asarray(r["logits"])[0]))]
    pos, key = len(prompt), None
    while len(out) < steps and (eos is None or out[-1] != eos):
        pl = {"tokens": [[out[-1]]], "start_pos": pos, "decode_steps": min(k, steps - len(out))}
        if eos is not None:
            pl["eos"] = eos
        if sampling is not None:
            pl["sampling"], pl["seed"] = sampling, seed
        if key is not None:
            pl["key"] = key
        rr = process(sid, pl)
        assert rr["real_len"] == len(rr["tokens"][0]) and rr["start_pos"] == pos
        out.extend(int(t) for t in rr["tokens"][0])
        pos += rr["real_len"]
        key = rr["key"]
        if keys is not None:
            keys.append(list(key))
    return out


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_solo_kstep_greedy_equals_jax_executor(solo, k):
    jex, tex = _jax_solo(solo), _port_solo(solo)
    ref = _client_loop(jex.process, "ref", PROMPT, 12)
    assert len(set(ref)) > 3
    jkeys, tkeys = [], []
    assert _kstep_loop(jex.process, "j", PROMPT, 12, k, keys=jkeys) == ref
    assert _kstep_loop(tex.process, "t", PROMPT, 12, k, keys=tkeys) == ref
    assert tkeys == jkeys  # greedy leaves the key where the seed put it
    assert _client_loop(tex.process, "c", PROMPT, 12) == ref


@pytest.mark.parametrize("k", [2, 5, 8])
def test_solo_kstep_stop_token_mid_window(solo, k):
    """eos inside a window: the row stops there (real_len < K) and the
    stream equals the K = 1 loop's with the same eos. Sampled, so the stop
    lands mid-stream."""
    ex = _port_solo(solo)
    ref = _kstep_loop(ex.process, "r1", PROMPT, 12, 1, sampling=SAMPLING, seed=7)
    eos = ref[5]
    cut = ref.index(eos) + 1
    assert 1 < cut <= 6
    got = _kstep_loop(ex.process, f"k{k}", PROMPT, 12, k, eos=eos, sampling=SAMPLING, seed=7)
    assert got == ref[:cut]


@pytest.mark.parametrize("k", [4, 8])
def test_solo_kstep_sampled_equals_single_steps(solo, k):
    ex = _port_solo(solo)
    k1, kk = [], []
    ref = _kstep_loop(ex.process, "s1", PROMPT, 10, 1, sampling=SAMPLING, seed=7, keys=k1)
    got = _kstep_loop(ex.process, f"s{k}", PROMPT, 10, k, sampling=SAMPLING, seed=7, keys=kk)
    assert got == ref and len(set(ref)) > 1
    assert kk[-1] == k1[-1]  # the same key chain, whatever the window size


@pytest.mark.parametrize("which", ["jax", "port"])
def test_solo_kstep_budget_clamp_and_overflow(solo, which):
    """K falls back toward the KV budget; a frontier at max_len raises
    BufferError, in both packages alike."""
    ex = (_jax_solo if which == "jax" else _port_solo)(solo, max_len=10)
    r = ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": 4})
    tok = int(np.argmax(np.asarray(r["logits"])[0]))
    rr = ex.process("s", {"tokens": [[tok]], "start_pos": 4, "decode_steps": 16})
    assert rr["decode_steps"] == 6 and rr["real_len"] == 6
    with pytest.raises(BufferError):
        ex.process("s", {"tokens": [[1]], "start_pos": 10, "decode_steps": 4})


def test_solo_kstep_replay_rollback_and_refusals(solo):
    ex = _port_solo(solo)
    ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": 4})
    r1 = ex.process("s", {"tokens": [[5]], "start_pos": 4, "decode_steps": 4,
                          "sampling": SAMPLING, "seed": 3})
    r2 = ex.process("s", {"tokens": [[5]], "start_pos": 4, "decode_steps": 4,
                          "sampling": SAMPLING, "seed": 3})
    assert r1 == r2 and ex.sessions.get("s").length == 8
    with pytest.raises(ValueError, match="out-of-order"):
        ex.process("s", {"tokens": [[5]], "start_pos": 50, "decode_steps": 4})
    with pytest.raises(ValueError, match="start_pos > 0"):
        ex.process("s", {"tokens": [[5]], "start_pos": 0, "decode_steps": 4})
    with pytest.raises(ValueError, match=r"tokens \[1, 1\]"):
        ex.process("s", {"tokens": [[5, 6]], "start_pos": 8, "decode_steps": 4})
    spec0 = tstages.StageSpec(0, 2, 0, L // 2 - 1)
    stage0 = Qwen3StageExecutor(tcfg.TINY, spec0,
                                tstages.extract_stage_params(solo[1], tcfg.TINY, spec0),
                                max_len=64)
    stage0.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": 4})
    with pytest.raises(ValueError, match="single-stage"):
        stage0.process("s", {"tokens": [[1]], "start_pos": 4, "decode_steps": 4})


def test_parse_kstep_and_kstep_hi():
    assert parse_kstep({"decode_steps": 0}, 10) is None
    ks = parse_kstep({"decode_steps": 9, "seed": 5, "eos": 3,
                      "sampling": {"temperature": 0.5, "top_k": 4}}, 6)
    assert ks["k"] == 6 and ks["eos"] == 3 and ks["sampling"] == (0.5, 4, 1.0, 0.0)
    np.testing.assert_array_equal(ks["key"], np.asarray(jax.random.PRNGKey(5)))
    assert parse_kstep({"decode_steps": 2, "key": [1, 2]}, 6)["key"].tolist() == [1, 2]
    with pytest.raises(BufferError):
        parse_kstep({"decode_steps": 2}, 0)
    assert kstep_hi(10, 16, 16) == 26  # full window: k committed writes
    assert kstep_hi(10, 3, 16) == 14  # early eos: n committed + 1 frozen slot
    assert kstep_hi(10, 0, 4) == 11


def _prefilled(solo, rows):
    """Both packages' dense caches [L, B, 32, ...] with each row's prompt
    written from slot 0 (rows padded to one bucket)."""
    jp, tp, _ = solo
    s = max(len(r) for r in rows)
    toks = np.asarray([r + [0] * (s - len(r)) for r in rows], np.int32)
    jc = JKVCache.create(jcfg.TINY, L, len(rows), 32)
    _, jc = jq.forward_cached(jp, jcfg.TINY, jnp.asarray(toks), None, jc, jnp.int32(0))
    tc = KVCache.create(tcfg.TINY, L, len(rows), 32)
    tq.forward_cached(tp, tcfg.TINY, torch.from_numpy(toks).long(), None, tc, 0)
    return jc, tc


@pytest.mark.parametrize("active,eos", [([True, True], None), ([True, True], "row1"),
                                        ([False, True], [-1, -1]), ([True, True], "both")])
def test_decode_k_b2_ragged_equals_jax(solo, active, eos):
    """B = 2 rows at fills 5 and 9, greedy: seq and n_new equal the JAX
    decode_k's, and the serving form's equal them too."""
    jp, tp, _ = solo
    rows = [[3, 7, 11, 19, 5], [9, 4, 1, 8, 30, 2, 6, 12, 44]]
    lens, last, k = [5, 9], [5, 44], 6
    if isinstance(eos, str):
        jc, _ = _prefilled(solo, rows)
        _, free, _, _, _, _, _ = jq.decode_k(
            jp, jcfg.TINY, jnp.asarray(last, jnp.int32), jc, jnp.asarray(lens, jnp.int32),
            jnp.ones((2,), bool), jnp.zeros((2, 2), jnp.uint32), k)
        free = np.asarray(free)
        eos = [-1, int(free[2, 1])] if eos == "row1" else [int(free[3, 0]), int(free[1, 1])]
    jeos = None if eos is None else jnp.asarray(eos, jnp.int32)
    jc, tc = _prefilled(solo, rows)
    _, jseq, jn, jkeys, _, _, _ = jq.decode_k(
        jp, jcfg.TINY, jnp.asarray(last, jnp.int32), jc, jnp.asarray(lens, jnp.int32),
        jnp.asarray(active), jnp.zeros((2, 2), jnp.uint32), k, eos=jeos)
    keys0 = np.zeros((2, 2), np.uint32)
    _, seq, n_new, keys, lps, tis, _ = tq.decode_k(
        tp, tcfg.TINY, last, tc, lens, active, keys0, k, eos=eos, want_lp=True, top_n=2)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(n_new.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(keys, np.asarray(jkeys))  # greedy: untouched
    assert lps.shape == (k, 2) and tis.shape == (k, 2, 2)
    if eos is not None and eos[1] >= 0:
        assert int(n_new[1]) < k
    jc, tc = _prefilled(solo, rows)
    _, sseq, sn, _ = tq.make_decode_k_serve(tcfg.TINY)(
        tp, tc, last, lens, active, keys0, -1 if eos is None else eos, k, 0.0, 0, 1.0, 0.0)
    _, jsseq, jsn, _ = jq.make_decode_k_serve(jcfg.TINY)(
        jp, jc, jnp.asarray(last, jnp.int32), jnp.asarray(lens, jnp.int32), jnp.asarray(active),
        jnp.zeros((2, 2), jnp.uint32), jnp.asarray(-1 if eos is None else eos, jnp.int32), k,
        0.0, 0, 1.0, 0.0)
    np.testing.assert_array_equal(sseq.numpy(), np.asarray(jsseq))
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))


def test_decode_k_counts_eos_token_then_freezes(solo):
    """The stop token itself is emitted and counted; later steps re-emit it
    and write nothing real; sampled keys split every step regardless."""
    _, tp, _ = solo
    _, tc = _prefilled(solo, [PROMPT])
    key0 = samplib.prng_key(4)[None]
    _, seq, n_new, keys, _, _, _ = tq.decode_k(tp, tcfg.TINY, [PROMPT[-1]], tc, [4], [True],
                                               key0, 6, temperature=0.9, top_k=8)
    stream = seq[:, 0].tolist()
    assert int(n_new[0]) == 6
    eos = stream[2]
    expect = stream.index(eos) + 1
    _, tc = _prefilled(solo, [PROMPT])
    _, seq2, n2, keys2, _, _, _ = tq.decode_k(tp, tcfg.TINY, [PROMPT[-1]], tc, [4], [True],
                                              key0, 6, temperature=0.9, top_k=8, eos=eos)
    assert int(n2[0]) == expect and seq2[:, 0].tolist()[:expect] == stream[:expect]
    assert seq2[:, 0].tolist()[expect:] == [eos] * (6 - expect)
    np.testing.assert_array_equal(keys2, keys)
    with pytest.raises(BufferError):
        tq.decode_k(tp, tcfg.TINY, [1], tc, [30], [True], key0, 4)
    paged = PagedKVCache.create(tcfg.TINY, L, 1, 32, block_size=16)
    with pytest.raises(NotImplementedError, match="paged"):
        tq.decode_k(tp, tcfg.TINY, [1], paged, [4], [True], key0, 2)


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _node_process(node, stage=0):
    def process(sid, payload):
        status, body = _post(node, {"session_id": sid, "stage": stage, "relay": False,
                                    "payload": payload})
        if status != 200:
            raise RuntimeError((status, body))
        return body["result"]
    return process


def test_one_stage_node_serves_decode_steps(solo, tmp_path):
    """A one-stage run_node (CPU) serves decode_steps windows: its tokens,
    real_len and keys equal the in-process executor's, greedy and sampled;
    errors map to the JAX node's codes (409 overflow, 409 session_state for
    a stage of a two-stage chain)."""
    jp, _, parts = solo
    args = run_node.build_parser().parse_args(
        ["--parts", parts, "--stage", "0", "--port", "0", "--device", "cpu", "--max-len", "24"])
    node = run_node.make_node(args).start()
    parts2 = str(tmp_path / "parts2")
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts2)
    stage0 = run_node.make_node(run_node.build_parser().parse_args(
        ["--parts", parts2, "--stage", "0", "--port", "0", "--device", "cpu"])).start()
    try:
        ex = _port_solo(solo, max_len=24)
        for sampling in (None, SAMPLING):
            nk, ek = [], []
            got = _kstep_loop(_node_process(node), "n", PROMPT, 14, 5, sampling=sampling,
                              seed=2, keys=nk)
            assert got == _kstep_loop(ex.process, "e", PROMPT, 14, 5, sampling=sampling,
                                      seed=2, keys=ek)
            assert nk == ek
        status, body = _post(node, {"session_id": "n", "stage": 0, "relay": False,
                                    "payload": {"tokens": [[1]], "start_pos": 24,
                                                "decode_steps": 4}})
        assert status == 409 and body["code"] == "overflow"
        _node_process(stage0)("m", {"tokens": [PROMPT], "start_pos": 0, "real_len": 4})
        status, body = _post(stage0, {"session_id": "m", "stage": 0, "relay": False,
                                      "payload": {"tokens": [[1]], "start_pos": 4,
                                                  "decode_steps": 4}})
        assert status == 409 and body["code"] == "session_state"
        assert "single-stage" in body["error"]
    finally:
        node.stop()
        stage0.stop()
