"""Sessions that move, on the executors: the port's fork, export and import
and its handoff codec, held to the JAX package's (the TINY preset, weights
10x the init so greedy streams move; f32, K/V within atol 1e-5 and logits
within 1e-4, the stage tests' tolerances):

  * for the same prefilled session both packages export the same payload
    keys and length, K/V within 1e-5 (one-session, dense and paged lanes);
  * a payload the reference exports, packed by its wire, imports into the
    port and continues within 1e-4 of the reference's own continuation, and
    a port export imports into the reference the same way;
  * fork + suffix prefill gives the full prefill's greedy tokens on the
    one-session, the stage-lane (paged) and the batched (dense and paged)
    executors, and every miss is a clean False;
  * a forked child's writes never reach its parent's KV (a torch slice is a
    view), and a fork or an import takes a pooled buffer of its own;
  * runtime/handoff.decode fails closed on every malformed payload, and
    bf16 and fp8 payloads cross both packages' wires bit for bit;
  * `session_lengths` equals the reference's on every executor that exports.
"""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime import handoff as jhandoff
from inferd_tpu.runtime import wire as jwire
from inferd_tpu.runtime.batch_executor import BatchedExecutor as JBatched
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core.cache import BlockPool
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime import handoff, wire
from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor
from inferd_tpu_torch.runtime.executor import CounterStageExecutor, Qwen3StageExecutor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

torch.set_num_threads(2)

WHOLE = StageSpec(0, 1, 0, tcfg.TINY.num_layers - 1)
PROMPT = [3, 7, 11, 19, 5, 2, 17, 13, 23, 29, 31, 37, 41]
PREFIX = 9  # a fork point inside a 4-slot block and past a 16-slot one
MAX_LEN = 64
KINDS = ("one_session", "batched_dense", "batched_paged")


@pytest.fixture(scope="module")
def params():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    jsp = jstages.extract_stage_params(jp, jcfg.TINY, jstages.StageSpec(0, 1, 0, 3))
    return jp, jsp, convert.params_from_numpy(jax.tree.map(np.asarray, jsp), None)


def _port(params, kind, **kw):
    tp = params[2]
    if kind == "one_session":
        return Qwen3StageExecutor(tcfg.TINY, WHOLE, tp, max_len=MAX_LEN, initial_kv_len=16, **kw)
    if kind == "stage_paged":
        return BatchedStageExecutor(tcfg.TINY, WHOLE, tp, lanes=4, max_len=MAX_LEN,
                                    block_size=4, **kw)
    return BatchedExecutor(tcfg.TINY, tp, lanes=kw.pop("lanes", 4), max_len=MAX_LEN,
                           block_size=4 if kind == "batched_paged" else 0, **kw)


def _jax(params, kind="one_session"):
    if kind == "one_session":
        return JExecutor(jcfg.TINY, jstages.StageSpec(0, 1, 0, 3), params[1], max_len=MAX_LEN,
                         initial_kv_len=16)
    return JBatched(jcfg.TINY, params[0], lanes=4, max_len=MAX_LEN)


def _step(ex, sid, tokens, pos):
    out = ex.process(sid, {"tokens": np.asarray([tokens], np.int32), "start_pos": pos,
                           "real_len": len(tokens)})
    return np.asarray(out["logits"].float() if isinstance(out["logits"], torch.Tensor)
                      else out["logits"], np.float32)[0]


def _greedy(ex, sid, prompt, new, start=0, logits=None):
    """Greedy tokens of `new` steps after prefilling prompt[start:]."""
    pos = start
    if start < len(prompt):
        logits = _step(ex, sid, prompt[start:], start)
        pos = len(prompt)
    toks = []
    for _ in range(new):
        tok = int(np.argmax(logits))
        toks.append(tok)
        logits = _step(ex, sid, [tok], pos)
        pos += 1
    return toks, logits


def _kv(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- export parity ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_export_matches_the_reference(params, kind):
    jex, tex = _jax(params), _port(params, kind)
    for ex in (jex, tex):
        _greedy(ex, "s", PROMPT, 3)
        _step(ex, "other", [5, 6], 0)
    want = dict(jex.export_sessions(only="s"))["s"]
    got = dict(tex.export_sessions(only="s"))["s"]
    assert set(got) == set(want) == {"k", "v", "length"}
    assert got["length"] == want["length"] == len(PROMPT) + 3
    assert tuple(got["k"].shape) == tuple(np.asarray(want["k"]).shape)
    np.testing.assert_allclose(_kv(got["k"]), _kv(want["k"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_kv(got["v"]), _kv(want["v"]), rtol=0, atol=1e-5)
    assert sorted(s for s, _ in tex.export_sessions()) == ["other", "s"]
    assert tex.export_sessions(only="ghost") == []


# -- cross-package import -------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_a_reference_payload_continues_in_the_port(params, kind):
    """The reference exports after 2 decode steps; its wire packs the payload
    as /import_session carries it; the port imports it and decodes on
    within 1e-4 of the reference's own continuation."""
    jex, tex = _jax(params), _port(params, kind)
    toks, jl = _greedy(jex, "s", PROMPT, 2)
    body = jwire.pack({"session_id": "s", "stage": 0, **dict(jex.export_sessions())["s"]})
    env = wire.unpack(body)
    assert tex.import_session(env["session_id"], env)
    assert not tex.import_session("s", env)  # never over a live session
    pos = len(PROMPT) + 2
    tl = None
    for _ in range(4):
        tok = int(np.argmax(jl))
        jl = _step(jex, "s", [tok], pos)
        tl = _step(tex, "s", [tok], pos)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        pos += 1


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_payload_continues_in_the_reference(params, kind):
    jex, tex = _jax(params), _port(params, kind)
    toks, tl = _greedy(tex, "s", PROMPT, 2)
    body = wire.pack({"session_id": "s", "stage": 0, **dict(tex.export_sessions())["s"]})
    env = jwire.unpack(body)
    assert jex.import_session("s", env)
    pos = len(PROMPT) + 2
    for _ in range(4):
        tok = int(np.argmax(tl))
        tl = _step(tex, "s", [tok], pos)
        jl = _step(jex, "s", [tok], pos)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        pos += 1


def test_an_import_takes_a_pooled_buffer_of_its_bucket(params):
    src, dst = _port(params, "one_session"), _port(params, "one_session")
    _greedy(src, "s", PROMPT + list(range(40, 60)), 1)  # 34 slots: the 64 bucket
    payload = dict(src.export_sessions())["s"]
    before = dst.buffers.stats()["allocated"]
    assert dst.import_session("s", payload)
    cache = dst.sessions.get("s")
    assert cache.max_len == 64 and cache.length == payload["length"]
    assert dst.buffers.stats()["allocated"] == before + 1
    assert cache.k.data_ptr() != src.sessions.get("s").k.data_ptr()


def test_tenant_payloads(params):
    """A one-session executor declines a tenant payload (no registry); a
    lane executor without --adapters declines it too; an export stamps the
    session's binding."""
    src = _port(params, "batched_dense")
    _greedy(src, "s", PROMPT, 1)
    payload = dict(src.export_sessions())["s"]
    assert "adapter" not in payload
    src._session_adapter["s"] = "t0"  # as a tenant admission binds it
    stamped = dict(src.export_sessions())["s"]
    assert stamped["adapter"] == "t0"
    for kind in ("one_session", "batched_dense", "batched_paged"):
        assert not _port(params, kind).import_session("s", stamped)
        assert _port(params, kind).import_session("s", payload)


# -- fork parity and misses ---------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS + ("stage_paged",))
def test_fork_and_suffix_equal_a_full_prefill(params, kind):
    ex = _port(params, kind)
    full, _ = _greedy(ex, "fresh", PROMPT, 6)
    ex.end_session("fresh")
    _greedy(ex, "parent", PROMPT[:PREFIX], 3)  # the parent ran on past the fork point
    assert ex.fork_session("child", "parent", PREFIX)
    forked, _ = _greedy(ex, "child", PROMPT, 6, start=PREFIX)
    assert forked == full
    # the prompt IS the prefix: a second child starts from the parent's logits
    j = _port(params, kind)
    want, _ = _greedy(j, "p", PROMPT[:PREFIX], 4)
    logits = _step(ex, "pin", PROMPT[:PREFIX], 0)
    assert ex.fork_session("child2", "pin", PREFIX)
    got, _ = _greedy(ex, "child2", PROMPT[:PREFIX], 4, start=PREFIX, logits=logits)
    assert got == want


@pytest.mark.parametrize("kind", KINDS + ("stage_paged",))
def test_fork_misses_are_clean(params, kind):
    ex = _port(params, kind)
    assert not ex.fork_session("c", "nope", 4)  # unknown parent
    _step(ex, "p", [1, 2], 0)
    assert not ex.fork_session("c", "p", 5)  # shorter than the prefix
    assert not ex.fork_session("c", "p", 0)  # degenerate
    if kind != "one_session":
        ex._session_adapter["p"] = "t0"  # a tenant parent: its KV needs the adapter
        assert not ex.fork_session("c", "p", 2)
        del ex._session_adapter["p"]
    assert ex.fork_session("c", "p", 2)


@pytest.mark.parametrize("kind", ("batched_dense", "batched_paged", "stage_paged"))
def test_a_lane_fork_needs_a_lane_and_never_evicts_its_parent(params, kind):
    ex = _port(params, kind, lanes=2) if kind != "stage_paged" else _port(params, kind)
    lanes = ex.lanes
    for i in range(lanes):
        _step(ex, f"s{i}", PROMPT[:PREFIX], 0)
    for i in range(1, lanes):
        ex._inflight[f"s{i}"] = 1  # every other lane mid-step
    assert not ex.fork_session("child", "s0", PREFIX)  # the parent alone is idle
    assert "s0" in ex and "child" not in ex
    ex._inflight.pop("s1")
    assert ex.fork_session("child", "s0", PREFIX)  # s1 (idle now) goes, never s0
    assert "s0" in ex and "s1" not in ex


def test_dense_stage_lanes_do_not_fork(params):
    ex = BatchedStageExecutor(tcfg.TINY, WHOLE, params[2], lanes=2, max_len=MAX_LEN)
    _step(ex, "p", PROMPT, 0)
    assert not ex.fork_session("c", "p", 4)


def test_counter_forks_trivially():
    assert CounterStageExecutor(StageSpec(0, 2, 0, 0)).fork_session("c", "p", 4)


@pytest.mark.parametrize("kind", KINDS)
def test_a_childs_writes_never_reach_its_parent(params, kind):
    """A torch slice is a view: the fork must copy, or the child's suffix and
    decode writes would land in the parent's KV."""
    ex = _port(params, kind)
    _greedy(ex, "parent", PROMPT, 5)  # 18 slots: the 32 bucket
    before = dict(ex.export_sessions(only="parent"))["parent"]
    assert ex.fork_session("child", "parent", PREFIX)
    if kind == "one_session":
        parent, child = ex.sessions.get("parent"), ex.sessions.get("child")
        assert child.k.data_ptr() != parent.k.data_ptr()
        assert (child.max_len, parent.max_len) == (16, 32)  # its own bucket
    _greedy(ex, "child", [99] * 12, 5, start=PREFIX,
            logits=np.zeros(tcfg.TINY.vocab_size, np.float32))
    after = dict(ex.export_sessions(only="parent"))["parent"]
    assert torch.equal(after["k"], before["k"]) and torch.equal(after["v"], before["v"])


def test_a_paged_fork_shares_full_blocks_and_copies_the_tail(params):
    ex = _port(params, "batched_paged")
    _step(ex, "parent", PROMPT, 0)  # 13 slots: blocks of 4 -> 3 full + 1 partial
    pool = ex.pool
    plane = ex._sessions["parent"]
    refs = [int(pool.refcount[b]) for b in pool.table[plane, :3]]
    assert ex.fork_session("child", "parent", PREFIX)  # 2 full + a tail of 1
    lane = ex._sessions["child"]
    assert list(pool.table[lane, :2]) == list(pool.table[plane, :2])
    assert pool.table[lane, 2] != pool.table[plane, 2]
    assert [int(pool.refcount[b]) for b in pool.table[plane, :3]] == [
        refs[0] + 1, refs[1] + 1, refs[2] + 1]  # the third: the queued copy's source
    assert ex.block_stats()["cow_shared"] >= 2
    assert pool._pending_copies  # the tail's copy lands with the next dispatch
    _step(ex, "child", PROMPT[PREFIX:], PREFIX)
    assert not pool._pending_copies


def test_block_pool_fork_lane_exhaustion_claims_nothing():
    pool = BlockPool(tcfg.TINY, 2, lanes=3, max_len=16, block_size=4, num_blocks=4)
    pool.ensure(0, 6)  # 2 of the 3 usable blocks
    pool.ensure(2, 4)  # the last one
    before = pool.refcount.copy()
    with pytest.raises(BufferError):
        pool.fork_lane(0, 1, 6)  # a full block and a tail: no block for the tail
    assert pool.lane_blocks[1] == 0 and (pool.refcount == before).all()
    pool.release_lane(2)
    pool.fork_lane(0, 1, 6)
    full, tail = int(pool.table[0, 0]), int(pool.table[1, 1])
    assert int(pool.table[1, 0]) == full and pool.refcount[full] == 2
    assert pool._pending_copies == [(int(pool.table[0, 1]), tail)]
    with pytest.raises(ValueError):
        pool.fork_lane(0, 1, 4)  # not empty
    pool.drain_copies()
    pool.fork_lane(0, 2, 4)  # one full block, no tail
    assert pool.refcount[full] == 3 and not pool._pending_copies
    assert pool.cow_shared == 1


# -- the codec -----------------------------------------------------------------------------


def _payload(n=5, t=6, layers=4, dtype=torch.float32):
    shape = (layers, 1, t, tcfg.TINY.num_kv_heads, tcfg.TINY.head_dim)
    return handoff.encode(torch.randn(shape).to(dtype), torch.randn(shape).to(dtype), n)


@pytest.mark.parametrize("case", [
    "missing_k", "missing_length", "ndim", "v_shape", "layers", "batch", "heads", "head_dim",
    "short", "zero", "past_max_len", "kv_dtype_not_uint8", "kv_dtype_unknown",
    "kv_dtype_name_attack", "integer_kv", "ring_fields", "length_garbage",
])
def test_decode_fails_closed(case):
    p = _payload()
    if case == "missing_k":
        del p["k"]
    elif case == "missing_length":
        del p["length"]
    elif case == "ndim":
        p["k"] = p["k"][0]
        p["v"] = p["v"][0]
    elif case == "v_shape":
        p["v"] = p["v"][:, :, :5]
    elif case == "layers":
        p["k"], p["v"] = p["k"][:3], p["v"][:3]
    elif case == "batch":
        p["k"], p["v"] = torch.cat([p["k"]] * 2, 1), torch.cat([p["v"]] * 2, 1)
    elif case == "heads":
        p["k"], p["v"] = p["k"][:, :, :, :1], p["v"][:, :, :, :1]
    elif case == "head_dim":
        p["k"], p["v"] = p["k"][..., :8], p["v"][..., :8]
    elif case == "short":
        p["length"] = 7
    elif case == "zero":
        p["length"] = 0
    elif case == "past_max_len":
        p = _payload(n=5, t=6)
        return assert_none(handoff.decode(p, tcfg.TINY, 4, 4))
    elif case == "kv_dtype_not_uint8":
        p["kv_dtype"] = "float8_e4m3fn"
    elif case == "kv_dtype_unknown":
        p = _payload(dtype=torch.float8_e4m3fn)
        p["kv_dtype"] = "float8_e4m3fnuz"
    elif case == "kv_dtype_name_attack":
        p = _payload(dtype=torch.float8_e4m3fn)
        p["kv_dtype"] = "load"  # a torch attribute, never looked up
    elif case == "integer_kv":
        p["k"], p["v"] = p["k"].to(torch.int32), p["v"].to(torch.int32)
    elif case == "ring_fields":
        p["k_loc"], p["v_loc"], p["hi"] = p["k"], p["v"], 5
    elif case == "length_garbage":
        p["length"] = "five"
    assert_none(handoff.decode(p, tcfg.TINY, 4, MAX_LEN))


def assert_none(x):
    assert x is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float32"])
def test_payloads_cross_both_wires_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    shape = (4, 1, 6, tcfg.TINY.num_kv_heads, tcfg.TINY.head_dim)
    np_dt = {"bfloat16": ml_dtypes.bfloat16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
             "float32": np.float32}[dtype]
    k = rng.standard_normal(shape).astype(np_dt)
    v = rng.standard_normal(shape).astype(np_dt)
    # the reference packs, the port decodes
    env = wire.unpack(jwire.pack({"session_id": "s", "stage": 0, **jhandoff.encode(k, v, 5)}))
    dec = handoff.decode(env, tcfg.TINY, 4, MAX_LEN)
    assert dec is not None and dec["n"] == 5
    assert str(dec["k"].dtype) == f"torch.{dtype}"
    for got, want in ((dec["k"], k), (dec["v"], v)):
        assert got.contiguous().view(torch.uint8).numpy().tobytes() == want.tobytes()
    # the port packs, the reference decodes
    tk, tv = dec["k"], dec["v"]
    env = jwire.unpack(wire.pack({"session_id": "s", "stage": 0, **handoff.encode(tk, tv, 5)}))
    jdec = jhandoff.decode(env, jcfg.TINY, 4, 0, MAX_LEN, want_ring=False)
    assert jdec is not None and jdec["n"] == 5
    assert np.asarray(jdec["k"]).dtype == np.dtype(np_dt)
    assert np.asarray(jdec["k"]).tobytes() == k.tobytes()
    assert np.asarray(jdec["v"]).tobytes() == v.tobytes()


def test_fp8_sessions_round_trip_between_port_executors(params):
    cfg = dataclasses.replace(tcfg.TINY, kv_dtype="float8_e4m3fn")

    def mk():
        return Qwen3StageExecutor(cfg, WHOLE, params[2], max_len=MAX_LEN, initial_kv_len=16)

    src, dst, ref = mk(), mk(), mk()
    want, _ = _greedy(ref, "s", PROMPT, 6)
    got, logits = _greedy(src, "s", PROMPT, 2)
    payload = dict(src.export_sessions())["s"]
    assert payload["kv_dtype"] == "float8_e4m3fn" and payload["k"].dtype == torch.uint8
    assert dst.import_session("s", wire.unpack(wire.pack({"session_id": "s", **payload})))
    pos = len(PROMPT) + 2
    while len(got) < 6:
        got.append(int(np.argmax(logits)))
        logits = _step(dst, "s", [got[-1]], pos)
        pos += 1
    assert got == want


def test_stage_lanes_have_no_export_or_import(params):
    ex = _port(params, "stage_paged")
    assert not hasattr(ex, "export_sessions") and not hasattr(ex, "import_session")
    assert hasattr(ex, "fork_session")
    assert not hasattr(ex, "export_session_delta")  # nor a standby replication delta
    for kind in KINDS:  # the exporting kinds: nothing for a session they do not hold
        assert _port(params, kind).export_session_delta("s", 0) is None


@pytest.mark.parametrize("kind", KINDS)
def test_session_lengths_match_the_reference(params, kind):
    jex, tex = _jax(params, kind), _port(params, kind)
    for ex in (jex, tex):
        assert ex.session_lengths() == {}
        _greedy(ex, "s", PROMPT, 3)
        _step(ex, "other", [5, 6], 0)
    assert tex.session_lengths() == jex.session_lengths() == {"s": len(PROMPT) + 3, "other": 2}
    tex.end_session("other")
    assert tex.session_lengths() == {"s": len(PROMPT) + 3}
