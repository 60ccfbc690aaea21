# jaxlint: file-disable=J003 -- test code: the loops read each step's logits to ASSERT parity; they are verification loops, not serving hot paths
"""Paged KV in the port against the JAX package: the chained block keys,
the block pool's host state, the block-table gather, the plain paged decode
attention (against the Pallas kernel in interpret mode and against the XLA
gather path), and a cached forward over a paged cache (prefill, then
co-batched decode steps at ragged lengths with a write mask).

Tolerances: f32 attention atol 1e-5 and logits atol 1e-4 (summation order);
bf16 by chip_smoke's per-row rule (worst output row's max |diff| over that
row's RMS, limit 0.05): the two packages round p to bf16 at the same point
but take their sums in another order. The reference's own paged-vs-dense
tests assert bitwise equality and fail on this tree, so nothing here is
held bitwise to it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, row_rel_err
from inferd_tpu import config as jcfg
from inferd_tpu.core import cache as jcache
from inferd_tpu.core import prefix as jprefix
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import attention as jatt
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core import cache as tcache
from inferd_tpu_torch.core import prefix as tprefix
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# -- block keys ------------------------------------------------------------------


@pytest.mark.parametrize("ids,bs,kw", [
    (list(range(40)), 16, {}),
    (list(range(40)) + [99], 16, {}),
    ([7] + list(range(1, 40)), 16, {}),
    ([3, 2, 1], 16, {}),
    ([-5, 2 ** 40, 151935] * 30, 32, {"n_blocks": 1}),
    (list(range(64)), 8, {"salt": "tenant0"}),
])
def test_block_keys_bytes_equal_reference(ids, bs, kw):
    got = tprefix.block_keys(ids, bs, **kw)
    assert got == jprefix.block_keys(ids, bs, **kw)
    assert [tprefix.digest_key(k) for k in got] == [jprefix.digest_key(k) for k in got]
    assert tprefix.normalize_ids(ids) == jprefix.normalize_ids(ids)


# -- the block pool: the same calls, the same host state -------------------------


def _pools(**kw):
    kw.setdefault("block_size", 16)
    return (jcache.BlockPool(jcfg.TINY, jcfg.TINY.num_layers, **kw),
            tcache.BlockPool(tcfg.TINY, tcfg.TINY.num_layers, **kw))


def _same_state(jp, tp):
    assert np.array_equal(jp.table, tp.table)
    assert np.array_equal(jp.refcount, tp.refcount)
    assert jp._free == tp._free
    assert jp.lane_blocks == tp.lane_blocks and jp.lane_shared == tp.lane_shared
    assert list(jp._index) == list(tp._index)
    assert [(e.block, e.pinned) for e in jp._index.values()] == [
        (e.block, e.pinned) for e in tp._index.values()]
    assert jp.block_stats() == tp.block_stats()


def _both(pools, name, *args, **kw):
    """Call `name` on both pools; results (or exception types) must agree
    and the host state must be identical afterwards."""
    outs = []
    for p in pools:
        try:
            outs.append(getattr(p, name)(*args, **kw))
        except Exception as e:  # compared by type below
            outs.append(e)
    if isinstance(outs[0], Exception):
        assert type(outs[1]) is type(outs[0]), outs
        assert str(outs[1]) == str(outs[0])
    else:
        assert outs[0] == outs[1]
    _same_state(*pools)
    return outs[1]


def test_pool_alloc_release_refcount_and_exhaustion_identity():
    pools = _pools(lanes=2, max_len=64)
    _both(pools, "ensure", 0, 40, owner="session a, lane 0")
    assert pools[1].lane_blocks[0] == 3 and pools[1].blocks_used == 3
    _both(pools, "release_lane", 0)
    small = _pools(lanes=2, max_len=64, num_blocks=3)  # scratch + 2
    _both(small, "ensure", 0, 32, owner="session a, lane 0")
    err = _both(small, "ensure", 1, 32, owner="session b, lane 1")
    assert isinstance(err, BufferError) and "session b, lane 1" in str(err)
    err = _both(small, "ensure", 1, 80, owner="x")  # past the table
    assert isinstance(err, BufferError)


def test_pool_prefix_index_map_register_evict():
    pools = _pools(lanes=2, max_len=64, num_blocks=5)
    keys = tprefix.block_keys(list(range(32)), 16)
    _both(pools, "ensure", 0, 32, owner="a")
    assert _both(pools, "register_prefix", 0, keys) == 2
    _both(pools, "release_lane", 0)
    assert pools[1].blocks_used == 2  # the index's references keep them
    assert _both(pools, "map_prefix", 1, keys) == 32
    assert pools[1].lane_shared[1] == 2 and pools[1].cow_shared == 2
    _both(pools, "register_prefix", 1, keys)  # touched, not duplicated
    _both(pools, "release_lane", 1)
    _both(pools, "ensure", 0, 64, owner="a")  # needs all 4 usable blocks
    assert pools[1].prefix_evictions == 2 and pools[1].blocks_used == 4


def test_pool_pinned_entries_never_evicted():
    pools = _pools(lanes=1, max_len=64, num_blocks=4)
    keys = tprefix.block_keys(list(range(16)), 16)
    _both(pools, "ensure", 0, 16, owner="a")
    _both(pools, "register_prefix", 0, keys)
    assert _both(pools, "pin", keys) == 1
    _both(pools, "release_lane", 0)
    assert isinstance(_both(pools, "ensure", 0, 64, owner="session x, lane 0"), BufferError)
    _both(pools, "release_lane", 0)
    _both(pools, "unpin", keys)
    _both(pools, "ensure", 0, 48, owner="a")
    assert pools[1].pins_resident == 0


def test_pool_cow_split_queues_copy_and_holds_source():
    pools = _pools(lanes=2, max_len=64)
    keys = tprefix.block_keys(list(range(32)), 16)
    _both(pools, "ensure", 0, 32, owner="a")
    _both(pools, "register_prefix", 0, keys)
    _both(pools, "release_lane", 0)
    _both(pools, "map_prefix", 1, keys)
    _both(pools, "make_writable", 1, 20, owner="b")  # splits chain block 1 only
    assert pools[1].cow_splits == 1 and pools[1].lane_shared[1] == 1
    src = pools[1]._pending_copies[0][0]
    assert pools[1].refcount[src] == 2  # the index's + the queue's own reference
    pairs = _both(pools, "drain_copies")
    assert len(pairs) == 1 and pools[1].refcount[src] == 1
    assert _both(pools, "chain_clamp") == 2


def test_pool_rejects_sliding_window_models():
    for mod, cfg in ((jcache, jcfg.TINY_GEMMA2), (tcache, tcfg.TINY_GEMMA2)):
        with pytest.raises(ValueError, match="uniform-layout"):
            mod.BlockPool(cfg, 4, lanes=1, max_len=64, block_size=16)


def test_sync_paged_applies_copies_and_stamps_the_clamped_table():
    import threading

    pool = tcache.BlockPool(tcfg.TINY, 2, lanes=2, max_len=64, block_size=16)
    pool.ensure(0, 20, owner="a")
    pool.cache.k[:, int(pool.table[0, 1])] = 7.0
    pool.refcount[int(pool.table[0, 1])] += 1  # a second holder: the next write must split
    pool.make_writable(0, 16, owner="a")
    cache, table = tcache.sync_paged(pool, pool.cache, threading.Lock())
    assert table.shape == (2, 2) and torch.equal(table, torch.from_numpy(pool.table[:, :2]))
    pool.table[0, 0] = 99  # a snapshot: the host mirror moves on without it
    assert int(table[0, 0]) != 99
    assert bool((cache.k[:, int(pool.table[0, 1])] == 7.0).all())


def test_lane_slice_is_a_view_of_the_slab():
    c = tcache.KVCache.create(tcfg.TINY, 2, 3, 8)
    lc = tcache.lane_slice(c, 1)
    lc.k[:, :, 2] = 5.0
    assert bool((c.k[:, 1, 2] == 5.0).all()) and c.k[:, [0, 2]].abs().max() == 0
    assert tcache.lane_write(c, 1, lc) is c
    with pytest.raises(ValueError):
        tcache.lane_write(c, 2, lc)


# -- ops: gather and paged decode attention --------------------------------------


def _paged_case(rng, b=2, nkv=2, g=2, d=16, bs=8, mb=4):
    """Shuffled chains over blocks 1..NB-1 (block 0 = scratch)."""
    nb = 1 + b * mb
    pool_k = rng.randn(nb, bs, nkv, d).astype(np.float32)
    pool_v = rng.randn(nb, bs, nkv, d).astype(np.float32)
    table = (rng.permutation(nb - 1)[: b * mb] + 1).reshape(b, mb).astype(np.int32)
    q = rng.randn(b, 1, nkv * g, d).astype(np.float32)
    return pool_k, pool_v, table, q


def test_gather_block_kv_exact():
    pool_k, pool_v, table, _ = _paged_case(np.random.RandomState(0))
    jk, jv = jatt.gather_block_kv(jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(table))
    tk, tv = tatt.gather_block_kv(_t(pool_k), _t(pool_v), _t(table))
    assert np.array_equal(tk.numpy(), np.asarray(jk)) and np.array_equal(tv.numpy(), np.asarray(jv))


def _jax_both(q, pk, pv, table, qpos, valid, **kw):
    """(Pallas kernel in interpret mode, XLA gather + decode_gqa) outputs."""
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv))
    kern = jatt.paged_decode_gqa(*args, jnp.asarray(table), jnp.asarray(qpos), jnp.asarray(valid),
                                 interpret=True, **kw)
    kd, vd = jatt.gather_block_kv(args[1], args[2], jnp.asarray(table))
    xla = jatt.decode_gqa(args[0], kd, vd, jnp.asarray(qpos), jnp.asarray(valid), **kw)
    return np.asarray(kern, np.float32), np.asarray(xla, np.float32)


@pytest.mark.parametrize("pool", ["float32", "float8_e4m3fn"])
def test_plain_paged_decode_matches_reference_f32_queries(pool):
    """f32 queries over shuffled chains with ragged per-lane lengths, f32
    and fp8 pools (upcast at the read)."""
    rng = np.random.RandomState(0)
    pool_k, pool_v, table, q = _paged_case(rng)
    qpos, valid = np.array([[21], [30]], np.int32), np.array([22, 31], np.int32)
    jdt = getattr(jnp, pool)
    kern, xla = _jax_both(q, jnp.asarray(pool_k, jdt), jnp.asarray(pool_v, jdt), table, qpos, valid)
    tdt = getattr(torch, pool)
    got = tatt.decode_gqa(_t(q), _t(pool_k, tdt), _t(pool_v, tdt), _t(qpos), _t(valid),
                          block_table=_t(table)).numpy()
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


def test_plain_paged_decode_matches_reference_bf16():
    rng = np.random.RandomState(4)
    pool_k, pool_v, table, q = _paged_case(rng, b=3, mb=5)
    qpos, valid = np.array([[3], [39], [17]], np.int32), np.array([4, 40, 18], np.int32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: _t(a, torch.bfloat16)  # noqa: E731
    kern, xla = _jax_both(jb(q), jb(pool_k), jb(pool_v), table, qpos, valid)
    got = tatt.paged_decode_gqa(tb(q), tb(pool_k), tb(pool_v), _t(table), _t(qpos), _t(valid))
    assert got.dtype == torch.bfloat16
    for ref in (kern, xla):
        assert row_rel_err(got, torch.from_numpy(ref), 16) <= ATTN_TOL["bfloat16"]


def test_plain_paged_decode_never_scores_scratch_or_unchained_blocks():
    """Scratch block 0 and never-chained blocks hold garbage, and a lane's
    tail table entries point at scratch: no lane may see any of it. The
    garbage is finite because the plain version gathers it and multiplies
    it by p == 0 (0 * NaN would be NaN); the CUDA kernel never loads it."""
    rng = np.random.RandomState(1)
    pool_k, pool_v, table, q = _paged_case(rng, b=2, mb=4)
    table[1, 2:] = 0
    garbage = [0] + [b for b in range(pool_k.shape[0]) if b not in set(table.flatten())]
    pool_k[garbage], pool_v[garbage] = 1e6, -1e6
    qpos, valid = np.array([[21], [13]], np.int32), np.array([22, 14], np.int32)
    kern, _ = _jax_both(q, pool_k, pool_v, table, qpos, valid)
    got = tatt.paged_decode_gqa(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(qpos), _t(valid))
    assert np.isfinite(got.numpy()).all() and np.abs(got.numpy()).max() < 10
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-5)


@pytest.mark.parametrize("softcap,window,with_sinks", [
    (30.0, None, False), (0.0, 16, False), (0.0, None, True), (30.0, 16, True),
])
def test_plain_paged_decode_sinks_softcap_window(softcap, window, with_sinks):
    rng = np.random.RandomState(2)
    pool_k, pool_v, table, q = _paged_case(rng)
    sinks = rng.randn(q.shape[2]).astype(np.float32) if with_sinks else None
    qpos, valid = np.array([[25], [28]], np.int32), np.array([26, 29], np.int32)
    kern, xla = _jax_both(q, pool_k, pool_v, table, qpos, valid, softcap=softcap,
                          window=None if window is None else jnp.int32(window),
                          sinks=None if sinks is None else jnp.asarray(sinks))
    got = tatt.decode_gqa(_t(q), _t(pool_k), _t(pool_v), _t(qpos), _t(valid), softcap=softcap,
                          window=window, sinks=None if sinks is None else _t(sinks),
                          block_table=_t(table)).numpy()
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


# -- model: cached forward over a paged cache ------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


def test_forward_cached_paged_prefill_then_cobatched_decode(tiny_params):
    """A bucket-padded prefill of three lanes at ragged real lengths, then 8
    co-batched decode steps with a write mask (lane 1 sits out the odd
    steps): logits atol 1e-4 against the JAX forward over the same pool
    state, and a masked-out lane writes nothing outside the scratch block 0
    (where the device write plan sends a write that must not commit). The
    one row left out of the logits check is named: a masked-out row whose
    position lies in a chain slot with no block attends block 0, where its
    own dropped write lands (the reference drops it)."""
    jp, tp = tiny_params
    kw = dict(lanes=3, max_len=64, block_size=8)
    jpool = jcache.BlockPool(jcfg.TINY, jcfg.TINY.num_layers, **kw)
    tpool = tcache.BlockPool(tcfg.TINY, tcfg.TINY.num_layers, **kw)
    real = np.array([10, 5, 13])
    toks = np.random.default_rng(0).integers(0, 256, (3, 16)).astype(np.int32)
    for lane, n in enumerate(real):
        for p in (jpool, tpool):
            p.ensure(lane, n, owner=f"lane {lane}")
    jc = dataclasses.replace(jpool.cache, table=jpool.device_table())
    tc = dataclasses.replace(tpool.cache, table=tpool.device_table())
    pos = np.broadcast_to(np.arange(16), (3, 16))
    jl, jc = jq.forward_cached(jp, jcfg.TINY, jnp.asarray(toks), jnp.asarray(pos), jc,
                               jnp.int32(0), real_end=jnp.asarray(real))
    tl, tc = tq.forward_cached(tp, tcfg.TINY, _t(toks).long(), None, tc, 0, real_end=real)
    jl = np.asarray(jl)
    for lane, n in enumerate(real):  # rows past real_end are padding
        np.testing.assert_allclose(tl[lane, :n].numpy(), jl[lane, :n], rtol=0, atol=1e-4)
    lens = real.copy()
    tok = jl[np.arange(3), lens - 1].argmax(-1)
    scratch_rows = []
    for step in range(8):
        active = np.array([True, step % 2 == 0, True])
        for lane in np.flatnonzero(active):
            for p in (jpool, tpool):
                p.ensure(lane, lens[lane] + 1, owner=f"lane {lane}")
        jc = dataclasses.replace(jc, table=jpool.device_table(jpool.chain_clamp()))
        tc = dataclasses.replace(tc, table=tpool.device_table(tpool.chain_clamp()))
        before = tc.k.clone()
        jl, jc = jq.forward_cached(
            jp, jcfg.TINY, jnp.asarray(tok[:, None], jnp.int32), jnp.asarray(lens[:, None]), jc,
            jnp.asarray(lens), real_end=jnp.asarray(lens + 1), write_mask=jnp.asarray(active))
        tl, tc = tq.forward_cached(tp, tcfg.TINY, _t(tok[:, None]).long(), None, tc, lens,
                                   real_end=lens + 1, write_mask=active)
        jl = np.asarray(jl)
        # rows whose position's chain slot maps no block read the scratch block
        table = tc.table.numpy()
        slot = lens // 8
        scratch = np.array([slot[b] >= table.shape[1] or table[b, slot[b]] == 0
                            for b in range(3)])
        assert not (scratch & active).any()
        scratch_rows += [(step, int(b)) for b in np.flatnonzero(scratch)]
        np.testing.assert_allclose(tl.numpy()[~scratch], jl[~scratch], rtol=0, atol=1e-4)
        # outside the scratch block, the pool changed at the active lanes'
        # write slots, and only there; inside it, only at the offsets of
        # rows that did not commit
        changed = (tc.k != before).any(dim=(0, 3, 4)).nonzero().tolist()  # [(block, offset)]
        want = sorted([int(tpool.table[b, lens[b] // 8]), int(lens[b] % 8)]
                      for b in np.flatnonzero(active))
        assert sorted(c for c in changed if c[0] != 0) == want
        assert {o for blk, o in changed if blk == 0} <= {int(lens[b] % 8)
                                                         for b in np.flatnonzero(~active)}
        new_tok = jl[:, 0].argmax(-1)
        tok = np.where(active, new_tok, tok)
        lens = lens + active
    # lane 1 sits out step 5 at position 8, the first slot of an unmapped block
    assert scratch_rows == [(5, 1)]


def test_paged_write_device_gives_the_reference_pools(tiny_params):
    """One bucket-padded chunk of 8 rows on 3 lanes (blocks of 4) at ragged
    write positions, with padding past real_end and lane 1 masked out,
    through both packages' cached forward over the same pool state: every
    block but the scratch block 0 ends as the reference's scatter left it
    (f32, atol 1e-5), the reference's block 0 stays zero, and the device
    plan sends exactly the committing rows to their chain slots and every
    other row into block 0."""
    jp, tp = tiny_params
    kw = dict(lanes=3, max_len=32, block_size=4)
    jpool = jcache.BlockPool(jcfg.TINY, jcfg.TINY.num_layers, **kw)
    tpool = tcache.BlockPool(tcfg.TINY, tcfg.TINY.num_layers, **kw)
    wp, real_end = np.array([0, 4, 2]), np.array([6, 12, 10])
    mask = np.array([True, False, True])
    for lane in range(3):
        for p in (jpool, tpool):
            p.ensure(lane, int(real_end[lane]), owner=f"lane {lane}")
    jc = dataclasses.replace(jpool.cache, table=jpool.device_table())
    tc = dataclasses.replace(tpool.cache, table=tpool.device_table())
    toks = np.random.default_rng(2).integers(0, 256, (3, 8)).astype(np.int32)
    pos = wp[:, None] + np.arange(8)[None, :]
    _, jc = jq.forward_cached(jp, jcfg.TINY, jnp.asarray(toks), jnp.asarray(pos), jc,
                              jnp.asarray(wp), real_end=jnp.asarray(real_end),
                              write_mask=jnp.asarray(mask))
    _, tc = tq.forward_cached(tp, tcfg.TINY, _t(toks).long(), None, tc, wp, real_end=real_end,
                              write_mask=mask)
    for name in ("k", "v"):
        jb, tb = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        np.testing.assert_allclose(tb[:, 1:], jb[:, 1:], rtol=0, atol=1e-5)
        assert not jb[:, 0].any()
    dest = tq.paged_write_device(tc.table, 4, _t(wp), 8, _t(real_end), _t(mask)).numpy()
    commit = (pos < real_end[:, None]) & mask[:, None]
    table = tpool.table
    want = table[np.arange(3)[:, None], pos // 4] * 4 + pos % 4
    np.testing.assert_array_equal(dest[commit], want[commit])
    assert (dest[~commit] < 4).all()  # the scratch block
    assert (dest[commit] >= 4).all()


def test_paged_write_past_the_table_raises_before_dispatch(tiny_params):
    """A committing row past the table raises BufferError on the host before
    any write: from forward_cached's check on a narrowed table, and on the
    lane executor from admission (a step past max_len, a chain the pool
    cannot extend), with no dispatch and the pools untouched."""
    from inferd_tpu_torch.parallel.stages import StageSpec, extract_stage_params
    from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

    _, tp = tiny_params
    pool = tcache.BlockPool(tcfg.TINY, tcfg.TINY.num_layers, lanes=1, max_len=32, block_size=8)
    pool.ensure(0, 16)
    narrow = dataclasses.replace(pool.cache, table=pool.device_table(2))
    before = narrow.k.clone()
    with pytest.raises(BufferError, match="past the table"):
        tq.forward_cached(tp, tcfg.TINY, torch.zeros((1, 4), dtype=torch.long), None, narrow,
                          14, real_end=18)
    assert torch.equal(narrow.k, before)
    # padding past the table is not a write: only committing rows count
    tq.forward_cached(tp, tcfg.TINY, torch.zeros((1, 4), dtype=torch.long), None, narrow, 14,
                      real_end=16)

    spec = StageSpec(0, 1, 0, tcfg.TINY.num_layers - 1)
    ex = BatchedStageExecutor(tcfg.TINY, spec, extract_stage_params(tp, tcfg.TINY, spec),
                              lanes=2, max_len=32, block_size=8, kv_blocks=6)
    ex.process("a", {"tokens": [list(range(1, 32))], "start_pos": 0, "real_len": 31})
    ex.process("a", {"tokens": [[5]], "start_pos": 31, "real_len": 1})
    ex.process("b", {"tokens": [[1, 2, 3]], "start_pos": 0, "real_len": 3})
    steps, k = ex.stats()["batched_steps"], ex.cache.k.clone()
    with pytest.raises(BufferError, match="overflow"):
        ex.process("a", {"tokens": [[5]], "start_pos": 32, "real_len": 1})
    assert ex.stats()["batched_steps"] == steps and torch.equal(ex.cache.k, k)
    ex.process("b", {"tokens": [list(range(5))], "start_pos": 3, "real_len": 5})  # 8: 1 block
    k = ex.cache.k.clone()
    with pytest.raises(BufferError, match="exhausted"):  # b's second block: none left
        ex.process("b", {"tokens": [[5]], "start_pos": 8, "real_len": 1})
    assert ex.stats()["batched_steps"] == steps and torch.equal(ex.cache.k, k)
