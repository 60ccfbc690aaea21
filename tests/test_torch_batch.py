"""The port's continuous-batching engine (inferd_tpu_torch/core/batch.py)
against the JAX package's BatchedEngine on the same TINY weights (every
weight but the norms 10x its init, so greedy streams vary), and its own
invariants.

Greedy streams are token-exact against the JAX engine's; prefill logits
within f32 atol 1e-4 (tests/test_torch_model.py's limit). Sampled streams
follow the port's key (core.sampling, not threefry): held to the port's
solo Engine with seed + index, and chunk 4 to chunk 1. A paged window
(models/qwen3.decode_k over a PagedKVCache) gives the tokens of K single
paged steps and of the dense window, across a block boundary and from a
block shared by copy-on-write."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core import batch as jbatch
from inferd_tpu.models import qwen3 as jq
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core import batch as tbatch
from inferd_tpu_torch.core import generate as tgen
from inferd_tpu_torch.core.cache import BlockPool, PagedKVCache, sync_paged
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq

torch.set_num_threads(2)

ATOL = 1e-4
PROMPTS = [[3, 7, 11], [2, 5, 13, 17, 19], [23, 29], [31, 37, 41, 43, 47, 53, 59],
           [61, 67, 71, 3]]
GREEDY_J = jcfg.SamplingConfig(temperature=0.0)
GREEDY_T = tcfg.SamplingConfig(temperature=0.0)
SAMPLED_T = tcfg.SamplingConfig(temperature=0.9, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def tiny():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


@pytest.fixture(scope="module")
def jax_greedy(tiny):
    eng = jbatch.BatchedEngine(jcfg.TINY, tiny[0], lanes=2, max_len=64, sampling_cfg=GREEDY_J)
    return eng.generate_all(PROMPTS, max_new_tokens=10, seed=0)


def _engine(tiny, sampling=GREEDY_T, **kw):
    kw = dict(dict(lanes=2, max_len=64), **kw)
    return tbatch.BatchedEngine(tcfg.TINY, tiny[1], sampling_cfg=sampling, **kw)


@pytest.mark.parametrize("chunk", [1, 4])
def test_generate_all_greedy_equals_jax(tiny, jax_greedy, chunk):
    """More prompts than lanes: freed lanes refill, every stream equals the
    JAX engine's, and every lane comes back."""
    eng = _engine(tiny)
    got = eng.generate_all(PROMPTS, max_new_tokens=10, seed=0, chunk=chunk)
    assert got == jax_greedy
    assert all(len(g) == 10 for g in got) and any(len(set(g)) > 2 for g in got)
    assert sorted(eng.free) == [0, 1] and eng.lengths == [0, 0]


def test_prefill_logits_equal_jax(tiny):
    jp, tp = tiny
    jeng = jbatch.BatchedEngine(jcfg.TINY, jp, lanes=2, max_len=64)
    eng = _engine(tiny)
    p = PROMPTS[3]
    padded = p + [0] * (16 - len(p))
    _, jl = jeng._prefill_lane_logits(jp, jeng.cache, jnp.asarray([padded], jnp.int32),
                                      jnp.int32(1), jnp.int32(0), jnp.int32(len(p)))
    tl = eng._prefill_lane_logits(torch.tensor([padded]), 1, 0, len(p))
    assert tuple(tl.shape) == (1, tcfg.TINY.vocab_size)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_eos_frees_lane_and_max_len_boundary(tiny):
    """An eos ends its stream (the solo engine's cut) and frees the lane, at
    chunk 1 and 8; at a short max_len the lanes release where the per-step
    loop releases them, and every chunk gives the same streams."""
    solo = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=GREEDY_T)
    free = solo.generate(PROMPTS[0], max_new_tokens=12)
    eos = free[4]
    want = [solo.generate(p, max_new_tokens=12, eos_token_id=eos) for p in PROMPTS]
    for chunk in (1, 8):
        eng = _engine(tiny)
        got = eng.generate_all(PROMPTS, max_new_tokens=12, eos_token_id=eos, chunk=chunk)
        assert got == want and got[0][-1] == eos and len(got[0]) <= 5
        assert sorted(eng.free) == [0, 1]
    short = [_engine(tiny, max_len=16).generate_all(PROMPTS, max_new_tokens=40, chunk=c)
             for c in (1, 8)]
    assert short[0] == short[1]
    assert [len(s) for s in short[0]] == [16 - len(p) for p in PROMPTS]


def test_admit_capacity_guard(tiny):
    eng = _engine(tiny, lanes=1)
    eng.admit([1, 2, 3])
    with pytest.raises(RuntimeError, match="free lanes"):
        eng.admit([4, 5])
    with pytest.raises(BufferError):
        _engine(tiny, lanes=1, max_len=8).admit(list(range(8)))
    paged = _engine(tiny, block_size=16)
    with pytest.raises(RuntimeError, match="dense-only"):
        paged.generate_all(PROMPTS, 4)


@pytest.mark.parametrize("sampling", [GREEDY_T, SAMPLED_T], ids=["greedy", "sampled"])
def test_chunk_4_equals_chunk_1_and_solo_engine(tiny, sampling):
    """Lanes never interact numerically: every sequence equals the solo
    Engine's with seed + index, at chunk 1 and 4, with the logprob sinks
    the solo engine's too."""
    eng = _engine(tiny, sampling=sampling, lanes=3)
    got = {c: eng.generate_all(PROMPTS, max_new_tokens=10, seed=5, chunk=c) for c in (1, 4)}
    assert got[1] == got[4]
    solo = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=sampling)
    for i, p in enumerate(PROMPTS):
        assert got[1][i] == solo.generate(p, max_new_tokens=10, seed=5 + i), i
    lps, tops = [], []
    assert eng.generate_all(PROMPTS[:2], max_new_tokens=6, seed=5, chunk=4, logprob_sink=lps,
                            top_n=2, top_sink=tops) == [g[:6] for g in got[1][:2]]
    want_lp, want_top = [], []
    solo.generate(PROMPTS[1], max_new_tokens=6, seed=6, logprob_sink=want_lp, top_n=2,
                  top_sink=want_top)
    np.testing.assert_allclose(lps[1], want_lp, rtol=0, atol=ATOL)
    assert [t[0] for t in tops[1]] == [t[0] for t in want_top]


# -- paged windows (models/qwen3.decode_k over a PagedKVCache) ---------------------


def _paged_lanes(tp, prompts, bs=8, share=False):
    """A 2-lane BlockPool with each prompt prefilled into its lane, and the
    same prompts in a dense [L, 2, 64] slab: (pool, dense cache). With
    `share`, lane 1 maps lane 0's full blocks read-only (the prefix
    index), as a session sharing its prefix does."""
    from inferd_tpu_torch.core import prefix as prefixlib
    from inferd_tpu_torch.core.cache import KVCache

    cfg = tcfg.TINY
    pool = BlockPool(cfg, cfg.num_layers, 2, 64, block_size=bs)
    dense = KVCache.create(cfg, cfg.num_layers, 2, 64)
    for lane, p in enumerate(prompts):
        start = 0
        if share and lane == 1:
            start = pool.map_prefix(1, prefixlib.block_keys(p, bs)[:(len(p) - 1) // bs])
        pool.ensure(lane, len(p))
        row = pool.table[lane:lane + 1, :pool.blocks_for(len(p))]
        toks = torch.tensor([p[start:]])
        tbatch.lane_prefill(tp, cfg, pool.cache, toks, lane, start, len(p) - start, first=True,
                            last=True, table_row=row)
        tbatch.lane_prefill(tp, cfg, dense, torch.tensor([p]), lane, 0, len(p), first=True,
                            last=True)
        if share and lane == 0:
            pool.register_prefix(0, prefixlib.block_keys(p, bs))
    return pool, dense


def _paged(pool):
    cache, table = sync_paged(pool, pool.cache, threading.Lock())
    return PagedKVCache(k=cache.k, v=cache.v, table=table)


@pytest.mark.parametrize("sampling", [GREEDY_T, SAMPLED_T], ids=["greedy", "sampled"])
def test_paged_window_equals_single_steps_and_dense(tiny, sampling):
    """Lanes at fills 6 and 13 (blocks of 8), a window of 6: lane 0 crosses
    into its second block and lane 1 into its third; lane 1's eos freezes it
    mid-window and its frozen steps write to the scratch block. Tokens,
    n_new and keys equal 6 chained one-step windows and the dense window's,
    and one step's logits the dense step's."""
    _, tp = tiny
    s = sampling
    prompts = [PROMPTS[3][:6], (PROMPTS[1] + PROMPTS[3] + [5])[:13]]
    lens, last, k = [6, 13], [prompts[0][-1], prompts[1][-1]], 6
    keys0 = np.stack([np.asarray([0, 3], np.uint32), np.asarray([0, 9], np.uint32)])
    args = dict(temperature=s.temperature, top_k=s.top_k, top_p=s.top_p, min_p=s.min_p)
    pool, dense = _paged_lanes(tp, prompts)
    for lane in range(2):
        pool.ensure(lane, lens[lane] + k)
    _, free, _, _, _, _, _ = tq.decode_k(tp, tcfg.TINY, last, _paged(pool), lens, [True, True],
                                         keys0, k, **args)
    eos = [-1, int(free[2, 1])]
    pool, dense = _paged_lanes(tp, prompts)
    for lane in range(2):
        pool.ensure(lane, lens[lane] + k)
    _, seq, n_new, keys, _, _, _ = tq.decode_k(tp, tcfg.TINY, last, _paged(pool), lens,
                                               [True, True], keys0, k, eos=eos, **args)
    assert int(n_new[0]) == k and int(n_new[1]) < k
    _, dseq, dn, dkeys, _, _, _ = tq.decode_k(tp, tcfg.TINY, last, dense, lens, [True, True],
                                              keys0, k, eos=eos, kv_bound=64, **args)
    assert seq.tolist() == dseq.tolist() and n_new.tolist() == dn.tolist()
    np.testing.assert_array_equal(keys, dkeys)
    # the same window as k one-step windows, the host chaining fills and keys
    pool, _ = _paged_lanes(tp, prompts)
    for lane in range(2):
        pool.ensure(lane, lens[lane] + k)
    tok, fill, act, kk, steps = np.asarray(last), np.asarray(lens), np.ones(2, bool), keys0, []
    for _ in range(k):
        _, sq, nn, kk, _, _, _ = tq.decode_k(tp, tcfg.TINY, tok, _paged(pool), fill, act, kk, 1,
                                             eos=eos, **args)
        tok = sq[0].numpy()
        steps.append(tok.tolist())
        fill = fill + nn.numpy()
        act = act & ~((np.asarray(eos) >= 0) & (tok == np.asarray(eos))) & (nn.numpy() > 0)
    assert steps == seq.tolist() and (fill - lens).tolist() == n_new.tolist()
    # a paged step's logits are the dense step's
    pool, dense = _paged_lanes(tp, prompts)
    for lane in range(2):
        pool.ensure(lane, lens[lane] + 1)
    paged = _paged(pool)
    xs = np.asarray(last, np.int64).reshape(2, 1)
    got = tbatch.lane_step(None, tp, tcfg.TINY, pool.cache, xs, np.asarray(lens), first=True,
                           last=True, active=np.ones(2, bool), table=paged.table)
    want = tbatch.lane_step(None, tp, tcfg.TINY, dense, xs, np.asarray(lens), first=True,
                            last=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_paged_window_from_a_shared_block(tiny):
    """Lane 1 maps lane 0's first block; both roll back into it (a replay at
    fill 5) after make_writable split it: the window gives the dense
    window's tokens, and lane 0's own copy of the block (the prefix
    index's) is left as it was."""
    _, tp = tiny
    p = (PROMPTS[3] + PROMPTS[1])[:12]
    pool, dense = _paged_lanes(tp, [p, p], share=True)
    shared = int(pool.table[1, 0])
    assert shared == int(pool.table[0, 0]) and pool.refcount[shared] == 3
    before = pool.cache.k[:, shared].clone()
    k, lens = 4, [12, 5]
    pool.ensure(0, lens[0] + k)
    pool.make_writable(1, lens[1])
    assert int(pool.table[1, 0]) != shared and pool.cow_splits == 1
    last = [p[-1], p[lens[1]]]
    paged = _paged(pool)  # applies the queued copy
    _, seq, _, _, _, _, _ = tq.decode_k(tp, tcfg.TINY, last, paged, lens, [True, True],
                                        np.zeros((2, 2), np.uint32), k)
    _, dseq, _, _, _, _, _ = tq.decode_k(tp, tcfg.TINY, last, dense, lens, [True, True],
                                         np.zeros((2, 2), np.uint32), k, kv_bound=64)
    assert seq.tolist() == dseq.tolist()
    assert torch.equal(pool.cache.k[:, shared], before)


def test_decode_step_equals_one_step_window(tiny):
    """`decode` (one step, keys[i] lane i's subkey) gives the tokens of a
    one-step `decode_chunk` whose keys split to those subkeys, and both
    advance only the active lanes."""
    from inferd_tpu_torch.core import sampling as samplib

    engines = [_engine(tiny, sampling=SAMPLED_T) for _ in range(2)]
    for eng in engines:
        for p in PROMPTS[:2]:
            eng.admit(p)
    keys = np.stack([samplib.prng_key(3), samplib.prng_key(4)])
    subs = samplib.split_keys(keys)[1]
    toks, active = [5, 9], [True, False]
    one = engines[0].decode(toks, active, subs)
    seq, _ = engines[1].decode_chunk(toks, active, 1, keys)
    assert one.tolist()[0] == seq[0].tolist()[0] and one[1] == 9
    # lanes are claimed from the top: PROMPTS[0] sits in lane 1, PROMPTS[1] in lane 0
    assert engines[0].lengths == engines[1].lengths == [len(PROMPTS[1]) + 1, len(PROMPTS[0])]
