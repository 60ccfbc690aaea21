"""paged_plan, the host's cut of each lane's block chain for the paged decode
kernels (ops/attention.py): properties over batch, kv heads, table width
and block size, checked with hypothesis; and the split-and-combine the
kernels compute, emulated in plain torch from the plan's ranges with this
file's own merge, against paged_decode_gqa_reference. Imports no JAX."""

import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import ATTN_TOL, row_rel_err
from inferd_tpu_torch.ops import attention as A

torch.set_num_threads(2)


@st.composite
def shapes(draw):
    """(b, nkv, mb, bs, dtype)."""
    b = draw(st.integers(1, 64))
    nkv = draw(st.sampled_from([1, 2, 4, 8, 16]))
    mb = draw(st.one_of(st.integers(0, 8), st.integers(0, 2048)))
    bs = draw(st.sampled_from([1, 8, 16, 32, 64, 128]))
    dtype = draw(st.sampled_from([torch.bfloat16, torch.float32]))
    return b, nkv, mb, bs, dtype


def _ranges(p, mb):
    return [range(z * p.blocks_per_split, min((z + 1) * p.blocks_per_split, mb))
            for z in range(p.splits)]


@settings(max_examples=400, deadline=None)
@given(shapes())
def test_ranges_cover_the_chain_once_with_no_empty_range_at_the_end(shape):
    b, nkv, mb, bs, dtype = shape
    p = A.paged_plan(b, nkv, mb, bs, dtype)
    covered = [j for r in _ranges(p, mb) for j in r]
    assert covered == list(range(mb))  # no gap, no overlap, in order
    assert p.splits >= 1 and p.blocks_per_split >= 1
    if mb:
        assert len(_ranges(p, mb)[-1]) > 0
    else:
        assert p.splits == 1


@settings(max_examples=400, deadline=None)
@given(shapes())
def test_grid_and_split_limits(shape):
    """At most MAX_SPLITS ranges (the kernel's kMaxSplits) and no more CTAs
    from splitting than PAGED_TARGET_CTAS; a split range holds at least
    PAGED_MIN_SPLIT_SLOTS slots; the grid's y and z fit CUDA's limits."""
    b, nkv, mb, bs, dtype = shape
    p = A.paged_plan(b, nkv, mb, bs, dtype)
    groups = b * nkv
    assert p.splits <= A.MAX_SPLITS
    assert p.splits * groups <= max(groups, A.PAGED_TARGET_CTAS)
    if p.splits > 1:
        assert p.blocks_per_split * bs >= A.PAGED_MIN_SPLIT_SLOTS
    assert nkv <= 65535 and b <= 65535


@settings(max_examples=200, deadline=None)
@given(shapes())
def test_plan_is_a_pure_function_of_the_shapes(shape):
    first = A.paged_plan(*shape)
    A.paged_plan.cache_clear()
    assert A.paged_plan(*shape) == first == A.paged_plan(*shape)


def test_plans_of_the_main_path():
    """8 lanes x 8 kv heads at the lanes' table widths: one kernel up to 8
    blocks of 32, then 2, 4 and 8 ranges of 8 blocks; one long session
    (128 blocks) in 16 ranges of 8."""
    want = {1: (1, 8), 8: (1, 8), 16: (2, 8), 32: (4, 8), 64: (8, 8)}
    for mb, (splits, bps) in want.items():
        assert A.paged_plan(8, 8, mb, 32, torch.bfloat16) == A.PagedPlan(splits, bps)
    assert A.paged_plan(1, 8, 128, 32, torch.bfloat16) == A.PagedPlan(16, 8)


# -- the split and the combine, emulated -----------------------------------------


def _split_and_combine(q, k_pool, v_pool, table, qpos, kv_len, plan, window=0, sinks=None,
                       scale=None):
    """What the split kernel and the combine compute, written from the
    plan's ranges: each (lane, kv head, range) keeps (m, l, acc) over the
    slots it attends (p rounded to q's dtype before p.v, f32 sums); an
    empty range is (-inf, 0, 0); the merge weighs each partial by exp(m_z -
    m), folds the sinks once and normalises by l, or by 1 where l == 0."""
    b, _, nq, d = q.shape
    bs, nkv = k_pool.shape[1], k_pool.shape[2]
    g = nq // nkv
    mb = table.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.zeros(b, nq, d)
    for lane in range(b):
        qp, kl = int(qpos[lane, 0]), int(kv_len[lane])
        last = min(kl, qp + 1)
        hi = min(-(-last // bs), mb) if last > 0 else 0
        lo_slot = qp - window + 1 if window > 0 else 0
        lo = min(lo_slot // bs, mb) if lo_slot > 0 else 0
        for h in range(nkv):
            parts = []
            for z in range(plan.splits):
                blo = max(lo, z * plan.blocks_per_split)
                bhi = min(hi, (z + 1) * plan.blocks_per_split)
                slots = [(j, i) for j in range(blo, bhi) for i in range(bs)
                         if j * bs + i < kl and j * bs + i <= qp
                         and (window <= 0 or j * bs + i > qp - window)]
                if not slots:
                    parts.append((torch.full((g,), -math.inf), torch.zeros(g), torch.zeros(g, d)))
                    continue
                blk = torch.tensor([int(table[lane, j]) for j, _ in slots])
                off = torch.tensor([i for _, i in slots])
                kk = k_pool[blk, off, h].float()  # [n, D]
                vv = v_pool[blk, off, h].float()
                qh = q[lane, 0, h * g:(h + 1) * g].float()  # [G, D]
                s = qh @ kk.T * sc
                m = s.amax(dim=1)
                p = torch.exp(s - m[:, None])
                acc = p.to(q.dtype).float() @ vv
                parts.append((m, p.sum(dim=1), acc))
            ms = torch.stack([m for m, _, _ in parts])  # [Z, G]
            mx = ms.amax(dim=0)
            w = torch.where(torch.isinf(ms), 0.0, torch.exp(ms - mx))
            lsum = sum(wz * lz for wz, (_, lz, _) in zip(w, parts))
            acc = sum(wz[:, None] * az for wz, (_, _, az) in zip(w, parts))
            if sinks is not None:
                sk = sinks[h * g:(h + 1) * g].float()
                mf = torch.maximum(torch.where(torch.isinf(mx), -1e30, mx), sk)
                af = torch.where(torch.isinf(mx), 0.0, torch.exp(mx - mf))
                lsum = lsum * af + torch.exp(sk - mf)
                acc = acc * af[:, None]
            out[lane, h * g:(h + 1) * g] = acc / torch.where(lsum == 0, 1.0, lsum)[:, None]
    return out.reshape(b, 1, nq * d).to(q.dtype)


def _paged_inputs(seed, kv_len, nq=8, nkv=2, d=16, bs=8):
    g = torch.Generator().manual_seed(seed)
    chains = [-(-n // bs) for n in kv_len]
    mb = 1
    while mb < max(max(chains), 1):
        mb <<= 1
    nb = sum(chains) + 2
    kp = torch.randn(nb, bs, nkv, d, generator=g)
    vp = torch.randn(nb, bs, nkv, d, generator=g)
    kp[0], vp[0] = 300.0, -300.0  # the scratch block: any read of it would show
    perm = torch.randperm(nb - 1, generator=g) + 1
    table = torch.zeros(len(kv_len), mb, dtype=torch.int32)
    used = 0
    for lane, n in enumerate(chains):
        table[lane, :n] = perm[used:used + n].to(torch.int32)
        used += n
    q = torch.randn(len(kv_len), 1, nq, d, generator=g)
    kl = torch.tensor(kv_len)
    return q, kp, vp, table, (kl - 1).clamp(min=0)[:, None], kl


@pytest.mark.parametrize("kv_len,window,sinks,splits", [
    ([300, 17, 0, 129], 0, False, 4),    # a kv_len-0 lane; short lanes' later ranges empty
    ([300, 17, 0, 129], 0, True, 4),     # sinks folded once, after the merge
    ([511, 200], 100, False, 8),         # the window floor inside a range; ranges below it empty
    ([511, 200], 100, True, 3),
    ([64], 0, False, 1),                 # one range: the kernel finishes alone
])
def test_split_and_combine_emulation_matches_the_plain_version(kv_len, window, sinks, splits):
    """f32 queries and pools: the merge only reorders f32 sums (1e-5)."""
    q, kp, vp, table, qpos, kl = _paged_inputs(3, kv_len)
    mb = table.shape[1]
    bps = -(-mb // splits)
    plan = A.PagedPlan(-(-mb // bps), bps)
    sk = torch.randn(q.shape[2], generator=torch.Generator().manual_seed(9)) if sinks else None
    got = _split_and_combine(q, kp, vp, table, qpos, kl, plan, window, sk)
    want = A.paged_decode_gqa_reference(q, kp, vp, table, qpos, kl, window=window or None,
                                        sinks=sk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not sinks:
        assert torch.equal(got[kl == 0], torch.zeros_like(got[kl == 0]))


def test_the_rules_plan_emulated_at_the_lanes_shape():
    """The rule's own cut of a 32-block table (4 ranges of 8 blocks; the
    rule's block size 32, the pools' 8 here, so the block count is the
    lanes') merges to the plain version; bf16 queries round p against each
    range's own maximum, as the kernel does, so the comparison is
    chip_smoke's bf16 row rule."""
    q, kp, vp, table, qpos, kl = _paged_inputs(5, [17, 60, 101, 230, 240, 160, 200, 250],
                                               nq=4, nkv=2, d=16, bs=8)
    plan = A.paged_plan(8, 8, table.shape[1], 32, torch.bfloat16)
    assert plan.splits > 1
    qb, kb, vb = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    got = _split_and_combine(qb, kb, vb, table, qpos, kl, plan)
    want = A.paged_decode_gqa_reference(qb, kb, vb, table, qpos, kl)
    assert row_rel_err(got, want, 16) <= ATTN_TOL["bfloat16"]
