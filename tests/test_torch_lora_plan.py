"""lora_plan, the host's launch plan for the fused LoRA lane delta
(ops/lora.py): properties over the batch, rows, widths, rank and dtypes,
checked with hypothesis; and the cluster's split of the shrink and of the
output columns, emulated in plain torch from the plan, against
fused_lane_delta_reference. Imports no JAX."""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu_torch.ops import lora as L

torch.set_num_threads(2)

MAX_SMEM = 227 * 1024  # kMaxSmem in csrc/lora_delta.cu: an H100 block's shared memory


@st.composite
def calls(draw):
    """(b, s, din, dout, r, x_dtype, w_dtype)."""
    b = draw(st.integers(1, 16))
    s = draw(st.one_of(st.just(1), st.integers(1, 40), st.integers(1, 2000)))
    din = draw(st.one_of(st.sampled_from([16, 40, 1000, 1024, 2048, 3072, 4096]),
                         st.integers(1, 8192)))
    dout = draw(st.one_of(st.sampled_from([24, 333, 1024, 2048, 3072]), st.integers(1, 8192)))
    r = draw(st.integers(1, L.MAX_KERNEL_RANK))
    dts = st.sampled_from([torch.bfloat16, torch.float32])
    return b, s, din, dout, r, draw(dts), draw(dts)


@settings(max_examples=400, deadline=None)
@given(calls())
def test_ranks_divide_k_as_the_kernel_needs(call):
    """A power-of-two cluster up to 8 whose every rank gets a non-empty K
    range, K per rank a multiple of 16 when split (16-byte loads, mma K
    steps), chunks that tile a rank's range, columns per rank a multiple of
    8 that cover the output."""
    b, s, din, dout, r, xd, wd = call
    p = L.lora_plan(*call)
    assert p.cluster in (1, 2, 4, 8)
    assert (p.cluster - 1) * p.k_per_rank < din <= p.cluster * p.k_per_rank
    if p.cluster > 1:
        assert p.k_per_rank % 16 == 0
    else:
        assert p.k_per_rank == din
    assert 1 <= p.k_chunk <= p.k_per_rank
    assert p.k_chunk == p.k_per_rank or p.k_chunk % 16 == 0
    assert p.cols_per_rank % 8 == 0 and p.cols_per_rank * p.cluster >= dout
    assert p.cols_per_rank < dout + 8 * p.cluster  # no rank past what rounding needs
    assert p.r_pad % 8 == 0 and r <= p.r_pad < r + 8


@settings(max_examples=400, deadline=None)
@given(calls())
def test_grid_and_shared_memory_limits(call):
    """Row tiles within grid.y, every shared-memory part a multiple of 16
    bytes (cp.async lands aligned), the whole within an H100 block's."""
    b, s, din, dout, r, xd, wd = call
    p = L.lora_plan(*call)
    assert p.rows == (1 if s == 1 else L.ROW_TILE)
    assert p.row_tiles == -(-s // p.rows) <= 65535 and b <= 65535
    sx, sw = (4 if t == torch.float32 else 2 for t in (xd, wd))
    parts = L.smem_parts(p.route, p.rows, p.k_chunk, p.r_pad, r, p.cluster, sx, sw,
                         p.cols_per_rank if p.b_stage else 0)
    assert all(n % 16 == 0 for n in parts), parts
    assert sum(parts) == p.smem_bytes <= MAX_SMEM
    if p.b_stage:
        assert p.smem_bytes <= L.SMEM_BUDGET


@settings(max_examples=400, deadline=None)
@given(calls())
def test_f32_never_takes_the_tensor_cores(call):
    b, s, din, dout, r, xd, wd = call
    p = L.lora_plan(*call)
    if torch.float32 in (xd, wd):
        assert p.route == "simt"  # no TF32: xa stays f32 end to end
    assert p.route == ("mma" if xd == wd == torch.bfloat16 and s >= L.MMA_MIN_ROWS
                       and din % 16 == 0 else "simt")
    if p.route == "mma":
        assert p.rows == L.ROW_TILE and p.k_per_rank % 16 == 0 and p.k_chunk % 16 == 0


@settings(max_examples=200, deadline=None)
@given(calls())
def test_plan_is_a_pure_function_of_the_shapes(call):
    first = L.lora_plan(*call)
    L.lora_plan.cache_clear()
    assert L.lora_plan(*call) == first == L.lora_plan(*call)


def test_plans_of_the_main_path():
    """Qwen3-0.6B's projections at the lanes' decode and prefill: K split
    over 8 ranks, 1-row tiles at decode, the tensor cores at prefill, B
    staged in shared memory."""
    bf = torch.bfloat16
    p = L.lora_plan(8, 1, 1024, 3072, 16, bf, bf)
    assert (p.route, p.rows, p.cluster, p.k_per_rank, p.k_chunk, p.cols_per_rank,
            p.b_stage) == ("simt", 1, 8, 128, 128, 384, True)
    p = L.lora_plan(1, 256, 3072, 1024, 32, bf, bf)
    assert (p.route, p.rows, p.row_tiles, p.cluster, p.k_per_rank, p.b_stage) == (
        "mma", 16, 16, 8, 384, True)
    assert L.lora_plan(1, 256, 1024, 3072, 16, torch.float32, bf).route == "simt"


# -- the cluster's split, emulated ------------------------------------------------


def _emulate(x, a_pool, b_pool, scale_pool, ids, layer, plan):
    """What the kernel computes, written from the plan: per lane and row
    tile, each rank's partial x[:, K_c] @ A[K_c] in chunks of k_chunk, the
    partials added in rank order, then each rank's columns expanded from
    the sum and scaled; base-slot lanes zero."""
    bsz, s, din = x.shape
    dout = b_pool.shape[-1]
    out = torch.zeros(bsz, s, dout)
    for lane in range(bsz):
        slot = int(ids[lane])
        if slot == 0:
            continue
        a, bm = a_pool[slot, layer].float(), b_pool[slot, layer].float()
        for t in range(plan.row_tiles):
            rows = x[lane, t * plan.rows:(t + 1) * plan.rows].float()
            xa = 0.0
            for c in range(plan.cluster):
                lo, hi = c * plan.k_per_rank, min((c + 1) * plan.k_per_rank, din)
                part = 0.0
                for kb in range(lo, hi, plan.k_chunk):
                    ke = min(kb + plan.k_chunk, hi)
                    part = part + rows[:, kb:ke] @ a[kb:ke]
                xa = xa + part
            for c in range(plan.cluster):
                c0, c1 = c * plan.cols_per_rank, min((c + 1) * plan.cols_per_rank, dout)
                out[lane, t * plan.rows:(t + 1) * plan.rows, c0:c1] = (
                    (xa @ bm[:, c0:c1]) * scale_pool[slot].float())
    return out


@pytest.mark.parametrize("b,s,din,dout,r", [
    (4, 1, 1024, 3072, 16),   # decode: 8 ranks, 1-row tiles
    (1, 37, 1000, 333, 7),    # 4 ranks, a ragged row tile and column share
    (2, 20, 3072, 1024, 128),  # f32: K walked in chunks
    (3, 5, 40, 24, 3),        # one rank
])
def test_cluster_split_emulation_matches_the_plain_version(b, s, din, dout, r):
    """f32: the split only reorders f32 sums (1e-5 of the output's scale)."""
    g = torch.Generator().manual_seed(b + s + r)
    a = torch.randn(3, 2, din, r, generator=g) * 0.05
    bm = torch.randn(3, 2, r, dout, generator=g) * 0.05
    a[0] = bm[0] = 0.0
    x = torch.randn(b, s, din, generator=g)
    scale = torch.tensor([0.0, 2.0, 0.5])
    ids = torch.tensor([(i % 3) for i in range(1, b + 1)], dtype=torch.int32)
    plan = L.lora_plan(b, s, din, dout, r, torch.float32, torch.float32)
    if din == 3072:
        assert plan.k_chunk < plan.k_per_rank
    got = _emulate(x, a, bm, scale, ids, 1, plan)
    want = L.fused_lane_delta_reference(x, a, bm, scale, ids, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
