"""flash_plan, the host's launch plan for the flash kernels
(ops/attention.py): properties over batch, lengths, heads, dtype, host or
device spans and windows, checked with hypothesis; and the wrapper's
refusals of what neither kernel takes. Imports no JAX."""

import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu_torch.ops import attention as A

torch.set_num_threads(2)

HEADS = [(16, 8), (8, 2), (16, 2), (6, 2), (4, 4), (32, 1)]


@st.composite
def calls(draw):
    """(b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start, host)."""
    b = draw(st.integers(1, 12))
    t = draw(st.integers(1, 40000))
    s = draw(st.integers(1, min(t, 600)))
    nq, nkv = draw(st.sampled_from(HEADS))
    dtype = draw(st.sampled_from([torch.bfloat16, torch.float32]))
    kv_start = draw(st.integers(0, 50))
    kv_len = draw(st.integers(0, t))
    q_start = draw(st.integers(0, kv_start + t))
    window = draw(st.one_of(st.none(), st.integers(-2, 3 * t)))
    host = draw(st.booleans())
    return b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start, host


def _plan(call):
    b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start, host = call
    if not host:  # the spans as device (here: CPU) tensors, one per batch row
        q_start, kv_len = torch.full((b,), q_start), torch.full((b,), kv_len)
    return A.flash_plan(b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start)


def _needed_slots(s, t, q_start, kv_len, window, kv_start):
    """The slots some query of the call attends, from the masking rules."""
    win = window or 0
    need = set()
    for qpos in range(q_start, q_start + s):
        lo = max(qpos - win + 1 - kv_start, 0) if win > 0 else 0
        need.update(range(lo, min(kv_len, t, qpos - kv_start + 1)))
    return need


@settings(max_examples=300, deadline=None)
@given(calls())
def test_splits_partition_the_tile_span_exactly_once(call):
    p = _plan(call)
    covered = []
    for z in range(p.splits):
        lo = p.tile_lo + z * p.tiles_per_split
        covered.extend(range(lo, min(lo + p.tiles_per_split, p.tile_hi)))
    assert covered == list(range(p.tile_lo, p.tile_hi))  # no gap, no overlap, in order
    assert p.splits >= 1 and p.tile_hi <= -(-call[2] // p.tile)


@settings(max_examples=300, deadline=None)
@given(calls())
def test_host_span_covers_what_is_attended_with_no_empty_split(call):
    b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start, _ = call
    p = _plan(call[:-1] + (True,))
    need = _needed_slots(min(s, 64), t, q_start, kv_len, window, kv_start) if s <= 64 else None
    if need is not None:
        tiles = {j // p.tile for j in need}
        assert tiles <= set(range(p.tile_lo, p.tile_hi))
        if tiles:  # the span is the attended one: first and last tile are used
            assert min(tiles) == p.tile_lo and max(tiles) == p.tile_hi - 1
    for z in range(p.splits):
        if p.tile_hi > p.tile_lo:
            assert p.tile_lo + z * p.tiles_per_split < p.tile_hi


@settings(max_examples=300, deadline=None)
@given(calls())
def test_device_span_is_the_whole_buffer(call):
    p = _plan(call[:-1] + (False,))
    assert (p.tile_lo, p.tile_hi) == (0, -(-call[2] // p.tile))


@settings(max_examples=300, deadline=None)
@given(calls(), st.integers(0, 50000))
def test_device_span_with_a_bound_covers_every_attended_slot(call, extra):
    """kv_bound (a host bound on every row's kv_len, as decode_k passes it)
    cuts a device plan to the bound's tiles and no further, and a decode
    row's device plan under the bound kv_len is the host plan: a fused
    K-step window launches what a single step launches."""
    b, s, t, nq, nkv, dtype, q_start, kv_len, window, kv_start, _ = call
    bound = kv_len + extra
    cols = torch.full((b,), q_start), torch.full((b,), kv_len)
    p = A.flash_plan(b, s, t, nq, nkv, dtype, *cols, window, kv_start, kv_bound=bound)
    assert (p.tile_lo, p.tile_hi) == (0, -(-min(t, bound) // p.tile))
    if s <= 64:
        assert {j // p.tile for j in _needed_slots(s, t, q_start, kv_len, window, kv_start)} \
            <= set(range(p.tile_lo, p.tile_hi))
    if q_start < t:  # a decode step at q_start over the filled span [0, q_start]
        host = A.flash_plan(b, 1, t, nq, nkv, dtype, q_start, q_start + 1)
        dev = A.flash_plan(b, 1, t, nq, nkv, dtype, torch.full((b,), q_start),
                           torch.full((b,), q_start + 1), kv_bound=q_start + 1)
        assert dev == host


@settings(max_examples=300, deadline=None)
@given(calls())
def test_cta_count_stays_within_the_cap(call):
    b, s, t, nq, nkv = call[:5]
    p = _plan(call)
    groups = b * nkv * p.row_tiles
    assert p.splits * groups <= max(groups, A.TARGET_CTAS[p.route]) and p.splits <= A.MAX_SPLITS
    if p.splits > 1:  # a split spans at least the route's minimum
        assert p.tiles_per_split >= A.MIN_SPLIT_TILES[p.route]


@settings(max_examples=300, deadline=None)
@given(calls())
def test_route_and_row_tiles(call):
    b, s, t, nq, nkv, dtype = call[:6]
    p = _plan(call)
    rows = s * (nq // nkv)
    if dtype == torch.float32:
        assert p.route == "split"  # never TF32
    assert p.route == ("mma" if dtype == torch.bfloat16 and rows > A.SPLIT_ROWS else "split")
    assert p.rows == (A.MMA_ROWS if p.route == "mma" else
                      max(2, min(A.SPLIT_ROWS, 1 << (rows - 1).bit_length())))
    assert p.row_tiles == math.ceil(rows / p.rows) and p.rows >= min(rows, p.rows)
    assert p.tile == (A.MMA_TILE if p.route == "mma" else A.SPLIT_TILE)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16])
def test_route_changes_exactly_at_the_row_threshold(g):
    """The last S with G*S <= SPLIT_ROWS splits; one position more takes the
    tensor cores (bf16), while f32 splits at both."""
    s_edge = A.SPLIT_ROWS // g
    for s, want in ((s_edge, "split"), (s_edge + 1, "mma")):
        if s == 0:
            continue
        assert A.flash_plan(1, s, 4096, 8 * g, 8, torch.bfloat16, 0, s).route == want
        assert A.flash_plan(1, s, 4096, 8 * g, 8, torch.float32, 0, s).route == "split"


def test_plans_of_the_main_path():
    """The one-session decode step at kv_len 732 is sized over its 23 tiles
    of 32, not its buffer; a dense-lane step with device spans over the
    whole buffer, with few enough splits that empty lanes cost little."""
    p = A.flash_plan(1, 1, 1024, 16, 8, torch.bfloat16, 731, 732)
    assert (p.route, p.tile_lo, p.tile_hi, p.splits, p.tiles_per_split) == ("split", 0, 23, 12, 2)
    lanes = torch.tensor([16, 0, 229, 700, 999, 2047, 3099, 3999])
    p = A.flash_plan(8, 1, 4096, 16, 8, torch.bfloat16, lanes, lanes + 1)
    assert (p.tile_lo, p.tile_hi) == (0, 128) and p.splits * 64 <= A.TARGET_CTAS["split"]
    p = A.flash_plan(1, 1, 4096, 16, 8, torch.bfloat16, 2999, 3000, 1000)
    assert (p.tile_lo, p.tile_hi) == (2000 // 32, -(-3000 // 32))
    p = A.flash_plan(1, 512, 1024, 16, 8, torch.bfloat16, 0, 512)
    assert (p.route, p.row_tiles, p.splits) == ("mma", 16, 1)
    p = A.flash_plan(1, 1, 1024, 16, 8, torch.bfloat16, 5, 0)  # nothing to attend
    assert (p.splits, p.tile_lo, p.tile_hi) == (1, 0, 0)


def _qkv(b, s, t, nq, nkv, d, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(shape, generator=g).to(dtype)
                 for shape in ((b, s, nq, d), (b, t, nkv, d), (b, t, nkv, d)))


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(d=96), "head_dim"),
        (dict(q_dtype=torch.float16), "f32 or bf16"),
        (dict(kv_dtype=torch.bfloat16, q_dtype=torch.float32), "K/V dtype"),
        (dict(nq=12, nkv=8), "groups"),
        (dict(nq=33, nkv=1), "groups"),
        (dict(unaligned="k"), "16-byte aligned"),
        (dict(unaligned="q"), "16-byte aligned"),
        (dict(b=70000, nkv=1, nq=1, t=1, s=1, d=64), "grid limit"),
        (dict(kv_len=torch.tensor([8, 8, 8])), "for B 1"),
    ],
)
def test_wrapper_rejects_what_neither_kernel_takes(kw, err):
    """Both routes' refusals, raised before any build or launch (checked on
    CPU tensors, which the validation treats like any other)."""
    b, s, t = kw.get("b", 1), kw.get("s", 4), kw.get("t", 64)
    nq, nkv, d = kw.get("nq", 16), kw.get("nkv", 8), kw.get("d", 128)
    q, k, v = _qkv(b, s, t, nq, nkv, d, kw.get("q_dtype", torch.bfloat16))
    if "kv_dtype" in kw:
        k, v = k.to(kw["kv_dtype"]), v.to(kw["kv_dtype"])
    if kw.get("unaligned"):  # a contiguous view 2 elements into its storage
        x = {"q": q, "k": k}[kw["unaligned"]]
        flat = torch.empty(x.numel() + 2, dtype=x.dtype)[2:].view(x.shape)
        flat.copy_(x)
        q, k = (flat, k) if kw["unaligned"] == "q" else (q, flat)
    with pytest.raises((ValueError, TypeError), match=err):
        A._launch(q, k, v, 0, kw.get("kv_len", 8), 0, None, 0.0, None, None)
