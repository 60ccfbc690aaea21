"""Attention kernels' wrappers and their plain versions (port of
inferd_tpu/ops/attention.py).

`flash_gqa` is the attention hot op of every prefill chunk and of decode
over a dense cache; `paged_decode_gqa` is the decode step over a paged
block pool. On a CUDA tensor each launches its hand-written kernel
(`csrc/flash_gqa.cu`, `csrc/paged_decode.cu`), or raises on anything the
kernel does not take; on a CPU tensor each runs its plain version
(`flash_gqa_reference`, `paged_decode_gqa_reference`) with the same
contract. There is no other route: no fallback on the card.

Layout contract (the KV cache's): kv slot `j` holds absolute position
`kv_start + j`; queries are contiguous from `q_start`, per batch row.
Scattered positions take the composite in models/qwen3.gqa_attention.
A paged pool's chain slot j covers positions [j*bs, (j+1)*bs).

Also here, as in the JAX module: `NEG_INF`, `apply_softcap`,
`apply_window_mask`, `gather_block_kv` and the S == 1 composite
`decode_gqa`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from inferd_tpu_torch.ops import build
from inferd_tpu_torch.utils.profiling import span

NEG_INF = -1e30  # finite: exp(-inf - -inf) would be NaN

Scalar = Union[int, torch.Tensor]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_MAX_GRID_YZ = 65535  # CUDA's limit on grid.y and grid.z
_ROUTE_CODES = {"split": 0, "mma": 1}  # Route in csrc/flash_gqa.cu


def apply_softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma logit softcapping: cap * tanh(x / cap); cap == 0 is identity."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def apply_window_mask(
    mask: torch.Tensor,  # [B, S, T] bool: already causal/valid-masked
    kpos: torch.Tensor,  # [B, T] absolute position per kv slot
    q_positions: torch.Tensor,  # [B, S]
    window,  # int, int tensor or None; <= 0 = global
) -> torch.Tensor:
    """AND the sliding-window predicate: keep kv iff its position is in
    (qpos - window, qpos]."""
    if window is None:
        return mask
    win = torch.as_tensor(window, dtype=torch.int64, device=mask.device)
    in_win = kpos[:, None, :] > (q_positions[:, :, None] - win)
    return mask & ((win <= 0) | in_win)


def gather_block_kv(
    k_pool: torch.Tensor,  # [NB, bs, Nkv, D]: one layer's paged block pool
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, MB] int32: lane -> block chain
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position-contiguous K/V views [B, MB*bs, Nkv, D] gathered through a
    block table (the paged-KV read path). Chain slot j of lane b covers
    positions [j*bs, (j+1)*bs), so slot index == absolute position, the
    dense cache layout; unallocated entries (0, the scratch block) are only
    read at slots a query cannot attend. The storage dtype is kept. A plain
    index op: a copy, not a view."""
    b, mb = block_table.shape
    bs = k_pool.shape[1]
    idx = block_table.long()
    kd = k_pool[idx]  # [B, MB, bs, Nkv, D]
    vd = v_pool[idx]
    return (
        kd.reshape(b, mb * bs, *k_pool.shape[2:]),
        vd.reshape(b, mb * bs, *v_pool.shape[2:]),
    )


def decode_gqa(
    q: torch.Tensor,  # [B, 1, Nq, D]
    k: torch.Tensor,  # [B, T, Nkv, D], possibly a narrower dtype
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, 1]
    kv_valid_len,  # int or [B]
    kv_positions: Optional[torch.Tensor] = None,  # [B, T] or [T]
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window=None,
    sinks: Optional[torch.Tensor] = None,  # [Nq]
    block_table: Optional[torch.Tensor] = None,  # [B, MB]: k/v are then
    #   paged POOLS [NB, bs, Nkv, D] read through the table
) -> torch.Tensor:
    """Single-query (S == 1) GQA composite: models/qwen3.gqa_attention at
    S == 1 with the query axis dropped. Returns [B, 1, Nq*D] in q.dtype.

    With `block_table`, k/v are paged pools and the call goes to
    paged_decode_gqa: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors (the port's rule in place of the reference's autotune
    registry). `models/qwen3.gqa_attention(block_table=...)` is the
    gather + composite path that `attn_impl="xla"` selects."""
    if block_table is not None:
        if kv_positions is not None:
            raise ValueError("decode_gqa: kv_positions do not apply to a paged pool")
        return paged_decode_gqa(
            q, k, v, block_table, q_positions, kv_valid_len,
            scale=scale, softcap=softcap, window=window, sinks=sinks,
        )
    b, s, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qh = q.reshape(b, nkv, g, d)
    scores = torch.einsum("bngd,btnd->bngt", qh, k.to(q.dtype)).float()
    scores = scores * (float(scale) if scale is not None else 1.0 / math.sqrt(d))
    scores = apply_softcap(scores, softcap)

    slots = torch.arange(t, device=q.device)
    valid = torch.as_tensor(kv_valid_len, device=q.device)
    if valid.ndim == 0:
        valid = valid[None]
    kpos = slots if kv_positions is None else kv_positions
    if kpos.ndim == 1:
        kpos = kpos[None, :]
    qpos = q_positions[:, 0]
    mask = (slots[None, :] < valid[:, None]) & (kpos <= qpos[:, None])  # [B, T]
    mask = apply_window_mask(mask[:, None, :], kpos, qpos[:, None], window)[:, 0]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    if sinks is not None:
        sk = sinks.float().reshape(nkv, g)[None, :, :, None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sk)
        p = torch.exp(scores - m)
        denom = p.sum(dim=-1, keepdim=True) + torch.exp(sk - m)
        probs = (p / denom).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngt,btnd->bngd", probs, v.to(q.dtype))
    return out.reshape(b, 1, nq * d)


def _per_batch(x: Optional[Scalar], b: int, device) -> torch.Tensor:
    """int / 0-d / [B] -> int64 [B] on `device` (None = 0). A host int is
    filled in on the device: copying it over would stall the host until the
    stream drains."""
    if x is None:
        x = 0
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int64, device=device)
    t = torch.as_tensor(x, dtype=torch.int64, device=device)
    return t.expand(b) if t.ndim == 0 else t.to(torch.int64)


def flash_gqa_reference(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, T, Nkv, D]: slot j = position kv_start + j
    v: torch.Tensor,
    q_start: Scalar,  # int or [B]: absolute position of q[:, 0]
    kv_len: Scalar,  # int or [B]: valid kv slots
    kv_start: Scalar = 0,  # int or [B]: absolute position of slot 0
    *,
    stream: Optional[bool] = None,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: Optional[Scalar] = None,
    sinks: Optional[torch.Tensor] = None,  # [Nq]
) -> torch.Tensor:
    """The plain version of flash_gqa: masked softmax attention, written
    straight. Same signature and contract as the kernel: scores in f32,
    times `scale`, softcapped, masked (causal, validity, window); sinks join
    the denominator; p is rounded to q.dtype before p @ v with f32
    accumulation; a row with no valid slot gives zeros. K/V in a narrower
    dtype (fp8) are upcast to q.dtype first. `stream` is accepted for the
    kernel's signature and changes nothing. Returns [B, S, Nq*D] in q.dtype."""
    del stream
    b, s, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    dev = q.device
    qf = q.float().reshape(b, s, nkv, g, d)
    kf = k.to(q.dtype).float()
    vf = v.to(q.dtype).float()
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bsngd,btnd->bngst", qf, kf) * eff_scale
    scores = apply_softcap(scores, softcap)

    qs = _per_batch(q_start, b, dev)
    ks = _per_batch(kv_start, b, dev)
    kl = _per_batch(kv_len, b, dev)
    win = _per_batch(window, b, dev)
    slot = torch.arange(t, device=dev)
    kpos = ks[:, None] + slot[None, :]  # [B, T]
    qpos = qs[:, None] + torch.arange(s, device=dev)[None, :]  # [B, S]
    mask = (slot[None, None, :] < kl[:, None, None]) & (kpos[:, None, :] <= qpos[:, :, None])
    mask &= (win[:, None, None] <= 0) | (kpos[:, None, :] > qpos[:, :, None] - win[:, None, None])
    mask = mask[:, None, None]  # [B, 1, 1, S, T]

    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)  # [B, Nkv, G, S, 1]
    if sinks is not None:
        sk = sinks.float().reshape(nkv, g)[None, :, :, None, None]
        m = torch.maximum(m, sk)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.where(sk > NEG_INF / 2, torch.exp(sk - m), 0.0)
    acc = torch.einsum("bngst,btnd->bngsd", p.to(q.dtype).float(), vf)
    out = acc / torch.where(l == 0.0, 1.0, l)
    # [B, Nkv, G, S, D] -> [B, S, Nkv*G (= Nq), D] -> [B, S, Nq*D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nq * d).to(q.dtype)


# -- the flash kernels' launch plan --------------------------------------------

# Constants shared with csrc/flash_gqa.cu
SPLIT_ROWS = 16  # packed rows G*S a split-KV CTA holds at most (its largest row tile)
SPLIT_TILE = 32  # kv slots per tile on the split-KV route (kSplitTile)
MMA_ROWS = 64  # packed rows per tensor-core CTA (kMmaRows)
MMA_TILE = 64  # kv slots per tile on the tensor-core route (kMmaTile)
# Enough CTAs to fill the H100's 132 SMs in one wave (two split-KV CTAs fit
# an SM, one tensor-core CTA of 8 warps and 153 KB of shared memory), never
# more from splitting (a launch with more groups keeps one split each), and
# at most MAX_SPLITS partials per row for the combine kernel. A split spans
# at least MIN_SPLIT_TILES tiles, so a short span is not cut into CTAs that
# each read almost nothing, nor a chunk into partials that cost more than
# they save.
TARGET_CTAS = {"split": 2 * 132, "mma": 132}
MAX_SPLITS = 64
MIN_SPLIT_TILES = {"split": 2, "mma": 16}


class FlashPlan(NamedTuple):
    """How one flash_gqa call is launched. Split z covers the kv tiles
    [tile_lo + z * tiles_per_split, min(tile_lo + (z+1) * tiles_per_split,
    tile_hi)), each tile `tile` slots; a CTA reads only what its rows can
    attend of its split's tiles. The grid is (row_tiles, splits, B * Nkv)."""

    route: str  # "split" (CUDA cores, split-KV) or "mma" (tensor cores)
    rows: int  # packed query rows (i * G + g) per CTA
    row_tiles: int
    tile: int
    tile_lo: int
    tile_hi: int
    splits: int
    tiles_per_split: int


def flash_plan(b: int, s: int, t: int, nq: int, nkv: int, dtype: torch.dtype,
               q_start: Scalar, kv_len: Scalar, window: Optional[Scalar] = None,
               kv_start: Scalar = 0, kv_bound: Optional[int] = None) -> FlashPlan:
    """The route and the KV split of a flash_gqa launch, from what the host
    knows. With host ints (the one-session path) the split covers the real
    span, the window floor of the first query to the causal frontier of the
    last; with device tensors (lanes, the paged prefill, a fused K-step
    window) it covers the whole buffer, or the first `kv_bound` slots when
    the caller knows that bound on the host, and CTAs past a row's frontier
    write an empty partial.

    The route: bf16 queries with more packed rows per kv head (G*S) than
    the split-KV route's row tile take the tensor cores; everything else,
    and every f32 call (TF32 would break f32's accuracy), splits KV."""
    g = nq // nkv
    route = "mma" if dtype == torch.bfloat16 and s * g > SPLIT_ROWS else "split"
    if route == "mma":
        rows, tile = MMA_ROWS, MMA_TILE
    else:
        rows = max(2, min(SPLIT_ROWS, 1 << max(s * g - 1, 0).bit_length()))
        tile = SPLIT_TILE
    row_tiles = -(-s * g // rows)
    win = 0 if window is None else window
    if all(isinstance(x, int) for x in (q_start, kv_len, kv_start, win)):
        last = min(kv_len, t, q_start + s - kv_start)  # past the last query's frontier
        floor = max(q_start - win + 1 - kv_start, 0) if win > 0 else 0
        lo = floor // tile
        hi = -(-last // tile) if last > floor else lo
    else:
        lo, hi = 0, -(-(t if kv_bound is None else min(t, kv_bound)) // tile)
    span = hi - lo
    if span <= 0:
        return FlashPlan(route, rows, row_tiles, tile, lo, lo, 1, 0)
    groups = b * nkv * row_tiles
    want = max(1, min(TARGET_CTAS[route] // groups, MAX_SPLITS))
    tps = max(MIN_SPLIT_TILES[route], -(-span // want))
    return FlashPlan(route, rows, row_tiles, tile, lo, hi, -(-span // tps), tps)


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_gqa")
    fn = lib.flash_gqa_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        fn.argtypes = [p] * 11 + [i] * 10 + [ll] * 4 + [f, f] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib


def flash_gqa(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, T, Nkv, D]: slot j = position kv_start + j
    v: torch.Tensor,
    q_start: Scalar,
    kv_len: Scalar,
    kv_start: Scalar = 0,
    *,
    stream: Optional[bool] = None,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: Optional[Scalar] = None,
    sinks: Optional[torch.Tensor] = None,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA attention over a (possibly oversized) KV buffer; returns
    [B, S, Nq*D] in q.dtype.

    `kv_bound`, a launch hint, is a host int no row's `kv_len` exceeds:
    with device spans the kernel then walks only the first kv_bound slots
    (flash_plan). The caller guarantees it; the plain version ignores it.

    CUDA tensors launch the kernels of csrc/flash_gqa.cu (which replace both
    Pallas kernels of the JAX package) on the route `flash_plan` picks: the
    split-KV kernel (and its combine) or the tensor-core kernel; CPU tensors
    run flash_gqa_reference. `stream` keeps the JAX signature: on the TPU it
    picked the VMEM-resident or the streaming kernel; here both stream K/V
    through shared memory and it changes nothing. The Pallas-only
    `block_q`/`block_k`/`interpret` knobs have no counterpart. Each call
    that launches adds one to `flash_gqa.launches` and one to its route's
    count, `flash_gqa.split_launches` or `flash_gqa.mma_launches`.
    Inside a captured CUDA graph (utils/cuda_graph) the checks, the plan
    and the count run once, at capture: a replay launches what was captured
    and re-runs none of them."""
    if q.device.type == "cpu":
        return flash_gqa_reference(
            q, k, v, q_start, kv_len, kv_start, stream=stream, scale=scale,
            softcap=softcap, window=window, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa: unsupported device {q.device}")
    with span("kernel.flash_gqa"):
        out, route = _launch(q, k, v, q_start, kv_len, kv_start, scale, softcap, window, sinks,
                             kv_bound)
    flash_gqa.launches += 1
    if route == "mma":
        flash_gqa.mma_launches += 1
    else:
        flash_gqa.split_launches += 1
    return out


flash_gqa.launches = 0
flash_gqa.split_launches = 0
flash_gqa.mma_launches = 0


def _launch(q, k, v, q_start, kv_len, kv_start, scale, softcap, window, sinks,
            kv_bound=None):
    """Validate, plan and launch; returns (out, route)."""
    dev = q.device
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_gqa: want 4-d q/k/v, got {q.shape} {k.shape} {v.shape}")
    b, s, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_gqa: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.device != dev or v.device != dev:
        raise ValueError("flash_gqa: q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_gqa kernel takes f32 or bf16 queries, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (q.dtype, torch.float8_e4m3fn):
        raise TypeError(f"flash_gqa kernel: K/V dtype {k.dtype}/{v.dtype} with q {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash_gqa kernel: head_dim {d} not in (64, 128)")
    if nkv == 0 or nq % nkv or nq // nkv > 32:
        raise ValueError(f"flash_gqa kernel: Nq {nq} / Nkv {nkv} groups not supported")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_gqa kernel: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_gqa kernel: {name} must be 16-byte aligned")
    plan = flash_plan(b, s, t, nq, nkv, q.dtype, q_start, kv_len, window, kv_start, kv_bound)
    if b * nkv > _MAX_GRID_YZ:
        raise ValueError(f"flash_gqa kernel: B*Nkv {b * nkv} over the grid limit")
    out = torch.empty((b, s, nq * d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out, plan.route
    sink_t = None
    if sinks is not None:
        if sinks.shape != (nq,):
            raise ValueError(f"flash_gqa: sinks shape {tuple(sinks.shape)} != ({nq},)")
        sink_t = sinks.to(device=dev, dtype=torch.float32).contiguous()
    # each span field a host int, or an int64 column the kernel reads in
    # place (no copy kernels: a decode step's positions are used as they are)
    scalars, columns, strides = [], [], []
    for name, x in (("q_start", q_start), ("kv_start", kv_start), ("kv_len", kv_len),
                    ("window", 0 if window is None else window)):
        if isinstance(x, int):
            scalars.append(x)
            columns.append(None)
            strides.append(0)
            continue
        col = torch.as_tensor(x, device=dev)
        if col.dtype != torch.int64:
            col = col.to(torch.int64)
        if col.ndim > 1 or (col.ndim == 1 and col.shape[0] != b):
            raise ValueError(f"flash_gqa: {name} of shape {tuple(col.shape)} for B {b}")
        scalars.append(0)
        columns.append(col)
        strides.append(col.stride(0) if col.ndim else 0)
    part_acc = part_ml = None
    if plan.splits > 1:  # scratch for the partials, merged by the combine kernel
        n = b * nkv * plan.row_tiles * plan.splits * plan.rows
        part_acc = torch.empty(n * d, dtype=torch.float32, device=dev)
        part_ml = torch.empty(n * 2, dtype=torch.float32, device=dev)
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.flash_gqa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(None if c is None else c.data_ptr() for c in columns),
            None if sink_t is None else sink_t.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            b, s, t, nq, nkv, d, *scalars, *strides,
            eff_scale, float(softcap),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
            _ROUTE_CODES[plan.route], plan.rows, plan.row_tiles, plan.tile_lo, plan.splits,
            plan.tiles_per_split,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_gqa kernel launch failed: cudaError_t {rc}")
    return out, plan.route


# -- paged decode attention ----------------------------------------------------


def paged_decode_gqa_reference(
    q: torch.Tensor,  # [B, 1, Nq, D]
    k_pool: torch.Tensor,  # [NB, bs, Nkv, D]: one layer's paged block pool
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, MB] int32
    q_positions: torch.Tensor,  # [B, 1]
    kv_valid_len: Scalar,  # int or [B]
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: Optional[Scalar] = None,
    sinks: Optional[torch.Tensor] = None,  # [Nq]
) -> torch.Tensor:
    """The plain version of paged_decode_gqa: gather_block_kv, then
    flash_gqa_reference over the position-contiguous view. The reference's
    own XLA sibling is gather + the decode_gqa composite; this one takes
    flash_gqa_reference instead because it holds the kernel's contract,
    where the composite does not: a lane with nothing to attend (kv_len 0)
    gives zeros, as the Pallas kernel's does (the composite gives the mean
    of V there), and p is rounded to q.dtype before p @ v with the sum
    normalised after. Returns [B, 1, Nq*D] in q.dtype."""
    k, v = gather_block_kv(k_pool, v_pool, block_table)
    return flash_gqa_reference(
        q, k, v, q_positions[:, 0], kv_valid_len, 0,
        scale=scale, softcap=softcap, window=window, sinks=sinks,
    )


# -- the paged kernel's launch plan -----------------------------------------------

# A split covers at least PAGED_MIN_SPLIT_SLOTS chain slots (whole blocks): a
# CTA's 8 warps then have four steps of rows each to keep loads in flight,
# and a short chain is not cut into partials that cost more to merge than
# they save. The ranges aim at PAGED_TARGET_CTAS CTAs: one CTA of the split
# kernel fits an SM (~180 registers a thread), so that is four waves, the
# slowest CTA's range short. Both chosen with tools/paged_sweep.py (PERF.md).
PAGED_MIN_SPLIT_SLOTS = 256
PAGED_TARGET_CTAS = 4 * 132


class PagedPlan(NamedTuple):
    """How one paged_decode_gqa call is launched: split z covers chain
    blocks [z * blocks_per_split, min((z+1) * blocks_per_split, mb)) of
    every lane, intersected with the lane's own [lo, hi). The grid is
    (splits, Nkv, B); with splits > 1 a combine kernel merges the partials."""

    splits: int
    blocks_per_split: int


@functools.lru_cache(maxsize=4096)
def paged_plan(b: int, nkv: int, mb: int, bs: int, dtype: torch.dtype) -> PagedPlan:
    """Cut the table's chain [0, mb) into uniform ranges so that B * Nkv *
    splits lands near PAGED_TARGET_CTAS, each range at least
    PAGED_MIN_SPLIT_SLOTS slots, at most MAX_SPLITS ranges, and none empty
    at the end. Host ints only: the lanes' spans live on the device, so a
    range past a lane's chain writes an empty partial. `dtype` (the
    query's) does not change the cut today; it is in the key so a later
    route may."""
    del dtype
    groups = b * nkv
    want = max(1, min(PAGED_TARGET_CTAS // max(groups, 1), MAX_SPLITS))
    least = max(1, -(-PAGED_MIN_SPLIT_SLOTS // bs))
    bps = max(least, -(-mb // want), 1)
    return PagedPlan(max(1, -(-mb // bps)), bps)


def _paged_kernel_lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 12 + [i] * 8 + [f, f, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_gqa(
    q: torch.Tensor,  # [B, 1, Nq, D]: one decode query per lane
    k_pool: torch.Tensor,  # [NB, bs, Nkv, D]: one layer's paged block pool
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, MB] int32: lane -> block chain
    q_positions: torch.Tensor,  # [B, 1]
    kv_valid_len: Scalar,  # int or [B]
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: Optional[Scalar] = None,
    sinks: Optional[torch.Tensor] = None,  # [Nq]
) -> torch.Tensor:
    """S == 1 attention that walks each lane's block chain through the
    table, with no dense gather; returns [B, 1, Nq*D] in q.dtype.

    CUDA tensors launch the kernels of csrc/paged_decode.cu (which replace
    the Pallas `_paged_decode_kernel`) as `paged_plan` cuts the chain: one
    kernel when it keeps the chain whole, else the split kernel and a
    combine; CPU tensors run paged_decode_gqa_reference. The Pallas-only
    `interpret` knob has no counterpart. Table entries must index the pool
    (core.cache.BlockPool hands out nothing else); the kernel does not check
    them. Each call that launches adds one to `paged_decode_gqa.launches`,
    and one to `paged_decode_gqa.split_launches` when its plan splits.
    Inside a captured CUDA graph (utils/cuda_graph) the checks, the plan
    and the count run once, at capture: a replay launches what was captured
    and re-runs none of them."""
    if q.device.type == "cpu":
        return paged_decode_gqa_reference(
            q, k_pool, v_pool, block_table, q_positions, kv_valid_len,
            scale=scale, softcap=softcap, window=window, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_gqa: unsupported device {q.device}")
    with span("kernel.paged_decode_gqa"):
        out, plan = _paged_launch(q, k_pool, v_pool, block_table, q_positions, kv_valid_len,
                                  scale, softcap, window, sinks)
    if plan is not None:
        paged_decode_gqa.launches += 1
        paged_decode_gqa.split_launches += plan.splits > 1
    return out


paged_decode_gqa.launches = 0
paged_decode_gqa.split_launches = 0


def _paged_launch(q, k_pool, v_pool, block_table, q_positions, kv_valid_len,
                  scale, softcap, window, sinks, plan: Optional[PagedPlan] = None):
    """Validate and launch on `plan` (paged_plan's unless given: the sweep
    tool times others); returns (out, plan), plan None when nothing launched."""
    dev = q.device
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.ndim != 4 or block_table.ndim != 2:
        raise ValueError(
            f"paged_decode_gqa: want q [B,1,Nq,D], pools [NB,bs,Nkv,D], table [B,MB]; got "
            f"{tuple(q.shape)} {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
            f"{tuple(block_table.shape)}")
    b, s, nq, d = q.shape
    _nb, bs, nkv, _ = k_pool.shape
    mb = block_table.shape[1]
    if s != 1:
        raise ValueError(f"paged_decode_gqa is S == 1 only, got S={s}")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != d or block_table.shape[0] != b:
        raise ValueError(
            f"paged_decode_gqa: shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
            f"{tuple(v_pool.shape)} table {tuple(block_table.shape)}")
    if any(x.device != dev for x in (k_pool, v_pool, block_table)):
        raise ValueError("paged_decode_gqa: q, pools and table must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_decode_gqa kernel takes f32 or bf16 queries, got {q.dtype}")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (q.dtype, torch.float8_e4m3fn):
        raise TypeError(
            f"paged_decode_gqa kernel: pool dtype {k_pool.dtype}/{v_pool.dtype} with q {q.dtype}")
    if block_table.dtype != torch.int32:
        raise TypeError(f"paged_decode_gqa kernel: table must be int32, got {block_table.dtype}")
    if d not in (64, 128):
        raise ValueError(f"paged_decode_gqa kernel: head_dim {d} not in (64, 128)")
    if nkv == 0 or nq % nkv or nq // nkv > 8:
        raise ValueError(f"paged_decode_gqa kernel: Nq {nq} / Nkv {nkv} groups not supported")
    if b > _MAX_GRID_YZ or bs < 1:
        raise ValueError(f"paged_decode_gqa kernel: B {b} over the grid limit or block size {bs}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", block_table)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_gqa kernel: {name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_gqa kernel: pools must be 16-byte aligned")
    out = torch.empty((b, 1, nq * d), dtype=q.dtype, device=dev)
    if b == 0:
        return out, None
    sink_t = None
    if sinks is not None:
        if sinks.shape != (nq,):
            raise ValueError(f"paged_decode_gqa: sinks shape {tuple(sinks.shape)} != ({nq},)")
        sink_t = sinks.to(device=dev, dtype=torch.float32).contiguous()
    # each span a host int, or a column the kernel reads in place (int32 or
    # int64, any stride): a decode step launches no copy kernel for them
    cols = (ctypes.c_void_p * 3)()
    scalars, strides, wide = (ctypes.c_longlong * 3)(), (ctypes.c_longlong * 3)(), (ctypes.c_int * 3)()
    keep = []  # the columns, alive until the launch is enqueued
    for i, (name, x) in enumerate((("q_positions", q_positions[:, 0]), ("kv_valid_len", kv_valid_len),
                                   ("window", 0 if window is None else window))):
        if isinstance(x, int):
            scalars[i] = x
            continue
        col = torch.as_tensor(x, device=dev)
        if col.dtype not in (torch.int32, torch.int64):
            col = col.to(torch.int64)
        if col.ndim > 1 or (col.ndim == 1 and col.shape[0] != b):
            raise ValueError(f"paged_decode_gqa: {name} of shape {tuple(col.shape)} for B {b}")
        keep.append(col)
        cols[i] = col.data_ptr()
        strides[i] = col.stride(0) if col.ndim else 0
        wide[i] = int(col.dtype == torch.int64)
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    plan = plan or paged_plan(b, nkv, mb, bs, q.dtype)
    part_acc = part_ml = None
    if plan.splits > 1:  # scratch for the partials, merged by the combine kernel
        n = b * nkv * plan.splits * (nq // nkv)
        part_acc = torch.empty(n * d, dtype=torch.float32, device=dev)
        part_ml = torch.empty(n * 2, dtype=torch.float32, device=dev)
    lib = _paged_kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.paged_decode_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            cols, scalars, strides, wide, None if sink_t is None else sink_t.data_ptr(),
            out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            b, nq, nkv, d, bs, mb, plan.splits, plan.blocks_per_split, eff_scale,
            float(softcap), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode_gqa kernel launch failed: cudaError_t {rc}")
    return out, plan
