"""Qwen3 decoder in PyTorch (port of inferd_tpu/models/qwen3.py).

Same functions, same parameter layout as the JAX module, so the tests can
feed both the same weights:

  * params are a dict of tensors with every decoder layer STACKED on a
    leading axis; a pipeline stage is the slice `layers[a:b]`;
  * weights are stored [in, out], so projections are plain `x @ W`;
    norms, softmax and RoPE run in float32, matmuls in the model dtype.

What differs, by PyTorch idiom: the layer loop is a Python loop where JAX
has `lax.scan`; the KV cache is written IN PLACE (the JAX package donates
the buffers to get the same effect); and `positions` may be given as a
Python int, meaning every row runs contiguously from that position, which
lets the attention kernel take its per-row metadata as scalars.

Every contiguous-position attention call goes to ops.attention.flash_gqa
(the CUDA kernel on the card), and a decode step over a paged pool to
ops.attention.paged_decode_gqa (its own kernel); `attn_impl="xla"` selects
the composite `gqa_attention` instead, as in the JAX package.

Caches: the uniform dense KVCache, written from one start position or from
a per-row start [B] (lanes at ragged fill levels decoding in one step), and
the paged PagedKVCache, whose writes scatter through the block table.

Every linear projection (q/k/v/o, the MLP, an untied head, and a tied
head's quantized shadow "lm_head_q") contracts through ops.quant.qdot, so
a stage quantized by ops.quant.quantize_params (run_node --quant) serves
unchanged: decode-shaped rows against int8 or int4 weights launch the GEMV
kernels of csrc/qmatmul.cu on the card, and bf16 weights stay plain
products.

Multi-tenant LoRA: with an `adapters` operand (the registry's stacked pools
plus per-lane slot ids, ops.lora's pool contract) every one of the seven
projections adds each lane's own delta through ops.lora.apply_lane_delta:
on the card one launch of the kernel of csrc/lora_delta.cu per projection
and layer, on the CPU the reference's gather-then-einsum form.

Fused K-step decode (`decode_k`, `make_decode_k_serve`) runs K decode
steps with on-device sampling over a dense cache and reads nothing back
until the window ends.

This slice covers the dense Qwen3/Qwen2-style decoder. MoE, sandwich norms,
sliding windows and scaled RoPE raise NotImplementedError here (and an
adapter operand on such a config raises, as in the reference); tensor/
expert parallelism waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.ops import attention as attention_ops
from inferd_tpu_torch.ops import lora as lora_ops
from inferd_tpu_torch.ops.quant import qdot

Params = Dict[str, Any]
Positions = Union[torch.Tensor, int, None]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architecture features this slice of the port lacks."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE layers (model-families slice)")
    if cfg.sandwich_norm:
        missing.append("sandwich norms (model-families slice)")
    if cfg.sliding_window:
        missing.append("sliding-window layers and ring KV (model-families slice)")
    if cfg.rope_scaling != "none":
        missing.append(f"{cfg.rope_scaling} RoPE scaling (model-families slice)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: " + "; ".join(missing)
        )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_layer_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    num_layers: Optional[int] = None,
    device=None,
) -> Params:
    """Stacked decoder-layer params: every leaf has leading dim `num_layers`.
    Weights are N(0, 0.02) drawn from `generator` (which must live on
    `device`), norms ones, biases zeros."""
    check_supported(cfg)
    n = cfg.num_layers if num_layers is None else num_layers
    h, q, kv, d, i = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.head_dim, cfg.intermediate_size
    dt = cfg.torch_dtype
    device = generator.device if device is None else torch.device(device)

    def w(*shape):
        x = torch.randn((n, *shape), generator=generator, device=device, dtype=torch.float32)
        return (x * 0.02).to(dt)

    norm1 = torch.zeros if cfg.rms_norm_plus_one else torch.ones
    p = {
        "input_norm": norm1((n, h), dtype=dt, device=device),
        "q_proj": w(h, q),
        "k_proj": w(h, kv),
        "v_proj": w(h, kv),
        "o_proj": w(q, h),
        "post_norm": norm1((n, h), dtype=dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, d), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n, d), dtype=dt, device=device)
    if cfg.attn_bias:
        p["q_bias"] = torch.zeros((n, q), dtype=dt, device=device)
        p["k_bias"] = torch.zeros((n, kv), dtype=dt, device=device)
        p["v_bias"] = torch.zeros((n, kv), dtype=dt, device=device)
    if cfg.o_bias:
        p["o_bias"] = torch.zeros((n, h), dtype=dt, device=device)
    if cfg.attn_sinks:
        p["sinks"] = torch.zeros((n, cfg.num_heads), dtype=dt, device=device)
    p["gate_proj"] = w(h, i)
    p["up_proj"] = w(h, i)
    p["down_proj"] = w(i, h)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Params:
    """Full-model params: embed + stacked layers + final norm (+ lm_head)."""
    dt = cfg.torch_dtype
    device = generator.device if device is None else torch.device(device)
    norm1 = torch.zeros if cfg.rms_norm_plus_one else torch.ones
    embed = torch.randn(
        (cfg.vocab_size, cfg.hidden_size), generator=generator, device=device,
        dtype=torch.float32,
    )
    params = {
        "embed": (embed * 0.02).to(dt),
        "layers": init_layer_params(cfg, generator, device=device),
        "final_norm": norm1((cfg.hidden_size,), dtype=dt, device=device),
    }
    del embed
    if not cfg.tie_word_embeddings:
        head = torch.randn(
            (cfg.hidden_size, cfg.vocab_size), generator=generator, device=device,
            dtype=torch.float32,
        )
        params["lm_head"] = (head * 0.02).to(dt)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = False
) -> torch.Tensor:
    """RMSNorm computed in float32, result cast back to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (out * w).to(x.dtype)


def act_fn(cfg: ModelConfig):
    """MLP gate activation: SiLU, or tanh-approximated GeLU."""
    if cfg.hidden_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu


def rope_cos_sin(
    positions: torch.Tensor,  # [B, S] absolute positions
    head_dim: int,
    theta: float,
    cfg: Optional[ModelConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] in float32, duplicated-halves layout
    (emb = concat(freqs, freqs)); unscaled RoPE only in this slice."""
    if cfg is not None and cfg.rope_scaling != "none":
        check_supported(cfg)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq  # [B, S, D/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a K/V chunk to the cache's storage dtype, SATURATING for narrow
    float types (e4m3fn has no inf: values past +-448 would become NaN)."""
    if x.dtype == dtype:
        return x
    if dtype.is_floating_point:
        lim = float(torch.finfo(dtype).max)
        x = x.float().clamp(-lim, lim)
    return x.to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, N, D]; cos/sin: [B, S, D] float32."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def gqa_attention(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, T, Nkv, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    kv_valid_len,  # int or [B]
    kv_positions: Optional[torch.Tensor] = None,  # [B, T] or [T]
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window=None,
    sinks: Optional[torch.Tensor] = None,  # [Nq]
    block_table: Optional[torch.Tensor] = None,  # [B, MB]: k/v are then
    #   paged POOLS [NB, bs, Nkv, D], gathered through the table
) -> torch.Tensor:
    """Composite grouped-query attention with causal masking over a
    (possibly oversized) KV buffer: slot j attends iff j < kv_valid_len AND
    its absolute position <= the query's. Softmax in float32, matmuls in
    the input dtype. A fully masked row gets the mean of V (the flash
    contract gives zeros there).

    With `block_table`, k/v are paged pools gathered through the table
    first (ops.attention.gather_block_kv); the gathered view is position-
    contiguous, so the math below is the dense layout's."""
    if block_table is not None:
        k, v = attention_ops.gather_block_kv(k, v, block_table)
    b, s, nq, d = q.shape
    if s == 1:
        return attention_ops.decode_gqa(
            q, k, v, q_positions, kv_valid_len, kv_positions=kv_positions,
            scale=scale, softcap=softcap, window=window, sinks=sinks,
        )
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    qh = q.reshape(b, s, nkv, g, d)
    scores = torch.einsum("bsngd,btnd->bngst", qh, k).float()
    scores = scores * (float(scale) if scale is not None else 1.0 / math.sqrt(d))
    scores = attention_ops.apply_softcap(scores, softcap)

    slots = torch.arange(t, device=q.device)
    valid = torch.as_tensor(kv_valid_len, device=q.device)
    if valid.ndim == 0:
        valid = valid[None]
    kpos = slots if kv_positions is None else kv_positions
    if kpos.ndim == 1:
        kpos = kpos[None, :]
    mask = (slots[None, None, :] < valid[:, None, None]) & (
        kpos[:, None, :] <= q_positions[:, :, None]
    )  # [B, S, T]
    mask = attention_ops.apply_window_mask(mask, kpos, q_positions, window)
    scores = torch.where(mask[:, None, None, :, :], scores, attention_ops.NEG_INF)
    if sinks is not None:
        sk = sinks.float().reshape(nkv, g)[None, :, :, None, None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sk)
        p = torch.exp(scores - m)
        denom = p.sum(dim=-1, keepdim=True) + torch.exp(sk - m)
        probs = (p / denom).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, nq * d)


def swiglu_mlp(p: Params, x: torch.Tensor, act=F.silu, lane_adapters=None) -> torch.Tensor:
    """Gated feed-forward: act(x @ gate) * (x @ up) @ down. `lane_adapters`
    (ops.lora.apply_lane_delta) adds each lane's LoRA delta to the three
    projections, where a merged adapter's weights would act."""
    gate = act(lora_ops.apply_lane_delta(qdot(x, p["gate_proj"]), x, "gate_proj", lane_adapters))
    up = lora_ops.apply_lane_delta(qdot(x, p["up_proj"]), x, "up_proj", lane_adapters)
    h = gate * up
    return lora_ops.apply_lane_delta(qdot(h, p["down_proj"]), h, "down_proj", lane_adapters)


def _attend(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_len,
    kv_positions: Optional[torch.Tensor] = None,
    window=None,
    sinks: Optional[torch.Tensor] = None,
    q_start=None,  # int or [B]: q_positions[:, 0], as a host int when known
    kv_bound: Optional[int] = None,  # host bound on every row's kv_len (flash_gqa)
) -> torch.Tensor:
    """The attention dispatch site for prefill AND cached decode: the flash
    kernel (ops.attention.flash_gqa) for every call, unless the config asks
    for the composite with attn_impl="xla". Positions are contiguous per
    batch row; kv slot j holds position kv_positions[:, 0] + j (or j)."""
    if cfg.attn_impl == "xla":
        return gqa_attention(
            q, k, v, q_positions, kv_len, kv_positions=kv_positions,
            scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap, window=window,
            sinks=sinks,
        )
    if q_start is None:
        q_start = q_positions[:, 0]
    if kv_positions is None:
        kv_start = 0
    elif kv_positions is q_positions:
        kv_start = q_start  # cache-free forward: slot j is query j
    else:
        kv_start = kv_positions[:, 0]
    return attention_ops.flash_gqa(
        q, k, v, q_start=q_start, kv_len=kv_len, kv_start=kv_start,
        scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
        window=window, sinks=sinks, kv_bound=kv_bound,
    )


def decoder_layer(
    lp: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [B, S, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    k_buf: Optional[torch.Tensor],  # [B, T, Nkv, D], a pool [NB, bs, Nkv, D], or None
    v_buf: Optional[torch.Tensor],
    cache_write_pos,  # int, or [B] int64 on the device: where each row's chunk goes
    window=None,
    q_start=None,  # int or [B]: first query position (see _attend)
    block_table: Optional[torch.Tensor] = None,  # [B, MB] int32: PAGED mode
    paged_write=None,  # PagedWrite: the committing rows and their pool slots
    adapters=None,  # this layer's per-lane LoRA operand (ops.lora.layer_adapters)
    kv_bound: Optional[int] = None,  # dense cache: host bound on every row's KV fill
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One pre-norm residual decoder block with GQA and Qwen3's per-head
    q/k RMSNorm. Returns (hidden', k_buf, v_buf); the chunk's K/V are
    written into k_buf/v_buf IN PLACE. With k_buf None the layer runs
    cache-free over the chunk itself.

    Dense caches take the chunk at one start slot (an int) or at a start
    per batch row ([B], continuous batching: lanes at ragged fill levels).
    PAGED mode (`block_table`): k_buf/v_buf are one layer's block pools;
    the rows in `paged_write` (computed once per forward on the host by
    paged_write_plan) scatter into their pool slots, and every other row
    (bucket padding past real_end, lanes with write_mask False) writes
    NOTHING: blocks are shared property. The reference drops those writes
    with an out-of-range scatter index; torch would raise on it, so the
    committing rows are selected first. Then attention reads through the
    table: the paged decode kernel at S == 1, and for a chunk (S > 1)
    flash_gqa over the gathered view (the reference runs its composite
    there), so no attention on the card runs outside a hand-written kernel.

    Caller contract: every write lands inside the buffer (the runtime and
    forward_layers_cached check room on the host before dispatch)."""
    b, s, _ = hidden.shape
    d = cfg.head_dim
    p1 = cfg.rms_norm_plus_one

    x = rms_norm(hidden, lp["input_norm"], cfg.rms_norm_eps, p1)
    q = lora_ops.apply_lane_delta(qdot(x, lp["q_proj"]), x, "q_proj", adapters)
    k = lora_ops.apply_lane_delta(qdot(x, lp["k_proj"]), x, "k_proj", adapters)
    v = lora_ops.apply_lane_delta(qdot(x, lp["v_proj"]), x, "v_proj", adapters)
    if cfg.attn_bias:
        q = q + lp["q_bias"]
        k = k + lp["k_bias"]
        v = v + lp["v_bias"]
    q = q.reshape(b, s, q.shape[-1] // d, d)
    k = k.reshape(b, s, k.shape[-1] // d, d)
    v = v.reshape(b, s, v.shape[-1] // d, d)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    sinks = lp["sinks"] if cfg.attn_sinks else None
    if k_buf is None:
        attn = _attend(
            cfg, q, k, v.contiguous(), q_positions, s, kv_positions=q_positions,
            window=window, sinks=sinks, q_start=q_start,
        )
    elif block_table is not None:
        if paged_write is not None:
            kf = k_buf.view(-1, *k_buf.shape[2:])  # [NB * bs, Nkv, D]: slot = block * bs + off
            vf = v_buf.view(-1, *v_buf.shape[2:])
            kf[paged_write.dest] = _to_cache_dtype(k[paged_write.rows, paged_write.cols], kf.dtype)
            vf[paged_write.dest] = _to_cache_dtype(v[paged_write.rows, paged_write.cols], vf.dtype)
        end = cache_write_pos + s
        if cfg.attn_impl == "xla":
            attn = gqa_attention(
                q, k_buf, v_buf, q_positions, end, scale=cfg.attn_scale,
                softcap=cfg.attn_logit_softcap, window=window, sinks=sinks,
                block_table=block_table,
            )
        elif s == 1:
            attn = attention_ops.decode_gqa(
                q, k_buf, v_buf, q_positions, end, scale=cfg.attn_scale,
                softcap=cfg.attn_logit_softcap, window=window, sinks=sinks,
                block_table=block_table,
            )
        else:
            kd, vd = attention_ops.gather_block_kv(k_buf, v_buf, block_table)
            attn = attention_ops.flash_gqa(
                q, kd, vd, q_start=q_start, kv_len=end, kv_start=0,
                scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
                window=window, sinks=sinks,
            )
    else:
        end = cache_write_pos + s
        kc = _to_cache_dtype(k, k_buf.dtype)
        vc = _to_cache_dtype(v, v_buf.dtype)
        if isinstance(cache_write_pos, int):
            if end > k_buf.shape[1]:
                raise BufferError(
                    f"KV write [{cache_write_pos}, {end}) past the buffer ({k_buf.shape[1]})"
                )
            k_buf[:, cache_write_pos:end] = kc
            v_buf[:, cache_write_pos:end] = vc
        else:  # per-row start [B]: one indexed write per buffer
            rows = torch.arange(b, device=k_buf.device)[:, None]
            cols = cache_write_pos[:, None] + torch.arange(s, device=k_buf.device)[None, :]
            k_buf[rows, cols] = kc
            v_buf[rows, cols] = vc
        attn = _attend(
            cfg, q, k_buf, v_buf, q_positions, end, window=window, sinks=sinks,
            q_start=q_start, kv_bound=kv_bound,
        )

    attn_out = lora_ops.apply_lane_delta(qdot(attn, lp["o_proj"]), attn, "o_proj", adapters)
    if cfg.o_bias:
        attn_out = attn_out + lp["o_bias"]
    hidden = hidden + attn_out.to(hidden.dtype)
    x = rms_norm(hidden, lp["post_norm"], cfg.rms_norm_eps, p1)
    mlp_out = swiglu_mlp(lp, x, act_fn(cfg), lane_adapters=adapters)
    return hidden + mlp_out.to(hidden.dtype), k_buf, v_buf


# ---------------------------------------------------------------------------
# Stage / model forward
# ---------------------------------------------------------------------------


def slice_layers(layers: Params, start: int, end: int) -> Params:
    """Stage partition = a slice of the stacked layer dict, [start, end)."""
    return {name: a[start:end] for name, a in layers.items()}


def _stack_len(layers: Params) -> int:
    return next(iter(layers.values())).shape[0]


def _positions(positions: Positions, b: int, s: int, device):
    """(positions [B, S] tensor, q_start) from a tensor, or from an int
    start (contiguous rows; q_start stays a host int) or None (= 0)."""
    if positions is None:
        positions = 0
    if isinstance(positions, int):
        pos = positions + torch.arange(s, device=device).expand(b, s)
        return pos, positions
    return positions, positions[:, 0]


def forward_layers(
    layers: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [B, S, H]
    positions: Positions,  # [B, S], or an int start
    k_cache: Optional[torch.Tensor] = None,  # [L, B, T, Nkv, D] or pools [L, NB, bs, Nkv, D]
    v_cache: Optional[torch.Tensor] = None,
    cache_write_pos=None,  # int, or [B] int64 on the device
    layer_offset: int = 0,
    block_table: Optional[torch.Tensor] = None,  # [B, MB] int32: paged pools
    paged_write=None,  # PagedWrite (paged only)
    adapters=None,  # multi-tenant LoRA pools + per-lane ids (ops.lora's contract)
    kv_bound: Optional[int] = None,  # dense caches: host bound on every row's KV fill
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run a stack of decoder layers (a Python loop over the stacked
    params). With caches, each layer writes its chunk K/V into
    k_cache[i]/v_cache[i] in place; the buffers are returned as given.
    With `block_table` the caches are paged pools (one table for every
    layer: a lane's chain covers all of them). With `adapters`, layer i
    adds the lanes' deltas of the pools' layer i (the registry holds this
    stage's slice), gathered once here on the CPU, in the kernel on the
    card (ops.lora.layer_adapters)."""
    if adapters is not None and (cfg.is_moe or cfg.sliding_window):
        raise ValueError(
            "the adapter registry targets dense decoder projections on a "
            "uniform layout — MoE and sliding-window configs are unsupported"
        )
    check_supported(cfg)
    del layer_offset  # selects the sliding-window pattern, which waits
    b, s = hidden.shape[:2]
    pos, q_start = _positions(positions, b, s, hidden.device)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg)
    lane_adapters = lora_ops.layer_adapters(adapters, hidden.device)
    for i in range(_stack_len(layers)):
        lp = {name: a[i] for name, a in layers.items()}
        hidden, _, _ = decoder_layer(
            lp, cfg, hidden, cos, sin, pos,
            None if k_cache is None else k_cache[i],
            None if v_cache is None else v_cache[i],
            cache_write_pos, q_start=q_start, block_table=block_table,
            paged_write=paged_write, adapters=lane_adapters(i), kv_bound=kv_bound,
        )
    return hidden, k_cache, v_cache


class PagedWrite:
    """The rows of a chunk that commit to a paged pool, and their slots:
    row (rows[n], cols[n]) of the chunk's K/V goes to flat pool slot
    dest[n] = block * bs + offset. All three are int64 on the device."""

    __slots__ = ("rows", "cols", "dest")

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, dest: torch.Tensor):
        self.rows, self.cols, self.dest = rows, cols, dest


def _host_rows(x, b: int) -> Optional[np.ndarray]:
    """int or [B] host values (list, numpy, CPU tensor) -> int64 numpy [B];
    None stays None. No device value is read here."""
    if x is None:
        return None
    a = np.asarray(x, dtype=np.int64)
    return np.broadcast_to(a, (b,)) if a.ndim == 0 else a


def paged_write_plan(
    table: torch.Tensor,  # [B, MB] int32 on the pools' device
    block_size: int,
    write_pos: np.ndarray,  # [B] host: first position of each row's chunk
    s: int,
    real_end: Optional[np.ndarray] = None,  # [B] host: first padding position
    write_mask: Optional[np.ndarray] = None,  # [B] host bool: rows that commit
) -> Optional[PagedWrite]:
    """Select on the host the chunk rows that commit (position < real_end,
    write_mask True), then look their blocks up in the device table; None
    when no row commits. One upload per forward, whatever the depth."""
    pos = write_pos[:, None] + np.arange(s)[None, :]  # [B, S]
    ok = np.ones(pos.shape, bool)
    if real_end is not None:
        ok &= pos < real_end[:, None]
    if write_mask is not None:
        ok &= np.asarray(write_mask, bool)[:, None]
    rows, cols = np.nonzero(ok)
    if rows.size == 0:
        return None
    p = pos[rows, cols]
    chain = p // block_size
    if chain.max() >= table.shape[1]:
        raise BufferError(
            f"paged KV write at position {int(p.max())} past the table "
            f"({table.shape[1]} blocks of {block_size})"
        )
    from inferd_tpu_torch.core.cache import host_to_device

    idx = host_to_device(np.stack([rows, cols, chain, p % block_size]).astype(np.int64),
                         table.device)
    blk = table[idx[0], idx[2]].long()
    return PagedWrite(idx[0], idx[1], blk * block_size + idx[3])


def forward_layers_cached(
    layers: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,
    positions: Positions,  # [B, S], an int start, or None: from cache_write_pos
    cache,  # core.cache.KVCache (uniform layout) or core.cache.PagedKVCache
    cache_write_pos,  # int, or [B] (host array or tensor): per-row start
    real_end=None,  # int or [B]: first bucket-padding position (paged only)
    layer_offset: int = 0,
    write_mask=None,  # [B] bool (paged only): rows whose KV writes commit
    adapters=None,  # multi-tenant LoRA pools + per-lane ids (see forward_layers)
):
    """Cached stage/model forward, dispatching on the cache's layout: paged
    block pools (writes scatter and reads go through the lanes' block
    table) or the uniform dense buffers. Returns (hidden, the same cache,
    written in place, with its length unchanged: the caller advances it).

    A per-row `cache_write_pos` (lanes at ragged fill levels) is checked
    against the buffer on the host and uploaded once; with `positions`
    None each row's queries run contiguously from its write position."""
    from inferd_tpu_torch.core.cache import PagedKVCache, host_to_device

    b, s = hidden.shape[:2]
    paged = isinstance(cache, PagedKVCache)
    wp = cache_write_pos
    if not isinstance(wp, int):
        wp_host = _host_rows(wp, b)
        if not paged and int(wp_host.max(initial=0)) + s > cache.max_len:
            raise BufferError(
                f"KV write at {int(wp_host.max())} + {s} past the buffer ({cache.max_len})"
            )
        wp = host_to_device(wp_host, hidden.device)
    if positions is None:
        positions = wp if isinstance(wp, int) else (
            wp[:, None] + torch.arange(s, device=hidden.device)[None, :])
    if not paged:
        h, _, _ = forward_layers(
            layers, cfg, hidden, positions, cache.k, cache.v, wp, layer_offset=layer_offset,
            adapters=adapters,
        )
        return h, cache
    wp_host = _host_rows(cache_write_pos, b)
    plan = paged_write_plan(
        cache.table, cache.block_size, wp_host, s,
        wp_host + s if real_end is None else _host_rows(real_end, b),
        _host_rows(write_mask, b),
    )
    h, _, _ = forward_layers(
        layers, cfg, hidden, positions, cache.k, cache.v, wp, layer_offset=layer_offset,
        block_table=cache.table, paged_write=plan, adapters=adapters,
    )
    return h, cache


def forward_cached(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S]
    positions: Positions,
    cache,
    cache_write_pos,
    real_end=None,
    write_mask=None,
):
    """Whole-model cached forward -> (logits [B, S, V] float32, cache). With
    positions None they run contiguously from cache_write_pos."""
    hidden = embed(params, tokens, cfg)
    hidden, cache = forward_layers_cached(
        params["layers"], cfg, hidden, positions, cache, cache_write_pos, real_end,
        write_mask=write_mask,
    )
    return unembed(params, cfg, hidden), cache


def decode_k(
    params: Params,
    cfg: ModelConfig,
    toks,  # [B] int: each row's last emitted token (host or device)
    cache,  # core.cache.KVCache with batch B (dense)
    lengths,  # [B] HOST ints: each row's KV fill (its next write position)
    active,  # [B] bool (host or device): rows that advance this window
    keys,  # [B, 2] uint32 host keys (core.sampling.split_key chains them)
    k: int,  # decode steps in this window
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
    eos=None,  # None, an int, or [B] host ints; < 0 disables
    top_n: int = 0,
    want_lp: bool = False,
    adapters=None,  # multi-tenant LoRA pools + per-lane ids, for every step
):
    """K decode steps with sampling and every KV write on the device: the
    host reads the window's outputs once, at its end (port of
    inferd_tpu/models/qwen3.decode_k, whose per-row semantics hold here):

      * positions and masks come from each row's fill, not cache.length:
        a frozen row computes garbage at its frozen frontier slot, which its
        next real step overwrites before any query can read it;
      * a row's fill advances only while it is active; `n_new` counts those
        advances;
      * with `eos` >= 0 a row deactivates the step AFTER it emits its stop
        token (the token itself is emitted and counted); frozen rows
        re-emit their token;
      * sampled rows chain `key, sub = split_key(key)` every step, frozen
        rows too (greedy leaves the keys as they are), so a window gives the
        tokens of K single steps from the same keys.

    The steps are a Python loop. Every key split is on the host
    (core.sampling), so all K subkeys are known before the first launch.
    Each row's fill stays on the device (eos can freeze a row mid-window),
    so the attention gets its spans as device columns plus a host bound,
    max(lengths) + j + 1 at step j: a row advances at most one slot per
    step, and the kernel walks the filled span of the buffer, not all of it.

    Returns (cache, seq [k, B], n_new [B], keys' [B, 2], lps [k, B],
    top_ids [k, B, top_n], top_lps [k, B, top_n]); keys' is a host uint32
    array, the rest are tensors on the cache's device. The cache is
    written in place and its `length` left to the caller. A paged cache
    raises: its fused window needs host-side write plans from an on-device
    active mask (ROADMAP A3)."""
    from inferd_tpu_torch.core import sampling as samplib
    from inferd_tpu_torch.core.cache import PagedKVCache, host_to_device

    if isinstance(cache, PagedKVCache):
        raise NotImplementedError(
            "decode_k over a paged cache is not ported yet (ROADMAP A3: the lane "
            "executors' fused K-step items)"
        )
    dev = cache.k.device
    lens_host = np.asarray(lengths, dtype=np.int64).reshape(-1)
    b = lens_host.shape[0]
    top = int(lens_host.max(initial=0))
    if top + k > cache.max_len:
        raise BufferError(f"decode_k: {k} steps from fill {top} past the buffer ({cache.max_len})")
    lens = host_to_device(lens_host, dev)

    def column(x, dtype):  # [B] of x on the device, uploaded without a sync
        if isinstance(x, torch.Tensor):
            return x.reshape(b).to(dev, dtype)
        return host_to_device(np.array(np.broadcast_to(np.asarray(x), (b,))), dev).to(dtype)

    cur = column(toks, torch.int64)
    act = column(active, torch.bool)
    eos_t = None if eos is None else column(eos, torch.int64)
    keys = np.asarray(keys, dtype=np.uint32).reshape(b, 2)
    subs = []
    if temperature != 0.0:
        for _ in range(k):
            keys, sub = samplib.split_keys(keys)
            subs.append(sub)
    n_cand = samplib.candidate_count(cfg.vocab_size, top_k)
    n_new = torch.zeros(b, dtype=torch.int64, device=dev)
    no_lp = (torch.zeros(b, dtype=torch.float32, device=dev),
             torch.zeros((b, 0), dtype=torch.int32, device=dev),
             torch.zeros((b, 0), dtype=torch.float32, device=dev))
    seq, lps, tis, tls = [], [], [], []
    for j in range(k):
        hidden = embed(params, cur[:, None], cfg)
        hidden, _, _ = forward_layers(
            params["layers"], cfg, hidden, lens[:, None], cache.k, cache.v, lens,
            adapters=adapters, kv_bound=top + j + 1,
        )
        last = unembed(params, cfg, hidden)[:, 0]  # [B, V]
        if temperature == 0.0:
            ntok = torch.argmax(last, dim=-1)
        else:
            u = torch.cat([samplib.uniforms(sb, (1, n_cand), dev) for sb in subs[j]])
            ntok = samplib.sample_from_uniforms(last, u, temperature, top_k, top_p, min_p)
        ntok = torch.where(act, ntok, cur)  # frozen rows re-emit their token
        lp, ti, tl = samplib.logprob_topn(last, ntok, top_n) if want_lp else no_lp
        step = act.long()
        lens = lens + step
        n_new = n_new + step
        if eos_t is not None:
            act = act & ((eos_t < 0) | (ntok != eos_t))
        cur = ntok
        seq.append(ntok)
        lps.append(lp)
        tis.append(ti)
        tls.append(tl)
    return (cache, torch.stack(seq), n_new, keys, torch.stack(lps), torch.stack(tis),
            torch.stack(tls))


def make_decode_k_serve(cfg: ModelConfig):
    """The serving form of decode_k, with the reference's dispatch contract
    (params, cache, toks, lengths, active, keys, eos, k, t, tk, tp, mp,
    ads=None) -> (cache, seq [k, L], n_new [L], keys' [L, 2]): sampling
    parameters per request and a per-lane `eos` [L] that deactivates a
    lane in the window the step after its stop token. Its consumers (the
    batched engine, the lane executors' K-step items) land with ROADMAP A3."""

    def decode_k_serve(params, cache, toks, lengths, active, keys, eos, k: int,
                       temperature: float, top_k: int, top_p: float, min_p: float,
                       ads=None):
        cache, seq, n_new, keys, _lps, _tis, _tls = decode_k(
            params, cfg, toks, cache, lengths, active, keys, k, temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p, eos=eos, adapters=ads,
        )
        return cache, seq, n_new, keys

    return decode_k_serve


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    e = params["embed"][tokens]
    if cfg.scale_embedding:
        e = e * torch.tensor(math.sqrt(cfg.hidden_size), dtype=e.dtype, device=e.device)
    return e


def unembed(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head -> float32 logits (+ final softcapping)."""
    x = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_plus_one)
    if cfg.tie_word_embeddings:
        if "lm_head_q" in params:  # quantized shadow of embed.T (ops.quant)
            z = qdot(x, params["lm_head_q"]).float()
        else:
            z = (x @ params["embed"].T).float()
    else:
        z = qdot(x, params["lm_head"]).float()
    return attention_ops.apply_softcap(z, cfg.final_logit_softcap)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S]
    positions: Positions = None,
    k_cache: Optional[torch.Tensor] = None,
    v_cache: Optional[torch.Tensor] = None,
    cache_write_pos: Optional[int] = None,
):
    """Whole-model forward -> (logits [B, S, V], k_cache, v_cache). Without
    `positions` they start at cache_write_pos (or 0)."""
    if positions is None:
        positions = 0 if cache_write_pos is None else cache_write_pos
    hidden = embed(params, tokens, cfg)
    hidden, nk, nv = forward_layers(
        params["layers"], cfg, hidden, positions, k_cache, v_cache, cache_write_pos
    )
    return unembed(params, cfg, hidden), nk, nv
