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
(the CUDA kernel on the card); `attn_impl="xla"` selects the composite
`gqa_attention` instead, as in the JAX package.

This slice covers the dense Qwen3/Qwen2-style decoder with a uniform KV
cache. MoE, sandwich norms, sliding windows, scaled RoPE, paged KV, LoRA,
quantization, tensor/expert parallelism and fused K-step decode wait for
later slices and raise NotImplementedError here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.ops import attention as attention_ops

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
) -> torch.Tensor:
    """Composite grouped-query attention with causal masking over a
    (possibly oversized) KV buffer: slot j attends iff j < kv_valid_len AND
    its absolute position <= the query's. Softmax in float32, matmuls in
    the input dtype. A fully masked row gets the mean of V (the flash
    contract gives zeros there)."""
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


def swiglu_mlp(p: Params, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    """Gated feed-forward: act(x @ gate) * (x @ up) @ down."""
    return (act(x @ p["gate_proj"]) * (x @ p["up_proj"])) @ p["down_proj"]


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
        window=window, sinks=sinks,
    )


def decoder_layer(
    lp: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [B, S, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    k_buf: Optional[torch.Tensor],  # [B, T, Nkv, D] or None (no cache: T == S)
    v_buf: Optional[torch.Tensor],
    cache_write_pos: Optional[int],  # slot where the chunk's k/v go
    window=None,
    q_start=None,  # int or [B]: first query position (see _attend)
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One pre-norm residual decoder block with GQA and Qwen3's per-head
    q/k RMSNorm. Returns (hidden', k_buf, v_buf); the chunk's K/V are
    written into k_buf/v_buf IN PLACE. With k_buf None the layer runs
    cache-free over the chunk itself.

    Caller contract: cache_write_pos + S <= T (the runtime checks room
    before dispatch; an overlong write raises here instead of clamping)."""
    b, s, _ = hidden.shape
    d = cfg.head_dim
    p1 = cfg.rms_norm_plus_one

    x = rms_norm(hidden, lp["input_norm"], cfg.rms_norm_eps, p1)
    q = x @ lp["q_proj"]
    k = x @ lp["k_proj"]
    v = x @ lp["v_proj"]
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
    else:
        end = cache_write_pos + s
        if end > k_buf.shape[1]:
            raise BufferError(
                f"KV write [{cache_write_pos}, {end}) past the buffer ({k_buf.shape[1]})"
            )
        k_buf[:, cache_write_pos:end] = _to_cache_dtype(k, k_buf.dtype)
        v_buf[:, cache_write_pos:end] = _to_cache_dtype(v, v_buf.dtype)
        attn = _attend(
            cfg, q, k_buf, v_buf, q_positions, end, window=window, sinks=sinks,
            q_start=q_start,
        )

    attn_out = attn @ lp["o_proj"]
    if cfg.o_bias:
        attn_out = attn_out + lp["o_bias"]
    hidden = hidden + attn_out.to(hidden.dtype)
    x = rms_norm(hidden, lp["post_norm"], cfg.rms_norm_eps, p1)
    mlp_out = swiglu_mlp(lp, x, act_fn(cfg))
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
    k_cache: Optional[torch.Tensor] = None,  # [L, B, T, Nkv, D]
    v_cache: Optional[torch.Tensor] = None,
    cache_write_pos: Optional[int] = None,
    layer_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run a stack of decoder layers (a Python loop over the stacked
    params). With caches, each layer writes its chunk K/V into
    k_cache[i]/v_cache[i] in place; the buffers are returned as given."""
    check_supported(cfg)
    del layer_offset  # selects the sliding-window pattern, which waits
    b, s = hidden.shape[:2]
    pos, q_start = _positions(positions, b, s, hidden.device)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg)
    for i in range(_stack_len(layers)):
        lp = {name: a[i] for name, a in layers.items()}
        hidden, _, _ = decoder_layer(
            lp, cfg, hidden, cos, sin, pos,
            None if k_cache is None else k_cache[i],
            None if v_cache is None else v_cache[i],
            cache_write_pos, q_start=q_start,
        )
    return hidden, k_cache, v_cache


def forward_layers_cached(
    layers: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,
    positions: Positions,
    cache,  # core.cache.KVCache (uniform layout)
    cache_write_pos: int,
    real_end=None,
    layer_offset: int = 0,
):
    """Cached stage/model forward over a uniform KVCache. Returns (hidden,
    the same cache, written in place, with its length unchanged: the caller
    advances it). `real_end` matters only to ring and paged layouts, which
    wait for later slices."""
    del real_end
    if not isinstance(cache_write_pos, int):
        raise TypeError("per-row cache write positions wait for the batching slice")
    h, _, _ = forward_layers(
        layers, cfg, hidden, positions, cache.k, cache.v, cache_write_pos,
        layer_offset=layer_offset,
    )
    return h, cache


def forward_cached(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S]
    positions: Positions,
    cache,
    cache_write_pos: int,
    real_end=None,
):
    """Whole-model cached forward -> (logits [B, S, V] float32, cache). With
    positions None they run contiguously from cache_write_pos."""
    if positions is None:
        positions = cache_write_pos
    hidden = embed(params, tokens, cfg)
    hidden, cache = forward_layers_cached(
        params["layers"], cfg, hidden, positions, cache, cache_write_pos, real_end,
    )
    return unembed(params, cfg, hidden), cache


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    e = params["embed"][tokens]
    if cfg.scale_embedding:
        e = e * torch.tensor(math.sqrt(cfg.hidden_size), dtype=e.dtype, device=e.device)
    return e


def unembed(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head -> float32 logits (+ final softcapping)."""
    x = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_plus_one)
    if cfg.tie_word_embeddings:
        z = (x @ params["embed"].T).float()
    else:
        z = (x @ params["lm_head"]).float()
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
