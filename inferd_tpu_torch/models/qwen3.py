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
the paged PagedKVCache, whose writes scatter through the block table (rows
that must not commit to the scratch block 0).

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
steps with on-device sampling over a dense or a paged cache and reads
nothing back until the window ends. Its body, `decode_step` chained by
`decode_window`, reads and writes tensors only, so the engines and the
executors capture it as a CUDA graph (`run_window`); `window_bounds` gives
every step's kv bound, one rule for every one-session form of generation
(the lane forms pass a bound of their own: core/batch). A chain node's
decode step, `stage_step`, keeps the same contract (tensors only, a host
kv bound), so the stage executors capture it too; paged writes are planned
on the device (`paged_write_device`).

This slice covers the dense decoder of the Qwen3, Qwen2 and Llama-3
families, with unscaled, llama3 or yarn RoPE, and their mixture-of-experts
layers (Qwen3-MoE, Mixtral, GPT-OSS's expert block: `moe_mlp`). An MoE
layer keeps the reference's dense dispatch: every token goes through every
expert and the combine weights zero the experts the router did not pick,
so its shapes are static and it reads no device value (a CUDA graph
captures it). Sandwich norms and sliding windows raise NotImplementedError
naming the ROADMAP item that brings them (an adapter operand on an MoE or
sliding-window config raises, as in the reference); tensor/expert
parallelism waits for a later slice.
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
from inferd_tpu_torch.ops.quant import qdot, qeinsum
from inferd_tpu_torch.utils.profiling import span

Params = Dict[str, Any]
Positions = Union[torch.Tensor, int, None]
ROPE_SCALINGS = ("none", "llama3", "yarn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architecture features this slice of the port lacks."""
    missing = []
    if cfg.sandwich_norm:
        missing.append("sandwich norms (ROADMAP A5b)")
    if cfg.sliding_window:
        missing.append("sliding-window layers and ring KV (ROADMAP A5b)")
    if cfg.rope_scaling not in ROPE_SCALINGS:
        missing.append(f"{cfg.rope_scaling} RoPE scaling")
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
    if cfg.is_moe:
        e, mi = cfg.num_experts, cfg.moe_intermediate_size
        p["router"] = w(h, e)
        p["gate_proj"] = w(e, h, mi)
        p["up_proj"] = w(e, h, mi)
        p["down_proj"] = w(e, mi, h)
        if cfg.router_bias:
            p["router_bias"] = torch.zeros((n, e), dtype=dt, device=device)
        if cfg.moe_bias:
            p["gate_bias"] = torch.zeros((n, e, mi), dtype=dt, device=device)
            p["up_bias"] = torch.zeros((n, e, mi), dtype=dt, device=device)
            p["down_bias"] = torch.zeros((n, e, h), dtype=dt, device=device)
    else:
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


def _scaled_inv_freq(inv_freq: torch.Tensor, head_dim: int, theta: float,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """(inv_freq under cfg.rope_scaling, the factor cos and sin carry).

    "llama3" (Llama-3.1+, HF rope_utils): bands whose wavelength exceeds
    `rope_original_max_position / low_freq_factor` are slowed by
    `rope_scaling_factor`, bands shorter than `.. / high_freq_factor` keep
    their frequency, and a smooth ramp joins them. "yarn" (GPT-OSS, HF
    _compute_yarn_parameters): each band blends its frequency with the
    factor-slowed one along a ramp between the beta_fast and beta_slow
    rotation counts over the pretraining window, and cos and sin carry the
    attention factor (0.1 * ln(factor) + 1 unless the config sets one).

    Every constant is a host float from the config and every step a tensor
    op in float32, in the reference's order, so a captured step replays it
    unchanged and the CPU matches XLA's arithmetic."""
    if cfg.rope_scaling == "yarn":
        orig = float(cfg.rope_original_max_position)

        def corr_dim(rot: float) -> float:
            return (head_dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(theta))

        low, high = corr_dim(cfg.rope_beta_fast), corr_dim(cfg.rope_beta_slow)
        if cfg.rope_truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0.0), min(high, head_dim - 1.0)
        if low == high:
            high += 0.001
        band = torch.arange(head_dim // 2, dtype=torch.float32, device=inv_freq.device)
        ramp = ((band - low) / (high - low)).clamp(0.0, 1.0)
        extrap = 1.0 - ramp  # 1 where the band keeps its frequency
        inv_freq = (inv_freq / cfg.rope_scaling_factor) * (1.0 - extrap) + inv_freq * extrap
        return inv_freq, cfg.rope_attention_factor or (
            0.1 * math.log(cfg.rope_scaling_factor) + 1.0)
    if cfg.rope_scaling == "llama3":
        factor, orig = cfg.rope_scaling_factor, cfg.rope_original_max_position
        lo_f, hi_f = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
        # a scalar over a tensor is a reciprocal and a product in torch:
        # divide full tensors instead, one rounding as in the reference
        wavelen = torch.full_like(inv_freq, 2.0 * math.pi) / inv_freq
        smooth = (torch.full_like(wavelen, orig) / wavelen - lo_f) / (hi_f - lo_f)
        return torch.where(
            wavelen > orig / lo_f,
            inv_freq / factor,  # long wavelengths: slowed
            torch.where(wavelen < orig / hi_f, inv_freq,  # short wavelengths: kept
                        (1 - smooth) * inv_freq / factor + smooth * inv_freq),
        ), 1.0
    return inv_freq, 1.0


def rope_cos_sin(
    positions: torch.Tensor,  # [B, S] absolute positions
    head_dim: int,
    theta: float,
    cfg: Optional[ModelConfig] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] in float32, duplicated-halves layout
    (emb = concat(freqs, freqs)), with cfg.rope_scaling applied
    (_scaled_inv_freq)."""
    if cfg is not None and cfg.rope_scaling not in ROPE_SCALINGS:
        check_supported(cfg)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq, attn_factor = 1.0 / (theta ** exps), 1.0
    if cfg is not None:
        inv_freq, attn_factor = _scaled_inv_freq(inv_freq, head_dim, theta, cfg)
    angles = positions.float()[..., None] * inv_freq  # [B, S, D/2]
    emb = torch.cat([angles, angles], dim=-1)
    if attn_factor == 1.0:  # no multiply: two kernels fewer in every step
        return torch.cos(emb), torch.sin(emb)
    return torch.cos(emb) * attn_factor, torch.sin(emb) * attn_factor


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


def top_k_lowest_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis,
    ordered as jax.lax.top_k orders them: descending, and among equal
    values the lower index first. torch.topk promises no order among ties,
    and a tie at the k-th place would pick another expert; a stable
    descending sort does keep the lower index first, and runs inside a
    captured graph."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(cfg: ModelConfig, router_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits [T, E] f32 -> (top-k weights [T, K] f32, top-k
    indices [T, K]), in the reference's two routing modes:
      softmax_topk (Qwen3-MoE, Mixtral): probabilities over ALL experts,
        top-k selected, renormalized when cfg.norm_topk_prob;
      topk_softmax (GPT-OSS): top-k over the raw LOGITS, softmax over the
        k values selected."""
    k = cfg.num_experts_per_tok
    if cfg.moe_router_mode == "topk_softmax":
        topv, topi = top_k_lowest_first(router_logits, k)
        topw = torch.softmax(topv, dim=-1)
    else:
        probs = torch.softmax(router_logits, dim=-1)
        topw, topi = top_k_lowest_first(probs, k)
        if cfg.norm_topk_prob:
            topw = topw / topw.sum(dim=-1, keepdim=True)
    return topw, topi


def route(cfg: ModelConfig, router_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """route_topk densified to combine weights [T, E] f32 (zero where an
    expert was not picked), and the top-k indices."""
    topw, topi = route_topk(cfg, router_logits)
    comb = torch.zeros((router_logits.shape[0], cfg.num_experts), dtype=torch.float32,
                       device=router_logits.device)
    return comb.scatter_add_(1, topi, topw.float()), topi


def expert_ffn(p: Params, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    """Dense-dispatch expert feed-forward: [T, H] -> [T, E, H], every token
    through every expert (the caller's combine weights zero the experts
    not picked). Two flavours: plain SwiGLU (Qwen3-MoE, Mixtral) and
    GPT-OSS's biased clamped GLU: gate clamped above at swiglu_limit, up
    clamped to +-limit, glu = gate * sigmoid(1.702 * gate), out =
    (up + 1) * glu. The expert stacks may be quantized (ops.quant.qeinsum)."""
    # the reference's "th,ehi->tei" with the expert axis made a batch axis
    # of both operands: the product then reads each expert's [H, I] where it
    # lies (torch.einsum would copy the whole stack to contract over h)
    xe = xt.expand(cfg.num_experts, *xt.shape)
    gate = qeinsum("eth,ehi->tei", xe, p["gate_proj"])
    up = qeinsum("eth,ehi->tei", xe, p["up_proj"])
    if cfg.moe_bias:
        gate = gate + p["gate_bias"][None]
        up = up + p["up_bias"][None]
    if cfg.swiglu_limit > 0:
        lim = cfg.swiglu_limit
        gate = torch.clamp(gate, max=lim)
        up = torch.clamp(up, -lim, lim)
        act_out = (up + 1.0) * (gate * torch.sigmoid(1.702 * gate))
    else:
        act_out = F.silu(gate) * up
    expert_out = qeinsum("tei,eih->teh", act_out, p["down_proj"])
    if cfg.moe_bias:
        expert_out = expert_out + p["down_bias"][None]
    return expert_out


def moe_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Mixture-of-experts feed-forward [B, S, H] -> [B, S, H]: the router
    (never quantized) in f32, its combine weights (`route`), every
    expert's output (`expert_ffn`), summed under those weights."""
    b, s, h = x.shape
    xt = x.reshape(b * s, h)
    router_logits = (xt @ p["router"]).float()  # [T, E]
    if cfg.router_bias:
        router_logits = router_logits + p["router_bias"].float()
    comb, _ = route(cfg, router_logits)
    expert_out = expert_ffn(p, cfg, xt)
    out = torch.einsum("teh,te->th", expert_out, comb.to(expert_out.dtype))
    return out.reshape(b, s, h)


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
    paged_write: Optional[torch.Tensor] = None,  # [B, S] flat pool slots (paged_write_device)
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
    every row of the chunk scatters to its flat pool slot in `paged_write`
    (computed once per forward on the device by paged_write_device), and a
    row that must not commit (bucket padding past real_end, a lane with
    write_mask False) has its slot in the reserved scratch block 0, which
    no query attends: blocks are shared property. The reference drops
    those writes with an out-of-range scatter index (mode="drop"), which
    torch has no counterpart of. Then attention reads through the table:
    the paged decode kernel at S == 1, and for a chunk (S > 1) flash_gqa
    over the gathered view (the reference runs its composite there), so no
    attention on the card runs outside a hand-written kernel.

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
            kf[paged_write] = _to_cache_dtype(k, kf.dtype)
            vf[paged_write] = _to_cache_dtype(v, vf.dtype)
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
    if cfg.is_moe:  # forward_layers refuses an adapter operand here
        mlp_out = moe_mlp(lp, cfg, x)
    else:
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
    paged_write: Optional[torch.Tensor] = None,  # [B, S] pool slots (paged only)
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
        with span("qwen3.layer"):
            lp = {name: a[i] for name, a in layers.items()}
            hidden, _, _ = decoder_layer(
                lp, cfg, hidden, cos, sin, pos,
                None if k_cache is None else k_cache[i],
                None if v_cache is None else v_cache[i],
                cache_write_pos, q_start=q_start, block_table=block_table,
                paged_write=paged_write, adapters=lane_adapters(i), kv_bound=kv_bound,
            )
    return hidden, k_cache, v_cache


def _host_rows(x, b: int) -> Optional[np.ndarray]:
    """int or [B] host values (list, numpy, CPU tensor) -> int64 numpy [B];
    None stays None. No device value is read here."""
    if x is None:
        return None
    a = np.asarray(x, dtype=np.int64)
    return np.broadcast_to(a, (b,)) if a.ndim == 0 else a


def paged_write_device(
    table: torch.Tensor,  # [B, W] int32 on the pools' device
    block_size: int,
    write_pos,  # int, or [B] int64 on the device: each row's first position
    s: int,
    real_end=None,  # None, int, or [B] on the device: first padding position
    write_mask: Optional[torch.Tensor] = None,  # [B] bool on the device: rows that commit
) -> torch.Tensor:
    """Flat pool slots [B, S] of a chunk's K/V rows (slot = block * bs +
    offset), computed on the device: the reference's paged write
    (inferd_tpu/models/qwen3.py's decoder_layer). Row (b, i) sits at
    position p = write_pos[b] + i, in chain slot p // bs of row b's table;
    a row that must not commit (p >= real_end, write_mask False, or a chain
    slot past the table) goes to block 0, the reserved scratch block that
    no query attends, where the reference scatters to NB and drops the
    write. Reads no device value and uploads nothing, so a CUDA graph can
    capture it. The host checks that a committing row stays inside the
    table before dispatch (the executors' admission, forward_layers_cached)."""
    b, w = table.shape
    dev = table.device
    if isinstance(write_pos, int):
        write_pos = torch.full((b,), write_pos, dtype=torch.int64, device=dev)
    pos = write_pos.reshape(b, 1) + torch.arange(s, device=dev)[None, :]  # [B, S]
    chain = pos // block_size
    ok = chain < w
    if real_end is not None:
        re = real_end if isinstance(real_end, int) else real_end.reshape(b, 1)
        ok = ok & (pos < re)
    if write_mask is not None:
        ok = ok & write_mask.reshape(b, 1)
    blk = table.gather(1, chain.clamp(max=w - 1)).long()
    return torch.where(ok, blk, 0) * block_size + pos % block_size


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
    None each row's queries run contiguously from its write position. A
    paged write's committing rows are checked against the table on the
    host (a BufferError before any dispatch), and its slots computed on the
    device (paged_write_device)."""
    from inferd_tpu_torch.core.cache import PagedKVCache, host_to_device

    b, s = hidden.shape[:2]
    paged = isinstance(cache, PagedKVCache)
    wp = cache_write_pos
    wp_host = _host_rows(wp, b)
    if paged:
        re_host = wp_host + s if real_end is None else np.minimum(_host_rows(real_end, b),
                                                                   wp_host + s)
        commit = re_host > wp_host
        if write_mask is not None:
            commit &= np.asarray(write_mask, bool).reshape(b)
        top = int(re_host[commit].max(initial=0))
        if top > cache.table.shape[1] * cache.block_size:
            raise BufferError(
                f"paged KV write at position {top - 1} past the table "
                f"({cache.table.shape[1]} blocks of {cache.block_size})"
            )
    if not isinstance(wp, int):
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
    dev = hidden.device
    re = None
    if real_end is not None:
        re = real_end if isinstance(real_end, int) else host_to_device(_host_rows(real_end, b),
                                                                       dev)
    wm = None if write_mask is None else host_to_device(np.asarray(write_mask, bool).reshape(b),
                                                        dev)
    dest = paged_write_device(cache.table, cache.block_size, wp, s, re, wm)
    h, _, _ = forward_layers(
        layers, cfg, hidden, positions, cache.k, cache.v, wp, layer_offset=layer_offset,
        block_table=cache.table, paged_write=dest, adapters=adapters,
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


def stage_step(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # tokens [B, 1] int64 (first stage) or hidden [B, 1, H]
    k_cache: torch.Tensor,  # [L, B, T, Nkv, D] dense, or pools [L, NB, bs, Nkv, D]
    v_cache: torch.Tensor,
    fill: torch.Tensor,  # [B] int64 on the device: each row's position and write slot
    *,
    first: bool,  # the stage embeds tokens
    last: bool,  # the stage unembeds its row
    kv_bound: Optional[int] = None,  # dense: host bound on every live row's kv length
    table: Optional[torch.Tensor] = None,  # [B, W] int32: the pools' block table (paged)
    write_mask: Optional[torch.Tensor] = None,  # [B] bool on the device (paged): rows that commit
    adapters=None,  # multi-tenant LoRA pools + per-lane ids (see forward_layers)
) -> torch.Tensor:
    """One decode step of a pipeline stage, one token per row, over tensors
    only: the embed (first stage) or the hidden rows, the stage's layers at
    device positions fill[:, None] writing each row's K/V at its fill (a
    dense cache) or through paged_write_device (a paged one, rows with
    write_mask False to scratch), then the float32 logits [B, V] of the
    row (last stage) or its hidden state [B, 1, H]. Like decode_step it
    reads no device value on the host and uploads nothing, so the stage
    executors capture it as a CUDA graph (runtime/executor,
    runtime/stage_batch); its host values (`kv_bound`, the table's width,
    first/last) are fixed by the capture and belong in the graph's key.
    The caller checks every write's room on the host before the step."""
    hidden = embed(params, x, cfg) if first else x
    dest = None
    if table is not None:
        dest = paged_write_device(table, k_cache.shape[2], fill, 1, write_mask=write_mask)
    hidden, _, _ = forward_layers(
        params["layers"], cfg, hidden, fill[:, None], k_cache, v_cache, fill,
        block_table=table, paged_write=dest, adapters=adapters, kv_bound=kv_bound,
    )
    if last:
        return unembed(params, cfg, hidden)[:, 0]
    return hidden


# The kv bound a decode step's attention is launched with (flash_gqa's
# `kv_bound` hint, a launch parameter that a captured graph fixes): the
# power of two at or above the step's kv length, at least KV_BUCKET_MIN,
# capped at the buffer. The split-KV route's split spans at least 2 tiles
# of 32 slots, so a bound under 64 saves nothing; doubling buckets keep the
# graphs few (one per power of two the fill crosses) at the cost of CTAs
# past the frontier that write an empty partial.
KV_BUCKET_MIN = 64


def kv_bucket(kv_len: int, max_len: int) -> int:
    """The kv bound of a step whose rows attend at most `kv_len` slots."""
    b = KV_BUCKET_MIN
    while b < kv_len:
        b *= 2
    return min(b, max_len)


def window_bounds(fill: int, k: int, max_len: int) -> Tuple[int, ...]:
    """The kv bound of each of k steps from a host fill (every row's fill
    at most `fill`): step j attends fill + j + 1 slots at most. Every form
    of generation derives its bounds here, so a step at one fill gets one
    bound, whichever form runs it, and the same kernels' split plans."""
    return tuple(kv_bucket(fill + j + 1, max_len) for j in range(k))


def decode_step(
    params: Params,
    cfg: ModelConfig,
    k_cache: torch.Tensor,  # [L, B, T, Nkv, D], written in place
    v_cache: torch.Tensor,
    tok: torch.Tensor,  # [B] int64: each row's last emitted token
    fill: torch.Tensor,  # [B] int64: each row's KV fill (its next write slot)
    active: torch.Tensor,  # [B] bool: rows that advance
    eos: Optional[torch.Tensor],  # [B] int64, < 0 disables; or None
    u: Optional[torch.Tensor],  # [B, candidate_count] uniforms (sampled), or None
    kv_bound: int,  # host bound on every row's kv length this step (window_bounds)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
    top_n: int = 0,
    want_lp: bool = False,
    adapters=None,
    table: Optional[torch.Tensor] = None,  # [B, W] int32: the caches are paged pools
):
    """One decode step over tensors only: embed, the layers with device
    positions and writes, unembed, the sample from the given uniforms, the
    freeze of inactive rows, logprob_topn, and the advance. It reads no
    device value on the host and uploads nothing, so a CUDA graph can
    capture it. Returns (tok' [B], fill' [B], active' [B], lp [B], top ids
    [B, top_n], top lps [B, top_n]).

    A frozen row re-emits its token and computes garbage at its frontier
    slot, which its next real step overwrites before a query reads it; with
    `eos` a row deactivates the step AFTER it emits its stop token. Over
    paged pools (`table`) every row writes through paged_write_device with
    `active` as its write mask, so an inactive or frozen row writes to the
    scratch block 0 (blocks are shared property), and attends through the
    table (paged_decode_gqa); `kv_bound` does not apply there."""
    from inferd_tpu_torch.core import sampling as samplib

    hidden = embed(params, tok[:, None], cfg)
    dest = None
    if table is not None:
        dest = paged_write_device(table, k_cache.shape[2], fill, 1, write_mask=active)
    hidden, _, _ = forward_layers(
        params["layers"], cfg, hidden, fill[:, None], k_cache, v_cache, fill,
        block_table=table, paged_write=dest, adapters=adapters, kv_bound=kv_bound,
    )
    last = unembed(params, cfg, hidden)[:, 0]  # [B, V]
    if temperature == 0.0:
        ntok = torch.argmax(last, dim=-1)
    else:
        ntok = samplib.sample_from_uniforms(last, u, temperature, top_k, top_p, min_p)
    ntok = torch.where(active, ntok, tok)  # frozen rows re-emit their token
    if want_lp:
        lp, ti, tl = samplib.logprob_topn(last, ntok, top_n)
    else:
        b = tok.shape[0]
        lp = torch.zeros(b, dtype=torch.float32, device=tok.device)
        ti = torch.zeros((b, 0), dtype=torch.int32, device=tok.device)
        tl = torch.zeros((b, 0), dtype=torch.float32, device=tok.device)
    fill = fill + active.long()
    if eos is not None:
        active = active & ((eos < 0) | (ntok != eos))
    return ntok, fill, active, lp, ti, tl


def decode_window(
    params: Params,
    cfg: ModelConfig,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    tok: torch.Tensor,
    fill: torch.Tensor,
    active: torch.Tensor,
    eos: Optional[torch.Tensor],
    u: Optional[torch.Tensor],  # [K, B, candidate_count] (sampled), or None
    bounds: Tuple[int, ...],  # window_bounds: one kv bound per step
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
    top_n: int = 0,
    want_lp: bool = False,
    adapters=None,
    table: Optional[torch.Tensor] = None,  # [B, W]: paged pools (decode_step)
):
    """len(bounds) decode_steps chained on the device, step j from u[j]:
    what run_window runs, eagerly or captured as one graph.
    Returns (seq [K, B], fill' [B], active' [B], lps [K, B], top ids
    [K, B, top_n], top lps [K, B, top_n])."""
    seq, lps, tis, tls = [], [], [], []
    for j, bound in enumerate(bounds):
        tok, fill, active, lp, ti, tl = decode_step(
            params, cfg, k_cache, v_cache, tok, fill, active, eos,
            None if u is None else u[j], bound, temperature, top_k, top_p, min_p,
            top_n, want_lp, adapters, table)
        seq.append(tok)
        lps.append(lp)
        tis.append(ti)
        tls.append(tl)
    return (torch.stack(seq), fill, active, torch.stack(lps), torch.stack(tis),
            torch.stack(tls))


def run_window(graphs, params: Params, cfg: ModelConfig, cache,
               inputs: Dict[str, torch.Tensor], bounds: Tuple[int, ...],
               sampling: Tuple[float, int, float, float], top_n: int, want_lp: bool,
               adapters=None):
    """decode_window over `cache` (core.cache.KVCache, or a PagedKVCache
    whose table rides in `inputs`) from device or host-staged inputs
    {"tok", "fill", "active" [B], optional "eos" [B], "u" [K, B, n] when
    sampled, "table" [B, W] when paged}: a replay of the graph keyed by
    (buffer, bounds, sampling, top_n, want_lp, the inputs' names and
    shapes, the adapter pools' address) from `graphs` (a
    utils.cuda_graph.GraphCache), or eager when `graphs` is None. The one
    window runner: the engines' steps and windows, and decode_k (the
    executors' `decode_steps`), all come here.

    Tenant lanes (`adapters`, the registry's pools plus per-lane "ids"):
    the ids are a static input, the pools are read by address. The
    registry allocates them once and writes them in place
    (runtime/adapters), so the address in the key names them for good.
    Returns device tensors the caller owns (seq [K, B], fill', active',
    lps [K, B], top ids, top lps)."""
    from inferd_tpu_torch.utils.cuda_graph import run_step

    inputs = dict(inputs)
    pools, pools_at = None, None
    if adapters is not None:
        pools = {k: v for k, v in adapters.items() if k != "ids"}
        inputs["ids"] = adapters["ids"]
        pools_at = pools["scale"].data_ptr()

    def window(tok, fill, active, eos=None, u=None, table=None, ids=None):
        ads = None if ids is None else {**pools, "ids": ids}
        return decode_window(params, cfg, cache.k, cache.v, tok, fill, active, eos, u, bounds,
                             *sampling, top_n, want_lp, ads, table)

    key = (cache.k.data_ptr(), tuple(cache.k.shape), bounds, sampling, top_n, want_lp,
           tuple((n, tuple(inputs[n].shape)) for n in sorted(inputs)), pools_at)
    out = run_step(graphs, key, window, inputs, cache.k.device)
    return out if graphs is None else tuple(t.clone() for t in out)


def window_uniforms(cfg: ModelConfig, keys, k: int, top_k: int, device):
    """(keys' [B, 2], u [K, B, n_cand]) of a sampled K-step window: each
    row's key chained k times (`keys, sub = split_keys(keys)`) and step j's
    uniforms drawn per row from its subkey, one generator per row, on the
    host's side of the window (a graph replays none of it)."""
    from inferd_tpu_torch.core import sampling as samplib

    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    subs = []
    for _ in range(k):
        keys, sub = samplib.split_keys(keys)
        subs.append(sub)
    n_cand = samplib.candidate_count(cfg.vocab_size, top_k)
    return keys, torch.stack([torch.cat([samplib.uniforms(sb, (1, n_cand), device) for sb in sub])
                              for sub in subs])


def decode_k(
    params: Params,
    cfg: ModelConfig,
    toks,  # [B] int: each row's last emitted token (host or device)
    cache,  # core.cache.KVCache with batch B, or a PagedKVCache with a [B, W] table
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
    graphs=None,  # utils.cuda_graph.GraphCache: the window as a graph replay
    kv_bound: Optional[int] = None,  # dense: one bound for every step (lane forms)
):
    """K decode steps with sampling and every KV write on the device: the
    host reads the window's outputs once, at its end (port of
    inferd_tpu/models/qwen3.decode_k, whose per-row semantics hold here):

      * positions and masks come from each row's fill, not cache.length:
        a frozen row computes garbage at its frozen frontier slot, which its
        next real step overwrites before any query can read it (paged: it
        writes to the scratch block, as an inactive row does);
      * a row's fill advances only while it is active; `n_new` counts those
        advances;
      * with `eos` >= 0 a row deactivates the step AFTER it emits its stop
        token (the token itself is emitted and counted); frozen rows
        re-emit their token;
      * sampled rows chain `key, sub = split_key(key)` every step, frozen
        rows too (greedy leaves the keys as they are), so a window gives the
        tokens of K single steps from the same keys.

    The host prepares the window (the uploads, every key split, the
    uniforms of every step, each step's kv bound), then run_window runs
    decode_window: a replay from `graphs`, or eagerly when it is None. Each
    row's fill stays on the device (eos can freeze a row), so the attention
    gets its spans as device columns plus the step's host bound: from
    window_bounds at the highest ACTIVE row's fill, or `kv_bound` for every
    step when given (the lane forms: a lane's bits then do not depend on
    which lanes share its window). A dense row that is inactive writes its
    garbage at its own fill, clamped to the buffer's last slot (a full idle
    lane's last slot, which only a replay below it reads, and a replay
    rewrites it first).

    A paged cache's table (host or device, [B, W], e.g. core.cache.
    sync_paged's) is a static input of the graph; every step attends through
    it at its width W, which is the window's bound. The caller has ensured
    every active row's chain up to fill + k and made those blocks writable
    (copy-on-write) before the call: decode_k only checks that the window's
    committing writes stay inside the table (a BufferError before any
    dispatch).

    Returns (cache, seq [k, B], n_new [B], keys' [B, 2], lps [k, B],
    top_ids [k, B, top_n], top_lps [k, B, top_n]); keys' is a host uint32
    array, the rest are tensors on the cache's device. The cache is
    written in place and its `length` left to the caller."""
    from inferd_tpu_torch.core.cache import (
        PagedKVCache, device_column, host_staged, host_to_device)

    dev = cache.k.device
    paged = isinstance(cache, PagedKVCache)
    lens_host = np.asarray(lengths, dtype=np.int64).reshape(-1)
    b = lens_host.shape[0]
    act_host = (None if isinstance(active, torch.Tensor) and active.device.type != "cpu"
                else np.broadcast_to(np.asarray(active, bool), (b,)))
    live = lens_host if act_host is None else lens_host[act_host]
    top = int(live.max(initial=0))
    cap = cache.max_len
    if top + k > cap:
        raise BufferError(f"decode_k: {k} steps from fill {top} past the "
                          f"{'table' if paged else 'buffer'} ({cap})")
    if not paged and act_host is not None:
        # an inactive row writes at its fill: keep it inside the buffer
        lens_host = np.where(act_host, lens_host, np.minimum(lens_host, cap - 1))
    inputs = {"tok": device_column(toks, b, torch.int64, dev),
              "fill": host_staged(lens_host, dev),
              "active": device_column(active, b, torch.bool, dev)}
    if eos is not None:
        inputs["eos"] = device_column(eos, b, torch.int64, dev)
    if paged:
        inputs["table"] = cache.table
        bounds = (cap,) * k
    else:
        bounds = (window_bounds(top, k, cap) if kv_bound is None
                  else (min(kv_bound, cap),) * k)
    keys = np.asarray(keys, dtype=np.uint32).reshape(b, 2)
    if temperature != 0.0:
        keys, inputs["u"] = window_uniforms(cfg, keys, k, top_k, dev)
    seq, fill, _act, lps, tis, tls = run_window(
        graphs, params, cfg, cache, inputs, bounds, (temperature, top_k, top_p, min_p), top_n,
        want_lp, adapters)
    return cache, seq, fill - host_to_device(lens_host, dev), keys, lps, tis, tls


def make_decode_k_serve(cfg: ModelConfig):
    """The serving form of decode_k, with the reference's dispatch contract
    (params, cache, toks, lengths, active, keys, eos, k, t, tk, tp, mp,
    ads=None) -> (cache, seq [k, L], n_new [L], keys' [L, 2]): sampling
    parameters per request and a per-lane `eos` [L] that deactivates a
    lane in the window the step after its stop token. Its consumers are
    the lane executors' K-step items (runtime/executor.fuse_kstep_group:
    core/batch.BatchedEngine for runtime/batch_executor, and a whole-model
    runtime/stage_batch executor); `graphs` and `kv_bound` pass through to
    decode_k (a graph replay per window on a card; the lanes' bound)."""

    def decode_k_serve(params, cache, toks, lengths, active, keys, eos, k: int,
                       temperature: float, top_k: int, top_p: float, min_p: float,
                       ads=None, graphs=None, kv_bound=None):
        cache, seq, n_new, keys, _lps, _tis, _tls = decode_k(
            params, cfg, toks, cache, lengths, active, keys, k, temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p, eos=eos, adapters=ads, graphs=graphs,
            kv_bound=kv_bound,
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
