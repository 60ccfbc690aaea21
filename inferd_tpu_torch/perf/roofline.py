"""Analytic roofline cost model for a decode step (port of
inferd_tpu/perf/roofline.py).

From any `ModelConfig` + quant mode + KV dtype + context + batch: the
device-memory bytes one decode step must move and the FLOPs it must
execute, then, against a chip table, the floor ms per step and the
ceiling tok/s. The byte and FLOP counts are the reference's, field for
field (tests/test_torch_roofline.py holds them equal):

  * batch-1 decode is bound by memory: every resident weight byte that the
    step's products touch is read once per token. Quantized linears count
    their stored bytes (intN + float32 scales), not their bf16 size.
  * The embedding table is a full read only when it is also the unembed
    matrix (tied, unquantized). A quantized tied model reads the
    `lm_head_q` shadow instead and only gathers batch x H bytes of the
    table.
  * MoE layers count the router and the `num_experts_per_tok` active
    experts.
  * The KV read is 2 x L x ctx x kv_dim x itemsize(kv_dtype) per sequence;
    the KV write is one slot per layer.

What differs: dtype sizes come from `torch.dtype.itemsize`, and the chip
table holds the H100 (and a CPU placeholder), not the TPU generations.
Nothing here touches a device: `detect_chip()` asks torch for the card's
name, `CHIP_SPECS[...]` does not, so `python -m inferd_tpu_torch.perf
report` runs on a host without a card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from inferd_tpu_torch.config import ModelConfig, dtype_of
from inferd_tpu_torch.ops.quant import _group_size

# CLI-facing quant flags (ops.quant.QUANT_CHOICES). w8a8 and int8-kernel
# store the same bytes as int8; w8a8 contracts at the int8 peak.
QUANT_MODES = ("none", "int8", "w8a8", "int8-kernel", "int4")

_SCALE_BYTES = 4  # every quant scheme stores float32 scales
INT4_GROUP = 128  # ops.quant.quantize_int4's default group size


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published peak numbers for one accelerator. The roofline is a
    ceiling model, so the data sheet's nominal values are the constants."""

    key: str
    description: str
    hbm_gbps: float  # device-memory bandwidth, GB/s
    peak_bf16_tflops: float  # dense bf16 tensor-core peak, TFLOP/s
    peak_int8_tops: float  # dense int8 tensor-core peak, TOP/s
    hbm_gib: float  # device-memory capacity, GiB


CHIP_SPECS: Dict[str, ChipSpec] = {
    s.key: s
    for s in [
        # NVIDIA H100 SXM5 80GB data sheet, dense rates (no sparsity), at its
        # 700 W power limit: HBM3 3.35 TB/s, bf16 989 TFLOP/s, int8 1979 TOP/s,
        # 80 GB (= 74.5 GiB)
        ChipSpec("h100", "NVIDIA H100 SXM5 80GB", 3350.0, 989.0, 1979.0, 80e9 / 2 ** 30),
        # Order-of-magnitude placeholder so CPU runs of the report and the
        # anatomy have a denominator; never used for a claim.
        ChipSpec("cpu", "host CPU (nominal)", 20.0, 0.2, 0.4, 64.0),
    ]
}

# torch.cuda.get_device_name() substring -> chip key (first match wins)
_NAME_MAP = (("h100", "h100"),)


def detect_chip() -> ChipSpec:
    """ChipSpec of the attached card (`torch.cuda.get_device_name(0)`), or
    the CPU placeholder on a host without one. An unknown card raises: its
    bound would otherwise be another chip's."""
    if not torch.cuda.is_available():
        return CHIP_SPECS["cpu"]
    return chip_for_name(torch.cuda.get_device_name(0))


def chip_for_name(name: str) -> ChipSpec:
    """ChipSpec for a CUDA device name; raises for a card the table lacks."""
    low = name.lower()
    for needle, key in _NAME_MAP:
        if needle in low:
            return CHIP_SPECS[key]
    raise KeyError(f"no chip spec for device {name!r}; the table has {sorted(CHIP_SPECS)}")


def get_chip(key: str) -> ChipSpec:
    try:
        return CHIP_SPECS[key.lower()]
    except KeyError:
        raise KeyError(f"unknown chip {key!r}; have {sorted(CHIP_SPECS)}")


# ---------------------------------------------------------------------------
# Per-step cost
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Bytes moved and FLOPs executed by ONE decode step (all sequences of
    the batch together). Byte fields are device-memory reads unless named
    otherwise."""

    cfg_name: str
    quant: str
    kv_dtype: str
    ctx: int
    batch: int
    embed_gather_bytes: int
    attn_weight_bytes: int
    mlp_weight_bytes: int
    head_bytes: int
    norm_bytes: int
    kv_read_bytes: int
    kv_write_bytes: int
    matmul_flops: int
    attn_flops: int

    @property
    def weight_bytes(self) -> int:
        return self.attn_weight_bytes + self.mlp_weight_bytes + self.head_bytes + self.norm_bytes

    @property
    def read_bytes(self) -> int:
        return self.weight_bytes + self.embed_gather_bytes + self.kv_read_bytes

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.kv_write_bytes

    @property
    def flops(self) -> int:
        return self.matmul_flops + self.attn_flops


def _linear_bytes(k: int, n: int, quant: str, dsize: int) -> int:
    """Stored bytes of one [K, N] linear under a quant mode: int8 one byte
    per weight + f32 per-output-channel scales; int4 nibble-packed when K
    is even + f32 per-(group, output) scales."""
    if quant == "none":
        return k * n * dsize
    if quant in ("int8", "w8a8", "int8-kernel"):
        return k * n + _SCALE_BYTES * n
    if quant == "int4":
        body = (k // 2) * n if k % 2 == 0 else k * n
        groups = k // _group_size(k, INT4_GROUP)
        return body + _SCALE_BYTES * groups * n
    raise ValueError(f"unknown quant mode {quant!r}; have {QUANT_MODES}")


def _linear_flops(k: int, n: int, batch: int) -> int:
    return 2 * batch * k * n


def _itemsize(name: str) -> int:
    return dtype_of(name).itemsize


def decode_step_cost(
    cfg: ModelConfig,
    quant: str = "none",
    kv_dtype: Optional[str] = None,
    ctx: int = 0,
    batch: int = 1,
) -> StepCost:
    """Cost of one decode step (S = 1 per sequence) for `batch` sequences
    attending over `ctx` cached tokens each. `kv_dtype` overrides the
    config's KV storage dtype ("model" = the model dtype); `quant` is the
    run_node --quant vocabulary."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; have {QUANT_MODES}")
    h, d, n_layers = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    qd, kvd = cfg.q_dim, cfg.kv_dim
    dsize = _itemsize(cfg.dtype)
    if kv_dtype is None:
        kv_size = cfg.kv_torch_dtype.itemsize
    else:
        kv_size = _itemsize(cfg.dtype if kv_dtype == "model" else kv_dtype)

    attn_shapes = ((h, qd), (h, kvd), (h, kvd), (qd, h))
    attn_b = sum(_linear_bytes(kk, nn, quant, dsize) for kk, nn in attn_shapes)
    attn_f = sum(_linear_flops(kk, nn, batch) for kk, nn in attn_shapes)
    if cfg.attn_bias:
        attn_b += (qd + 2 * kvd) * dsize
    if cfg.o_bias:
        attn_b += h * dsize
    if cfg.attn_sinks:
        attn_b += cfg.num_heads * dsize
    attn_b *= n_layers
    attn_f *= n_layers

    if cfg.is_moe:
        e, mi, act = cfg.num_experts, cfg.moe_intermediate_size, cfg.num_experts_per_tok
        expert_shapes = ((h, mi), (h, mi), (mi, h))
        mlp_b = h * e * dsize  # router (never quantized)
        mlp_f = _linear_flops(h, e, batch)
        per_expert_b = sum(_linear_bytes(kk, nn, quant, dsize) for kk, nn in expert_shapes)
        per_expert_f = sum(_linear_flops(kk, nn, batch) for kk, nn in expert_shapes)
        if cfg.moe_bias:
            per_expert_b += (2 * mi + h) * dsize
        if cfg.router_bias:
            mlp_b += e * dsize
        mlp_b += act * per_expert_b
        mlp_f += act * per_expert_f
    else:
        i = cfg.intermediate_size
        mlp_shapes = ((h, i), (h, i), (i, h))
        mlp_b = sum(_linear_bytes(kk, nn, quant, dsize) for kk, nn in mlp_shapes)
        mlp_f = sum(_linear_flops(kk, nn, batch) for kk, nn in mlp_shapes)
    mlp_b *= n_layers
    mlp_f *= n_layers

    per_layer_norms = 2 * h + (2 * h if cfg.sandwich_norm else 0)
    if cfg.qk_norm:
        per_layer_norms += 2 * d
    norm_b = (n_layers * per_layer_norms + h) * dsize  # + final_norm

    if cfg.tie_word_embeddings and quant == "none":
        head_b = h * cfg.vocab_size * dsize  # the table IS the unembed matrix
    else:  # an untied head, or the quantized shadow of a tied one
        head_b = _linear_bytes(h, cfg.vocab_size, quant, dsize)
    head_f = _linear_flops(h, cfg.vocab_size, batch)

    return StepCost(
        cfg_name=cfg.name,
        quant=quant,
        kv_dtype=(kv_dtype or cfg.kv_dtype),
        ctx=ctx,
        batch=batch,
        embed_gather_bytes=batch * h * dsize,
        attn_weight_bytes=attn_b,
        mlp_weight_bytes=mlp_b,
        head_bytes=head_b,
        norm_bytes=norm_b,
        kv_read_bytes=2 * n_layers * ctx * kvd * kv_size * batch,
        kv_write_bytes=2 * n_layers * kvd * kv_size * batch,
        matmul_flops=attn_f + mlp_f + head_f,
        # two [1, d] x [d, ctx] products per head and layer
        attn_flops=4 * batch * n_layers * ctx * cfg.num_heads * d,
    )


# ---------------------------------------------------------------------------
# Kernel byte models at explicit shapes: each kernel against the plain
# composite it replaces (the reference's XLA sibling)
# ---------------------------------------------------------------------------


def _pow2_bucket(n: int) -> int:
    """The power-of-two bucketing of the reference's BlockPool.chain_clamp."""
    b = 1
    while b < n:
        b <<= 1
    return b


def paged_attn_step_bytes(
    batch: int,
    ctx: int,
    kv_dim: int,  # Nkv * D
    kv_size: int,  # bytes per KV element (2 bf16, 1 fp8)
    block_size: int,
    table_blocks: int,  # MB: the table's width
) -> Dict[str, int]:
    """Per-layer KV bytes of one paged decode-attention step.

    xla (gather + dense attention): reads the clamped table width's blocks,
    writes the dense gathered copy and reads it back: three passes over the
    gather width (the power-of-two bucket of the longest chain).

    kernel (the chain walk): each lane's live chain blocks once, plus one
    scratch-block fetch per lane."""
    chain = -(-ctx // block_size)
    t_gather = min(_pow2_bucket(chain), table_blocks) * block_size
    xla = 3 * 2 * batch * t_gather * kv_dim * kv_size
    kernel = 2 * batch * (chain + 1) * block_size * kv_dim * kv_size
    return {"kernel": kernel, "xla": xla}


def quant_matvec_bytes(k: int, n: int, scheme: str) -> Dict[str, int]:
    """Weight bytes of one [1, K] x [K, N] decode matvec ("int8" | "int4").

    kernel: only the quantized weight and its f32 scales cross memory.
    xla (dequant then product): the quantized read plus a bf16 copy written
    and read back."""
    dsize = 2  # the widened bf16 operand
    if scheme == "int8":
        q_bytes = k * n + _SCALE_BYTES * n
    elif scheme == "int4":
        q_bytes = (k // 2) * n if k % 2 == 0 else k * n
        q_bytes += _SCALE_BYTES * (k // _group_size(k, INT4_GROUP)) * n
    else:
        raise ValueError(f"unknown quant kernel scheme {scheme!r}")
    return {"kernel": q_bytes, "xla": q_bytes + 2 * dsize * k * n}


def lora_delta_step_bytes(
    batch: int, d_in: int, rank: int, d_out: int, pool_dsize: int = 4,
) -> Dict[str, int]:
    """Adapter-pool bytes of one layer's LoRA lane delta at ONE projection.

    kernel: each lane's own [in, r] and [r, out] matrices once, through its
    slot id. xla (gather, then the delta): the gather reads them, writes
    per-lane copies, and the delta reads those back: three passes."""
    row = batch * (d_in * rank + rank * d_out) * pool_dsize
    return {"kernel": row, "xla": 3 * row}


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Floor and ceiling of one StepCost on one chip."""

    cost: StepCost
    chip: ChipSpec
    hbm_ms: float  # the step's bytes at peak bandwidth
    compute_ms: float  # the step's FLOPs at peak
    floor_ms: float  # the larger of the two: no step can beat it
    ceiling_tok_s: float  # aggregate tok/s ceiling (batch / floor)
    bound: str  # "hbm" | "flops"


def roofline(cost: StepCost, chip: ChipSpec) -> Roofline:
    hbm_s = cost.total_bytes / (chip.hbm_gbps * 1e9)
    # w8a8 contracts int8 x int8; every other mode runs its products in bf16
    peak = (chip.peak_int8_tops if cost.quant == "w8a8" else chip.peak_bf16_tflops) * 1e12
    comp_s = cost.flops / peak
    floor_s = max(hbm_s, comp_s, 1e-12)
    return Roofline(
        cost=cost,
        chip=chip,
        hbm_ms=hbm_s * 1e3,
        compute_ms=comp_s * 1e3,
        floor_ms=floor_s * 1e3,
        ceiling_tok_s=cost.batch / floor_s,
        bound="hbm" if hbm_s >= comp_s else "flops",
    )


def roofline_frac(measured_tok_s: float, cost: StepCost, chip: ChipSpec) -> float:
    """The share of the ceiling that a measured aggregate tok/s reaches."""
    return measured_tok_s / roofline(cost, chip).ceiling_tok_s


def format_report(
    cfg: ModelConfig,
    chip: ChipSpec,
    ctx: int = 0,
    batch: int = 1,
    kv_dtypes=("model", "float8_e4m3fn"),
) -> str:
    """The roofline table, quant modes x KV dtypes, for one preset on one
    chip: a plain string the CLI prints and the tests parse."""
    lines = [
        f"roofline: {cfg.name}  chip={chip.key} ({chip.description}, "
        f"{chip.hbm_gbps:.0f} GB/s HBM, {chip.peak_bf16_tflops:.0f} TF bf16)  "
        f"ctx={ctx} batch={batch}",
        f"{'quant':<12} {'kv_dtype':<15} {'read MB/step':>12} "
        f"{'floor ms':>9} {'ceiling tok/s':>14} {'bound':>6}",
    ]
    for quant in QUANT_MODES:
        for kvd in kv_dtypes:
            if ctx == 0 and kvd != kv_dtypes[0]:
                continue  # the KV dtype is irrelevant with an empty cache
            c = decode_step_cost(cfg, quant=quant, kv_dtype=kvd, ctx=ctx, batch=batch)
            r = roofline(c, chip)
            lines.append(
                f"{quant:<12} {c.kv_dtype:<15} {c.total_bytes / 1e6:>12.1f} "
                f"{r.floor_ms:>9.3f} {r.ceiling_tok_s:>14.1f} {r.bound:>6}"
            )
    return "\n".join(lines)
