"""Weight-only quantization for decode-bandwidth-bound serving: int8 w8a16
and group-wise int4 w4a16 (port of inferd_tpu/ops/quant.py).

A decode step reads every weight byte once per token, so int8 halves and
int4 quarters the bytes a stage moves per step; activations, the KV cache,
norms and the embedding stay in the model dtype.

  * int8, symmetric per output channel: for W [..., K, N] contracted over
    K, scale[..., n] = max_k |W[..., k, n]| / 127 and q = round(W / scale),
    so x @ W == (x @ q) * scale and the scale rides after the product.
  * int4, symmetric per group of `gs` rows along K: scale [..., G, N] with
    G = K / gs; two K-adjacent values packed per int8 byte (low nibble
    first) when K is even, one value per byte when K is odd.

`quantize`/`quantize_int4` reproduce the JAX package's bytes and scales
bit for bit. `QuantWeight` and `Int4Weight` are dataclasses of tensors
that duck-type the original weight (`shape`, `ndim`, `device`) and index
along their leading layer axis (`w[i]`, `w[a:b]`), so the model's layer
loop and stage slicing need no change.

`qdot` is the one contraction site. The port's dispatch rule, in place of
the reference's autotune registry: a CUDA activation of at most
`ops.qmatmul.MAX_KERNEL_ROWS` rows against a 2-D quantized weight
launches the hand-written decode GEMV (`csrc/qmatmul.cu`) or raises; more
rows, stacked weights and CPU tensors take the reference's plain product
(its XLA sibling) in PyTorch. There is no other route and no fallback.

`qeinsum` is the MoE experts' contraction site ("th,ehi->tei" and
"tei,eih->teh" over [E, K, N] stacks): a plain einsum over the int8
weight widened to x.dtype with the per-output scale after it, and for
int4 the reference's grouped contraction (`_int4_grouped_einsum`): a
partial sum per group of K, its scale applied, summed over the groups.
Those products are dense-dispatch expert stacks, which no GEMV kernel
takes; they stay plain products on every device.

Not ported here (ROADMAP A6): w8a8 (the reference's `QDOT_MODE="int8"`: a
dynamic int8 x int8 product) and the autotune
registry with its "slower than bf16" warning. With no w8a8 and no
registry, the reference's `QDOT_MODE` has nothing left to choose, so the
port has none: `--quant int8` and `int8-kernel` quantize and route alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from inferd_tpu_torch.ops import qmatmul

Params = Dict[str, Any]


@dataclasses.dataclass
class _QWeightBase:
    """(q, scale) of one quantized weight, duck-typing the original."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, idx):
        """Index the leading (layer) axis: `w[i]` is layer i's weight,
        `w[a:b]` a stage's slice. Views, no copy."""
        return dataclasses.replace(self, q=self.q[idx], scale=self.scale[idx])


@dataclasses.dataclass
class QuantWeight(_QWeightBase):
    """int8 weights + per-output-channel scales for one linear layer.

    q:     int8 [..., K, N]
    scale: float32 [..., N]
    """

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale[..., None, :]).to(dtype)


@dataclasses.dataclass
class Int4Weight(_QWeightBase):
    """Group-wise int4 weights for one linear layer.

    q:      int8 [..., K/2, N], two 4-bit two's-complement values per byte
            along K, low nibble first (packed=True); [..., K, N] with one
            value per byte when K is odd (packed=False)
    scale:  float32 [..., G, N], G groups of K/G rows along K
    """

    packed: bool = True

    @property
    def shape(self):  # the ORIGINAL [..., K, N] weight shape
        s = tuple(self.q.shape)
        if not self.packed:
            return s
        return s[:-2] + (s[-2] * 2,) + s[-1:]

    def unpacked(self) -> torch.Tensor:
        """int8 [..., K, N] in [-7, 7], back in K order. A nibble n is
        sign-extended as (n ^ 8) - 8, the high one by an arithmetic shift
        of the sign-extended byte (no shift of a negative value)."""
        if not self.packed:
            return self.q
        b = self.q.to(torch.int32)
        lo = ((b & 0xF) ^ 8) - 8
        hi = b >> 4
        s = self.q.shape
        return torch.stack([lo, hi], dim=-2).reshape(*s[:-2], s[-2] * 2, s[-1]).to(torch.int8)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        qi = self.unpacked()
        k, n = qi.shape[-2], qi.shape[-1]
        g = self.scale.shape[-2]
        qf = qi.float().reshape(*qi.shape[:-2], g, k // g, n)
        return (qf * self.scale[..., :, None, :]).reshape(qi.shape).to(dtype)


def quantize(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 over the second-to-last axis (the
    contraction axis of every linear). The input is made contiguous first:
    the tied head's `embed.T` is a transposed view, and the kernel reads q
    row by row."""
    wf = w.contiguous().float()
    amax = wf.abs().amax(dim=-2)  # [..., N]
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return QuantWeight(q=q, scale=scale)


def _group_size(k: int, group: int) -> int:
    """Largest divisor of K that is <= the requested group size."""
    g = min(group, k)
    while k % g:
        g -= 1
    return g


def quantize_int4(w: torch.Tensor, group: int = 128) -> Int4Weight:
    """Symmetric group-wise int4 over the contraction axis (-2), nibble-
    packed two K-adjacent values per byte when K is even."""
    k, n = w.shape[-2], w.shape[-1]
    gs = _group_size(k, group)
    wf = w.contiguous().float().reshape(*w.shape[:-2], k // gs, gs, n)
    amax = wf.abs().amax(dim=-2)  # [..., G, N]
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 7.0)
    q = torch.clamp(torch.round(wf / scale[..., :, None, :]), -7, 7)
    qi = q.reshape(w.shape).to(torch.int8)
    if k % 2:
        return Int4Weight(q=qi, scale=scale, packed=False)
    qw = qi.to(torch.int32)
    byte = (qw[..., 0::2, :] & 0xF) | ((qw[..., 1::2, :] & 0xF) << 4)  # 0..255
    return Int4Weight(q=byte.to(torch.uint8).view(torch.int8).contiguous(), scale=scale,
                      packed=True)


WeightLike = Union[torch.Tensor, QuantWeight, Int4Weight]
QTYPES = (QuantWeight, Int4Weight)

# How an Int4Weight contracts: "grouped" (a per-group f32 partial times its
# scale, summed), what every --quant int4 node serves: the reference's
# answer off a TPU with a cold autotune registry. "dequant" (the weight
# widened group-wise to x.dtype, one product) is the Pallas kernel's other
# scheme, which the port computes too; no node serves it.
INT4_MODE = "grouped"


def _w8a8_error() -> NotImplementedError:
    return NotImplementedError(
        "w8a8 (dynamic int8 activations) is not ported yet: it waits for a later "
        "slice (ROADMAP A6); serve --quant int8, int8-kernel or int4"
    )


def _kernel_rows(x: torch.Tensor) -> bool:
    """A decode-shaped CUDA activation: the GEMV kernels take it."""
    return x.device.type == "cuda" and x.numel() // x.shape[-1] <= qmatmul.MAX_KERNEL_ROWS


def qdot(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x [..., K] @ w [K, N], where w may be quantized (an Int4Weight
    contracts under INT4_MODE). Returns [..., N] in x.dtype."""
    if isinstance(w, Int4Weight):
        mode = INT4_MODE
        if w.ndim == 2 and _kernel_rows(x):
            lead = x.shape[:-1]
            y = qmatmul.w4a16_matvec(x.reshape(-1, x.shape[-1]), w, scheme=mode)
            return y.reshape(*lead, w.shape[-1])
        if w.ndim != 2 or mode == "dequant":
            return x @ w.dequantize(x.dtype)
        # grouped: y = sum_g (x_g @ q_g) * s_g, each group's scale on its
        # own partial sum
        k, n = w.shape
        g = w.scale.shape[-2]
        xg = x.reshape(*x.shape[:-1], g, k // g)
        qg = w.unpacked().reshape(g, k // g, n).to(x.dtype)
        y = torch.einsum("...gk,gkn->...gn", xg, qg)
        return (y.float() * w.scale).sum(dim=-2).to(x.dtype)
    if not isinstance(w, QuantWeight):
        return x @ w
    if w.ndim == 2 and _kernel_rows(x):
        lead = x.shape[:-1]
        y = qmatmul.w8a16_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
        return y.reshape(*lead, w.shape[-1])
    y = x @ w.q.to(x.dtype)
    return (y.float() * w.scale).to(x.dtype)


_GROUP_LETTERS = "gzyxwvu"


def _int4_grouped_einsum(spec: str, x: torch.Tensor, w: Int4Weight):
    """The grouped contraction of an Int4Weight under a one-contraction
    einsum: the contraction axis split into (G, K/G) on both operands, a
    partial sum per group on the narrow operand, each group's scale on its
    own partial sum and the groups summed in one last einsum: the int4
    sibling of qdot's grouped path, for the MoE expert einsums. None when
    the spec does not have that shape (the caller then widens the weight)."""
    try:
        ins, out = spec.split("->")
        xs_, ws_ = ins.split(",")
    except ValueError:
        return None
    shared = [ch for ch in ws_ if ch in xs_ and ch not in out]
    if len(shared) != 1:
        return None
    c = shared[0]
    # quantize_int4 groups along the weight's -2 axis; x contracts on its last
    if ws_.index(c) != len(ws_) - 2 or xs_.index(c) != len(xs_) - 1:
        return None
    # every other weight axis must reach the output: an axis summed before
    # the scale multiply would scale a sum of partials by a sum of scales
    if any(ch not in out for ch in ws_ if ch != c):
        return None
    g_letter = next(ch for ch in _GROUP_LETTERS if ch not in spec)
    qi = w.unpacked()
    k = qi.shape[-2]
    groups = w.scale.shape[-2]
    xg = x.reshape(*x.shape[:-1], groups, k // groups)
    qg = qi.reshape(*qi.shape[:-2], groups, k // groups, qi.shape[-1]).to(x.dtype)
    y = torch.einsum(f"{xs_.replace(c, g_letter + c)},{ws_.replace(c, g_letter + c)}"
                     f"->{g_letter}{out}", xg, qg)
    # the scale [..., G, N] carries the weight's other letters with the
    # groups in place of c: scale and sum over the groups in one einsum
    return torch.einsum(f"{g_letter}{out},{ws_.replace(c, g_letter)}->{out}",
                        y.float(), w.scale).to(x.dtype)


def qeinsum(spec: str, x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """einsum over a possibly quantized weight whose scale is per output
    (valid when every weight axis but the contraction reaches the output,
    as in the MoE expert einsums: [t, e, i] * scale [e, i]). An
    Int4Weight contracts under INT4_MODE, grouped where the spec allows."""
    if isinstance(w, Int4Weight):
        if INT4_MODE == "grouped":
            y = _int4_grouped_einsum(spec, x, w)
            if y is not None:
                return y
        return torch.einsum(spec, x, w.dequantize(x.dtype))
    if not isinstance(w, QuantWeight):
        return torch.einsum(spec, x, w)
    y = torch.einsum(spec, x, w.q.to(x.dtype))
    return (y.float() * w.scale).to(x.dtype)


# Leaves to quantize in a stacked layers dict and in the top-level params.
# Not listed: "router" (routing precision is quality-critical).
_LAYER_LINEARS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def quantize_params(
    params: Params, tie_word_embeddings: bool = False, needs_head: bool = True,
    quantizer=quantize,
) -> Params:
    """Quantize every linear projection of a full-model or stage param dict.

    Kept in the model dtype: the embedding table (the gather source),
    norms, biases. An untied lm_head is quantized in place. A tied head
    gets a quantized SHADOW of embed.T under "lm_head_q", which
    models.qwen3.unembed prefers; needs_head=False (stages that hold embed
    only for the token gather) skips it."""
    out = dict(params)
    if "layers" in out:
        layers = dict(out["layers"])
        for name in _LAYER_LINEARS:
            if name in layers and not isinstance(layers[name], QTYPES):
                layers[name] = quantizer(layers[name])
        out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], QTYPES):
        out["lm_head"] = quantizer(out["lm_head"])
    elif needs_head and tie_word_embeddings and "embed" in out and "lm_head_q" not in out:
        out["lm_head_q"] = quantizer(out["embed"].T)
    return out


QUANT_CHOICES = ("none", "int8", "w8a8", "int8-kernel", "int4")


def apply_quant_mode(
    flag: str,
    params: Params,
    tie_word_embeddings: bool = False,
    needs_head: bool = True,
) -> Params:
    """The CLI flag ("none" | "int8" | "int8-kernel" | "int4") -> the tree
    quantized. "int8-kernel" is "int8" here (the reference's flag, kept for
    parity: both take the w8a16 kernel on decode rows). "w8a8" raises: it
    waits for a later slice."""
    if flag not in QUANT_CHOICES:
        raise ValueError(f"unknown quant flag {flag!r}; one of {QUANT_CHOICES}")
    if flag == "none":
        return params
    if flag == "w8a8":
        raise _w8a8_error()
    return quantize_params(params, tie_word_embeddings=tie_word_embeddings,
                           needs_head=needs_head,
                           quantizer=quantize_int4 if flag == "int4" else quantize)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QTYPES):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def quantized_bytes(params: Params) -> int:
    """Parameter bytes as stored: int8/packed int4 + scales + whatever
    stays in the model dtype."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))
