"""Flash GQA attention: the CUDA kernel's wrapper and its plain version
(port of inferd_tpu/ops/attention.py).

`flash_gqa` is the attention hot op of every prefill chunk and decode step.
On a CUDA tensor it launches the hand-written kernel in
`csrc/flash_gqa.cu`, or raises on anything the kernel does not take; on a
CPU tensor it runs `flash_gqa_reference`, the plain masked-softmax version
with the same contract. There is no other route: no fallback on the card.

Layout contract (the KV cache's): kv slot `j` holds absolute position
`kv_start + j`; queries are contiguous from `q_start`, per batch row.
Scattered positions take the composite in models/qwen3.gqa_attention.

Also here, as in the JAX module: `NEG_INF`, `apply_softcap`,
`apply_window_mask` and the S == 1 composite `decode_gqa` (without the paged
block table, which waits for the paged-KV slice).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from inferd_tpu_torch.ops import build

NEG_INF = -1e30  # finite: exp(-inf - -inf) would be NaN

Scalar = Union[int, torch.Tensor]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_MAX_GRID_YZ = 65535  # CUDA's limit on grid.y (Nkv) and grid.z (B)


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
) -> torch.Tensor:
    """Single-query (S == 1) GQA composite: models/qwen3.gqa_attention at
    S == 1 with the query axis dropped. Returns [B, 1, Nq*D] in q.dtype."""
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


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_gqa")
    fn = lib.flash_gqa_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, i, i, p]
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
) -> torch.Tensor:
    """Flash GQA attention over a (possibly oversized) KV buffer; returns
    [B, S, Nq*D] in q.dtype.

    CUDA tensors launch the kernel of csrc/flash_gqa.cu (which replaces both
    Pallas kernels of the JAX package); CPU tensors run
    flash_gqa_reference. `stream` keeps the JAX signature: on the TPU it
    picked the VMEM-resident or the streaming kernel, here both values
    launch the one kernel, which streams K/V tiles through shared memory.
    The Pallas-only `block_q`/`block_k`/`interpret` knobs have no
    counterpart. Each kernel launch adds one to `flash_gqa.launches`."""
    if q.device.type == "cpu":
        return flash_gqa_reference(
            q, k, v, q_start, kv_len, kv_start, stream=stream, scale=scale,
            softcap=softcap, window=window, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa: unsupported device {q.device}")
    out = _launch(q, k, v, q_start, kv_len, kv_start, scale, softcap, window, sinks)
    flash_gqa.launches += 1
    return out


flash_gqa.launches = 0


def _launch(q, k, v, q_start, kv_len, kv_start, scale, softcap, window, sinks):
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
    if b > _MAX_GRID_YZ or nkv > _MAX_GRID_YZ:
        raise ValueError(f"flash_gqa kernel: B {b} or Nkv {nkv} over the grid limit")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_gqa kernel: {name} must be contiguous")
    out = torch.empty((b, s, nq * d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    sink_t = None
    if sinks is not None:
        if sinks.shape != (nq,):
            raise ValueError(f"flash_gqa: sinks shape {tuple(sinks.shape)} != ({nq},)")
        sink_t = sinks.to(device=dev, dtype=torch.float32).contiguous()
    win = 0 if window is None else window
    scalars = (q_start, kv_start, kv_len, win)
    meta = None
    if all(isinstance(x, int) for x in scalars):
        qs0, ks0, kl0, w0 = (int(x) for x in scalars)
    else:
        meta = torch.stack([_per_batch(x, b, dev) for x in scalars], dim=1)
        meta = meta.to(torch.int32).contiguous()
        qs0 = ks0 = kl0 = w0 = 0
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.flash_gqa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if meta is None else meta.data_ptr(),
            None if sink_t is None else sink_t.data_ptr(),
            b, s, t, nq, nkv, d, qs0, ks0, kl0, w0,
            eff_scale, float(softcap),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_gqa kernel launch failed: cudaError_t {rc}")
    return out
