"""Session-KV handoff payload codec, ONE schema for every executor (port of
inferd_tpu/runtime/handoff.py).

A session's KV moves between replicas (a fork's parent stays put; an
export to a decode replica, a drain, a migration or a stop ships it) as
{"k", "v", "length"[, "kv_dtype"]}. The one-session executor and the
whole-model lane executor produce and consume it, and the node's
/import_session adopts it; the JAX package's nodes read and write the same
payload, byte for byte through runtime/wire.

K/V are batch-1 host tensors [L, 1, n, Nkv, D], sliced to the populated
prefix. Standby replication (runtime/repl) ships the same payload over the
slots [start, length) of a session, with its `start` beside it. bf16 travels as the wire carries it (a torch bf16 tensor on
unpack, an ml_dtypes array on the reference's side). fp8 KV, which the
wire does not carry, travels as a same-shape uint8 byte view plus the
dtype's name, and `decode` views it back through FP8_DTYPES, an allowlist
of torch dtypes: a name off the list is a mismatch, never a getattr.

Ring payloads (`k_loc`, `v_loc`, `hi`: the sliding-window layers' rings)
wait for ROADMAP A5b (sliding windows and ring KV): the port keeps no rings, so
`decode` refuses a payload that carries them, as the reference's refuses a
ring payload for a layout without rings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig

# the narrow float KV dtypes that ride as uint8 byte views, by their
# numpy/JAX names (what `kv_dtype` carries on the wire)
FP8_DTYPES: Dict[str, torch.dtype] = {
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_FP8_NAMES = {dt: name for name, dt in FP8_DTYPES.items()}


def encode(k: torch.Tensor, v: torch.Tensor, length: int) -> Dict[str, Any]:
    """The handoff payload of host tensors k/v [L, 1, n, Nkv, D] (already
    sliced to the populated prefix)."""
    payload: Dict[str, Any] = {"length": int(length)}
    name = _FP8_NAMES.get(k.dtype)
    if name is not None:
        payload["kv_dtype"] = name  # itemsize 1: a shape-preserving view
        k, v = k.view(torch.uint8), v.view(torch.uint8)
    payload["k"], payload["v"] = k, v
    return payload


def as_tensor(x: Any) -> torch.Tensor:
    """A wire value as a CPU tensor: torch as it is, numpy copied when the
    array is read-only (a wire frame's buffer)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def decode(payload: Dict[str, Any], cfg: ModelConfig, num_layers: int,
           max_len: int) -> Optional[Dict[str, Any]]:
    """Validate and decode a handoff payload against this executor's dense
    layout: {"k", "v" (CPU tensors, fp8 views restored to the shipped
    dtype), "n"}, or None on ANY mismatch: adopting a malformed or
    wrong-layout payload fails closed, never corrupts."""
    try:
        k = as_tensor(payload["k"])
        v = as_tensor(payload["v"])
        n = int(payload["length"])
    except Exception:
        return None
    if k.dim() != 5 or tuple(v.shape) != tuple(k.shape) or v.dtype != k.dtype:
        return None
    kd = payload.get("kv_dtype")
    if kd is not None:  # fp8 shipped as uint8 byte views: view BOTH back
        dt = FP8_DTYPES.get(str(kd))
        if k.dtype != torch.uint8 or dt is None:
            return None
        k, v = k.contiguous().view(dt), v.contiguous().view(dt)
    elif not k.is_floating_point():
        return None  # integer K/V without its dtype's name
    if "k_loc" in payload or "v_loc" in payload:
        return None  # ring layers: a layout this port does not keep (A5b)
    expect = (num_layers, 1, cfg.num_kv_heads, cfg.head_dim)
    got = (k.shape[0], k.shape[1], k.shape[3], k.shape[4])
    if got != expect or k.shape[2] < n or n <= 0 or n > max_len:
        return None
    return {"k": k, "v": v, "n": n}
