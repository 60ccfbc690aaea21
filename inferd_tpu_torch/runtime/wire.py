"""Tensor wire codec, inferd wire format v1 (port of inferd_tpu/runtime/wire.py
and the normative pure-Python codec inferd_tpu/native/pyimpl.py).

FORMAT (little-endian): magic 'I' 'W', u8 version = 1, then ONE value:

  value := tag:u8 body
    0 none | 1 true | 2 false
    3 int    body = i64
    4 float  body = f64
    5 str    body = u64 len, utf8 bytes
    6 bytes  body = u64 len, raw
    7 list   body = u64 count, value*
    8 dict   body = u64 count, (str-body key, value)*   keys are str
    9 tensor body = str-body dtype name, u8 ndim, u64 dims[ndim],
                    u64 nbytes, raw C-contiguous data

`pack` writes the bytes the JAX package's codec writes for the same payload.
Tensors go in as numpy arrays or torch tensors (any device: they are copied
to the host). On the way out, a tensor comes back as a numpy array, except
bfloat16, which numpy lacks without ml_dtypes: it comes back as a torch
bfloat16 tensor built from the raw bytes, bit-exact. Nothing on the wire is
ever executed; dtype names are checked against an allowlist.

Two codecs write and read v1, byte for byte the same: the native one
(csrc/wirecodec.cpp, built at first use by inferd_tpu_torch/native; the
default) and the pure-Python one below (`pack_python`, `unpack_python`),
which INFERD_NATIVE=0 selects, read on every call. A native codec that
fails to build raises; there is no silent fallback. `codec_name()` names
the one in use.

The legacy envelopes: msgpack maps whose tensors are {"__nd__": 1, "dtype",
"shape", "data"} dicts, written by older nodes. `unpack` reads a frame
without the v1 magic as one (bfloat16 again as a torch tensor), through the
port's own msgpack subset (utils/msgpack_lite.py), and `pack_legacy` writes
the bytes the reference's `msgpack.packb(..., default=_encode_hook,
use_bin_type=True)` writes; INFERD_WIRE=legacy makes `pack` emit them,
read on every call as in the reference (a rolling upgrade's escape hatch).

The coalesced relay's multi-session envelopes (`coalesce_forward`,
`split_forward`, `MULTI_KEY`) are described below, where they are defined.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from inferd_tpu_torch import native
from inferd_tpu_torch.utils import msgpack_lite

MAGIC = b"IW\x01"

_TAG_NONE, _TAG_TRUE, _TAG_FALSE = 0, 1, 2
_TAG_INT, _TAG_FLOAT, _TAG_STR, _TAG_BYTES = 3, 4, 5, 6
_TAG_LIST, _TAG_DICT, _TAG_TENSOR = 7, 8, 9

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_MAX_DEPTH = 64

ALLOWED_DTYPES = {
    "float32", "float16", "float64", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
}

_TORCH_NAMES = {
    torch.float32: "float32", torch.float16: "float16", torch.float64: "float64",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}


def tensor_parts(obj: Any) -> Tuple[str, Tuple[int, ...], Any]:
    """array-ish -> (dtype name, shape, C-contiguous raw bytes)."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _TORCH_NAMES:
            raise TypeError(f"unserializable dtype {obj.dtype}")
        t = obj.detach().cpu().contiguous()
        shape = tuple(t.shape)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return _TORCH_NAMES[obj.dtype], shape, t.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(obj)
    shape = a.shape  # before ascontiguousarray: it promotes 0-d to (1,)
    a = np.ascontiguousarray(a)
    name = a.dtype.name
    if name not in ALLOWED_DTYPES:
        raise TypeError(f"unserializable dtype {name!r}")
    return name, shape, a.view(np.uint8).reshape(-1)


def tensor_build(name: str, shape: Tuple[int, ...], data: Any) -> Any:
    """(dtype name, shape, raw bytes) -> numpy array, or a torch bf16 tensor."""
    if name not in ALLOWED_DTYPES:
        raise ValueError(f"disallowed wire dtype {name!r}")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        if len(data) != 2 * n:
            raise ValueError(f"tensor payload {len(data)} bytes != shape {shape}")
        raw = bytearray(data)
        t = torch.frombuffer(raw, dtype=torch.bfloat16) if n else torch.empty(0, dtype=torch.bfloat16)
        return t.reshape(shape)
    a = np.frombuffer(data, dtype=np.dtype(name))
    if a.size != n:
        raise ValueError(f"tensor payload size {a.size} != shape {shape}")
    return a.reshape(shape)


# -- codec selection -------------------------------------------------------------


def codec_name() -> str:
    """The v1 codec `pack` and `unpack` use now (INFERD_NATIVE, read per
    call): "native", or "python" under INFERD_NATIVE=0."""
    return "python" if os.environ.get("INFERD_NATIVE", "1") == "0" else "native"


def _native_codec():
    """The native codec module, or None when the Python codec is selected."""
    return native.load(tensor_parts, tensor_build) if codec_name() == "native" else None


def _emit_legacy() -> bool:
    return os.environ.get("INFERD_WIRE", "v1").lower() == "legacy"


def pack(obj: Any) -> bytes:
    """Serialize a nested payload (dicts/lists/scalars/tensors) to bytes: a v1
    frame, or a legacy msgpack envelope under INFERD_WIRE=legacy."""
    if _emit_legacy():
        return pack_legacy(obj)
    codec = _native_codec()
    return pack_python(obj) if codec is None else codec.pack(obj)


def unpack(data: bytes) -> Any:
    """Deserialize a v1 frame or a legacy msgpack envelope; tensors come back
    as numpy arrays (bf16 as torch tensors). Never executes code."""
    data = bytes(data)
    if data[:3] != MAGIC:
        return unpack_legacy(data)
    codec = _native_codec()
    return unpack_python(data) if codec is None else codec.unpack(data)


# -- the pure-Python v1 codec ------------------------------------------------------


def pack_python(obj: Any) -> bytes:
    """The pure-Python v1 codec's `pack` (the native codec's bytes)."""
    chunks: List[bytes] = [MAGIC]
    _pack_value(chunks, obj, 0)
    return b"".join(chunks)


def _pack_str_body(chunks: List[Any], s: str) -> None:
    b = s.encode("utf-8")
    chunks.append(_U64.pack(len(b)))
    chunks.append(b)


def _pack_value(chunks: List[Any], obj: Any, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("nesting too deep")
    if obj is None:
        chunks.append(bytes([_TAG_NONE]))
    elif obj is True:
        chunks.append(bytes([_TAG_TRUE]))
    elif obj is False:
        chunks.append(bytes([_TAG_FALSE]))
    elif type(obj) is int:
        if not -(2**63) <= obj < 2**63:
            raise OverflowError("int exceeds int64 wire range")
        chunks.append(bytes([_TAG_INT]))
        chunks.append(_I64.pack(obj))
    elif type(obj) is float:
        chunks.append(bytes([_TAG_FLOAT]))
        chunks.append(_F64.pack(obj))
    elif isinstance(obj, str):
        chunks.append(bytes([_TAG_STR]))
        _pack_str_body(chunks, obj)
    elif isinstance(obj, bytes):
        chunks.append(bytes([_TAG_BYTES]))
        chunks.append(_U64.pack(len(obj)))
        chunks.append(obj)
    elif isinstance(obj, (list, tuple)):
        chunks.append(bytes([_TAG_LIST]))
        chunks.append(_U64.pack(len(obj)))
        for v in obj:
            _pack_value(chunks, v, depth + 1)
    elif isinstance(obj, dict):
        chunks.append(bytes([_TAG_DICT]))
        chunks.append(_U64.pack(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("wire dict keys must be str")
            _pack_str_body(chunks, k)
            _pack_value(chunks, v, depth + 1)
    else:
        name, shape, buf = tensor_parts(obj)
        if len(shape) > 255:
            raise ValueError("tensor rank > 255")
        data = buf.tobytes()
        chunks.append(bytes([_TAG_TENSOR]))
        _pack_str_body(chunks, name)
        chunks.append(bytes([len(shape)]))
        for d in shape:
            if d < 0:
                raise ValueError("negative dim")
            chunks.append(_U64.pack(d))
        chunks.append(_U64.pack(len(data)))
        chunks.append(data)


def unpack_python(data: bytes) -> Any:
    """The pure-Python v1 codec's `unpack`."""
    data = bytes(data)
    if data[:3] != MAGIC:
        raise ValueError("bad wire magic/version")
    value, pos = _unpack_value(data, 3, 0)
    if pos != len(data):
        raise ValueError("trailing wire bytes")
    return value


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise ValueError("truncated wire data")


def _unpack_u64(data: bytes, pos: int) -> Tuple[int, int]:
    _need(data, pos, 8)
    return _U64.unpack_from(data, pos)[0], pos + 8


def _unpack_str(data: bytes, pos: int) -> Tuple[str, int]:
    n, pos = _unpack_u64(data, pos)
    _need(data, pos, n)
    return data[pos : pos + n].decode("utf-8"), pos + n


def _unpack_value(data: bytes, pos: int, depth: int) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise ValueError("nesting too deep")
    _need(data, pos, 1)
    tag = data[pos]
    pos += 1
    if tag == _TAG_NONE:
        return None, pos
    if tag == _TAG_TRUE:
        return True, pos
    if tag == _TAG_FALSE:
        return False, pos
    if tag == _TAG_INT:
        _need(data, pos, 8)
        return _I64.unpack_from(data, pos)[0], pos + 8
    if tag == _TAG_FLOAT:
        _need(data, pos, 8)
        return _F64.unpack_from(data, pos)[0], pos + 8
    if tag == _TAG_STR:
        return _unpack_str(data, pos)
    if tag == _TAG_BYTES:
        n, pos = _unpack_u64(data, pos)
        _need(data, pos, n)
        return data[pos : pos + n], pos + n
    if tag == _TAG_LIST:
        n, pos = _unpack_u64(data, pos)
        if n > len(data) - pos:
            raise ValueError("truncated wire data")
        out = []
        for _ in range(n):
            v, pos = _unpack_value(data, pos, depth + 1)
            out.append(v)
        return out, pos
    if tag == _TAG_DICT:
        n, pos = _unpack_u64(data, pos)
        if n > len(data) - pos:
            raise ValueError("truncated wire data")
        d = {}
        for _ in range(n):
            k, pos = _unpack_str(data, pos)
            v, pos = _unpack_value(data, pos, depth + 1)
            d[k] = v
        return d, pos
    if tag == _TAG_TENSOR:
        name, pos = _unpack_str(data, pos)
        _need(data, pos, 1)
        ndim = data[pos]
        pos += 1
        _need(data, pos, 8 * ndim)
        shape = tuple(_U64.unpack_from(data, pos + 8 * i)[0] for i in range(ndim))
        pos += 8 * ndim
        nbytes, pos = _unpack_u64(data, pos)
        _need(data, pos, nbytes)
        arr = tensor_build(name, shape, memoryview(data)[pos : pos + nbytes])
        return arr, pos + nbytes
    raise ValueError(f"unknown wire tag {tag}")


# -- legacy msgpack envelopes ------------------------------------------------------

TENSOR_KEY = "__nd__"


def _encode_hook(obj: Any) -> Dict[str, Any]:
    """A tensor as the legacy envelope's dict (the reference's _encode_hook)."""
    name, shape, buf = tensor_parts(obj)
    return {TENSOR_KEY: 1, "dtype": name, "shape": list(shape), "data": buf.tobytes()}


def _decode_hook(obj: Dict[Any, Any]) -> Any:
    if obj.get(TENSOR_KEY) != 1:
        return obj
    try:
        name, shape, data = obj["dtype"], obj["shape"], obj["data"]
    except KeyError as e:
        raise ValueError(f"legacy tensor without {e}") from None
    if not isinstance(name, str) or not isinstance(shape, list) or not isinstance(data, bytes):
        raise ValueError("malformed legacy tensor")
    return tensor_build(name, tuple(shape), data)


def pack_legacy(obj: Any) -> bytes:
    """The legacy msgpack envelope of `obj` (the reference's pack_legacy)."""
    return msgpack_lite.packb(obj, default=_encode_hook)


def unpack_legacy(data: bytes) -> Any:
    """Read a legacy msgpack envelope, its tensor dicts checked against the
    dtype allowlist and their shapes."""
    return msgpack_lite.unpackb(data, object_hook=_decode_hook)


# -- multi-session /forward envelopes (the coalesced relay) -------------------------
#
# When a lane node co-batches the decode steps of N sessions into one device
# step and their next hop is the same replica, the relay ships ONE envelope
# instead of N:
#
#   {"stage": s, "multi": [frame, ...], "hidden": [N, 1, H]}
#
# where each frame is the session's single-session envelope without its
# hidden rows ({"task_id", "session_id", "payload": {"start_pos",
# "real_len"}, "deadline_ms", ...}). The receiver splits it back into N
# single-session envelopes (`split_forward`), runs them as it runs any, and
# answers with one multi REPLY aligned with the frames:
#
#   {"multi": [{"status": int, "body": bytes}, ...]}
#
# `body` is the wire-packed reply the session's own relay would have got.
# Both wire generations carry these (plain dicts, lists, tensors and
# bytes), and a node that never coalesces sends the single-session bytes it
# always did: a coalescing node falls back to per-session relays when a
# peer refuses the multi form.

MULTI_KEY = "multi"

# single-session envelope keys that do not ride a frame (carried once at the
# top level, or rebuilt by split_forward)
_FRAME_EXCLUDE = ("payload", "stage", MULTI_KEY)


def _stack_rows(rows: Sequence[Any]) -> Any:
    """Concatenate decode rows along dim 0: torch when any row is a tensor
    (bf16 has no numpy dtype), numpy otherwise."""
    if any(isinstance(r, torch.Tensor) for r in rows):
        return torch.cat([torch.as_tensor(r).cpu() for r in rows], dim=0)
    return np.concatenate([np.asarray(r) for r in rows], axis=0)


def coalesce_forward(envs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """ONE multi-session envelope from N >= 2 single-session /forward
    envelopes for the SAME stage whose payloads are single-token decode
    activations ({"hidden": [1, 1, H], "start_pos", "real_len"})."""
    if len(envs) < 2:
        raise ValueError("coalesce_forward needs >= 2 envelopes")
    stage = envs[0].get("stage")
    frames, rows = [], []
    for e in envs:
        if e.get("stage") != stage:
            raise ValueError("coalesce_forward: mixed stages")
        p = dict(e.get("payload") or {})
        h = p.pop("hidden")
        if not isinstance(h, torch.Tensor):
            h = np.asarray(h)
        if h.ndim != 3 or h.shape[0] != 1 or h.shape[1] != 1:
            raise ValueError(f"coalesce_forward: not a decode row {tuple(h.shape)}")
        rows.append(h)
        frame = {k: v for k, v in e.items() if k not in _FRAME_EXCLUDE}
        frame["payload"] = p
        frames.append(frame)
    return {"stage": stage, MULTI_KEY: frames, "hidden": _stack_rows(rows)}


def split_forward(env: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Inverse of coalesce_forward: N single-session /forward envelopes from
    one multi envelope, the frame/row alignment checked."""
    frames = env.get(MULTI_KEY)
    hidden = env.get("hidden")
    if not isinstance(hidden, torch.Tensor):
        hidden = np.asarray(hidden)
    if not isinstance(frames, list) or not frames:
        raise ValueError("multi envelope without frames")
    if hidden.ndim != 3 or hidden.shape[0] != len(frames):
        raise ValueError(f"multi envelope: {len(frames)} frames vs hidden {tuple(hidden.shape)}")
    out = []
    for i, frame in enumerate(frames):
        if not isinstance(frame, dict):
            raise ValueError("multi frame is not a dict")
        e = {k: v for k, v in frame.items() if k != "payload"}
        e["stage"] = env.get("stage")
        p = dict(frame.get("payload") or {})
        p["hidden"] = hidden[i:i + 1]
        e["payload"] = p
        out.append(e)
    return out
