"""The safetensors file format, read and written without the `safetensors`
package (a machine with the card need not have it).

A file is an 8-byte little-endian header length N, then N bytes of JSON
mapping each tensor name to {"dtype", "shape", "data_offsets": [begin,
end]} (offsets into the data section, which follows the header), plus an
optional "__metadata__" map of strings to strings; then the tensors' raw
little-endian bytes, packed back to back.

Dtypes handled: F32, F16 and BF16 (what peft adapters and dense HF
checkpoints hold) and U8 (GPT-OSS's MXFP4 expert blocks and scales); any
other raises. `get_tensor` returns a numpy array;
BF16 has no numpy type without ml_dtypes, so it is widened to float32
through its 16-bit pattern (`uint16 << 16`), which is exact. `get_torch`
returns a torch tensor in the file's own dtype, a BF16 one over the file's
bytes: the same values at half the host memory of the widened array, which
is what a model checkpoint wants. The writer takes numpy arrays and torch
tensors (a bf16 tensor is written as its raw 16-bit pattern).
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_NP_DTYPES = {"F32": np.float32, "F16": np.float16, "U8": np.uint8}
_CODES = {np.dtype(v).newbyteorder("<").str: k for k, v in _NP_DTYPES.items()}
# the package's order of dtypes in a file, widest first (its Dtype enum, reversed)
_WRITE_RANK = {"F32": 3, "BF16": 2, "F16": 1, "U8": 0}
# a header larger than this is not a safetensors file (the package's own cap)
MAX_HEADER_BYTES = 100_000_000


def _read_header(f) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("safetensors: file shorter than its 8-byte header length")
    (n,) = struct.unpack("<Q", raw)
    if n > MAX_HEADER_BYTES:
        raise ValueError(f"safetensors: header of {n} bytes is too large")
    text = f.read(n)
    if len(text) != n or not text.lstrip().startswith(b"{"):
        raise ValueError("safetensors: truncated or malformed header")
    header = json.loads(text.decode("utf-8"))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


class SafeOpen:
    """A safetensors file opened for reading: `keys()` and `metadata()`
    come from the header alone; `get_tensor(name)` reads one tensor's bytes."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._header, self._meta, self._data_start = _read_header(f)

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def keys(self) -> List[str]:
        return list(self._header)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._meta

    def _read(self, name: str) -> tuple:
        """(dtype code, shape, the tensor's bytes as a bytearray), its byte
        count checked against its shape."""
        info = self._header[name]
        code, shape = info["dtype"], tuple(int(d) for d in info["shape"])
        if code != "BF16" and code not in _NP_DTYPES:
            raise ValueError(f"safetensors: dtype {code} of {name!r} is not supported")
        begin, end = (int(o) for o in info["data_offsets"])
        raw = bytearray(end - begin)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + begin)
            got = f.readinto(raw)
        if got != end - begin:
            raise ValueError(f"safetensors: {name!r} runs past the end of {self.path}")
        item = 2 if code == "BF16" else np.dtype(_NP_DTYPES[code]).itemsize
        if len(raw) != int(np.prod(shape, dtype=np.int64)) * item:
            raise ValueError(
                f"safetensors: {name!r} has {len(raw)} bytes for shape {shape} {code}")
        return code, shape, raw

    def get_tensor(self, name: str) -> np.ndarray:
        code, shape, raw = self._read(name)
        if code == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        dt = np.dtype(_NP_DTYPES[code]).newbyteorder("<")
        return np.frombuffer(raw, dtype=dt).reshape(shape).astype(dt.newbyteorder("="))

    def get_torch(self, name: str) -> torch.Tensor:
        """One tensor as a CPU torch tensor in the file's dtype (BF16 stays
        bf16, viewing the bytes read; F32 and F16 as get_tensor reads them)."""
        code, shape, raw = self._read(name)
        if code == "BF16":
            if not raw:  # frombuffer refuses an empty buffer
                return torch.empty(shape, dtype=torch.bfloat16)
            return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
        dt = np.dtype(_NP_DTYPES[code]).newbyteorder("<")
        return torch.from_numpy(
            np.frombuffer(raw, dtype=dt).reshape(shape).astype(dt.newbyteorder("=")))


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, by name."""
    with SafeOpen(path) as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def _le_bytes(a: np.ndarray, dtype) -> np.ndarray:
    """`a` as a flat uint8 array of its little-endian bytes: a view where
    `a` already is contiguous little-endian, so a large tensor is not copied."""
    return np.ascontiguousarray(a).astype(dtype, copy=False).reshape(-1).view(np.uint8)


def _encode(value: Any) -> tuple:
    """(dtype code, shape, little-endian bytes as a uint8 array) of one
    array or tensor."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", list(t.shape), _le_bytes(t.view(torch.int16).numpy(), "<i2")
        value = t.numpy()
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array, written as its bits
        return "BF16", list(a.shape), _le_bytes(a.view(np.uint16), "<u2")
    code = _CODES.get(a.dtype.newbyteorder("<").str)
    if code is None:
        raise ValueError(f"safetensors: cannot write numpy dtype {a.dtype}")
    return code, list(a.shape), _le_bytes(a, a.dtype.newbyteorder("<"))


def save_file(tensors: Dict[str, Any], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (name -> numpy array or torch tensor) to `path` as
    the safetensors package writes them: the wider dtypes first (F32,
    BF16, F16, U8: its alignment order), by name within a dtype, the
    header padded with spaces to a multiple of 8 bytes."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    encoded = {name: _encode(value) for name, value in tensors.items()}
    blobs, offset = [], 0
    for name in sorted(encoded, key=lambda n: (-_WRITE_RANK[encoded[n][0]], n)):
        code, shape, data = encoded[name]
        header[name] = {"dtype": code, "shape": shape,
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)
