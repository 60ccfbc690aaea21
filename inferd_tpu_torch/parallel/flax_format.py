"""The stage-checkpoint file format of the JAX package, written by hand.

The JAX package saves stage checkpoints with flax's msgpack serializer
(`flax.serialization.to_bytes`, inferd_tpu/parallel/stages.py:183-216), so
one parts directory serves both packages. The port has neither flax nor
msgpack, so this module speaks the subset those files use, with `struct`:

  * maps with str keys, str, bin, int, nil/bool/float, arrays;
  * ext type 1 = an array leaf: an inner msgpack array
    [shape (array of ints), dtype name (str), raw C-order bytes (bin)].

For the same nested dict of arrays it writes the bytes flax writes (flax
keeps dict insertion order and picks the smallest encodings, as here).

A leaf of more than MAX_CHUNK_SIZE bytes (1 GiB: an MoE stage's expert
stack, a large vocabulary's embedding) goes in flax's chunked form, in
both directions: in its place a map {"__msgpack_chunked_array__": True,
"shape": {"0": d0, ...}, "chunks": {"0": leaf, ...}}, whose chunks are
the flattened leaf cut every MAX_CHUNK_SIZE / itemsize elements, each an
ext-1 leaf of its own.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

from inferd_tpu_torch.models.convert import tensor_to_numpy

_EXT_NDARRAY = 1
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_BY_NAME = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "bool": torch.bool,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


# -- encoder ------------------------------------------------------------------


def _pack_int(n: int, out: List[Any]) -> None:
    if 0 <= n < 128:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for lim, fmt, tag in ((2**8, ">BB", 0xCC), (2**16, ">BH", 0xCD),
                              (2**32, ">BI", 0xCE), (2**64, ">BQ", 0xCF)):
            if n < lim:
                out.append(struct.pack(fmt, tag, n))
                return
        raise OverflowError(f"int {n} too large for msgpack")
    else:
        for lim, fmt, tag in ((2**7, ">Bb", 0xD0), (2**15, ">Bh", 0xD1),
                              (2**31, ">Bi", 0xD2), (2**63, ">Bq", 0xD3)):
            if n >= -lim:
                out.append(struct.pack(fmt, tag, n))
                return
        raise OverflowError(f"int {n} too small for msgpack")


def _pack_len(n: int, fix_base: int, fix_max: int, tags: Tuple[int, int, int],
              out: List[Any]) -> None:
    """Header of a sized object: fix form (when there is one), then 8/16/32-bit lengths.
    `tags` are the 8-, 16- and 32-bit tags (0 = that width does not exist)."""
    if n < fix_max:
        out.append(struct.pack("B", fix_base | n))
    elif tags[0] and n < 2**8:
        out.append(struct.pack(">BB", tags[0], n))
    elif n < 2**16:
        out.append(struct.pack(">BH", tags[1], n))
    elif n < 2**32:
        out.append(struct.pack(">BI", tags[2], n))
    else:
        raise ValueError(f"msgpack object of {n} elements/bytes is too large")


def _pack_str(s: str, out: List[Any]) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _pack_bin(b: Any, out: List[Any]) -> None:
    n = memoryview(b).nbytes
    _pack_len(n, 0, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: List[Any]) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n < 2**8:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 2**16:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n < 2**32:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise ValueError("ext payload too large")
    out.append(data)


def _leaf_parts(x: Any) -> Tuple[Tuple[int, ...], str, np.ndarray]:
    """(shape, dtype name, the values flattened) of a torch or numpy array
    leaf; a bf16 tensor's values are its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _NAME_BY_TORCH:
            raise TypeError(f"unsupported leaf dtype {x.dtype}")
        name = _NAME_BY_TORCH[x.dtype]
        a = tensor_to_numpy(x)
        shape = tuple(x.shape)
    else:
        a = np.asarray(x)
        name, shape = a.dtype.name, a.shape
    return shape, name, np.ascontiguousarray(a).reshape(-1)


def _pack_ndarray(shape, name: str, flat: np.ndarray, out: List[Any]) -> None:
    inner: List[Any] = []
    _pack([list(shape), name, memoryview(flat.view(np.uint8))], inner)
    _pack_ext(_EXT_NDARRAY, b"".join(inner), out)


def _pack_leaf(x: Any, out: List[Any]) -> None:
    """One array leaf: ext 1, or flax's chunked map when it holds more than
    MAX_CHUNK_SIZE bytes."""
    shape, name, flat = _leaf_parts(x)
    if flat.nbytes <= MAX_CHUNK_SIZE:
        _pack_ndarray(shape, name, flat, out)
        return
    size = max(1, int(MAX_CHUNK_SIZE / flat.itemsize))
    starts = range(0, flat.size, size)
    _pack_len(3, 0x80, 16, (0, 0xDE, 0xDF), out)
    _pack_str(_CHUNKED, out)
    _pack(True, out)
    _pack_str("shape", out)
    _pack({str(i): int(d) for i, d in enumerate(shape)}, out)
    _pack_str("chunks", out)
    _pack_len(len(starts), 0x80, 16, (0, 0xDE, 0xDF), out)
    for i, j in enumerate(starts):
        _pack_str(str(i), out)
        chunk = flat[j:j + size]
        _pack_ndarray((chunk.size,), name, chunk, out)


def _pack(obj: Any, out: List[Any]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(obj, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("map keys must be str")
            _pack_str(k, out)
            _pack(v, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_leaf(obj, out)
    else:
        raise TypeError(f"cannot serialize {type(obj)!r}")


def pieces(tree: Any) -> List[Any]:
    """dumps(tree) as the list of buffers it joins: the array leaves'
    bytes where they lie (a writer or a reader can take them one by one,
    with no copy of the whole blob)."""
    out: List[Any] = []
    _pack(tree, out)
    return out


def dumps(tree: Any) -> bytes:
    """Serialize a nested dict of str / int / arrays like flax.serialization.to_bytes."""
    return b"".join(pieces(tree))


# -- decoder ------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: memoryview, device):
        self.buf = buf
        self.pos = 0
        self.device = device

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        tag = self.unpack("B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if tag in ints:
            return self.unpack(ints[tag])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if tag in lens:
            return str(self.take(self.unpack(lens[tag])), "utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if tag in bins:
            return self.take(self.unpack(bins[tag]))
        if tag in (0xDC, 0xDD):
            n = self.unpack(">H" if tag == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if tag in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if tag == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if tag in fixext or tag in exts:
            n = fixext[tag] if tag in fixext else self.unpack(exts[tag])
            code = self.unpack(">b")
            return self._ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:  # flax's chunked leaf: the chunks joined, reshaped
            shape = tuple(int(out["shape"][str(i)]) for i in range(len(out["shape"])))
            chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return out

    def _ext(self, code: int, data: memoryview) -> torch.Tensor:
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, raw = _Reader(data, None).value()
        if isinstance(name, memoryview):
            name = str(name, "utf-8")
        if name not in _TORCH_BY_NAME:
            raise ValueError(f"unsupported array dtype {name!r}")
        dt = _TORCH_BY_NAME[name]
        shape = tuple(int(s) for s in shape)
        numel = int(np.prod(shape, dtype=np.int64))
        t = torch.frombuffer(raw, dtype=dt, count=numel) if numel else torch.empty(0, dtype=dt)
        t = t.reshape(shape)
        return t if self.device is None else t.to(self.device)


def loads(data: Any, device=None) -> Any:
    """Parse a flax msgpack blob; array leaves become torch tensors on
    `device` (on the CPU they share memory with a writable `data`)."""
    buf = memoryview(data)
    r = _Reader(buf, device)
    out = r.value()
    if r.pos != len(buf):
        raise ValueError("trailing bytes after msgpack value")
    return out
