"""A msgpack subset on the standard library: what the swarm's gossip frames
hold (nil, bool, int, float64, str, bin, array and map).

`packb(obj, default=None)` writes the bytes `msgpack.packb(obj,
default=default, use_bin_type=True)` writes for such a value: the
smallest integer form (positive values
unsigned, negative ones signed), floats as float64, str as fixstr / str8 /
str16 / str32, bytes as bin8 / bin16 / bin32, lists and tuples as arrays,
dicts as maps in their own order; any other object goes through
`default` first (the legacy wire envelopes' tensor hook). `unpackb(data,
object_hook=None)` reads those forms (and float32) back as
`msgpack.unpackb(data, object_hook=object_hook, raw=False)` does: arrays
as lists, str as str, bin as bytes, each map through `object_hook` once
its entries are read. It refuses, with `UnpackError`, what a peer
must not be able to slip in: extension types, the reserved byte 0xc1,
a frame cut short, a length or count past the bytes that are left,
nesting deeper than 64, map keys other than str or bytes, and bytes left
over after the value.

The reference gossips with the msgpack package over UDP and still reads
(and on request writes) msgpack /forward envelopes; the port does without
the package, and this codec keeps the two on the same wires.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Optional, Tuple

MAX_DEPTH = 64


class UnpackError(ValueError):
    """A frame this codec refuses."""


_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    out: List[bytes] = []
    _pack(obj, out, 0, default)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes], depth: int,
          default: Optional[Callable[[Any], Any]] = None) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("msgpack_lite: nesting deeper than %d" % MAX_DEPTH)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(_B.pack(0xA0 | n))
        elif n < 1 << 8:
            out.append(b"\xd9" + _B.pack(n))
        elif n < 1 << 16:
            out.append(b"\xda" + _H.pack(n))
        else:
            out.append(b"\xdb" + _I.pack(_len32(n)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 1 << 8:
            out.append(b"\xc4" + _B.pack(n))
        elif n < 1 << 16:
            out.append(b"\xc5" + _H.pack(n))
        else:
            out.append(b"\xc6" + _I.pack(_len32(n)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, b"\xdc", b"\xdd"))
        for v in obj:
            _pack(v, out, depth + 1, default)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out, depth + 1, default)
            _pack(v, out, depth + 1, default)
    elif default is not None:
        _pack(default(obj), out, depth + 1, default)
    else:
        raise TypeError(f"msgpack_lite: cannot serialize {type(obj).__name__}")


def _len32(n: int) -> int:
    if n >= 1 << 32:
        raise ValueError("msgpack_lite: object too large")
    return n


def _head(n: int, fix: int, b16: bytes, b32: bytes) -> bytes:
    if n < 16:
        return _B.pack(fix | n)
    if n < 1 << 16:
        return b16 + _H.pack(n)
    return b32 + _I.pack(_len32(n))


def _pack_int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return _B.pack(v)
        if v < 1 << 8:
            return b"\xcc" + _B.pack(v)
        if v < 1 << 16:
            return b"\xcd" + _H.pack(v)
        if v < 1 << 32:
            return b"\xce" + _I.pack(v)
        if v < 1 << 64:
            return b"\xcf" + _Q.pack(v)
    else:
        if v >= -32:
            return _b.pack(v)
        if v >= -(1 << 7):
            return b"\xd0" + _b.pack(v)
        if v >= -(1 << 15):
            return b"\xd1" + _h.pack(v)
        if v >= -(1 << 31):
            return b"\xd2" + _i.pack(v)
        if v >= -(1 << 63):
            return b"\xd3" + _q.pack(v)
    raise OverflowError(f"msgpack_lite: int {v} out of range")


def unpackb(data: bytes, object_hook: Optional[Callable[[dict], Any]] = None) -> Any:
    buf = memoryview(bytes(data))
    obj, at = _unpack(buf, 0, 0, object_hook)
    if at != len(buf):
        raise UnpackError(f"msgpack_lite: {len(buf) - at} bytes after the value")
    return obj


def _take(buf: memoryview, at: int, n: int) -> Tuple[memoryview, int]:
    if n > len(buf) - at:
        raise UnpackError(f"msgpack_lite: frame cut short ({n} bytes wanted at {at}, "
                          f"{len(buf) - at} left)")
    return buf[at:at + n], at + n


def _num(s: struct.Struct, buf: memoryview, at: int) -> Tuple[Any, int]:
    raw, at = _take(buf, at, s.size)
    return s.unpack(raw)[0], at


# fixed-width scalars: type byte -> struct
_SCALARS = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
            0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
# length-prefixed str / bin: type byte -> (length struct, is str)
_SIZED = {0xD9: (_B, True), 0xDA: (_H, True), 0xDB: (_I, True),
          0xC4: (_B, False), 0xC5: (_H, False), 0xC6: (_I, False)}
# arrays and maps with a counted header: type byte -> (count struct, is map)
_COUNTED = {0xDC: (_H, False), 0xDD: (_I, False), 0xDE: (_H, True), 0xDF: (_I, True)}


def _unpack(buf: memoryview, at: int, depth: int, hook=None) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise UnpackError("msgpack_lite: nesting deeper than %d" % MAX_DEPTH)
    if at >= len(buf):
        raise UnpackError("msgpack_lite: frame cut short")
    t = buf[at]
    at += 1
    if t <= 0x7F:
        return t, at
    if t >= 0xE0:
        return t - 0x100, at
    if 0xA0 <= t <= 0xBF:
        return _str(buf, at, t & 0x1F)
    if 0x90 <= t <= 0x9F:
        return _array(buf, at, t & 0x0F, depth, hook)
    if 0x80 <= t <= 0x8F:
        return _map(buf, at, t & 0x0F, depth, hook)
    if t == 0xC0:
        return None, at
    if t == 0xC2:
        return False, at
    if t == 0xC3:
        return True, at
    if t in _SCALARS:
        return _num(_SCALARS[t], buf, at)
    if t in _SIZED:
        s, is_str = _SIZED[t]
        n, at = _num(s, buf, at)
        if is_str:
            return _str(buf, at, n)
        raw, at = _take(buf, at, n)
        return bytes(raw), at
    if t in _COUNTED:
        s, is_map = _COUNTED[t]
        n, at = _num(s, buf, at)
        return (_map if is_map else _array)(buf, at, n, depth, hook)
    raise UnpackError(f"msgpack_lite: type byte 0x{t:02x} is not accepted "
                      "(extension types and 0xc1 are refused)")


def _str(buf: memoryview, at: int, n: int) -> Tuple[str, int]:
    raw, at = _take(buf, at, n)
    try:
        return str(raw, "utf-8"), at
    except UnicodeDecodeError as e:
        raise UnpackError(f"msgpack_lite: str is not utf-8: {e}") from None


def _array(buf: memoryview, at: int, n: int, depth: int, hook=None) -> Tuple[list, int]:
    if n > len(buf) - at:  # every element takes at least one byte
        raise UnpackError(f"msgpack_lite: array of {n} in {len(buf) - at} bytes")
    out = []
    for _ in range(n):
        v, at = _unpack(buf, at, depth + 1, hook)
        out.append(v)
    return out, at


def _map(buf: memoryview, at: int, n: int, depth: int, hook=None) -> Tuple[Any, int]:
    if 2 * n > len(buf) - at:  # every entry takes at least two bytes
        raise UnpackError(f"msgpack_lite: map of {n} in {len(buf) - at} bytes")
    out = {}
    for _ in range(n):
        k, at = _unpack(buf, at, depth + 1, hook)
        if not isinstance(k, (str, bytes)):
            raise UnpackError(f"msgpack_lite: map key of type {type(k).__name__}")
        out[k], at = _unpack(buf, at, depth + 1, hook)
    return (out if hook is None else hook(out)), at
