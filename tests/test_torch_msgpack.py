"""The port's msgpack subset (inferd_tpu_torch/utils/msgpack_lite) against
the msgpack package the reference gossips with: gossip-shaped values pack
to msgpack.packb(..., use_bin_type=True)'s bytes and read back as
msgpack.unpackb(..., raw=False) reads them, and frames the codec must not
accept (extension types, cut short, lengths past the frame, trailing
bytes, deep nesting, non-str keys) are refused."""

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu_torch.utils import msgpack_lite as M

scalars = (
    st.none() | st.booleans()
    | st.integers(-(1 << 63), (1 << 64) - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=300)
    | st.binary(max_size=300)
)
values = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=40), inner, max_size=20),
    max_leaves=60,
)


def _record(owner, value, version, ts, addr):
    return {"owner": owner, "value": value, "version": version, "ts": ts, "addr": list(addr)}


record_values = st.fixed_dictionaries(
    {"name": st.text(max_size=30), "stage": st.integers(0, 64),
     "load": st.integers(0, 1000), "cap": st.integers(1, 1000),
     "host": st.sampled_from(["127.0.0.1", "0.0.0.0", "10.1.2.3"]),
     "port": st.integers(0, 65535), "model": st.sampled_from(["qwen3-0.6b", "counter"])},
    optional={"svc_ms": st.floats(0, 1e4), "outlier": st.just(1), "shed": st.just(1),
              "draining": st.just(1), "kvfree": st.floats(0, 1), "_tombstone": st.just(True),
              "sess": st.lists(st.text("0123456789abcdef", min_size=16, max_size=16),
                               max_size=8)},
)
frames = st.builds(
    lambda t, sender, recs, reply: {"t": t, "from": sender, "recs": recs,
                                    **({"reply": reply} if t == "state" else {})},
    st.sampled_from(["state", "gossip"]),
    st.text(max_size=30),
    st.lists(st.builds(_record, st.text(max_size=30), record_values,
                       st.integers(0, 1 << 62), st.floats(0, 4e9),
                       st.tuples(st.sampled_from(["127.0.0.1", "0.0.0.0"]),
                                 st.integers(0, 65535))), max_size=6),
    st.booleans(),
) | st.builds(lambda sender, port: {"t": "hello", "from": sender, "port": port},
              st.text(max_size=30), st.integers(0, 65535))


@settings(max_examples=300, deadline=None)
@given(frames)
def test_gossip_frames_pack_to_msgpack_bytes_and_round_trip(frame):
    want = msgpack.packb(frame, use_bin_type=True)
    assert M.packb(frame) == want
    assert M.unpackb(want) == msgpack.unpackb(want, raw=False) == frame


@settings(max_examples=300, deadline=None)
@given(values)
def test_values_pack_to_msgpack_bytes_and_round_trip(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert M.packb(value) == want
    assert M.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_length_boundaries(n):
    for value in ("x" * n, b"x" * n, [0] * n, {str(i): 0 for i in range(min(n, 70000))}):
        want = msgpack.packb(value, use_bin_type=True)
        assert M.packb(value) == want and M.unpackb(want) == value


@pytest.mark.parametrize("v", [0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
                               (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769,
                               -(1 << 31), -(1 << 31) - 1, -(1 << 63)])
def test_integer_boundaries(v):
    assert M.packb(v) == msgpack.packb(v, use_bin_type=True)
    assert M.unpackb(M.packb(v)) == v


def test_float32_reads_back():
    assert M.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


BAD_FRAMES = {
    "ext fixext1": msgpack.packb(msgpack.ExtType(5, b"\x01")),
    "ext8": msgpack.packb(msgpack.ExtType(5, b"abc")),
    "ext in a map": msgpack.packb({"recs": [msgpack.ExtType(1, b"12345678")]}),
    "reserved 0xc1": b"\xc1",
    "empty": b"",
    "cut str": msgpack.packb("hello world")[:-1],
    "cut map": msgpack.packb({"t": "gossip", "from": "a"})[:-3],
    "cut int": b"\xcd\x01",
    "str32 past the frame": b"\xdb\xff\xff\xff\xff" + b"x" * 8,
    "bin32 past the frame": b"\xc6\x7f\xff\xff\xff" + b"x" * 8,
    "array32 past the frame": b"\xdd\xff\xff\xff\xff\x00",
    "map32 past the frame": b"\xdf\xff\xff\xff\xff\x00\x00",
    "trailing bytes": msgpack.packb({"t": "hello"}) + b"\x00",
    "int key": msgpack.packb({1: 2}),
    "bad utf-8": b"\xa2\xff\xfe",
    "deep nesting": b"\x91" * 100 + b"\xc0",
}


@pytest.mark.parametrize("name", sorted(BAD_FRAMES))
def test_refused_frames(name):
    with pytest.raises(M.UnpackError):
        M.unpackb(BAD_FRAMES[name])


def test_pack_refuses_what_msgpack_lite_does_not_cover():
    with pytest.raises(TypeError):
        M.packb({"x": object()})
    with pytest.raises(OverflowError):
        M.packb(1 << 64)
