"""The port's wire codec writes the JAX package's bytes (the normative
pure-Python codec, inferd_tpu/native/pyimpl.py) and carries bf16 bit-exact
both ways without ml_dtypes on the port's side."""

import ml_dtypes
import numpy as np
import pytest
import torch

from inferd_tpu import native
from inferd_tpu.native import pyimpl
from inferd_tpu.runtime import wire as jwire
from inferd_tpu_torch.runtime import wire

torch.set_num_threads(2)

BF16 = np.dtype(ml_dtypes.bfloat16)

PAYLOADS = {
    "f32_matrix": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "int32_tokens": np.asarray([[3, 7, 11, 19]], np.int32),
    "scalar_f32": np.float32(2.5),
    "zero_dim": np.asarray(7, np.int64),
    "empty": np.zeros((0, 4), np.float32),
    "nested_envelope": {
        "task_id": "t-1", "session_id": "s-1", "stage": 1, "relay": False,
        "payload": {"hidden": np.ones((1, 3, 8), np.float32), "start_pos": 17,
                    "real_len": 3, "tokens": np.asarray([[5]], np.int32)},
        "trace": None, "weights": [1.5, -2, True, b"\x00\xff", "ünï"],
    },
    "mixed_dtypes": [np.asarray([1, 0], bool), np.asarray([1, 2], np.uint8),
                     np.asarray([1.0], np.float64), np.asarray([-3], np.int16)],
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_pack_bytes_equal_reference(name):
    payload = PAYLOADS[name]
    assert wire.pack(payload) == pyimpl.pack(payload, native.tensor_parts)
    assert wire.pack(payload) == jwire.pack(payload)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_unpack_reference_frames(name):
    payload = PAYLOADS[name]
    got = wire.unpack(jwire.pack(payload))
    want = jwire.unpack(jwire.pack(payload))
    assert wire.pack(got) == jwire.pack(want)


def test_torch_tensors_pack_like_numpy():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    assert wire.pack({"x": t}) == wire.pack({"x": t.numpy()})
    assert wire.pack(t.T) == wire.pack(np.ascontiguousarray(t.T.numpy()))
    assert wire.pack(torch.tensor([[1, 2]], dtype=torch.int32)) == wire.pack(
        np.asarray([[1, 2]], np.int32))


def test_bf16_torch_to_jax_bit_exact():
    t = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    frame = wire.pack({"hidden": t})
    got = jwire.unpack(frame)["hidden"]
    assert got.dtype == BF16 and got.shape == (2, 5, 16)
    assert got.view(np.uint16).tobytes() == t.view(torch.int16).numpy().tobytes()
    # and the JAX side writes the same frame for the same bits
    assert jwire.pack({"hidden": got}) == frame


def test_bf16_jax_to_torch_bit_exact():
    a = (np.random.default_rng(1).standard_normal((3, 7)) * 10).astype(BF16)
    got = wire.unpack(jwire.pack({"h": a, "n": 3}))
    t = got["h"]
    assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 and tuple(t.shape) == (3, 7)
    assert t.view(torch.int16).numpy().tobytes() == a.view(np.uint16).tobytes()
    assert got["n"] == 3
    # round trip through the port unchanged: a client carrying hidden
    # between stages forwards the same bytes it received
    assert wire.pack({"h": t, "n": 3}) == jwire.pack({"h": a, "n": 3})


def test_unpack_rejects_bad_frames():
    good = wire.pack({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        wire.unpack(good[:-3])
    with pytest.raises(ValueError):
        wire.unpack(b"XX" + good[2:])
    with pytest.raises(ValueError):
        wire.unpack(good + b"\x00")
    bad = good.replace(b"float32", b"object7")
    with pytest.raises(ValueError, match="disallowed"):
        wire.unpack(bad)
    with pytest.raises(TypeError):
        wire.pack({1: 2})
    with pytest.raises(TypeError):
        wire.pack(np.asarray(["x"], object))
