"""The rest of the port's wire, held to the JAX package's on the same inputs:

  * the coalesced relay's multi envelopes (`coalesce_forward`,
    `split_forward`) and multi replies pack to the reference's bytes (bf16
    hidden rows as torch tensors on the port's side, ml_dtypes arrays on the
    reference's), each decodes the other's, and the rejections match;
  * the legacy msgpack envelopes: the port decodes the reference's
    `pack_legacy` frames and writes their bytes, and INFERD_WIRE=legacy makes
    `pack` emit them (read per call);
  * the native codec (csrc/wirecodec.cpp, built here with the host C++
    compiler) is byte-identical to the port's Python codec and to the
    reference's normative pyimpl on hypothesis payloads, bf16 round-trips,
    and INFERD_NATIVE=0 selects the Python codec per call.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from inferd_tpu import native as jnative
from inferd_tpu.native import pyimpl
from inferd_tpu.runtime import wire as jwire
from inferd_tpu_torch import native
from inferd_tpu_torch.runtime import wire

torch.set_num_threads(2)

BF16 = np.dtype(ml_dtypes.bfloat16)
H = 16


def _rows(n, seed=0):
    """n decode rows [1, 1, H] of bf16: torch for the port, ml_dtypes for JAX."""
    g = torch.Generator().manual_seed(seed)
    t = [torch.randn(1, 1, H, generator=g).to(torch.bfloat16) for _ in range(n)]
    return t, [r.view(torch.int16).numpy().view(BF16) for r in t]


def _env(i, hidden, deadline=True):
    e = {"task_id": f"t{i}", "session_id": f"s{i}", "stage": 1,
         "payload": {"hidden": hidden, "start_pos": 5 + i, "real_len": 1}}
    if deadline:
        e["deadline_ms"] = 1.7e12 + i
    if i % 2:
        e["route"] = {"1": "10.0.0.9:6050"}
    return e


def _pair(n, seed=0, **kw):
    t, j = _rows(n, seed)
    return [_env(i, t[i], **kw) for i in range(n)], [_env(i, j[i], **kw) for i in range(n)]


def _torch_rows(x):
    """A bf16 hidden tensor from either side, as torch bf16."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_coalesced_envelope_bytes_equal_reference(n):
    ours, theirs = _pair(n, seed=n)
    menv = wire.coalesce_forward(ours)
    jenv = jwire.coalesce_forward(theirs)
    assert list(menv) == list(jenv) and menv["multi"] == jenv["multi"]
    assert tuple(menv["hidden"].shape) == (n, 1, H) and menv["hidden"].dtype == torch.bfloat16
    assert wire.pack(menv) == jwire.pack(jenv)
    assert wire.pack_legacy(menv) == jwire.pack_legacy(jenv)


@pytest.mark.parametrize("legacy", [False, True])
def test_split_reads_the_reference_envelope(legacy):
    ours, theirs = _pair(4, seed=1)
    blob = (jwire.pack_legacy if legacy else jwire.pack)(jwire.coalesce_forward(theirs))
    back = wire.split_forward(wire.unpack(blob))
    assert len(back) == 4
    for got, want in zip(back, ours):
        assert set(got) == set(want)
        assert torch.equal(got["payload"]["hidden"], want["payload"]["hidden"])
        assert {k: v for k, v in got["payload"].items() if k != "hidden"} == {
            k: v for k, v in want["payload"].items() if k != "hidden"}
        for k in ("task_id", "session_id", "stage", "deadline_ms", "route"):
            assert got.get(k) == want.get(k)
    # and the reference splits the port's, frame for frame
    jback = jwire.split_forward(jwire.unpack(wire.pack(wire.coalesce_forward(ours))))
    for got, want in zip(jback, back):
        assert torch.equal(_torch_rows(got["payload"]["hidden"]), want["payload"]["hidden"])
        assert got["session_id"] == want["session_id"]


def test_split_of_f32_rows_equals_reference():
    rng = np.random.default_rng(0)
    envs = [_env(i, rng.standard_normal((1, 1, H)).astype(np.float32)) for i in range(3)]
    menv = wire.coalesce_forward(envs)
    assert wire.pack(menv) == jwire.pack(jwire.coalesce_forward(envs))
    for a, b in zip(wire.split_forward(menv), jwire.split_forward(menv)):
        assert wire.pack(a) == jwire.pack(b)


def test_multi_reply_bytes_equal_reference():
    inner = wire.pack({"result_for_user": {"logits": np.arange(6, dtype=np.float32)}})
    reply = {"multi": [{"status": 200, "body": inner}, {"status": 408, "body": b"x"}]}
    assert wire.pack(reply) == jwire.pack(reply)
    assert wire.pack_legacy(reply) == jwire.pack_legacy(reply)
    out = wire.unpack(jwire.pack(reply))
    assert out == reply


def _rejections(mod, rows):
    a = _env(0, rows[0])
    b = dict(_env(1, rows[1]), stage=2)
    c = _env(2, torch.cat([rows[2]] * 2, dim=1) if isinstance(rows[2], torch.Tensor)
             else np.concatenate([rows[2]] * 2, axis=1))  # two tokens: a prefill row
    bad = mod.coalesce_forward([_env(0, rows[0]), _env(1, rows[1])])
    bad["multi"] = bad["multi"][:1]
    no_frames = dict(bad, multi=[])
    not_dict = dict(mod.coalesce_forward([_env(0, rows[0]), _env(1, rows[1])]), multi=[1, 2])
    return [
        ("mixed stages", lambda: mod.coalesce_forward([a, b])),
        ("needs >= 2", lambda: mod.coalesce_forward([a])),
        ("not a decode row", lambda: mod.coalesce_forward([a, c])),
        ("frames vs hidden", lambda: mod.split_forward(bad)),
        ("without frames", lambda: mod.split_forward(no_frames)),
        ("not a dict", lambda: mod.split_forward(not_dict)),
    ]


def test_rejections_match_reference():
    t, j = _rows(3)
    for (what, ours), (_, theirs) in zip(_rejections(wire, t), _rejections(jwire, j)):
        with pytest.raises(ValueError, match=what):
            theirs()
        with pytest.raises(ValueError, match=what):
            ours()


def test_single_session_traffic_is_unchanged():
    """A node that never coalesces sends the bytes it always did."""
    ours, theirs = _pair(1)
    assert wire.pack(ours[0]) == jwire.pack(theirs[0])


# -- legacy envelopes -----------------------------------------------------------------

LEGACY = {
    "scalars": {"task_id": "t", "stage": 1, "relay": False, "x": 1.5, "n": None, "b": b"\x00",
                "big": 2**40, "neg": -70000, "u": "ünï", "l": [1, (2, 3)]},
    "numpy_scalars": {"a": np.float32(1.5), "b": np.float64(2.0), "c": np.int64(-3),
                      "d": np.bool_(True)},
    "tensors": {"payload": {"tokens": np.asarray([[3, 7, 11]], np.int32),
                            "hidden": np.ones((1, 2, 4), np.float16),
                            "e": np.zeros((0, 3), np.uint8)}},
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_emission_and_decode_equal_reference(name):
    payload = LEGACY[name]
    blob = jwire.pack_legacy(payload)
    assert wire.pack_legacy(payload) == blob
    assert wire.pack(wire.unpack(blob)) == jwire.pack(jwire.unpack(blob))


def test_legacy_bf16_round_trips_bit_exact():
    t, j = _rows(1, seed=3)
    blob = jwire.pack_legacy({"hidden": j[0]})
    assert wire.pack_legacy({"hidden": t[0]}) == blob
    got = wire.unpack(blob)["hidden"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, t[0])
    back = jwire.unpack(wire.pack_legacy({"hidden": t[0]}))["hidden"]
    assert back.dtype == BF16 and np.array_equal(back.view(np.int16), j[0].view(np.int16))


def test_inferd_wire_legacy_is_read_per_call(monkeypatch):
    payload = LEGACY["tensors"]
    monkeypatch.setenv("INFERD_WIRE", "legacy")
    assert wire.pack(payload) == jwire.pack(payload) == jwire.pack_legacy(payload)
    monkeypatch.setenv("INFERD_WIRE", "v1")
    assert wire.pack(payload)[:3] == wire.MAGIC


@pytest.mark.parametrize("mutate, error", [
    (lambda d: d.update(dtype="object"), "disallowed wire dtype"),
    (lambda d: d.update(shape=[5]), "payload"),
    (lambda d: d.pop("data"), "without"),
])
def test_legacy_tensor_dicts_are_checked(mutate, error):
    d = {"__nd__": 1, "dtype": "int32", "shape": [2], "data": np.arange(2, dtype=np.int32).tobytes()}
    mutate(d)
    blob = jwire.pack_legacy({"x": d})
    with pytest.raises(ValueError, match=error):
        wire.unpack(blob)


# -- the native codec -------------------------------------------------------------------

_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-(2**63), 2**63 - 1),
    st.floats(allow_nan=False), st.text(max_size=12), st.binary(max_size=12))
_dtypes = st.sampled_from(["float32", "float16", "float64", "int8", "int16", "int32",
                           "int64", "uint8", "uint16", "uint32", "uint64", "bool"])


@st.composite
def _arrays(draw):
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    dt = draw(_dtypes)
    n = int(np.prod(shape, dtype=np.int64))
    raw = draw(st.binary(min_size=n * np.dtype(dt).itemsize, max_size=n * np.dtype(dt).itemsize))
    a = np.frombuffer(raw, dtype=np.uint8).view(dt).reshape(shape).copy()
    return a.astype(bool) if dt == "bool" else a


_values = st.recursive(
    st.one_of(_scalars, _arrays()),
    lambda inner: st.one_of(st.lists(inner, max_size=4),
                            st.dictionaries(st.text(max_size=6), inner, max_size=4)),
    max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_native_codec_bytes_equal_python_and_reference(payload):
    got = native.load(wire.tensor_parts, wire.tensor_build).pack(payload)
    assert got == wire.pack_python(payload) == pyimpl.pack(payload, jnative.tensor_parts)
    assert wire.pack(payload) == got
    for unpack in (wire.unpack, wire.unpack_python):
        assert wire.pack_python(unpack(got)) == got


def test_native_codec_round_trips_bf16():
    t, _ = _rows(1, seed=5)
    x = {"h": t[0], "big": torch.randn(3, 2, 4).to(torch.bfloat16)}
    codec = native.load(wire.tensor_parts, wire.tensor_build)
    blob = codec.pack(x)
    assert blob == wire.pack_python(x)
    back = codec.unpack(blob)
    for k in x:
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], x[k])


def test_native_codec_refuses_what_python_refuses():
    codec = native.load(wire.tensor_parts, wire.tensor_build)
    good = codec.pack({"a": np.arange(3, dtype=np.int32)})
    for blob in (good[:-1], good + b"\x00", b"IW\x02" + good[3:], b"IW\x01\x63"):
        for unpack in (codec.unpack, wire.unpack_python):
            with pytest.raises(ValueError):
                unpack(blob)
    with pytest.raises(TypeError):
        codec.pack({"a": object()})


def test_inferd_native_selects_the_codec_per_call(monkeypatch):
    monkeypatch.setenv("INFERD_NATIVE", "0")
    assert wire.codec_name() == "python"
    monkeypatch.setenv("INFERD_NATIVE", "1")
    assert wire.codec_name() == "native"


def test_a_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails is an error that shows its log."""
    src = tmp_path / "wirecodec.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed building the native wire codec"):
        native.build()
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".so")]
