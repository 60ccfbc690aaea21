"""Port attention vs the JAX package's: flash_gqa (on CPU tensors, its plain
version) against the Pallas kernel run in interpret mode, for both `stream`
values and the cases of tests/test_ops.py; and the composites against the
JAX composites. The CUDA kernel against its plain version is in
tests/test_torch_kernels.py, which imports no JAX so that it also runs on
a machine with a card and without JAX.

Tolerances: f32 atol/rtol 1e-5 (the same math in another summation
order). bf16 atol 2e-2: outputs are ~1 in size where one bf16 ulp is
2^-7, and the Pallas kernel rounds p to bf16 against a running max while
the plain version rounds against the final max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu.models.qwen3 import gqa_attention as jax_gqa_attention
from inferd_tpu.ops.attention import flash_gqa as jax_flash_gqa
from inferd_tpu_torch.models.qwen3 import gqa_attention
from inferd_tpu_torch.ops import attention as A

torch.set_num_threads(2)


def _qkv(seed, b, s, t, nq, nkv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, nkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, nkv, d)).astype(np.float32)
    return q, k, v


def _to_jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _to_torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# (b, s, t, nq, nkv, d, q_start, kv_len, extra): the test_ops.py cases
CASES = {
    "prefill": (1, 16, 16, 4, 2, 16, 0, 16, {}),
    "chunk_mid_sequence": (2, 8, 64, 4, 4, 32, 24, 32, {}),
    "decode_step": (1, 1, 64, 8, 2, 16, 40, 41, {}),
    "ragged_padded": (2, 33, 70, 4, 2, 16, 0, 33, {}),
    "kv_start_offset": (2, 24, 24, 4, 2, 16, 100, 24, {"kv_start": 100}),
    "per_batch_lengths": (3, 4, 32, 4, 2, 16, [0, 8, 20], [4, 12, 24], {}),
    "fully_masked_row": (2, 4, 32, 4, 2, 16, [0, 8], [0, 12], {}),
    "window_prefill": (1, 16, 16, 4, 2, 16, 0, 16, {"window": 8, "softcap": 50.0, "scale": 32.0 ** -0.5}),
    "window_decode": (1, 1, 64, 8, 2, 16, 40, 41, {"window": 8, "softcap": 50.0, "scale": 32.0 ** -0.5}),
    "window_wider_than_context": (2, 8, 64, 4, 4, 32, 24, 32, {"window": 100}),
    "window_with_kv_start": (2, 1, 32, 4, 2, 16, 129, 30, {"window": 8, "kv_start": 100}),
    "sinks_prefill": (1, 16, 16, 4, 2, 16, 0, 16, {"sinks": True}),
    "sinks_ragged": (2, 33, 70, 4, 2, 16, 0, 33, {"sinks": True}),
    "sinks_window_decode": (1, 1, 64, 8, 2, 16, 40, 41, {"sinks": True, "window": 8}),
    "softcap_only": (2, 8, 64, 4, 2, 16, 24, 32, {"softcap": 30.0}),
    "multitile_packed": (1, 40, 64, 4, 2, 16, 20, 60, {"block": 32}),
    "multitile_group3": (2, 33, 96, 6, 2, 16, 0, 33, {"block": 32}),
    "stream_long_buffer": (1, 1, 512, 8, 2, 16, 300, 301, {}),
    "fp8_kv": (1, 8, 128, 4, 2, 16, 100, 108, {"fp8": True}),
}


def _run_pair(case, stream, seed=0, dtype="float32"):
    b, s, t, nq, nkv, d, q_start, kv_len, ex = case
    q, k, v = _qkv(seed, b, s, t, nq, nkv, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = _to_jax(q, jdt), _to_jax(k, jdt), _to_jax(v, jdt)
    tq, tk, tv = _to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt)
    if ex.get("fp8"):
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = tk.to(torch.float8_e4m3fn), tv.to(torch.float8_e4m3fn)
    sinks_np = np.random.default_rng(seed + 1).standard_normal(nq).astype(np.float32) * 2.0
    kw_common = dict(scale=ex.get("scale"), softcap=ex.get("softcap", 0.0))
    jkw = dict(kw_common, window=None if "window" not in ex else jnp.int32(ex["window"]),
               sinks=jnp.asarray(sinks_np) if ex.get("sinks") else None)
    tkw = dict(kw_common, window=ex.get("window"),
               sinks=torch.from_numpy(sinks_np) if ex.get("sinks") else None)
    blk = ex.get("block", 128)
    jqs = jnp.asarray(q_start, jnp.int32) if isinstance(q_start, list) else q_start
    jkl = jnp.asarray(kv_len, jnp.int32) if isinstance(kv_len, list) else kv_len
    tqs = torch.tensor(q_start) if isinstance(q_start, list) else q_start
    tkl = torch.tensor(kv_len) if isinstance(kv_len, list) else kv_len
    ks = ex.get("kv_start", 0)
    ref = jax_flash_gqa(jq, jk, jv, q_start=jqs, kv_len=jkl, kv_start=ks, interpret=True,
                        stream=stream, block_q=blk, block_k=blk, **jkw)
    got = A.flash_gqa(tq, tk, tv, tqs, tkl, ks, stream=stream, **tkw)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy(), got


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_jax_kernel(name, stream):
    ref, got, raw = _run_pair(CASES[name], stream)
    assert raw.dtype == torch.float32 and raw.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_flash_fully_masked_rows_are_zero():
    _ref, got, _raw = _run_pair(CASES["fully_masked_row"], False)
    assert np.all(got[0] == 0.0)
    assert np.abs(got[1]).max() > 0


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("name", ["prefill", "chunk_mid_sequence", "fp8_kv", "sinks_ragged"])
def test_flash_bf16_matches_jax_kernel(name, stream):
    ref, got, raw = _run_pair(CASES[name], stream, dtype="bfloat16")
    assert raw.dtype == torch.bfloat16
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


# composite paths: the port's gqa_attention / decode_gqa vs the JAX composites
COMPOSITE_CASES = {
    "prefill": (1, 16, 16, 4, 2, 16, 0, 16, {}),
    "chunk_window_softcap": (2, 8, 64, 4, 2, 16, 24, 32, {"window": 6, "softcap": 30.0}),
    "chunk_sinks": (2, 8, 64, 4, 2, 16, 24, 32, {"sinks": True}),
    "kv_positions_offset": (2, 12, 12, 4, 2, 16, 50, 12, {"kv_start": 50}),
    "decode": (2, 1, 64, 8, 2, 16, 40, 41, {}),
    "decode_window_sinks": (1, 1, 64, 8, 2, 16, 40, 41, {"window": 8, "sinks": True}),
    "decode_fp8_kv": (1, 1, 64, 4, 2, 16, 40, 41, {"fp8": True}),
}


@pytest.mark.parametrize("name", sorted(COMPOSITE_CASES))
def test_composites_match_jax(name):
    b, s, t, nq, nkv, d, q0, kv_len, ex = COMPOSITE_CASES[name]
    q, k, v = _qkv(3, b, s, t, nq, nkv, d)
    jq, jk, jv = _to_jax(q), _to_jax(k), _to_jax(v)
    tq, tk, tv = _to_torch(q), _to_torch(k), _to_torch(v)
    if ex.get("fp8"):
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = tk.to(torch.float8_e4m3fn), tv.to(torch.float8_e4m3fn)
    pos = q0 + np.broadcast_to(np.arange(s), (b, s))
    kvpos = ex.get("kv_start", 0) + np.arange(t) if "kv_start" in ex else None
    sinks = np.random.default_rng(4).standard_normal(nq).astype(np.float32)
    win = ex.get("window")
    ref = jax_gqa_attention(
        jq, jk, jv, jnp.asarray(pos), jnp.int32(kv_len),
        kv_positions=None if kvpos is None else jnp.asarray(kvpos),
        softcap=ex.get("softcap", 0.0), window=None if win is None else jnp.int32(win),
        sinks=jnp.asarray(sinks) if ex.get("sinks") else None,
    )
    got = gqa_attention(
        tq, tk, tv, torch.from_numpy(pos.copy()), kv_len,
        kv_positions=None if kvpos is None else torch.from_numpy(kvpos),
        softcap=ex.get("softcap", 0.0), window=win,
        sinks=torch.from_numpy(sinks) if ex.get("sinks") else None,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["prefill", "chunk_window_softcap", "decode", "chunk_sinks"])
def test_flash_plain_matches_composite_on_unmasked_rows(name):
    """The two port paths agree wherever a row has a valid slot (they differ
    only on fully masked rows: zeros vs the mean of V)."""
    b, s, t, nq, nkv, d, q0, kv_len, ex = COMPOSITE_CASES[name]
    q, k, v = (_to_torch(x) for x in _qkv(5, b, s, t, nq, nkv, d))
    sinks = torch.randn(nq, generator=torch.Generator().manual_seed(6)) if ex.get("sinks") else None
    pos = q0 + torch.arange(s).expand(b, s)
    comp = gqa_attention(q, k, v, pos, kv_len, softcap=ex.get("softcap", 0.0),
                         window=ex.get("window"), sinks=sinks)
    flash = A.flash_gqa(q, k, v, q0, kv_len, softcap=ex.get("softcap", 0.0),
                        window=ex.get("window"), sinks=sinks)
    torch.testing.assert_close(flash, comp, rtol=1e-5, atol=1e-5)
