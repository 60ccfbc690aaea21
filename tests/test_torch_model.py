# jaxlint: file-disable=J003 -- test code: these loops read each step's logits to ASSERT parity; they are verification loops, not serving hot paths
"""Port Qwen3 model vs the JAX package's on the same TINY weights.

Weights come from the JAX `init_params` and cross through
models/convert.params_from_numpy. The JAX side runs its XLA path (on the
CPU its `auto` attention dispatch is the composite); the port runs
flash_gqa, whose CPU version is the plain masked softmax.

Tolerances: f32 logits atol 1e-4 (the same math, other summation orders,
through 4 layers). bf16: 3% of the largest |logit| (bf16 rounds after
every projection and norm, at different points in XLA and PyTorch, and the
differences compound over the layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.cache import KVCache as JKVCache
from inferd_tpu.models import qwen3 as jq
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core.cache import KVCache, grow
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq

torch.set_num_threads(2)


def _params(cfg_j, seed=0):
    p = jq.init_params(cfg_j, jax.random.PRNGKey(seed))
    # randomize the norms so a mis-applied norm weight cannot hide behind ones
    rng = np.random.default_rng(seed)
    p["layers"]["q_norm"] = jnp.asarray(
        1.0 + 0.1 * rng.standard_normal(p["layers"]["q_norm"].shape), p["layers"]["q_norm"].dtype)
    p["final_norm"] = jnp.asarray(
        1.0 + 0.1 * rng.standard_normal(p["final_norm"].shape), p["final_norm"].dtype)
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p), None)


@pytest.fixture(scope="module")
def tiny():
    return _params(jcfg.TINY)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("b,s", [(1, 20), (2, 13)])
def test_forward_logits_match_jax(tiny, b, s):
    jp, tp = tiny
    toks = _tokens(b * 100 + s, b, s, jcfg.TINY.vocab_size)
    ref, _, _ = jq.forward(jp, jcfg.TINY, jnp.asarray(toks))
    got, nk, nv = tq.forward(tp, tcfg.TINY, torch.from_numpy(toks).long())
    assert nk is None and nv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_forward_composite_path_matches_jax(tiny):
    """attn_impl="xla" runs the port's composite instead of flash_gqa."""
    jp, tp = tiny
    toks = _tokens(7, 1, 18, jcfg.TINY.vocab_size)
    ref, _, _ = jq.forward(jp, jcfg.TINY, jnp.asarray(toks))
    got, _, _ = tq.forward(tp, dataclasses.replace(tcfg.TINY, attn_impl="xla"),
                           torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_forward_cached_prefill_then_decode_matches_jax(tiny):
    """A bucket-padded 17-token prefill (32 rows written), then 8 decode
    steps feeding back the JAX greedy token: logits match at every step."""
    jp, tp = tiny
    cfg_j, cfg_t = jcfg.TINY, tcfg.TINY
    n, steps, max_len = 17, 8, 64
    prompt = _tokens(11, 1, n, cfg_j.vocab_size)
    padded = np.zeros((1, bucket_len(n)), np.int32)
    padded[:, :n] = prompt

    jc = JKVCache.create(cfg_j, cfg_j.num_layers, 1, max_len, ring=False)
    jl, jc = jq.forward_cached(jp, cfg_j, jnp.asarray(padded), None, jc, jnp.int32(0),
                               real_end=jnp.int32(n))
    jc = dataclasses.replace(jc, length=jnp.int32(n))
    tc = KVCache.create(cfg_t, cfg_t.num_layers, 1, max_len)
    tl, tc = tq.forward_cached(tp, cfg_t, torch.from_numpy(padded).long(), None, tc, 0)
    tc.length = n
    np.testing.assert_allclose(tl[:, n - 1].numpy(), np.asarray(jl[:, n - 1]), rtol=0, atol=1e-4)

    tok = int(np.argmax(np.asarray(jl[0, n - 1])))
    for i in range(steps):
        pos = n + i
        jl, jc = jq.forward_cached(jp, cfg_j, jnp.asarray([[tok]], jnp.int32), None, jc,
                                   jc.length, real_end=jc.length + 1)
        jc = dataclasses.replace(jc, length=jc.length + 1)
        tl, tc = tq.forward_cached(tp, cfg_t, torch.tensor([[tok]]), None, tc, tc.length)
        tc.length += 1
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl[:, 0]), rtol=0, atol=1e-4,
                                   err_msg=f"decode step {i} (position {pos})")
        tok = int(np.argmax(np.asarray(jl[0, 0])))
    # the KV buffers themselves agree on every populated slot
    np.testing.assert_allclose(tc.k[:, :, : n + steps].numpy(),
                               np.asarray(jc.k[:, :, : n + steps]), rtol=0, atol=1e-5)


def test_forward_bf16_close_to_jax(tiny):
    cfg_j = dataclasses.replace(jcfg.TINY, dtype="bfloat16")
    cfg_t = dataclasses.replace(tcfg.TINY, dtype="bfloat16")
    jp, tp = _params(cfg_j, seed=1)
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(3, 1, 24, cfg_j.vocab_size)
    ref = np.asarray(jq.forward(jp, cfg_j, jnp.asarray(toks))[0], np.float32)
    got = tq.forward(tp, cfg_t, torch.from_numpy(toks).long())[0].float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 0.03 * scale, (np.abs(got - ref).max(), scale)


def test_bf16_params_cross_bit_exact():
    cfg_j = dataclasses.replace(jcfg.TINY, dtype="bfloat16")
    p = jq.init_params(cfg_j, jax.random.PRNGKey(2))
    pn = jax.tree.map(np.asarray, p)
    tp = convert.params_from_numpy(pn, tcfg.TINY)
    back = convert.params_to_numpy(tp, bf16_dtype=jnp.bfloat16)
    for a, b in zip(jax.tree.leaves(pn), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.view(np.uint16).tobytes() == b.view(np.uint16).tobytes()


def test_qwen2_style_biases_match_jax():
    cfg_j, cfg_t = jcfg.TINY_QWEN2, tcfg.TINY_QWEN2
    jp = jq.init_params(cfg_j, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    for name in ("q_bias", "k_bias", "v_bias"):
        jp["layers"][name] = jnp.asarray(0.1 * rng.standard_normal(jp["layers"][name].shape),
                                         jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t)
    toks = _tokens(5, 1, 10, cfg_j.vocab_size)
    ref, _, _ = jq.forward(jp, cfg_j, jnp.asarray(toks))
    got, _, _ = tq.forward(tp, cfg_t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_rope_and_norm_match_jax():
    pos = np.arange(0, 700, 7, dtype=np.int32).reshape(2, 50)
    jc, js = jq.rope_cos_sin(jnp.asarray(pos), 128, 1_000_000.0)
    tc, ts = tq.rope_cos_sin(torch.from_numpy(pos), 128, 1_000_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-5)
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tq.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(jq.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-gemma2", "tiny-llama", "tiny-gptoss"])
def test_unported_architectures_raise(name):
    """Sandwich norms and sliding windows still raise, naming the ROADMAP
    item that brings them (A5b, for tiny-gptoss too: its MoE layer has
    landed, its sliding windows wait); tiny-llama (llama3 RoPE) and
    tiny-moe (MoE layers) have landed and initialise and run."""
    cfg = tcfg.get_config(name)
    if name in ("tiny-llama", "tiny-moe"):
        p = tq.init_params(cfg, torch.Generator().manual_seed(0))
        logits, _, _ = tq.forward(p, cfg, torch.tensor([[1, 2, 3]]))
        assert logits.shape == (1, 3, cfg.vocab_size) and bool(torch.isfinite(logits).all())
        return
    item = {"tiny-gemma2": "A5b", "tiny-gptoss": "A5b"}[name]
    with pytest.raises(NotImplementedError, match=f"not ported.*{item}"):
        tq.init_params(cfg, torch.Generator().manual_seed(0))


# -- scaled RoPE and the Llama-3 family -----------------------------------------------

ROPE_PRESETS = ["llama3.2-1b", "llama3.1-8b", "tiny-llama", "gpt-oss-20b", "tiny-gptoss"]
ROPE_POSITIONS = 4096  # every position a node serves (MAX_LEN)


class _AnglesSeen:
    """The JAX module's jnp, keeping the argument of every cos it takes:
    the angle table rope_cos_sin builds, before the yarn attention factor."""

    def __init__(self):
        self.angles = []

    def cos(self, x):
        self.angles.append(np.asarray(x))
        return jnp.cos(x)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("name", ROPE_PRESETS)
def test_scaled_rope_matches_jax(monkeypatch, name):
    """llama3 and yarn RoPE against the reference at every served position.

    inv_freq (the angles at position 1) within 1 ulp of the reference's:
    `theta ** x` may round differently in XLA and torch. cos and sin at
    positions 0..4095 within pos * ulp(f) + ulp(angle) (that 1-ulp step of
    f moved by the position, then the product's rounding), times the
    attention factor, plus 2 ulps of 1 for cos/sin themselves."""
    cj, ct = jcfg.get_config(name), tcfg.get_config(name)
    assert ct.rope_scaling == cj.rope_scaling != "none"
    pos = np.arange(ROPE_POSITIONS, dtype=np.int32)[None, :]
    jcos, jsin = (np.asarray(x) for x in jq.rope_cos_sin(jnp.asarray(pos), cj.head_dim,
                                                        cj.rope_theta, cj))
    tcos, tsin = (x.numpy() for x in tq.rope_cos_sin(torch.from_numpy(pos), ct.head_dim,
                                                     ct.rope_theta, ct))
    seen = _AnglesSeen()
    with monkeypatch.context() as m:
        m.setattr(jq, "jnp", seen)
        jq.rope_cos_sin(jnp.ones((1, 1), jnp.int32), cj.head_dim, cj.rope_theta, cj)
    j_freq = seen.angles[0][0, 0, : cj.head_dim // 2]  # the angles at position 1
    exps = torch.arange(0, ct.head_dim, 2, dtype=torch.float32) / ct.head_dim
    t_freq, factor = tq._scaled_inv_freq(1.0 / (ct.rope_theta ** exps), ct.head_dim,
                                         ct.rope_theta, ct)
    t_freq = t_freq.numpy()
    assert (factor != 1.0) == (name in ("gpt-oss-20b", "tiny-gptoss"))
    ulps = np.abs(t_freq.view(np.int32).astype(np.int64) - j_freq.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps
    f = j_freq
    angle = pos[0, :, None].astype(np.float32) * f[None, :]
    tol = factor * (pos[0, :, None] * np.spacing(f)[None, :] + np.spacing(angle)) + 2 * 2.0**-24
    tol = np.concatenate([tol, tol], axis=-1)[None]
    for got, want in ((tcos, jcos), (tsin, jsin)):
        assert got.shape == want.shape == (1, ROPE_POSITIONS, cj.head_dim)
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.fixture(scope="module")
def tiny_llama():
    cfg_j = jcfg.TINY_LLAMA
    p = jq.init_params(cfg_j, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)  # norms off ones, so a mis-applied weight shows
    p["final_norm"] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(p["final_norm"].shape),
                                  jnp.float32)
    p["layers"]["input_norm"] = jnp.asarray(
        1.0 + 0.1 * rng.standard_normal(p["layers"]["input_norm"].shape), jnp.float32)
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg.TINY_LLAMA)


def test_tiny_llama_forward_matches_jax(tiny_llama):
    """tiny-llama (llama3 RoPE, no q/k norm, no bias) against the JAX forward,
    f32, atol 1e-4; 160 positions, past rope_original_max_position (128),
    so the slowed bands turn."""
    jp, tp = tiny_llama
    toks = _tokens(21, 2, 160, jcfg.TINY_LLAMA.vocab_size)
    ref, _, _ = jq.forward(jp, jcfg.TINY_LLAMA, jnp.asarray(toks))
    got, _, _ = tq.forward(tp, tcfg.TINY_LLAMA, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_tiny_llama_cache_matches_cacheless(tiny_llama):
    """KV-cached decode == the cacheless forward for the llama variant (the
    reference's test_llama_cache_matches_cacheless), atol 2e-4 as there."""
    _, tp = tiny_llama
    cfg = tcfg.TINY_LLAMA
    toks = torch.from_numpy(_tokens(4, 1, 10, cfg.vocab_size)).long()
    full, _, _ = tq.forward(tp, cfg, toks)
    cache = KVCache.create(cfg, cfg.num_layers, 1, 32)
    logits, cache = tq.forward_cached(tp, cfg, toks[:, :6], None, cache, 0)
    cache.length = 6
    outs = [logits[:, -1]]
    for i in range(6, 10):
        logits, cache = tq.forward_cached(tp, cfg, toks[:, i:i + 1], None, cache, cache.length)
        cache.length += 1
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), full[:, 5:10].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_tiny_llama_stage_split_matches_full(tiny_llama):
    """Two sliced stages == the full layer stack (the reference's
    test_stage_split_matches_full), at offset positions on the scaled bands."""
    _, tp = tiny_llama
    cfg = tcfg.TINY_LLAMA
    toks = torch.from_numpy(_tokens(2, 2, 5, cfg.vocab_size)).long()
    positions = 150 + torch.arange(5).expand(2, 5)
    hidden = tq.embed(tp, toks, cfg)
    full, _, _ = tq.forward_layers(tp["layers"], cfg, hidden, positions)
    h, _, _ = tq.forward_layers(tq.slice_layers(tp["layers"], 0, 2), cfg, hidden, positions)
    h, _, _ = tq.forward_layers(tq.slice_layers(tp["layers"], 2, 4), cfg, h, positions)
    np.testing.assert_allclose(h.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_init_params_layout_matches_jax():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    tp = tq.init_params(tcfg.TINY, torch.Generator().manual_seed(0))
    jshapes = {k: tuple(v.shape) for k, v in jp["layers"].items()}
    tshapes = {k: tuple(v.shape) for k, v in tp["layers"].items()}
    assert list(jshapes.items()) == list(tshapes.items())
    assert list(jp) == list(tp)
    assert tuple(tp["embed"].shape) == tuple(jp["embed"].shape)
    # same seed, same draw: the init is reproducible
    tp2 = tq.init_params(tcfg.TINY, torch.Generator().manual_seed(0))
    assert torch.equal(tp["layers"]["q_proj"], tp2["layers"]["q_proj"])


def test_cache_overflow_and_grow():
    c = KVCache.create(tcfg.TINY, 2, 1, 16)
    c.k[:, :, :10] = 1.0
    c.length = 10
    c.ensure_room(6)
    with pytest.raises(BufferError, match="overflow"):
        c.ensure_room(7, owner="s1")
    g = grow(c, KVCache.create(tcfg.TINY, 2, 1, 64))
    assert g.max_len == 64 and g.length == 10
    assert torch.equal(g.k[:, :, :16], c.k) and float(g.k[:, :, 16:].abs().max()) == 0.0
    for into in (KVCache.create(tcfg.TINY, 2, 1, 64), KVCache.create(tcfg.TINY, 2, 2, 128)):
        with pytest.raises(ValueError, match="grow"):  # not larger, or another batch
            grow(g, into)
    with pytest.raises(BufferError):  # a write past the buffer raises, never clamps
        tq.forward_cached(
            tq.init_params(tcfg.TINY, torch.Generator().manual_seed(0)), tcfg.TINY,
            torch.zeros((1, 8), dtype=torch.long), None,
            KVCache.create(tcfg.TINY, 4, 1, 16), 12,
        )
