"""The port's device sampler (inferd_tpu_torch/core/sampling.py) against the
JAX package's on the same logits.

The filters are the same math: the same finite set, values within 1e-5
(float32, one softmax and cumsum in another order). The draw is held
token-exact against numpy's Gumbel-max over the JAX package's OWN filtered
candidates for the same uniforms; the key (a host splitmix64 chain, not
threefry) is the port's decision and is tested on its own terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu.config import SamplingConfig as JSamplingConfig
from inferd_tpu.core import sampling as js
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.core import sampling as ts
from inferd_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(2)

V = 300
GRID = [  # (temperature, top_k, top_p, min_p)
    (0.0, 0, 1.0, 0.0), (0.7, 0, 1.0, 0.0), (0.6, 20, 0.95, 0.0), (1.0, 8, 1.0, 0.0),
    (0.9, 0, 0.8, 0.0), (1.3, 0, 1.0, 0.1), (0.6, 20, 0.9, 0.05), (0.8, 0, 0.7, 0.02),
    (1.0, V, 0.95, 0.0),
]


def _logits(seed, b=4, v=V, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal((b, v))).astype(np.float32)


@pytest.mark.parametrize("t,k,p,m", GRID)
def test_warped_logits_and_probs_match_jax(t, k, p, m):
    x = _logits(int(t * 10) + k)
    ref = np.asarray(js.warped_logits(jnp.asarray(x), t, k, p, m))
    got = ts.warped_logits(torch.from_numpy(x), t, k, p, m).numpy()
    np.testing.assert_array_equal(got > NEG_INF / 2, ref > NEG_INF / 2)
    keep = ref > NEG_INF / 2
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=1e-5)
    cfg = SamplingConfig(temperature=t, top_k=k, top_p=p, min_p=m)
    jcfg = JSamplingConfig(temperature=t, top_k=k, top_p=p, min_p=m)
    np.testing.assert_allclose(ts.warped_probs(torch.from_numpy(x), cfg).numpy(),
                               np.asarray(js.warped_probs(jnp.asarray(x), jcfg)),
                               rtol=0, atol=1e-5)
    assert ts.passthrough_filters(k, p, m, V) == js.passthrough_filters(k, p, m, V)


def _jax_gumbel_max(x, u, t, k, p, m):
    """numpy's Gumbel-max over the candidates the JAX package's `sample`
    hands to jax.random.categorical."""
    if t == 0.0:
        return np.argmax(x, axis=-1)
    lj = jnp.asarray(x) / jnp.float32(t)
    if js.passthrough_filters(k, p, m, V):
        cand, idx = np.asarray(lj), None
    elif 0 < k < V:
        vals, idx = jax.lax.top_k(lj, k)
        cand = np.asarray(js.min_p_filter(js.top_p_filter(vals, p), m))
        idx = np.asarray(idx)
    else:
        cand, idx = np.asarray(js.min_p_filter(js.top_p_filter(lj, p), m)), None
    choice = np.argmax(cand - np.log(-np.log(u)), axis=-1)
    return choice if idx is None else np.take_along_axis(idx, choice[:, None], -1)[:, 0]


@pytest.mark.parametrize("t,k,p,m", GRID)
def test_sample_from_uniforms_is_gumbel_max_over_jax_candidates(t, k, p, m):
    x = _logits(100 + k)
    n = ts.candidate_count(V, k)
    for seed in range(3):
        u = np.random.default_rng(seed).uniform(1e-6, 1.0, (x.shape[0], n)).astype(np.float32)
        got = ts.sample_from_uniforms(torch.from_numpy(x), torch.from_numpy(u), t, k, p, m)
        np.testing.assert_array_equal(got.numpy(), _jax_gumbel_max(x, u, t, k, p, m))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_logprob_topn_matches_jax(n):
    x = _logits(7)
    tok = np.array([0, 5, 299, 17])
    lp, ti, tl = js.logprob_topn(jnp.asarray(x), jnp.asarray(tok, jnp.int32), n)
    glp, gti, gtl = ts.logprob_topn(torch.from_numpy(x), torch.from_numpy(tok), n)
    np.testing.assert_allclose(glp.numpy(), np.asarray(lp), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gti.numpy(), np.asarray(ti))
    assert gti.dtype == torch.int32 and gti.shape == (4, n)
    np.testing.assert_allclose(gtl.numpy(), np.asarray(tl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [0, 1, 7, V - 1, V])
def test_top_k_filter_matches_jax(k):
    x = _logits(k + 3)
    ref = np.asarray(js.top_k_filter(jnp.asarray(x), k))
    np.testing.assert_array_equal(ts.top_k_filter(torch.from_numpy(x), k).numpy(), ref)


def test_min_p_of_one_is_refused_as_in_jax():
    x = _logits(1)
    with pytest.raises(ValueError, match="min_p"):
        js.min_p_filter(jnp.asarray(x), 1.0)
    with pytest.raises(ValueError, match="min_p"):
        ts.min_p_filter(torch.from_numpy(x), 1.0)


def test_key_chain_and_uniforms():
    """The root key is laid out as jax.random.PRNGKey's; splits run on the
    host, are deterministic, and give distinct keys and subkeys; `sample`
    is sample_from_uniforms on the sub's uniforms."""
    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        want = np.asarray(jax.random.PRNGKey(seed))  # jaxlint: disable=J003 -- the key under test
        np.testing.assert_array_equal(ts.prng_key(seed), want)
    key, seen = ts.prng_key(3), set()
    for _ in range(50):
        key, sub = ts.split_key(key)
        assert key.dtype == np.uint32 and key.shape == (2,)
        seen.update({tuple(key), tuple(sub)})
    assert len(seen) == 100
    a, b = ts.split_key(ts.prng_key(9)), ts.split_key(ts.prng_key(9))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    keys2, subs2 = ts.split_keys(np.stack([ts.prng_key(1), ts.prng_key(2)]))
    np.testing.assert_array_equal(keys2[0], ts.split_key(ts.prng_key(1))[0])
    np.testing.assert_array_equal(subs2[1], ts.split_key(ts.prng_key(2))[1])
    u = ts.uniforms(a[1], (3, 40), "cpu")
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u, ts.uniforms(a[1], (3, 40), "cpu"))
    assert not torch.equal(u, ts.uniforms(b[0], (3, 40), "cpu"))
    x = torch.from_numpy(_logits(4))
    want = ts.sample_from_uniforms(x, ts.uniforms(a[1], (4, 20), "cpu"), 0.6, 20, 0.95, 0.0)
    assert torch.equal(ts.sample(x, a[1], 0.6, 20, 0.95, 0.0), want)
    assert torch.equal(ts.sample_cfg(x, a[1], None), want)  # the default config
    assert torch.equal(ts.sample(x, a[1], 0.0), torch.argmax(x, dim=-1))


def test_draw_follows_the_warped_distribution():
    """Many Gumbel-max draws land on the warped distribution's support with
    its frequencies (a loose check of the draw itself, not of the RNG)."""
    x = torch.from_numpy(_logits(5, b=1, v=40, scale=1.0))
    probs = ts.warped_probs(x, SamplingConfig(temperature=0.8, top_k=6, top_p=0.9))[0]
    key, counts = ts.prng_key(0), torch.zeros(40)
    for _ in range(2000):
        key, sub = ts.split_key(key)
        counts[int(ts.sample(x, sub, 0.8, 6, 0.9, 0.0)[0])] += 1
    assert bool((counts[probs == 0] == 0).all())
    np.testing.assert_allclose((counts / 2000).numpy(), probs.numpy(), atol=0.04)
