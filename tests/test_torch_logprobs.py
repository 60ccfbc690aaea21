"""Per-token logprobs in the port: the engine's (on the device) and the
chain client's (from the logits it samples), against re-scoring the
emitted sequence with one forward, against the JAX Engine's, and against
each other. Logprob = log-softmax of the RAW logits, so under greedy
decoding every path reports the same values for the same tokens (f32
TINY: within 5e-4, the tolerance of tests/test_logprobs.py)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core import generate as jgen
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.base import logprob_np, top_logprobs_np
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.core import generate as tgen
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

PROMPT = [3, 7, 11, 19, 5, 2]
STEPS = 8
TOPN = 4


@pytest.fixture(scope="module")
def tiny():
    jp = jax.tree_util.tree_map_with_path(  # 10x weights: varied greedy streams
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


@pytest.fixture(scope="module")
def reference(tiny):
    """The port engine's greedy run with logprobs (chunk 1)."""
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64,
                      sampling_cfg=tcfg.SamplingConfig(temperature=0.0))
    lps, tops = [], []
    ids = eng.generate(PROMPT, max_new_tokens=STEPS, logprob_sink=lps, top_n=TOPN,
                       top_sink=tops)
    assert len(ids) == len(lps) == len(tops) == STEPS
    return ids, lps, tops


def _assert_match(reference, ids, lps, tops, atol=5e-4):
    ref_ids, ref_lps, ref_tops = reference
    assert ids == ref_ids
    np.testing.assert_allclose(lps, ref_lps, atol=atol, rtol=1e-4)
    for (ti, tl), (ri, rl) in zip(tops, ref_tops):
        assert list(ti) == list(ri)
        np.testing.assert_allclose(tl, rl, atol=atol, rtol=1e-4)


def test_engine_logprobs_match_rescoring(tiny, reference):
    """Re-score prompt + emitted ids with ONE JAX forward: log-softmax of
    the row before each token, and its top-N ids."""
    ids, lps, tops = reference
    logits, _, _ = jq.forward(tiny[0], jcfg.TINY, jnp.asarray([PROMPT + ids], jnp.int32))
    lf = np.asarray(logits[0], np.float64)
    for i, t in enumerate(ids):
        row = lf[len(PROMPT) - 1 + i]
        assert abs(lps[i] - logprob_np(row, t)) < 5e-4, i
        want_ids, want_lps = top_logprobs_np(row, TOPN)
        assert tops[i][0] == want_ids
        np.testing.assert_allclose(tops[i][1], want_lps, atol=5e-4)


def test_engine_logprobs_equal_jax_engine(tiny, reference):
    eng = jgen.Engine(jcfg.TINY, tiny[0], max_len=64,
                      sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    lps, tops = [], []
    ids = eng.generate(PROMPT, max_new_tokens=STEPS, logprob_sink=lps, top_n=TOPN,
                       top_sink=tops)
    _assert_match(reference, ids, lps, tops)


@pytest.mark.parametrize("chunk", [2, 8])
def test_engine_chunked_logprobs_equal_per_step(tiny, reference, chunk):
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64,
                      sampling_cfg=tcfg.SamplingConfig(temperature=0.0))
    lps, tops = [], []
    ids = eng.generate(PROMPT, max_new_tokens=STEPS, logprob_sink=lps, top_n=TOPN,
                       top_sink=tops, chunk=chunk)
    _assert_match(reference, ids, lps, tops, atol=1e-5)
    only = []
    assert eng.generate(PROMPT, max_new_tokens=STEPS, logprob_sink=only, chunk=chunk) == ids
    np.testing.assert_allclose(only, lps, atol=1e-6)


def test_chain_client_logprob_sinks(tiny, reference, tmp_path):
    """Two port nodes (CPU): the client's sinks, cleared first, come from the
    logits it samples; greedy, they equal the engine's."""
    parts = str(tmp_path / "parts")
    jstages.split_and_save(tiny[0], jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    nodes = [run_node.make_node(run_node.build_parser().parse_args(
        ["--parts", parts, "--stage", str(s), "--port", "0", "--device", "cpu",
         "--max-len", "64"])).start() for s in range(2)]
    try:
        lps, tops = [1.0], [([0], [0.0])]  # stale entries: the client clears them

        async def go():
            async with ChainClient([(n.host, n.port) for n in nodes],
                                   sampling=tcfg.SamplingConfig(temperature=0.0),
                                   prefill_chunk=4) as c:
                return await c.generate_ids(PROMPT, max_new_tokens=STEPS, logprob_sink=lps,
                                            top_n=TOPN, top_sink=tops)

        ids = asyncio.run(go())
    finally:
        for n in nodes:
            n.stop()
    _assert_match(reference, ids, lps, tops)


def test_numpy_logprob_helpers():
    x = np.random.default_rng(0).standard_normal(50).astype(np.float32) * 4
    lp = x.astype(np.float64) - np.log(np.exp(x.astype(np.float64)).sum())
    assert abs(logprob_np(x, 7) - lp[7]) < 1e-12
    ids, vals = top_logprobs_np(x, 3)
    assert ids == np.argsort(-lp)[:3].tolist() and np.allclose(vals, np.sort(lp)[::-1][:3])
    tie = np.zeros(6, np.float32)
    assert top_logprobs_np(tie, 2)[0] == [0, 1]  # ties to the lower id
