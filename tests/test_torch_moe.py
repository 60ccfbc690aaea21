# jaxlint: file-disable=J003 -- test code: these loops read each step's logits to ASSERT parity; they are verification loops, not serving hot paths
"""Mixture-of-experts layers in the port (models/qwen3 route_topk, route,
expert_ffn, moe_mlp; ops/quant qeinsum) against the JAX package's, and
the serving surfaces on an MoE model.

Weights come from the JAX `init_params` (every non-norm leaf x10, so a
greedy stream is not one repeated token; the expert and router biases
drawn, where a config has them) and cross through
models/convert.params_from_numpy. Three MoE configs: tiny-moe (Qwen3-MoE:
softmax over all experts, top-k, renormalized), test_torch_loader's tiny
Mixtral-shaped one (no q/k norm, untied head, 4 experts) and tiny-gptoss's
expert block (top-k over the logits, then softmax; biased experts, the
swiglu_limit clamp), whose attention waits for ROADMAP A5b, so only its
MoE layer runs.

Tolerances: routing indices EQUAL to jax.lax.top_k's, ties included
(equal logits planted); weights atol 1e-6 (f32 softmax, other summation
orders); f32 layer outputs and logits atol 1e-4 of their largest value
(the same math, other orders); bf16 layer outputs 3% of their largest
value (bf16 rounds after every product, at other points in XLA and
PyTorch); qeinsum f32 rtol = atol = 3e-5, the reference's own limit for
the grouped int4 contraction against the dequantized einsum
(tests/test_quant.py:436); greedy streams token for token."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.batch import BatchedEngine as JBatchedEngine
from inferd_tpu.core.cache import KVCache as JKVCache
from inferd_tpu.core.generate import Engine as JEngine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import quant as jquant
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.core.batch import BatchedEngine
from inferd_tpu_torch.core.cache import KVCache
from inferd_tpu_torch.core.generate import Engine
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.ops import quant as tquant
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.perf import anatomy
from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from test_torch_loader import both_configs, hf_state_dict, write_checkpoint

torch.set_num_threads(2)

GREEDY = tcfg.SamplingConfig(temperature=0.0)
GREEDY_J = jcfg.SamplingConfig(temperature=0.0)
PROMPTS = ([3, 17, 42, 9, 5, 8, 2, 11, 60, 1, 77, 130, 4], [200, 7, 7, 31, 250])
STEPS = 8


def _params(cfg_j, seed=0):
    """(JAX params, the port's): the JAX init with every non-norm leaf x10
    and the zero-initialised biases drawn."""
    p = jq.init_params(cfg_j, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def scale(path, x):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return x
        if "bias" in name:
            return jnp.asarray(0.5 * rng.standard_normal(x.shape), x.dtype)
        return x * 10.0

    p = jax.tree_util.tree_map_with_path(scale, p)
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p))


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# -- routing: top-k with ties ----------------------------------------------------------

TIE_CASES = {
    # each row: a pattern the k-th place can tie on
    "all_equal": np.zeros((2, 8), np.float32),
    "tie_at_kth": np.array([[3.0, 1.0, 2.0, 2.0, 0.5, 2.0, -1.0, 2.0],
                            [1.0, 5.0, 1.0, 5.0, 1.0, 1.0, 0.0, 5.0]], np.float32),
    "pairs": np.repeat(np.array([[0.3, -0.2, 1.5, 0.9]], np.float32), 2, axis=1),
    "random_duplicates": np.round(np.random.default_rng(7).standard_normal((6, 8)), 1)
    .astype(np.float32),
}


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_top_k_lowest_first_picks_lax_top_k(case, k):
    x = TIE_CASES[case]
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tq.top_k_lowest_first(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


ROUTE_MODES = {
    "softmax_topk_norm": dict(moe_router_mode="softmax_topk", norm_topk_prob=True),
    "softmax_topk_raw": dict(moe_router_mode="softmax_topk", norm_topk_prob=False),
    "topk_softmax": dict(moe_router_mode="topk_softmax"),
}


@pytest.mark.parametrize("mode", sorted(ROUTE_MODES))
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_route_topk_and_route_match_jax(case, mode):
    """Both routing modes (and softmax_topk without renormalization) on
    logits with planted ties: the reference's experts, its weights and its
    dense combine matrix."""
    kw = dict(ROUTE_MODES[mode], num_experts=8, num_experts_per_tok=2, moe_intermediate_size=8)
    cfg_j = dataclasses.replace(jcfg.TINY, **kw)
    cfg_t = dataclasses.replace(tcfg.TINY, **kw)
    logits = TIE_CASES[case]
    jw, ji = jq.route_topk(cfg_j, jnp.asarray(logits))
    tw, ti = tq.route_topk(cfg_t, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    jc, _ = jq.route(cfg_j, jnp.asarray(logits))
    tc, ti2 = tq.route(cfg_t, torch.from_numpy(logits))
    assert tc.dtype == torch.float32 and torch.equal(ti2, ti)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_route_ties_pick_the_lower_expert_not_topk_order():
    """The case torch.topk leaves open: two experts tie at the k-th place,
    and the lower index must win, as lax.top_k decides."""
    cfg = dataclasses.replace(tcfg.TINY, num_experts=4, num_experts_per_tok=1,
                              moe_intermediate_size=8)
    logits = torch.tensor([[0.0, 1.0, 1.0, 0.0], [2.0, 0.0, 0.0, 2.0]])
    _, idx = tq.route_topk(cfg, logits)
    assert idx[:, 0].tolist() == [1, 0]


# -- the MoE layer -----------------------------------------------------------------------

MOE_CONFIGS = ["tiny-moe", "tiny-mixtral", "tiny-gptoss"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_expert_ffn_and_moe_mlp_match_jax(name, dtype):
    cfg_j, cfg_t = both_configs(name)
    cfg_j = dataclasses.replace(cfg_j, dtype=dtype)
    cfg_t = dataclasses.replace(cfg_t, dtype=dtype)
    jp, tp = _params(cfg_j, seed=len(name))
    jl, tl = _layer(jp, 1), _layer(tp, 1)
    x = np.random.default_rng(3).standard_normal((2, 5, cfg_j.hidden_size)).astype(np.float32)
    xj = jnp.asarray(x, cfg_j.jnp_dtype)
    xt = convert.tensor_from_numpy(np.asarray(xj))
    tol = 1e-4 if dtype == "float32" else 3e-2

    want = np.asarray(jq.expert_ffn(jl, cfg_j, xj.reshape(10, -1)), np.float32)
    got = _np(tq.expert_ffn(tl, cfg_t, xt.reshape(10, -1)))
    assert got.shape == (10, cfg_j.num_experts, cfg_j.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())

    want = np.asarray(jq.moe_mlp(jl, cfg_j, xj), np.float32)
    got = tq.moe_mlp(tl, cfg_t, xt)
    assert got.dtype == cfg_t.torch_dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * np.abs(want).max())


def test_gptoss_clamp_is_live():
    """The swiglu_limit clamp changes tiny-gptoss's experts at these
    weights (so the parity above covers it), and matches the reference's
    once the limit is lifted too."""
    cfg_j, cfg_t = both_configs("tiny-gptoss")
    jp, tp = _params(cfg_j, seed=5)
    x = 3.0 * np.random.default_rng(4).standard_normal((6, cfg_j.hidden_size)).astype(np.float32)
    clamped = tq.expert_ffn(_layer(tp), cfg_t, torch.from_numpy(x))
    free_t = dataclasses.replace(cfg_t, swiglu_limit=0.0)
    free_j = dataclasses.replace(cfg_j, swiglu_limit=0.0)
    unclamped = tq.expert_ffn(_layer(tp), free_t, torch.from_numpy(x))
    assert (clamped - unclamped).abs().max() > 1e-2
    want = np.asarray(jq.expert_ffn(_layer(jp), free_j, jnp.asarray(x)))
    np.testing.assert_allclose(unclamped.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_moe():
    return _params(jcfg.TINY_MOE)


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_forward_logits_match_jax(name):
    cfg_j, cfg_t = both_configs(name)
    jp, tp = _params(cfg_j, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab_size, (2, 11)).astype(np.int32)
    ref, _, _ = jq.forward(jp, cfg_j, jnp.asarray(toks))
    got, _, _ = tq.forward(tp, cfg_t, torch.from_numpy(toks).long())
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_forward_cached_prefill_then_decode_match_jax(tiny_moe):
    jp, tp = tiny_moe
    cfg_j, cfg_t = jcfg.TINY_MOE, tcfg.TINY_MOE
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (1, 9)).astype(np.int32)
    jc = JKVCache.create(cfg_j, cfg_j.num_layers, 1, 32)
    tc = KVCache.create(cfg_t, cfg_t.num_layers, 1, 32)
    ref, jc = jq.forward_cached(jp, cfg_j, jnp.asarray(toks), None, jc, jnp.int32(0))
    got, tc = tq.forward_cached(tp, cfg_t, torch.from_numpy(toks).long(), None, tc, 0)
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * scale)
    tok = int(np.argmax(np.asarray(ref)[0, -1]))
    for pos in range(9, 15):
        ref, jc = jq.forward_cached(jp, cfg_j, jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray([[pos]], jnp.int32), jc, jnp.int32(pos))
        got, tc = tq.forward_cached(tp, cfg_t, torch.tensor([[tok]]), torch.tensor([[pos]]),
                                    tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * scale)
        tok = int(np.argmax(np.asarray(ref)[0, -1]))


# -- serving an MoE model ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(tiny_moe):
    eng = JEngine(jcfg.TINY_MOE, tiny_moe[0], max_len=64, sampling_cfg=GREEDY_J)
    streams = [eng.generate(p, max_new_tokens=STEPS) for p in PROMPTS]
    assert len({tuple(s) for s in streams}) == len(streams)
    assert all(len(set(s)) > 1 for s in streams)  # the streams vary
    return streams


def _chain_step(executors, sid, payload):
    for ex in executors:
        out = ex.process(sid, payload)
        if "logits" in out:
            return out["logits"]
        payload = {"hidden": out["hidden"], "start_pos": out["start_pos"],
                   "real_len": out["real_len"]}
    raise AssertionError("no logits")


def _greedy(executors, prompt, steps, sid="s"):
    lg = _chain_step(executors, sid, {"tokens": np.asarray([prompt], np.int32),
                                      "start_pos": 0, "real_len": len(prompt)})
    toks = [int(np.argmax(_np(lg)[0]))]
    for i in range(steps - 1):
        lg = _chain_step(executors, sid, {"tokens": np.asarray([[toks[-1]]], np.int32),
                                          "start_pos": len(prompt) + i, "real_len": 1})
        toks.append(int(np.argmax(_np(lg)[0])))
    for ex in executors:
        ex.end_session(sid)
    return toks


def _stages(params, cfg, n):
    out = []
    for spec in tstages.Manifest.even_split(cfg.name, n).stage_specs():
        out.append((tstages.extract_stage_params(params, cfg, spec), spec))
    return out


def test_engine_and_stage_pipeline_equal_jax_engine(tiny_moe, jax_streams):
    """The port's Engine, and a 2-stage chain of its one-session executors
    (the expert stacks sliced per stage like dense layers), give the JAX
    Engine's greedy streams token for token (the reference's
    test_moe_pipeline_matches_engine, held to the JAX package)."""
    eng = Engine(tcfg.TINY_MOE, tiny_moe[1], max_len=64, sampling_cfg=GREEDY)
    assert [eng.generate(p, max_new_tokens=STEPS) for p in PROMPTS] == jax_streams
    chain = [Qwen3StageExecutor(tcfg.TINY_MOE, spec, sp, max_len=64, initial_kv_len=16)
             for sp, spec in _stages(tiny_moe[1], tcfg.TINY_MOE, 2)]
    for i, p in enumerate(PROMPTS):
        assert _greedy(chain, p, STEPS, sid=f"s{i}") == jax_streams[i]


@pytest.mark.parametrize("block_size", [0, 8], ids=["dense", "paged"])
def test_lane_executors_cobatched_equal_jax_engine(tiny_moe, jax_streams, block_size):
    """Both stage lane layouts (dense and paged), two stages, both sessions
    decoding in one process_batch per stage per step."""
    kw = dict(lanes=4, max_len=64, block_size=block_size, prefill_chunk=8)
    lanes = [BatchedStageExecutor(tcfg.TINY_MOE, spec, sp, **kw)
             for sp, spec in _stages(tiny_moe[1], tcfg.TINY_MOE, 2)]
    sids = ["a", "b"]
    toks = {}
    for sid, p in zip(sids, PROMPTS):
        lg = _chain_step(lanes, sid, {"tokens": np.asarray([p], np.int32), "start_pos": 0,
                                      "real_len": len(p)})
        toks[sid] = [int(np.argmax(_np(lg)[0]))]
    for step in range(STEPS - 1):
        items = [(sid, {"tokens": [[toks[sid][-1]]], "start_pos": len(p) + step, "real_len": 1})
                 for sid, p in zip(sids, PROMPTS)]
        for ex in lanes:
            outs = ex.process_batch(items)
            assert not any(isinstance(o, Exception) for o in outs), outs
            if "logits" in outs[0]:
                break
            items = [(sid, {"hidden": o["hidden"], "start_pos": o["start_pos"], "real_len": 1})
                     for (sid, _), o in zip(items, outs)]
        for sid, o in zip(sids, outs):
            toks[sid].append(int(np.argmax(_np(o["logits"])[0])))
    assert [toks[s] for s in sids] == jax_streams
    for ex in lanes:
        assert ex.stats()["batched_tokens"] == 2 * (STEPS - 1)


def test_batched_engine_and_executor_equal_jax(tiny_moe, jax_streams):
    """Whole-model lanes: the port's BatchedEngine gives the JAX
    BatchedEngine's streams (and the solo Engine's), and a BatchedExecutor
    serves them one step at a time."""
    want = JBatchedEngine(jcfg.TINY_MOE, tiny_moe[0], lanes=2, max_len=64,
                          sampling_cfg=GREEDY_J).generate_all(list(PROMPTS), max_new_tokens=STEPS,
                                                              seed=0)
    eng = BatchedEngine(tcfg.TINY_MOE, tiny_moe[1], lanes=2, max_len=64, sampling_cfg=GREEDY)
    got = eng.generate_all(list(PROMPTS), max_new_tokens=STEPS, seed=0, chunk=4)
    assert got == want == jax_streams
    ex = BatchedExecutor(tcfg.TINY_MOE, tiny_moe[1], lanes=2, max_len=64, window_ms=1.0)
    for i, p in enumerate(PROMPTS):
        assert _greedy([ex], p, STEPS, sid=f"b{i}") == jax_streams[i]


@pytest.mark.parametrize("flag", ["int8", "int4"])
def test_quantized_moe_stages_serve_the_jax_quantized_stream(tiny_moe, flag):
    """--quant on an MoE stage quantizes the expert stacks (never the
    router), and the one-session executors of both packages over the same
    quantized stages give the same greedy streams."""
    saved = (jquant.INT4_MODE, tquant.INT4_MODE)
    jquant.INT4_MODE = tquant.INT4_MODE = "grouped"  # what the port's int4 nodes serve
    try:
        jex, tex = [], []
        for spec in jstages.Manifest.even_split("tiny-moe", 2).stage_specs():
            jsp = jquant.apply_quant_mode(
                flag, jstages.extract_stage_params(tiny_moe[0], jcfg.TINY_MOE, spec),
                tie_word_embeddings=True, needs_head=spec.is_last)
            tsp = convert.params_from_numpy(jax.tree.map(np.asarray, jsp))
            assert not isinstance(tsp["layers"]["router"], tquant.QTYPES)
            assert isinstance(tsp["layers"]["gate_proj"], tquant.QTYPES)
            assert tsp["layers"]["gate_proj"].ndim == 4  # [L, E, K, N]
            tspec = tstages.StageSpec(spec.stage, spec.num_stages, spec.start_layer,
                                      spec.end_layer)
            jex.append(JExecutor(jcfg.TINY_MOE, spec, jsp, max_len=64, initial_kv_len=16))
            tex.append(Qwen3StageExecutor(tcfg.TINY_MOE, tspec, tsp, max_len=64,
                                          initial_kv_len=16))
        for i, p in enumerate(PROMPTS):
            assert _greedy(tex, p, STEPS, sid=f"t{i}") == _greedy(jex, p, STEPS, sid=f"j{i}")
    finally:
        jquant.INT4_MODE, tquant.INT4_MODE = saved


def test_w8a8_still_waits_for_a6(tiny_moe):
    with pytest.raises(NotImplementedError, match="A6"):
        tquant.apply_quant_mode("w8a8", tiny_moe[1])


# -- qeinsum: the expert contractions under quantization -----------------------------------

EINSUMS = {"th,ehi->tei": ((6, 256), (4, 256, 96)), "tei,eih->teh": ((6, 4, 96), (4, 96, 256))}


def _same_weight(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("spec", sorted(EINSUMS))
def test_qeinsum_matches_jax_and_the_dequantized_einsum(spec, bits):
    """Both expert einsums over int8 and grouped int4 stacks: the port's
    qeinsum against the reference's on the same quantized bytes, and (the
    reference's own test) exact, within 3e-5, against the einsum over the
    explicitly dequantized weight."""
    xs, ws = EINSUMS[spec]
    xj, xt = _same_weight(1, xs)
    wj, wt = _same_weight(2, ws)
    jquantize = jquant.quantize if bits == 8 else jquant.quantize_int4
    tquantize = tquant.quantize if bits == 8 else tquant.quantize_int4
    qj, qt = jquantize(wj), tquantize(wt)
    if bits == 4:
        assert qt.scale.shape[-2] == ws[-2] // 128 or ws[-2] < 128
    saved = (jquant.INT4_MODE, tquant.INT4_MODE)
    jquant.INT4_MODE = tquant.INT4_MODE = "grouped"
    try:
        want = np.asarray(jquant.qeinsum(spec, xj, qj))
        got = tquant.qeinsum(spec, xt, qt).numpy()
    finally:
        jquant.INT4_MODE, tquant.INT4_MODE = saved
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    deq = torch.einsum(spec, xt, qt.dequantize(torch.float32)).numpy()
    np.testing.assert_allclose(got, deq, rtol=3e-5, atol=3e-5)


def test_int4_grouped_einsum_declines_what_it_cannot_group():
    """A spec whose contraction is not the weight's -2 axis, or that sums
    a weight axis away, has no grouped form (the reference's rule): None,
    and qeinsum widens the weight instead."""
    q = tquant.quantize_int4(torch.randn(4, 256, 96))
    x = torch.randn(6, 256)
    assert tquant._int4_grouped_einsum("th,ehi->ti", x, q) is None  # e summed away
    assert tquant._int4_grouped_einsum("ti,ehi->teh", torch.randn(6, 96), q) is None
    assert tquant._int4_grouped_einsum("bad", x, q) is None
    got = tquant.qeinsum("th,ehi->ti", x, q)
    torch.testing.assert_close(got, torch.einsum("th,ehi->ti", x, q.dequantize(torch.float32)))


# -- refusals, the anatomy and the CLIs -----------------------------------------------------


def test_moe_presets_pass_check_supported_and_a5b_still_refuses():
    for name in ("qwen3-moe-30b-a3b", "mixtral-8x7b", "tiny-moe"):
        tq.check_supported(tcfg.get_config(name))
    for name in ("tiny-gptoss", "gpt-oss-20b", "gpt-oss-120b", "tiny-gemma2", "gemma2-2b"):
        with pytest.raises(NotImplementedError, match="A5b") as e:
            tq.check_supported(tcfg.get_config(name))
        assert "A5c" not in str(e.value)


def test_moe_refuses_adapters_as_the_reference(tiny_moe):
    with pytest.raises(ValueError, match="MoE"):
        tq.forward_layers(tiny_moe[1]["layers"], tcfg.TINY_MOE,
                          torch.zeros(1, 2, tcfg.TINY_MOE.hidden_size), 0, adapters=object())


def test_anatomy_profile_step_runs_the_moe_layer():
    out = anatomy.profile_step(tcfg.TINY_MOE, ctx=16, pairs=1, short=1, long_=2,
                               phases=["mlp"], with_step=False, device="cpu")
    assert out["phases"]["mlp"]["ms"] > 0 and out["phases"]["mlp"]["bytes"] > 0


def test_cli_split_run_node_and_generate_on_tiny_moe(tmp_path, monkeypatch, capsys):
    """The CLIs with --model tiny-moe on a Qwen3-MoE checkpoint in an HF
    cache, cut to 3 of the preset's 4 layers as chip_smoke cuts
    Qwen3-30B-A3B: tools/split_model --weights --num-layers 3, two
    tools/run_node stages behind a ChainClient, and tools/generate
    --num-layers 3 without --random-init give the greedy stream of an
    Engine over load_params of the same snapshot (weights at 0.3, where
    the stream varies)."""
    from inferd_tpu_torch.models import loader
    from inferd_tpu_torch.tools import generate as gen_cli
    from inferd_tpu_torch.tools import run_node
    from inferd_tpu_torch.tools import split_model

    cfg = tcfg.TINY_MOE.with_layers(3)  # the checkpoint holds 3 of the preset's 4 layers
    base = tmp_path / "hub" / "models--tiny-moe"
    snap = write_checkpoint(str(base / "snapshots" / "rev0"),
                            hf_state_dict(cfg, seed=9, layout="qwen3_moe", scale=0.3), "BF16",
                            shards=2)
    (base / "refs").mkdir()
    (base / "refs" / "main").write_text("rev0")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    prompt = [5, 2, 9, 40, 41, 100]
    want = Engine(cfg, loader.load_params(cfg, device="cpu"), max_len=64,
                  sampling_cfg=GREEDY).generate(prompt, 8)
    assert len(set(want)) > 2
    parts = str(tmp_path / "parts")
    paths = split_model.main(["--model", "tiny-moe", "--num-layers", "3", "--stages", "2",
                              "--weights", snap, "--out", parts, "--device", "cpu"])
    assert [tstages.load_stage_checkpoint(p)[1].end_layer for p in paths] == [1, 2]
    nodes = []
    try:
        for s in range(2):
            args = run_node.build_parser().parse_args(
                ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0",
                 "--device", "cpu", "--max-len", "64"])
            nodes.append(run_node.make_node(args).start())

        async def go():
            async with ChainClient([(n.host, n.port) for n in nodes], sampling=GREEDY,
                                   prefill_chunk=4) as c:
                return await c.generate_ids(prompt, max_new_tokens=8)

        assert asyncio.run(go()) == want
        assert [n.stats()["forward_passes"] for n in nodes] == [2 + 7] * 2
        assert [n.stats()["end_layer"] for n in nodes] == [1, 2]
    finally:
        for n in nodes:
            n.stop()
    capsys.readouterr()
    assert gen_cli.main(["--model", "tiny-moe", "--num-layers", "3",
                         "--prompt-ids", ",".join(map(str, prompt)),
                         "--max-new-tokens", "8", "--device", "cpu", "--temperature", "0",
                         "--max-len", "64"]) == 0
    out = capsys.readouterr().out
    assert [int(x) for x in out.split("[", 1)[1].split("]")[0].split(",")] == want
