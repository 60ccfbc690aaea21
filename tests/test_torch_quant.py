"""Weight-only quantization in the port (inferd_tpu_torch.ops.quant and
ops.qmatmul) against the JAX package's.

  * quantize / quantize_int4 give the JAX package's bytes, scale bits and
    packing, and dequantize, indexing, shapes and byte counts agree;
  * the plain GEMVs match the Pallas kernels run in interpret mode (atol =
    rtol = 1e-5 in f32, 2e-2 in bf16: the JAX tests' own);
  * qdot matches the JAX qdot in every mode, its kernel forced on and off,
    and never reaches a kernel wrapper with CPU tensors;
  * quantize_params / apply_quant_mode quantize the same leaves of stage
    trees (the tied head's shadow on the last stage only);
  * a quantized two-stage TINY chain decodes the JAX package's greedy
    stream token for token, on the one-session and the paged lane
    executors (logits within 1e-4 of max |logit|, f32: the sums run in
    another order);
  * two in-process run_node --quant nodes serve that stream to a
    ChainClient and report the quantization in /stats.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import qmatmul as jqmm
from inferd_tpu.ops import quant as jquant
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JLanes
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.ops import qmatmul as tqmm
from inferd_tpu_torch.ops import quant as tquant
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def restore_modes():
    """apply_quant_mode and the tests set module-level modes: put them back."""
    saved = (jquant.QDOT_MODE, jquant.INT4_MODE, jquant.FORCE_QUANT_KERNEL, tquant.INT4_MODE)
    yield
    (jquant.QDOT_MODE, jquant.INT4_MODE, jquant.FORCE_QUANT_KERNEL, tquant.INT4_MODE) = saved


def _weight(seed, shape, dtype="float32", zero_col=False):
    """The same weight for both: (jax array, torch tensor), bit-identical."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col:
        a[..., 3] = 0.0
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return j, convert.tensor_from_numpy(np.asarray(j))


def _np(t):
    return convert.tensor_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def _same_quant(jw, tw):
    assert type(tw).__name__ == type(jw).__name__
    assert tuple(tw.shape) == tuple(jw.shape) and tw.ndim == jw.ndim
    assert _bits_equal(jw.q, _np(tw.q)), "q bytes differ"
    assert _bits_equal(jw.scale, _np(tw.scale)), "scale bits differ"
    if hasattr(jw, "packed"):
        assert tw.packed == jw.packed


# -- quantize / quantize_int4: bit-exact ------------------------------------------

QUANT_CASES = {
    # name: (shape, dtype, zero column)
    "f32": ((64, 96), "float32", False),
    "bf16": ((64, 96), "bfloat16", False),
    "stacked_f32": ((3, 256, 96), "float32", False),
    "stacked_bf16": ((2, 128, 40), "bfloat16", False),
    "odd_k": ((33, 96), "float32", False),
    "k130_odd_group": ((130, 24), "float32", False),
    "zero_column": ((64, 16), "float32", True),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_quantize_is_bit_exact_to_jax(name, bits):
    shape, dtype, zero = QUANT_CASES[name]
    jw, tw = _weight(len(name), shape, dtype, zero)
    jq_ = jquant.quantize(jw) if bits == 8 else jquant.quantize_int4(jw)
    tq_ = tquant.quantize(tw) if bits == 8 else tquant.quantize_int4(tw)
    _same_quant(jq_, tq_)
    assert tq_.q.is_contiguous() and tq_.scale.is_contiguous()
    if bits == 4:
        assert tq_.packed == (shape[-2] % 2 == 0)
        assert _bits_equal(jq_.unpacked(), _np(tq_.unpacked()))
    if zero:
        col = _np(tq_.scale)[..., 3]
        assert np.all(col == 1.0)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        assert _bits_equal(jq_.dequantize(jdt), _np(tq_.dequantize(tdt)))
    assert tquant.quantized_bytes({"w": tq_}) == jquant.quantized_bytes({"w": jq_})
    if len(shape) == 3:  # the layer loop's w[i] and stage slicing's w[a:b]
        jl = jax.tree.map(lambda a: a[1], jq_)
        _same_quant(jl, tq_[1])
        js = jax.tree.map(lambda a: a[1:], jq_)
        _same_quant(js, tq_[1:])


def test_tied_head_shadow_is_contiguous():
    """quantize of a transposed view (the tied head's embed.T) gives
    row-major q and the same bytes as quantizing a copy."""
    _, e = _weight(9, (200, 64))
    for fn in (tquant.quantize, tquant.quantize_int4):
        a, b = fn(e.T), fn(e.T.contiguous())
        assert a.q.is_contiguous() and torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)


# -- the plain GEMVs against the Pallas kernels (interpret mode) ------------------


def _x(seed, m, k, dtype):
    a = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return j, convert.tensor_from_numpy(np.asarray(j))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 128, 96), (4, 128, 200), (64, 64, 96)])
def test_w8a16_plain_matches_pallas(m, k, n, dtype):
    jx, tx = _x(m + n, m, k, dtype)
    jw, tw = _weight(k + n, (k, n))
    jqw, tqw = jquant.quantize(jw), tquant.quantize(tw)
    want = jqmm.w8a16_matmul(jx, jqw.q, jqw.scale, interpret=True)
    got = tqmm.w8a16_matmul_reference(tx, tqw.q, tqw.scale)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("scheme", ["grouped", "dequant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,group", [
    (1, 256, 96, 128),   # packed, 2 groups
    (4, 130, 200, 128),  # packed, odd group size 65 (pairs split)
    (64, 33, 96, 128),   # odd K: one value per byte
])
def test_w4a16_plain_matches_pallas(m, k, n, group, dtype, scheme):
    jx, tx = _x(m + k, m, k, dtype)
    jw, tw = _weight(k * n, (k, n))
    jqw, tqw = jquant.quantize_int4(jw, group), tquant.quantize_int4(tw, group)
    want = jqmm.w4a16_matvec(jx, jqw, scheme=scheme, interpret=True)
    got = tqmm.w4a16_matvec_reference(tx, tqw, scheme)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    _close(got, want, dtype)


def test_cpu_wrappers_run_the_plain_versions_without_building(monkeypatch):
    from inferd_tpu_torch.ops import build

    def no_build(name):
        raise AssertionError("a CPU call must not reach the kernel build")

    monkeypatch.setattr(build, "load", no_build)
    before = (tqmm.w8a16_matmul.launches, tqmm.w4a16_matvec.launches)
    _, tx = _x(1, 3, 128, "float32")
    _, tw = _weight(2, (128, 40))
    q8, q4 = tquant.quantize(tw), tquant.quantize_int4(tw)
    assert torch.equal(tqmm.w8a16_matmul(tx, q8.q, q8.scale),
                       tqmm.w8a16_matmul_reference(tx, q8.q, q8.scale))
    for scheme in ("grouped", "dequant"):
        assert torch.equal(tqmm.w4a16_matvec(tx, q4, scheme),
                           tqmm.w4a16_matvec_reference(tx, q4, scheme))
    assert (tqmm.w8a16_matmul.launches, tqmm.w4a16_matvec.launches) == before


# -- qdot against the JAX qdot ------------------------------------------------------


QDOT_MODES = ["int8", "int8-kernel", "int4-grouped", "int4-dequant"]


def _set_mode(mode):
    """One CLI-style mode on both packages -> (jax quantizer, torch quantizer).
    The port's int8 contraction has no mode: int8 and int8-kernel differ
    only on the JAX side."""
    if mode.startswith("int4"):
        jquant.INT4_MODE = tquant.INT4_MODE = mode.split("-")[1]
        return jquant.quantize_int4, tquant.quantize_int4
    jquant.QDOT_MODE = "kernel" if mode == "int8-kernel" else "dequant"
    return jquant.quantize, tquant.quantize


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("rows", [(2,), (2, 3), (tqmm.MAX_KERNEL_ROWS + 1,)])
@pytest.mark.parametrize("mode", QDOT_MODES)
def test_qdot_matches_jax(mode, rows, forced, monkeypatch):
    """Decode-shaped and prefill-shaped (> MAX_KERNEL_ROWS) rows, the JAX
    kernel forced on (Pallas in interpret mode) and off. The port's CPU
    qdot reaches no kernel wrapper whatever the rows."""
    jquantize, tquantize = _set_mode(mode)
    jquant.FORCE_QUANT_KERNEL = forced
    k, n = 128, 96
    a = np.random.default_rng(len(rows)).standard_normal((*rows, k)).astype(np.float32)
    jw, tw = _weight(3, (k, n))
    jqw, tqw = jquantize(jw), tquantize(tw)

    def no_kernel(*a, **kw):
        raise AssertionError("CPU qdot reached a kernel wrapper")

    monkeypatch.setattr(tqmm, "w8a16_matmul", no_kernel)
    monkeypatch.setattr(tqmm, "w4a16_matvec", no_kernel)
    got = tquant.qdot(torch.from_numpy(a), tqw)
    want = jquant.qdot(jnp.asarray(a), jqw)
    assert tuple(got.shape) == tuple(want.shape) == (*rows, n)
    _close(got, want, "float32")


def test_qdot_w8a8_and_dense_weights():
    """A dense weight is a plain product; --quant int8 and int8-kernel
    quantize alike (so qdot gives the same); w8a8 is refused at quantization."""
    _, tw = _weight(4, (64, 32))
    x = torch.ones(2, 64)
    assert torch.equal(tquant.qdot(x, tw), x @ tw)
    a, b = (tquant.apply_quant_mode(f, {"lm_head": tw}) for f in ("int8", "int8-kernel"))
    assert torch.equal(tquant.qdot(x, a["lm_head"]), tquant.qdot(x, b["lm_head"]))
    with pytest.raises(NotImplementedError, match=r"w8a8.*later slice \(ROADMAP A6\)"):
        tquant.apply_quant_mode("w8a8", {"lm_head": tw})


# -- quantize_params / apply_quant_mode on stage trees ------------------------------


@pytest.fixture(scope="module")
def jax_full():
    return jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))


def _specs():
    return jstages.Manifest.even_split("tiny", 2).stage_specs()


def _jax_stage(jax_full, spec, flag):
    """The reference node's load path: stage extraction, then quantization
    with the head shadow on the last stage only."""
    jsp = jstages.extract_stage_params(jax_full, jcfg.TINY, spec)
    return jquant.apply_quant_mode(flag, jsp, tie_word_embeddings=jcfg.TINY.tie_word_embeddings,
                                   needs_head=spec.is_last)


def _leaf_kinds(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_kinds(v, prefix + k + "."))
        else:
            out[prefix + k] = type(v).__name__ if hasattr(v, "scale") else "dense"
    return out


@pytest.mark.parametrize("flag", ["int8", "int8-kernel", "int4"])
def test_apply_quant_mode_on_stage_trees_matches_jax(jax_full, flag):
    for spec in _specs():
        jsp = jstages.extract_stage_params(jax_full, jcfg.TINY, spec)
        tsp = convert.params_from_numpy(jax.tree.map(np.asarray, jsp))
        want = _jax_stage(jax_full, spec, flag)
        got = tquant.apply_quant_mode(flag, tsp, tie_word_embeddings=tcfg.TINY.tie_word_embeddings,
                                      needs_head=spec.is_last)
        assert _leaf_kinds(got) == _leaf_kinds(want)
        assert ("lm_head_q" in got) == spec.is_last
        for name in tquant._LAYER_LINEARS:
            _same_quant(want["layers"][name], got["layers"][name])
        if spec.is_last:
            _same_quant(want["lm_head_q"], got["lm_head_q"])
            assert got["lm_head_q"].q.is_contiguous()
        assert tquant.quantized_bytes(got) == jquant.quantized_bytes(want)


def test_apply_quant_mode_none_w8a8_and_untied_head(jax_full):
    tsp = convert.params_from_numpy(jax.tree.map(np.asarray, jax_full))
    assert tquant.apply_quant_mode("none", tsp) is tsp
    with pytest.raises(NotImplementedError, match="w8a8"):
        tquant.apply_quant_mode("w8a8", tsp)
    with pytest.raises(ValueError, match="unknown quant flag"):
        tquant.apply_quant_mode("fp8", tsp)
    untied = dict(tsp, lm_head=tsp["embed"].T.contiguous())
    q = tquant.quantize_params(untied, tie_word_embeddings=False)
    assert isinstance(q["lm_head"], tquant.QuantWeight) and "lm_head_q" not in q


def test_extract_stage_params_on_quantized_full_tree(jax_full):
    """The JAX tests' order (quantize the full tree, then extract a stage):
    the port's stage slicing indexes the quantized leaves the same way."""
    jfull = jquant.apply_quant_mode("int4", jax_full, tie_word_embeddings=True)
    tfull = convert.params_from_numpy(jax.tree.map(np.asarray, jfull))
    for jspec in _specs():
        tspec = tstages.StageSpec(jspec.stage, jspec.num_stages, jspec.start_layer,
                                  jspec.end_layer)
        want = jstages.extract_stage_params(jfull, jcfg.TINY, jspec)
        got = tstages.extract_stage_params(tfull, tcfg.TINY, tspec)
        assert sorted(got) == sorted(want)
        for name in tquant._LAYER_LINEARS:
            _same_quant(want["layers"][name], got["layers"][name])


def test_convert_round_trips_quantized_leaves(jax_full):
    jsp = _jax_stage(jax_full, _specs()[1], "int4")
    tsp = convert.params_from_numpy(jax.tree.map(np.asarray, jsp))
    back = convert.params_to_numpy(tsp)
    for name in tquant._LAYER_LINEARS:
        _same_quant(jsp["layers"][name], back["layers"][name])
    _same_quant(jsp["lm_head_q"], back["lm_head_q"])
    assert isinstance(back["layers"]["q_proj"].q, np.ndarray)


# -- the slice end to end: quantized greedy streams -----------------------------------


STREAM_MODES = ["int8", "int4-grouped", "int4-dequant"]
PROMPTS = ([3, 17, 42, 9, 5, 8, 2, 11, 60, 1], [200, 7, 7, 31])
STEPS = 6


def _stage_pairs(jax_full, mode):
    """Per stage: (JAX quantized stage params, the port's, spec)."""
    flag = mode.split("-")[0]
    if flag == "int4":
        jquant.INT4_MODE = tquant.INT4_MODE = mode.split("-")[1]
    out = []
    for spec in _specs():
        jsp = _jax_stage(jax_full, spec, flag)
        tsp = convert.params_from_numpy(jax.tree.map(np.asarray, jsp))
        tspec = tstages.StageSpec(spec.stage, spec.num_stages, spec.start_layer, spec.end_layer)
        out.append((jsp, tsp, spec, tspec))
    return out


def _logits(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _check_logits(tl, jl):
    scale = np.abs(jl).max()
    assert np.abs(tl - jl).max() <= 1e-4 * scale
    assert int(np.argmax(tl)) == int(np.argmax(jl))


def _chain_step(executors, sid, payload):
    for ex in executors:
        out = ex.process(sid, payload)
        if "logits" in out:
            return out["logits"]
        payload = {"hidden": np.asarray(out["hidden"].float() if isinstance(out["hidden"], torch.Tensor)
                                        else out["hidden"]),
                   "start_pos": out["start_pos"], "real_len": out["real_len"]}
    raise AssertionError("no logits")


def _greedy(executors, prompt, steps, sid="s"):
    """Greedy stream and every step's logits through a chain of executors."""
    lg = _logits(_chain_step(executors, sid, {"tokens": np.asarray([prompt], np.int32),
                                              "start_pos": 0, "real_len": len(prompt)})[0])
    toks, logits = [int(np.argmax(lg))], [lg]
    for i in range(steps - 1):
        lg = _logits(_chain_step(executors, sid, {"tokens": np.asarray([[toks[-1]]], np.int32),
                                                  "start_pos": len(prompt) + i, "real_len": 1})[0])
        toks.append(int(np.argmax(lg)))
        logits.append(lg)
    for ex in executors:
        ex.end_session(sid)
    return toks, logits


@pytest.mark.parametrize("mode", STREAM_MODES)
def test_quantized_chain_stream_equals_jax(jax_full, mode):
    """The one-session executors of both packages over the same quantized
    stages: equal greedy streams, logits within 1e-4 of max |logit|."""
    pairs = _stage_pairs(jax_full, mode)
    jex = [JExecutor(jcfg.TINY, js, jsp, max_len=64, initial_kv_len=32) for jsp, _, js, _ in pairs]
    tex = [Qwen3StageExecutor(tcfg.TINY, ts, tsp, max_len=64, initial_kv_len=32)
           for _, tsp, _, ts in pairs]
    for prompt in PROMPTS:
        jt, jl = _greedy(jex, prompt, STEPS)
        tt, tl = _greedy(tex, prompt, STEPS)
        assert tt == jt
        for a, b in zip(tl, jl):
            _check_logits(a, b)


@pytest.mark.parametrize("mode", STREAM_MODES)
def test_quantized_paged_lanes_cobatched_equal_jax(jax_full, mode):
    """Paged lane executors of both packages: two sessions prefill, then
    decode co-batched (one process_batch per stage per step), the JAX
    stream fed to both; every step's logits agree and greedy tokens match."""
    pairs = _stage_pairs(jax_full, mode)
    kw = dict(lanes=4, max_len=64, block_size=8, prefill_chunk=8)
    jex = [JLanes(jcfg.TINY, js, jsp, **kw) for jsp, _, js, _ in pairs]
    tex = [BatchedStageExecutor(tcfg.TINY, ts, tsp, **kw) for _, tsp, _, ts in pairs]
    sids = ["a", "b"]
    toks = {}
    for sid, p in zip(sids, PROMPTS):
        payload = {"tokens": np.asarray([p], np.int32), "start_pos": 0, "real_len": len(p)}
        jl, tl = _logits(_chain_step(jex, sid, payload)[0]), _logits(_chain_step(tex, sid, payload)[0])
        _check_logits(tl, jl)
        toks[sid] = [int(np.argmax(jl))]
    for step in range(STEPS - 1):
        items = [(sid, {"tokens": [[toks[sid][-1]]], "start_pos": len(p) + step, "real_len": 1})
                 for sid, p in zip(sids, PROMPTS)]
        jitems, titems = items, items
        for j, t in zip(jex, tex):
            jo, to = j.process_batch(jitems), t.process_batch(titems)
            assert not any(isinstance(o, Exception) for o in jo + to), (jo, to)
            if "logits" in jo[0]:
                break
            jitems = [(sid, {"hidden": np.asarray(o["hidden"]), "start_pos": o["start_pos"],
                             "real_len": 1}) for (sid, _), o in zip(items, jo)]
            titems = [(sid, {"hidden": o["hidden"], "start_pos": o["start_pos"], "real_len": 1})
                      for (sid, _), o in zip(items, to)]
        for sid, a, b in zip(sids, to, jo):
            _check_logits(_logits(a["logits"][0]), _logits(b["logits"][0]))
            toks[sid].append(int(np.argmax(_logits(b["logits"][0]))))
    for t in tex:
        assert t.stats()["batched_steps"] == STEPS - 1
        assert t.stats()["batched_tokens"] == 2 * (STEPS - 1)


# -- run_node --quant: two in-process nodes -------------------------------------------


@pytest.fixture(scope="module")
def jax_parts(tmp_path_factory, jax_full):
    parts = str(tmp_path_factory.mktemp("quant_parts"))
    jstages.split_and_save(jax_full, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    return parts


def _nodes(parts, flag, extra=()):
    return [run_node.make_node(run_node.build_parser().parse_args(
        ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0", "--device", "cpu",
         "--max-len", "64", "--quant", flag, *extra])).start() for s in range(2)]


@pytest.mark.parametrize("flag,extra", [
    ("int4", ()),
    ("int8", ("--stage-lanes", "4", "--paged-kv", "8", "--prefill-chunk", "8",
              "--window-ms", "50")),
])
def test_quant_nodes_serve_the_jax_quantized_stream(jax_full, jax_parts, flag, extra):
    """run_node --quant nodes (the port quantizes at load) serve a
    ChainClient the stream of the JAX package's quantized executors, and
    /stats carries the quantization, the stage bytes and the counters."""
    jquant.INT4_MODE = "grouped"  # what the port's int4 nodes serve
    pairs = [(spec, _jax_stage(jax_full, spec, flag)) for spec in _specs()]
    jex = [JExecutor(jcfg.TINY, spec, jsp, max_len=64, initial_kv_len=32) for spec, jsp in pairs]
    expected = [_greedy(jex, p, STEPS, sid=f"j{i}")[0] for i, p in enumerate(PROMPTS)]
    nodes = _nodes(jax_parts, flag, extra)
    try:
        async def go():
            async with ChainClient([(n.host, n.port) for n in nodes],
                                   sampling=SamplingConfig(temperature=0.0),
                                   prefill_chunk=8) as c:
                return await asyncio.gather(*(c.generate_ids(p, max_new_tokens=STEPS)
                                              for p in PROMPTS))

        assert asyncio.run(go()) == expected
        for node, (spec, jsp) in zip(nodes, pairs):
            st = node.stats()
            assert st["quant"] == flag and st["errors"] == 0
            assert st["quantized_bytes"] == jquant.quantized_bytes(jsp)
            # CPU tensors take the plain products: no kernel launches here
            assert st["kernels"]["w8a16_matmul"]["launches"] == 0
            assert st["kernels"]["w4a16_matvec"]["launches"] == 0
            if spec.is_last:
                assert "lm_head_q" in node.executor.params
    finally:
        for n in nodes:
            n.stop()


def test_run_node_quant_w8a8_fails_loudly(jax_parts):
    args = run_node.build_parser().parse_args(
        ["--parts", jax_parts, "--stage", "0", "--port", "0", "--gossip-port", "0", "--device", "cpu",
         "--quant", "w8a8"])
    with pytest.raises(NotImplementedError, match="w8a8.*not ported"):
        run_node.make_node(args)


def test_run_node_quant_none_serves_bf16_unchanged(jax_parts):
    node = run_node.make_node(run_node.build_parser().parse_args(
        ["--parts", jax_parts, "--stage", "1", "--port", "0", "--gossip-port", "0", "--device", "cpu"])).start()
    try:
        assert node.stats()["quant"] == "none"
        assert not any(hasattr(v, "scale") for v in node.executor.params["layers"].values())
        assert "lm_head_q" not in node.executor.params
    finally:
        node.stop()
