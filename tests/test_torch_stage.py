# jaxlint: file-disable=J003 -- test code: these loops read each step's logits to ASSERT parity; they are verification loops, not serving hot paths
"""Stage checkpoints and stage executors: the port against the JAX package.

Parts written by the JAX `split_and_save` load in the port (and re-save to
the same bytes); parts the port writes load in the JAX package bit-exact;
a chain of two port executors matches a chain of two JAX executors on a
prefill, decode steps and a replay rollback (f32 logits atol 1e-4)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor, make_executor

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_parts(tmp_path_factory):
    parts = str(tmp_path_factory.mktemp("jax_parts"))
    params = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jstages.split_and_save(params, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), parts)
    return parts


def _executors(parts, max_len=128):
    jex, tex = [], []
    for s in range(2):
        path = jstages.stage_checkpoint_path(parts, s)
        jp, jspec, _ = jstages.load_stage_checkpoint(path)
        tp, tspec, name = tstages.load_stage_checkpoint(path)
        assert name == "tiny" and (tspec.start_layer, tspec.end_layer) == (
            jspec.start_layer, jspec.end_layer)
        jex.append(JExecutor(jcfg.TINY, jspec, jp, max_len=max_len, initial_kv_len=32))
        tex.append(Qwen3StageExecutor(tcfg.TINY, tspec, tp, max_len=max_len, initial_kv_len=32))
    return jex, tex


def _chain(executors, sid, tokens, start_pos):
    payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
               "real_len": len(tokens)}
    hidden = None
    for ex in executors:
        out = ex.process(sid, payload)
        if "logits" in out:
            return np.asarray(out["logits"], np.float32)[0], hidden
        hidden = np.asarray(out["hidden"], np.float32)
        assert out["real_len"] == len(tokens) and out["start_pos"] == start_pos
        payload = {"hidden": out["hidden"], "start_pos": start_pos, "real_len": len(tokens)}
    raise AssertionError("no logits")


def test_jax_parts_load_in_port_and_resave_byte_identical(jax_parts, tmp_path):
    for s in range(2):
        path = jstages.stage_checkpoint_path(jax_parts, s)
        params, spec, name = tstages.load_stage_checkpoint(path)
        out = str(tmp_path / os.path.basename(path))
        tstages.save_stage_checkpoint(out, params, spec, name)
        with open(path, "rb") as a, open(out, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_parts_load_in_jax_bit_exact(tmp_path, dtype):
    cfg = dataclasses.replace(tcfg.TINY, dtype=dtype)
    params = tq.init_params(cfg, torch.Generator().manual_seed(5))
    paths = tstages.split_and_save(params, cfg, tstages.Manifest.even_split("tiny", 2),
                                   str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["stage_000.msgpack", "stage_001.msgpack"]
    specs = tstages.Manifest.even_split("tiny", 2).stage_specs()
    for path, spec in zip(paths, specs):
        jp, jspec, name = jstages.load_stage_checkpoint(path)
        assert name == "tiny" and jspec.start_layer == spec.start_layer
        want = convert.params_to_numpy(
            tstages.extract_stage_params(params, cfg, spec), bf16_dtype=jnp.bfloat16)
        assert jax.tree.structure(jp) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.asarray(a).tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_moe_stage_files_equal_flax(tmp_path, monkeypatch, dtype):
    """flax's chunked leaf (every leaf over MAX_CHUNK_SIZE bytes), the
    limit lowered in both packages to 3000 bytes so tiny-moe's expert
    stacks, projections and embedding cross it (3000 is no multiple of a
    leaf's size, so each last chunk is short): the port's stage files are the bytes
    the JAX split writes from the same params, each package loads the
    other's, and the port's loader gives back every parameter."""
    import flax.serialization

    from inferd_tpu_torch.parallel import flax_format

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 3000)
    monkeypatch.setattr(flax_format, "MAX_CHUNK_SIZE", 3000)
    cfg_j = dataclasses.replace(jcfg.TINY_MOE, dtype=dtype)
    cfg_t = dataclasses.replace(tcfg.TINY_MOE, dtype=dtype)
    jp = jq.init_params(cfg_j, jax.random.PRNGKey(2))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    manifest = jstages.Manifest.even_split("tiny-moe", 2)
    jpaths = jstages.split_and_save(jp, cfg_j, manifest, str(tmp_path / "j"))
    tpaths = tstages.split_and_save(tp, cfg_t, tstages.Manifest.even_split("tiny-moe", 2),
                                    str(tmp_path / "t"))
    for jpath, tpath, spec in zip(jpaths, tpaths, manifest.stage_specs()):
        with open(jpath, "rb") as a, open(tpath, "rb") as b:
            blob = b.read()
            assert a.read() == blob
        # the expert stacks, the router and the attention projections at least
        assert blob.count(b"__msgpack_chunked_array__") >= 8
        got, tspec, name = tstages.load_stage_checkpoint(jpath)
        want = tstages.extract_stage_params(tp, cfg_t, tstages.StageSpec(
            spec.stage, spec.num_stages, spec.start_layer, spec.end_layer))
        assert name == "tiny-moe" and got.keys() == want.keys()
        for k in want:
            pairs = ([(got[k][n], want[k][n]) for n in want[k]] if isinstance(want[k], dict)
                     else [(got[k], want[k])])
            for a, b in pairs:
                assert a.dtype == b.dtype and torch.equal(a, b), k
        jback, _, _ = jstages.load_stage_checkpoint(tpath)
        assert jax.tree.structure(jback) == jax.tree.structure(
            jstages.extract_stage_params(jp, cfg_j, spec))


def test_chain_matches_jax_prefill_decode_and_replay(jax_parts):
    jex, tex = _executors(jax_parts)
    prompt = np.random.default_rng(0).integers(0, 256, 17).tolist()
    jl, jh = _chain(jex, "s", prompt, 0)
    tl, th = _chain(tex, "s", prompt, 0)
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-5)  # stage 0 ships 17 real rows
    assert th.shape == (1, 17, tcfg.TINY.hidden_size)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    pos, toks = len(prompt), []
    for _ in range(6):
        tok = int(np.argmax(jl))
        toks.append(tok)
        jl, _ = _chain(jex, "s", [tok], pos)
        tl, _ = _chain(tex, "s", [tok], pos)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        pos += 1
    # replay: re-send the last three steps as one chunk from before the frontier
    replay_at = pos - 3
    jl, _ = _chain(jex, "s", toks[-3:], replay_at)
    tl, _ = _chain(tex, "s", toks[-3:], replay_at)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    tok = int(np.argmax(jl))
    jl, _ = _chain(jex, "s", [tok], pos)
    tl, _ = _chain(tex, "s", [tok], pos)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for ex in tex:
        assert ex.sessions.get("s").length == pos + 1
        ex.end_session("s")
        assert "s" not in ex.sessions


def test_chunked_prefill_grows_cache_like_jax(jax_parts):
    """Two chunks (the second crosses the initial buffer): same logits, same
    bucket growth as the JAX executor."""
    jex, tex = _executors(jax_parts)
    prompt = np.random.default_rng(1).integers(0, 256, 45).tolist()
    for chunk_at in (0, 20):
        chunk = prompt[chunk_at: 20 if chunk_at == 0 else 45]
        jl, _ = _chain(jex, "g", chunk, chunk_at)
        tl, _ = _chain(tex, "g", chunk, chunk_at)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for j, t in zip(jex, tex):
        assert t.sessions.get("g").max_len == j.sessions.get("g").max_len
        assert t.sessions.get("g").length == int(j.sessions.get("g").length) == 45


def test_kv_overflow_raises_buffer_error(jax_parts):
    _, tex = _executors(jax_parts, max_len=32)
    _chain(tex, "o", list(range(30)), 0)
    with pytest.raises(BufferError, match="overflow"):
        _chain(tex, "o", [1, 2, 3], 30)


def test_out_of_order_chunk_and_decode_steps_raise_value_error(jax_parts):
    _, tex = _executors(jax_parts)
    _chain(tex, "x", [1, 2, 3], 0)
    with pytest.raises(ValueError, match="out-of-order"):
        _chain(tex, "x", [4], 7)
    with pytest.raises(ValueError, match="single-stage"):
        tex[0].process("x", {"tokens": [[4]], "start_pos": 3, "decode_steps": 4})


def test_make_executor_and_manifest(jax_parts):
    params, spec, _ = tstages.load_stage_checkpoint(jstages.stage_checkpoint_path(jax_parts, 1))
    ex = make_executor(tcfg.TINY, spec, params)
    assert isinstance(ex, Qwen3StageExecutor) and ex.spec.is_last
    counter = make_executor(tcfg.TINY, spec, params, backend="counter")
    assert counter.process("s", {"state": 1, "trace": [0]}) == {
        "state": 2, "trace": [0, 1], "result_for_user": {"state": 2, "trace": [0, 1]}}
    with pytest.raises(ValueError, match="unknown executor backend"):
        make_executor(tcfg.TINY, spec, params, backend="mystery")
    m = tstages.Manifest.even_split("qwen3-0.6b", 2)
    m.validate()
    assert [(s.start_layer, s.end_layer) for s in m.stage_specs()] == [(0, 13), (14, 27)]
    jm = jstages.Manifest.even_split("qwen3-0.6b", 3)
    tm = tstages.Manifest.from_yaml(jm.to_yaml())
    assert [dataclasses.astuple(n) for n in tm.nodes] == [dataclasses.astuple(n) for n in jm.nodes]
