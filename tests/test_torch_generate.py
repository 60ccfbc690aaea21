"""The port's single-process engine (inferd_tpu_torch/core/generate.py)
against the JAX package's Engine on the same TINY weights, and the
engine's own invariants; also the tokenizer, the timing harness and the
`tools/generate` CLI on the CPU.

Greedy streams are token-exact against the JAX Engine, with and without
prefix pins and at every chunk size. Prefill logits: f32 atol 1e-4 (the
tolerance of tests/test_torch_model.py). Sampled streams cannot match JAX
(core.sampling's key is not threefry); within the port they are
bit-identical across chunk sizes, against generate_scan and with or
without the logprob sinks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core import generate as jgen
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.utils import profiling as jprof
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core import generate as tgen
from inferd_tpu_torch.core import tokenizer as ttok
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.tools import generate as gen_cli
from inferd_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

PROMPT = [3, 7, 11, 19, 5, 2, 40, 9]
GREEDY_J = jcfg.SamplingConfig(temperature=0.0)
GREEDY_T = tcfg.SamplingConfig(temperature=0.0)
SAMPLED = [tcfg.SamplingConfig(), tcfg.SamplingConfig(temperature=0.9, top_k=0, top_p=0.9),
           tcfg.SamplingConfig(temperature=0.7, top_k=0, top_p=1.0, min_p=0.05)]


def scaled_tiny_params(seed=0):
    """(JAX params, the port's) of TINY with every weight but the norms 10x
    its init: at the init's scale a greedy stream repeats one token."""
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


@pytest.fixture(scope="module")
def tiny():
    return scaled_tiny_params()


@pytest.fixture(scope="module")
def jax_greedy(tiny):
    jp, _ = tiny
    eng = jgen.Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=GREEDY_J)
    return {n: eng.generate(PROMPT[:n], max_new_tokens=20) for n in (3, 8)}


@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("n", [3, 8])
def test_engine_greedy_equals_jax_engine(tiny, jax_greedy, chunk, n):
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=GREEDY_T)
    got = eng.generate(PROMPT[:n], max_new_tokens=20, chunk=chunk)
    assert got == jax_greedy[n]
    assert len(set(got)) > 1  # the stream varies


@pytest.mark.parametrize("pin", [(3, 7), (3, 7, 11), tuple(PROMPT[:3])])
def test_engine_greedy_with_pins_equals_jax_engine(tiny, jax_greedy, pin):
    """A pinned prefix (shorter than, or the whole of, the prompt) gives the
    JAX stream; the snapshot shares no storage with the session and is left
    as it was; max_pins caps the pins LRU."""
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=GREEDY_T, max_pins=2)
    eng.pin_prefix(pin)
    snap, _ = eng._pins[tuple(pin)]
    k0 = snap.k.clone()
    assert eng.generate(PROMPT[:3], max_new_tokens=20) == jax_greedy[3]
    assert eng.generate(PROMPT[:3], max_new_tokens=20, chunk=8) == jax_greedy[3]
    assert torch.equal(snap.k, k0) and snap.length == len(pin)
    eng.pin_prefix([1, 2])
    eng.pin_prefix([4])
    assert eng.pins_resident == 2 and tuple(pin) not in eng._pins
    eng.unpin_prefix([4])
    assert eng.pins_resident == 1
    with pytest.raises(ValueError, match="max_pins"):
        tgen.Engine(tcfg.TINY, tiny[1], max_pins=0)


def test_cache_from_pin_copies_every_buffer(tiny):
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=GREEDY_T)
    for max_len in (16, 64):  # grown into the engine's max_len, or cloned at it
        snap = eng.new_cache(1, max_len)
        c = eng._cache_from_pin(snap)
        assert c.max_len == 64 and c.k.data_ptr() != snap.k.data_ptr()
        assert c.v.data_ptr() != snap.v.data_ptr()


def test_prefill_logits_match_jax_engine(tiny):
    jp, tp = tiny
    jeng = jgen.Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=GREEDY_J)
    teng = tgen.Engine(tcfg.TINY, tp, max_len=64, sampling_cfg=GREEDY_T)
    for n in (1, 8, 21):
        ids = list(range(5, 5 + n))
        ref, _ = jeng.prefill(ids, jeng.new_cache(1))
        got, cache = teng.prefill(ids, teng.new_cache(1))
        assert got.shape == (1, jcfg.TINY.vocab_size) and cache.length == n
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg_i", range(len(SAMPLED)))
def test_sampled_invariants_chunk_scan_and_sinks(tiny, cfg_i):
    """Bit-identical tokens for one seed: chunk sizes 1, 2, 5, 8, the
    logprob sinks on or off, and generate_scan."""
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=SAMPLED[cfg_i])
    ref = eng.generate(PROMPT, max_new_tokens=24, seed=5)
    assert len(set(ref)) > 3
    for chunk in (2, 5, 8):
        assert eng.generate(PROMPT, max_new_tokens=24, seed=5, chunk=chunk) == ref
    lps, tops = [], []
    assert eng.generate(PROMPT, max_new_tokens=24, seed=5, chunk=8, logprob_sink=lps,
                        top_n=3, top_sink=tops) == ref
    assert len(lps) == len(tops) == 24
    toks = [PROMPT + [0] * (tgen.bucket_len(len(PROMPT)) - len(PROMPT))]
    scan = eng.generate_scan(np.asarray(toks), len(PROMPT), 24, seed=5)
    assert scan.shape == (1, 24) and scan[0].tolist() == ref
    assert eng.generate(PROMPT, max_new_tokens=24, seed=6) != ref


def test_eos_stops_every_path(tiny):
    """EOS inside a chunk discards the window's tail; generate_scan keeps
    re-emitting EOS once a row is done (per row, B = 2)."""
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=64, sampling_cfg=SAMPLED[0])
    full = eng.generate(PROMPT, max_new_tokens=20, seed=2)
    eos = full[6]
    cut = full.index(eos) + 1
    for chunk in (1, 4, 8):
        assert eng.generate(PROMPT, max_new_tokens=20, seed=2, eos_token_id=eos,
                            chunk=chunk) == full[:cut]
    toks = np.asarray([PROMPT + [0] * 8, PROMPT[::-1] + [0] * 8])
    scan = eng.generate_scan(toks, len(PROMPT), 20, seed=2, eos_token_id=eos)
    for row in scan.tolist():
        if eos in row:
            i = row.index(eos)
            assert row[i:] == [eos] * (20 - i)
    assert scan[0].tolist()[:cut] == full[:cut]
    with pytest.raises(ValueError, match="non-empty"):
        eng.generate([], 4)
    assert eng.generate(PROMPT, 0) == []


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_fills_its_cache_then_raises(tiny, chunk):
    """An 8-token prompt in a 16-slot engine: 9 new tokens fit (the last
    needs no slot), a 10th overflows, on the host, before any write."""
    eng = tgen.Engine(tcfg.TINY, tiny[1], max_len=16, sampling_cfg=GREEDY_T)
    assert len(eng.generate(PROMPT, max_new_tokens=9, chunk=chunk)) == 9
    with pytest.raises(BufferError, match="overflow"):
        eng.generate(PROMPT, max_new_tokens=10, chunk=chunk)
    with pytest.raises(BufferError, match="overflow"):
        eng.generate(list(range(20)), 4, chunk=chunk)


def test_tokenizers_round_trip_and_generate_text(tiny):
    bt = ttok.ByteTokenizer()
    for text in ("hello, мир", "", "a\nb"):
        assert bt.decode(bt.encode(text)) == text
    chat = bt.apply_chat_template([{"role": "user", "content": "x"}])
    assert chat[0] == bt.bos_token_id and bt.decode(chat).endswith("<|assistant|>\n")
    t = ttok.Tokenizer()  # no model name: the byte tokenizer, nothing loaded
    assert t.hf is None and t.eos_token_id == bt.eos_token_id
    assert t.encode("hi") == bt.encode("hi") and t.decode([104, 105, 257]) == "hi"
    assert t.apply_chat_template([{"role": "user", "content": "x"}]) == chat
    # a vocabulary that holds the byte tokenizer's specials
    cfg = dataclasses.replace(tcfg.TINY, vocab_size=260)
    params = tq.init_params(cfg, torch.Generator().manual_seed(0))
    eng = tgen.Engine(cfg, params, max_len=64, sampling_cfg=GREEDY_T)
    text = tgen.generate_text(eng, t, "hi", max_new_tokens=5)
    ids = eng.generate(bt.apply_chat_template([{"role": "user", "content": "hi"}]), 5,
                       eos_token_id=bt.eos_token_id)
    assert isinstance(text, str) and text == bt.decode(ids)


def test_paired_timing_helpers_equal_jax_package():
    rng = np.random.default_rng(3)
    for pairs in (1, 2, 5, 9):
        ts = (1.0 + 0.1 * rng.random(pairs)).tolist()
        tl = (2.5 + 0.6 * rng.random(pairs) - 0.3 * (rng.random(pairs) > 0.7)).tolist()
        assert tprof.paired_delta_stats(ts, tl, 50, 150) == jprof.paired_delta_stats(
            ts, tl, 50, 150)
        calls = []

        def short():
            calls.append("s")
            return len(calls)

        def long_():
            calls.append("l")
            return -len(calls)

        got = tprof.interleaved_pair_times(short, long_, pairs)
        order = list(calls)
        calls.clear()
        assert got == jprof.interleaved_pair_times(short, long_, pairs) and calls == order
    assert tprof.paired_delta_stats([2.0], [1.0], 50, 150)[1] == 0  # no valid pair


def test_chained_attention_rate_on_cpu():
    q = torch.randn(1, 1, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    seen = []

    def fn(qc, kk, vv):
        seen.append(qc)
        return qc.reshape(1, 1, 64) * 2

    assert tprof.chained_attention_rate(fn, q, k, k, n=3, reps=2) > 0
    assert len(seen) == 9 and not torch.equal(seen[1], q)  # each call sees the last output


def test_cli_generates_on_cpu(capsys):
    assert gen_cli.main(["--random-init", "--prompt-ids", "3,7,11", "--max-new-tokens", "9",
                         "--chunk", "4", "--device", "cpu", "--temperature", "0"]) == 0
    out = capsys.readouterr()
    ids = [int(x) for x in out.out.split("[", 1)[1].split("]")[0].split(",")]
    assert len(ids) == 9 and "tok/s on cpu" in out.err
    params = tq.init_params(tcfg.TINY, torch.Generator().manual_seed(0))
    eng = tgen.Engine(tcfg.TINY, params, max_len=2048, sampling_cfg=GREEDY_T)
    assert ids == eng.generate([3, 7, 11], 9)
    assert gen_cli.main(["--random-init", "--prompt-ids", "3,7,11,2", "--max-new-tokens",
                         "4", "--device", "cpu", "--pin-prefix-ids", "3,7", "--quant", "int8",
                         "--seed", "3"]) == 0


@pytest.mark.parametrize("argv,item", [
    (["--engine", "batched"], "A3"), (["--engine", "speculative"], "A7"),
    (["--quant", "w8a8"], "A6"), ([], "A5"),
])
def test_cli_refuses_what_is_not_ported(capsys, argv, item):
    extra = [] if item == "A5" else ["--random-init"]
    with pytest.raises(SystemExit) as e:
        gen_cli.main(["--prompt-ids", "1", "--device", "cpu", *extra, *argv])
    assert e.value.code == 2 and item in capsys.readouterr().err
