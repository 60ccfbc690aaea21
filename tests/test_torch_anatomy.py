"""The port's step anatomy (inferd_tpu_torch/perf/anatomy.py) against the
JAX package's: each phase's bytes equal the reference _build_suite's, and
the step the anatomy times (models/qwen3.decode_step) gives the JAX step's
greedy tokens on the same weights and cache. On the CPU the phases run as
plain loops; no timing ratio is asserted (CPU times under parallel workers
are noise: the reference's own ratio test is flaky, ROADMAP Queue C)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.cache import KVCache as JKVCache
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.perf import anatomy as janat
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core.cache import KVCache
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.perf import anatomy
from inferd_tpu_torch.perf import roofline as rl
from inferd_tpu_torch.perf.__main__ import main as perf_main

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("preset", ["tiny", "tiny-qwen2", "tiny-moe"])  # presets the port runs
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_phase_bytes_equal_reference_build_suite(preset, quant):
    for ctx, batch in ((32, 1), (64, 2)):
        want = janat._build_suite(jcfg.get_config(preset), None, quant, ctx, batch, 2, 4, None,
                                  0)["phase_bytes"]
        got = anatomy._build_suite(tcfg.get_config(preset), None, quant, ctx, batch, 2, 4, None,
                                   0, CPU)["phase_bytes"]
        assert got == want
        assert set(got) == set(anatomy.PHASES) - {"dispatch"}


def test_decode_step_tokens_equal_the_reference_step():
    """Greedy, B = 2 at fills 5 and 9: K chained decode_steps (the body the
    anatomy and the engine run) give the JAX step's tokens: its cached
    forward, one row per step, each row at its own position."""
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(3)))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)
    rows = [[3, 7, 11, 19, 5], [9, 4, 1, 8, 30, 2, 6, 12, 44]]
    toks = np.asarray([r + [0] * (9 - len(r)) for r in rows], np.int32)
    jc = JKVCache.create(jcfg.TINY, jcfg.TINY.num_layers, 2, 32)
    _, jc = jq.forward_cached(jp, jcfg.TINY, jnp.asarray(toks), None, jc, jnp.int32(0))
    tc = KVCache.create(tcfg.TINY, tcfg.TINY.num_layers, 2, 32)
    tq.forward_cached(tp, tcfg.TINY, torch.from_numpy(toks).long(), None, tc, 0)
    lens, last, k = np.array([5, 9]), [5, 44], 6
    want = []
    cur, pos = jnp.asarray(last, jnp.int32), jnp.asarray(lens, jnp.int32)
    for _ in range(k):  # the reference step: a cached forward at each row's position
        logits, jc = jq.forward_cached(jp, jcfg.TINY, cur[:, None], pos[:, None], jc, pos)
        cur = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
        want.append(cur)
        pos = pos + 1
    fill = torch.as_tensor(lens)
    seq, fill2, active, _, _, _ = tq.decode_window(
        tp, tcfg.TINY, tc.k, tc.v, torch.as_tensor(last), fill, torch.ones(2, dtype=torch.bool),
        None, None, tq.window_bounds(9, k, 32))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jnp.stack(want)))
    assert fill2.tolist() == [5 + k, 9 + k] and bool(active.all())
    assert len(set(seq[:, 1].tolist())) > 1  # the stream varies


@pytest.mark.parametrize("paged", [0, 16])
def test_profile_step_on_cpu_fields_and_bounds(paged):
    out = anatomy.profile_step(tcfg.TINY, ctx=32, pairs=1, short=2, long_=4,
                               paged_block_size=paged, device="cpu")
    assert set(out["phases"]) == set(anatomy.PHASES)
    assert out["chip"] == "cpu" and out["device"] == "cpu" and out["graphs"] is None
    cost = rl.decode_step_cost(tcfg.TINY, ctx=32)
    chip = rl.get_chip("cpu")
    for name, p in out["phases"].items():
        if name == "dispatch":
            assert p["ms"] >= 0 and p["hostloop_step_ms"] > 0 and p["bytes"] == 0
            continue
        assert p["ms"] > 0 and p["bytes"] >= 0
        assert p["roofline_ms"] == round(p["bytes"] / (chip.hbm_gbps * 1e9) * 1e3, 4)
    assert out["phases"]["lm_head"]["bytes"] == cost.head_bytes
    assert out["step_roofline_ms"] == round(rl.roofline(cost, chip).floor_ms, 4)
    assert out["unattributed_ms"] == pytest.approx(out["step_ms"] - out["phase_sum_ms"], abs=1e-3)
    assert out["paged_block_size"] == paged


def test_phase_subsets_and_the_dispatch_anchor():
    with pytest.raises(ValueError, match="anchor"):
        anatomy.profile_step(tcfg.TINY, ctx=16, pairs=1, short=1, long_=2, phases=["dispatch"],
                             with_step=False, device="cpu")
    with pytest.raises(ValueError, match="unknown anatomy phases"):
        anatomy.profile_step(tcfg.TINY, ctx=16, phases=["warp"], device="cpu")
    out = anatomy.profile_step(tcfg.TINY, ctx=16, pairs=1, short=1, long_=2,
                               phases=["embed", "lm_head"], with_step=False, device="cpu")
    assert set(out["phases"]) == {"embed", "lm_head"}
    assert out["step_ms"] is None and out["phase_sum_ms"] is None
    assert out["unattributed_ms"] is None


def test_anatomy_session_measures_each_phase():
    s = anatomy.AnatomySession(tcfg.TINY, quant="int8", ctx=16, short=1, long_=2, device="cpu")
    assert s.phases == ("embed", "attention", "mlp", "lm_head", "sampling", "kv_write")
    rec = s.measure("mlp")
    assert rec["ms"] > 0
    assert rec["bytes"] == rl.decode_step_cost(tcfg.TINY, quant="int8", ctx=16).mlp_weight_bytes
    assert s.measure("mlp")["bytes"] == rec["bytes"]
    with pytest.raises(ValueError, match="unknown session phase"):
        s.measure("dispatch")


def test_cli_prints_one_json_line_with_every_phase(capsys):
    assert perf_main(["anatomy", "--preset", "tiny", "--ctx", "32", "--pairs", "2",
                      "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    obj = json.loads(lines[-1])
    assert obj["preset"] == "tiny" and set(obj["phases"]) == set(anatomy.PHASES)
    assert len(obj["phases"]) == 7
