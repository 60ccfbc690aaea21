"""The port's checkpoint loader (inferd_tpu_torch.models.loader) against the
JAX package's, and the slice it opens: HF safetensors -> split_model
--weights -> stage nodes -> ChainClient, and the generate CLI without
--random-init.

Checkpoints are written by the port's utils/safetensors_io from a seeded
numpy state dict in HF's names and [out, in] layout. Loaded parameters
must be EQUAL (torch.equal) to the reference's, converted: both read the
same bits and cast the same way. Forwards: f32 logits atol 1e-4 between
the packages (the same math, other summation orders), 2e-4 against
transformers (the reference's own limit in tests/test_model.py)."""

import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine as JEngine
from inferd_tpu.models import loader as jloader
from inferd_tpu.models import qwen3 as jq
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.core.generate import Engine
from inferd_tpu_torch.models import convert, loader
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.utils.safetensors_io import save_file

torch.set_num_threads(2)

FAMILIES = ["tiny", "tiny-qwen2", "tiny-llama"]  # q/k norm, q/k/v bias, llama3 RoPE
GREEDY = SamplingConfig(temperature=0.0)


MOE_LAYOUTS = {  # layout: the config it loads into
    "qwen3_moe": "tiny-moe", "mixtral": "tiny-mixtral",
    "gptoss_bf16": "tiny-gptoss", "gptoss_mxfp4": "tiny-gptoss",
}
MIXTRAL_FIELDS = dict(name="tiny-mixtral", qk_norm=False, tie_word_embeddings=False,
                      rms_norm_eps=1e-5, rope_theta=1_000_000.0, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=48)


def hf_state_dict(cfg, seed: int = 0, untied=None, layout: str = "dense", scale: float = 0.05):
    """A seeded float32 state dict in HF's names and [out, in] layout
    (norms near 1, biases near 0), `lm_head.weight` when the head is
    untied. `layout` names the MLP's: "dense", or one of MOE_LAYOUTS (the
    GPT-OSS ones with its attention biases and sinks; MXFP4 blocks and
    scales as uint8)."""
    rng = np.random.default_rng(seed)
    h, q, kv, i = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size

    def w(*shape, sd=scale, mean=0.0):
        return (mean + sd * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embed_tokens.weight": w(cfg.vocab_size, h), "norm.weight": w(h, mean=1.0)}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        sd.update({
            p + "input_layernorm.weight": w(h, mean=1.0),
            p + "post_attention_layernorm.weight": w(h, mean=1.0),
            p + "self_attn.q_proj.weight": w(q, h), p + "self_attn.k_proj.weight": w(kv, h),
            p + "self_attn.v_proj.weight": w(kv, h), p + "self_attn.o_proj.weight": w(h, q),
        })
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = w(cfg.head_dim, mean=1.0)
            sd[p + "self_attn.k_norm.weight"] = w(cfg.head_dim, mean=1.0)
        if cfg.attn_bias:
            for name, width in (("q", q), ("k", kv), ("v", kv)):
                sd[p + f"self_attn.{name}_proj.bias"] = w(width, sd=0.1)
        if cfg.o_bias:
            sd[p + "self_attn.o_proj.bias"] = w(h, sd=0.1)
        if cfg.attn_sinks:
            sd[p + "self_attn.sinks"] = w(cfg.num_heads, sd=0.5)
        sd.update(_mlp_tensors(cfg, p, layout, w, rng))
    if not cfg.tie_word_embeddings if untied is None else untied:
        sd["lm_head.weight"] = w(cfg.vocab_size, h)
    return sd


def _mlp_tensors(cfg, p: str, layout: str, w, rng):
    """One layer's MLP tensors (prefix `p`) in `layout`."""
    h = cfg.hidden_size
    if layout == "dense":
        i = cfg.intermediate_size
        return {p + "mlp.gate_proj.weight": w(i, h), p + "mlp.up_proj.weight": w(i, h),
                p + "mlp.down_proj.weight": w(h, i)}
    e, mi = cfg.num_experts, cfg.moe_intermediate_size
    if layout in ("qwen3_moe", "mixtral"):
        mix = layout == "mixtral"
        base = p + ("block_sparse_moe." if mix else "mlp.")
        names = ("w1", "w3", "w2") if mix else ("gate_proj", "up_proj", "down_proj")
        out = {base + "gate.weight": w(e, h)}
        for x in range(e):
            out[f"{base}experts.{x}.{names[0]}.weight"] = w(mi, h)
            out[f"{base}experts.{x}.{names[1]}.weight"] = w(mi, h)
            out[f"{base}experts.{x}.{names[2]}.weight"] = w(h, mi)
        return out
    base = p + "mlp."
    out = {base + "router.weight": w(e, h), base + "router.bias": w(e, sd=0.1),
           base + "experts.gate_up_proj_bias": w(e, 2 * mi, sd=0.1),
           base + "experts.down_proj_bias": w(e, h, sd=0.1)}
    if layout == "gptoss_bf16":  # stacked, [in, out]
        out[base + "experts.gate_up_proj"] = w(e, h, 2 * mi)
        out[base + "experts.down_proj"] = w(e, mi, h)
        return out
    for name, rows, cols in (("gate_up_proj", 2 * mi, h), ("down_proj", h, mi)):
        out[f"{base}experts.{name}_blocks"] = rng.integers(
            0, 256, (e, rows, cols // 32, 16), dtype=np.uint8)
        out[f"{base}experts.{name}_scales"] = rng.integers(
            120, 130, (e, rows, cols // 32), dtype=np.uint8)
    return out


def write_checkpoint(d: str, sd, dtype: str = "BF16", prefix: bool = True, shards: int = 1):
    """`sd` as safetensors file(s) in `d` (in HF's order: the layers split
    over the shards by name), each float tensor as `dtype` (uint8 ones, the
    MXFP4 blocks and scales, as U8)."""
    os.makedirs(d, exist_ok=True)
    to = {"BF16": lambda a: torch.from_numpy(a).to(torch.bfloat16),
          "F32": lambda a: a, "F16": lambda a: a.astype(np.float16)}[dtype]

    def cast(a):
        return a if a.dtype == np.uint8 else to(a)
    names = sorted(sd)
    for s in range(shards):
        part = {("model." if prefix and k != "lm_head.weight" else "") + k: cast(sd[k])
                for k in names[s::shards]}
        save_file(part, os.path.join(d, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    return d


def both_configs(name: str, **changes):
    if name == "tiny-mixtral":
        return (dataclasses.replace(jcfg.TINY, **MIXTRAL_FIELDS, **changes),
                dataclasses.replace(tcfg.TINY, **MIXTRAL_FIELDS, **changes))
    return (dataclasses.replace(jcfg.get_config(name), **changes),
            dataclasses.replace(tcfg.get_config(name), **changes))


def assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert_params_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def reference_params(cfg_j, d):
    """The JAX loader's params of `d`, converted to the port's tensors."""
    return convert.params_from_numpy(jax.tree.map(np.asarray, jloader.load_params(cfg_j, d)))


# -- load_params: the same bits as the reference's --------------------------------


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("prefix", [True, False], ids=["model.", "bare"])
@pytest.mark.parametrize("dtype", ["BF16", "F32", "F16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_load_params_equals_reference(tmp_path, name, dtype, prefix, tied, shards):
    cfg_j, cfg_t = both_configs(name, tie_word_embeddings=tied)
    d = write_checkpoint(str(tmp_path / "ckpt"), hf_state_dict(cfg_t, seed=len(name)),
                         dtype, prefix, shards)
    got = loader.load_params(cfg_t, d, device="cpu")
    assert ("lm_head" in got) == (not tied)
    assert_params_equal(got, reference_params(cfg_j, d))


@pytest.mark.parametrize("dtype", ["BF16", "F32", "F16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_load_params_casts_to_bf16_as_reference(tmp_path, name, dtype):
    """A bf16 model from each file dtype: f32 and f16 values round to bf16
    the same way in both packages."""
    cfg_j, cfg_t = both_configs(name, dtype="bfloat16")
    d = write_checkpoint(str(tmp_path / "ckpt"), hf_state_dict(cfg_t, seed=3), dtype)
    got = loader.load_params(cfg_t, d, device="cpu")
    assert got["layers"]["q_proj"].dtype == torch.bfloat16
    assert_params_equal(got, reference_params(cfg_j, d))


def test_bf16_is_read_as_bf16(tmp_path):
    """get_torch keeps BF16 at 2 bytes a value, with the widened read's values."""
    from inferd_tpu_torch.utils.safetensors_io import SafeOpen

    x = torch.randn(4, 6).to(torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    save_file({"x": x, "e": torch.zeros((0, 3), dtype=torch.bfloat16)}, path)
    with SafeOpen(path) as f:
        t = f.get_torch("x")
        assert t.dtype == torch.bfloat16 and torch.equal(t, x)
        assert np.array_equal(t.float().numpy(), f.get_tensor("x"))
        assert f.get_torch("e").shape == (0, 3)


# -- mixture-of-experts checkpoints (Qwen3-MoE, Mixtral, GPT-OSS bf16 and MXFP4) ------


@pytest.mark.parametrize("dtype", ["BF16", "F32"])
@pytest.mark.parametrize("layout", sorted(MOE_LAYOUTS))
def test_moe_load_params_equals_reference(tmp_path, layout, dtype):
    """Each MoE layout through both loaders: equal parameters (the expert
    stacks [L, E, in, out], the router [L, H, E], the biases), bf16 and
    f32 models alike; an MXFP4 checkpoint mixes U8 blocks and scales with
    the file's float dtype."""
    cfg_j, cfg_t = both_configs(MOE_LAYOUTS[layout])
    d = write_checkpoint(str(tmp_path / "ckpt"), hf_state_dict(cfg_t, seed=4, layout=layout),
                         dtype, shards=2)
    got = loader.load_params(cfg_t, d, device="cpu")
    e, h = cfg_t.num_experts, cfg_t.hidden_size
    assert got["layers"]["gate_proj"].shape == (cfg_t.num_layers, e, h,
                                                cfg_t.moe_intermediate_size)
    assert got["layers"]["router"].shape == (cfg_t.num_layers, h, e)
    assert list(got["layers"]) == sorted(got["layers"])
    assert_params_equal(got, reference_params(cfg_j, d))


def test_moe_bf16_model_from_each_layout_casts_as_reference(tmp_path):
    for layout in sorted(MOE_LAYOUTS):
        cfg_j, cfg_t = both_configs(MOE_LAYOUTS[layout], dtype="bfloat16")
        d = write_checkpoint(str(tmp_path / layout), hf_state_dict(cfg_t, seed=5, layout=layout),
                             "F32")
        got = loader.load_params(cfg_t, d, device="cpu")
        assert got["layers"]["down_proj"].dtype == torch.bfloat16
        assert_params_equal(got, reference_params(cfg_j, d))


def test_dequant_mxfp4_is_bit_exact():
    """Every code byte and every E8M0 exponent byte (0: the subnormal
    2**-127; 255: inf, so 0 * inf reads nan): the reference's float32
    bits, and its shape [*prefix, in, out]."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (3, 256, 4, 16), dtype=np.uint8)
    blocks[0, :, 0, 0] = np.arange(256, dtype=np.uint8)
    scales = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None], (3, 256, 4)).copy()
    want = jloader.dequant_mxfp4(blocks, scales)
    got = loader.dequant_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 128, 256)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_dequant_mxfp4_matches_transformers():
    """The reference's own pin: transformers' convert_moe_packed_tensors."""
    from transformers.integrations.mxfp4 import convert_moe_packed_tensors

    rng = np.random.RandomState(0)
    blocks = rng.randint(0, 256, size=(3, 8, 2, 16), dtype=np.uint8)
    scales = rng.randint(118, 136, size=(3, 8, 2), dtype=np.uint8)
    want = convert_moe_packed_tensors(torch.from_numpy(blocks), torch.from_numpy(scales),
                                      dtype=torch.float32).float()
    assert torch.equal(loader.dequant_mxfp4(blocks, scales), want)


@pytest.mark.parametrize("family", ["qwen3_moe", "mixtral"])
def test_hf_moe_state_dict_through_both_loaders(family):
    """transformers' Qwen3-MoE and Mixtral models (the reference's parity
    configs, tests/test_model.py): their state_dict through both loaders
    gives equal parameters, and the port's forward matches the JAX
    forward (atol 1e-4) and transformers' (2e-4)."""
    import transformers

    torch.manual_seed(0)
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  max_position_embeddings=512, rope_theta=1e6)
    fields = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=512,
                  dtype="float32", num_experts=8, num_experts_per_tok=2)
    if family == "qwen3_moe":
        hf_model = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            **common, tie_word_embeddings=True, num_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, norm_topk_prob=True, decoder_sparse_step=1,
            mlp_only_layers=[]))
        fields.update(name="tiny-moe-parity", moe_intermediate_size=32)
    else:
        hf_model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **common, tie_word_embeddings=False, num_local_experts=8, num_experts_per_tok=2,
            sliding_window=None, attn_implementation="eager"))
        fields.update(name="tiny-mixtral-parity", rope_theta=1e6, rms_norm_eps=1e-5,
                      qk_norm=False, tie_word_embeddings=False, moe_intermediate_size=128)
    hf_model.eval()
    cfg_j, cfg_t = jcfg.ModelConfig(**fields), tcfg.ModelConfig(**fields)
    sd = hf_model.state_dict()
    jp = jloader.params_from_hf_state_dict(cfg_j, sd)
    tp = loader.params_from_hf_state_dict(cfg_t, sd)
    assert_params_equal(tp, convert.params_from_numpy(jax.tree.map(np.asarray, jp)))
    tokens = np.array([[3, 17, 42, 99, 7, 250, 11, 5]], dtype=np.int64)
    with torch.no_grad():
        hf_logits = hf_model(torch.from_numpy(tokens)).logits.float().numpy()
    ref, _, _ = jq.forward(jp, cfg_j, jnp.asarray(tokens))
    got, _, _ = tq.forward(tp, cfg_t, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), hf_logits, rtol=2e-4, atol=2e-4)


def test_u8_safetensors_round_trip_and_bytes_equal_the_package(tmp_path):
    """U8 (the MXFP4 blocks and scales) beside the float dtypes: the
    port's writer gives the safetensors package's bytes (its order: F32,
    BF16, F16, U8, by name within each), and each reader reads the
    other's file."""
    from safetensors.torch import load_file as st_load
    from safetensors.torch import save_file as st_save

    from inferd_tpu_torch.utils.safetensors_io import SafeOpen

    rng = np.random.default_rng(2)
    tensors = {"a_blocks": torch.from_numpy(rng.integers(0, 256, (3, 4, 16), dtype=np.uint8)),
               "z": torch.randn(5), "m": torch.randn(2, 3).to(torch.bfloat16),
               "k": torch.randn(4).to(torch.float16), "b_scales": torch.zeros(0, dtype=torch.uint8)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_file(tensors, ours)
    st_save(tensors, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = st_load(ours)
    with SafeOpen(theirs) as f:
        for k, t in tensors.items():
            assert torch.equal(back[k], t)
            got = f.get_torch(k)
            assert got.dtype == t.dtype and torch.equal(got, t)
        assert f.get_tensor("a_blocks").dtype == np.uint8


def test_missing_checkpoint_raises_as_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    cfg_j, cfg_t = both_configs("tiny-llama")
    with pytest.raises(FileNotFoundError) as want:
        jloader.load_params(cfg_j)
    with pytest.raises(FileNotFoundError) as got:
        loader.load_params(cfg_t, device="cpu")
    assert str(got.value) == str(want.value)


# -- the HF cache search -------------------------------------------------------


def _snapshot(hub, rev, files=("model.safetensors",), mtime=None):
    d = os.path.join(hub, "snapshots", rev)
    os.makedirs(d, exist_ok=True)
    for f in files:
        open(os.path.join(d, f), "wb").close()
    if mtime is not None:
        os.utime(d, (mtime, mtime))
    return d


def _cache(tmp_path, case):
    """(the argument to resolve, the directory it must resolve to) for a
    fake HF cache under tmp_path laid out as `case`."""
    hub = str(tmp_path / "hub" / "models--meta-llama--Llama-3.2-1B")
    if case == "refs_main":  # refs/main wins over a newer snapshot
        want = _snapshot(hub, "aaa", mtime=1000)
        _snapshot(hub, "bbb", mtime=2000)
        os.makedirs(os.path.join(hub, "refs"))
        with open(os.path.join(hub, "refs", "main"), "w") as f:
            f.write("aaa\n")
        return "llama3.2-1b", want
    if case == "newest_mtime":
        _snapshot(hub, "old", mtime=1000)
        return "llama3.2-1b", _snapshot(hub, "new", mtime=2000)
    if case == "no_safetensors":  # the newest holds none: the next one is taken
        want = _snapshot(hub, "old", mtime=1000)
        _snapshot(hub, "new", files=("config.json",), mtime=2000)
        return "llama3.2-1b", want
    if case == "plain_path":
        d = str(tmp_path / "elsewhere")
        os.makedirs(d)
        return d, d
    if case == "repo_id":
        return "meta-llama/Llama-3.2-1B", _snapshot(hub, "ccc")
    if case == "empty_cache":
        return "llama3.2-1b", None
    raise ValueError(case)


@pytest.mark.parametrize("case", ["refs_main", "newest_mtime", "no_safetensors", "plain_path",
                                  "repo_id", "empty_cache"])
def test_find_checkpoint_dir_matches_reference(tmp_path, monkeypatch, case):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    model, want = _cache(tmp_path, case)
    assert jloader._find_checkpoint_dir(model) == want
    assert loader._find_checkpoint_dir(model) == want


# -- forwards on loaded weights ------------------------------------------------


def test_hf_llama_state_dict_through_both_loaders():
    """The reference's HF Llama parity config (tests/test_model.py): the
    transformers model's state_dict through both loaders gives equal
    parameters, and the port's forward matches the JAX forward (atol 1e-4)
    and transformers' (2e-4) over 144 positions, past the 128 of the
    llama3 scaling's original window."""
    import transformers

    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=512, rope_theta=5e5,
        tie_word_embeddings=True, attention_bias=False, mlp_bias=False,
        rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 128,
        },
    )
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval()
    fields = dict(
        name="tiny-llama-parity", vocab_size=256, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, max_position_embeddings=512, rope_theta=5e5,
        dtype="float32", qk_norm=False, attn_bias=False,
        rope_scaling="llama3", rope_scaling_factor=8.0,
        rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_original_max_position=128,
    )
    cfg_j, cfg_t = jcfg.ModelConfig(**fields), tcfg.ModelConfig(**fields)
    sd = hf_model.state_dict()
    jp = jloader.params_from_hf_state_dict(cfg_j, sd)
    tp = loader.params_from_hf_state_dict(cfg_t, sd)
    assert_params_equal(tp, convert.params_from_numpy(jax.tree.map(np.asarray, jp)))

    tokens = np.array([[3, 17, 42, 99, 7, 250] * 24], dtype=np.int64)  # S = 144
    with torch.no_grad():
        hf_logits = hf_model(torch.from_numpy(tokens)).logits.float().numpy()
    ref, _, _ = jq.forward(jp, cfg_j, jnp.asarray(tokens))
    got, _, _ = tq.forward(tp, cfg_t, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), hf_logits, rtol=2e-4, atol=2e-4)


# -- the CLIs --------------------------------------------------------------------


def test_split_model_weights_stage_files_equal_reference(tmp_path):
    """Both split_model CLIs with --weights on one tiny-llama directory
    (BF16, two shards): the stage files are the same bytes."""
    from inferd_tpu.tools import split_model as jsplit
    from inferd_tpu_torch.tools import split_model as tsplit

    cfg = tcfg.get_config("tiny-llama")
    d = write_checkpoint(str(tmp_path / "ckpt"), hf_state_dict(cfg, seed=7), "BF16", shards=2)
    jsplit.main(["--model", "tiny-llama", "--stages", "2", "--weights", d,
                 "--out", str(tmp_path / "j"), "--device", "cpu"])
    paths = tsplit.main(["--model", "tiny-llama", "--stages", "2", "--weights", d,
                         "--out", str(tmp_path / "t"), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["stage_000.msgpack", "stage_001.msgpack"]
    for p in paths:
        with open(p, "rb") as a, open(tmp_path / "j" / os.path.basename(p), "rb") as b:
            assert a.read() == b.read(), p


def test_split_model_without_checkpoint_stops(tmp_path, monkeypatch, capsys):
    from inferd_tpu_torch.tools import split_model as tsplit

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        tsplit.main(["--model", "tiny-llama", "--out", str(tmp_path / "t"), "--device", "cpu"])
    assert e.value.code == 2 and "no checkpoint" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "t")


def _hf_cache_checkpoint(home, name, seed=9):
    """The preset's checkpoint laid out in an HF cache under `home`, as the
    hub leaves it (a snapshot and refs/main)."""
    cfg = tcfg.get_config(name)
    repo = tcfg.HF_REPOS.get(name, name)
    base = os.path.join(home, "hub", "models--" + repo.replace("/", "--"))
    snap = write_checkpoint(os.path.join(base, "snapshots", "rev0"), hf_state_dict(cfg, seed),
                            "BF16", shards=2)
    os.makedirs(os.path.join(base, "refs"))
    with open(os.path.join(base, "refs", "main"), "w") as f:
        f.write("rev0")
    return snap


def test_generate_cli_loads_the_cached_checkpoint(tmp_path, monkeypatch, capsys):
    """The generate CLI without --random-init reads the preset's checkpoint
    from the HF cache: its ids equal an Engine over load_params."""
    from inferd_tpu_torch.tools import generate as gen_cli

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    _hf_cache_checkpoint(str(tmp_path), "tiny-llama")
    assert gen_cli.main(["--model", "tiny-llama", "--prompt-ids", "3,7,11,200",
                         "--max-new-tokens", "10", "--device", "cpu", "--temperature", "0",
                         "--max-len", "64"]) == 0
    out = capsys.readouterr()
    ids = [int(x) for x in out.out.split("[", 1)[1].split("]")[0].split(",")]
    cfg = tcfg.get_config("tiny-llama")
    eng = Engine(cfg, loader.load_params(cfg, device="cpu"), max_len=64, sampling_cfg=GREEDY)
    assert ids == eng.generate([3, 7, 11, 200], 10) and len(ids) == 10


def test_llama_chain_from_checkpoint_equals_jax_engine(tmp_path):
    """The slice on the CPU: an HF checkpoint -> the port's split_model
    --weights -> two in-process run_node stages behind the ChainClient,
    greedy, token-exact against the JAX package's Engine over its own
    loader's params of the same directory."""
    from inferd_tpu_torch.tools import run_node
    from inferd_tpu_torch.tools import split_model as tsplit

    cfg_j = jcfg.get_config("tiny-llama")
    d = write_checkpoint(str(tmp_path / "ckpt"), hf_state_dict(cfg_j, seed=11), "BF16", shards=2)
    parts = str(tmp_path / "parts")
    tsplit.main(["--model", "tiny-llama", "--stages", "2", "--weights", d, "--out", parts,
                 "--device", "cpu"])
    prompt = np.random.default_rng(1).integers(0, cfg_j.vocab_size, 150).tolist()
    expected = JEngine(cfg_j, jloader.load_params(cfg_j, d), max_len=256,
                       sampling_cfg=jcfg.SamplingConfig(temperature=0.0)).generate(
        prompt, max_new_tokens=12)
    nodes = []
    try:
        for s in range(2):
            args = run_node.build_parser().parse_args(
                ["--parts", parts, "--stage", str(s), "--port", "0", "--gossip-port", "0",
                 "--device", "cpu", "--max-len", "256"])
            nodes.append(run_node.make_node(args).start())

        async def go():
            async with ChainClient([(n.host, n.port) for n in nodes], sampling=GREEDY,
                                   prefill_chunk=64) as c:
                return await c.generate_ids(prompt, max_new_tokens=12)

        assert asyncio.run(go()) == expected
        for n in nodes:
            assert n.stats()["forward_passes"] == 3 + 11  # 64 + 64 + 22, then 11 steps
    finally:
        for n in nodes:
            n.stop()
