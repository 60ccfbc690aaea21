"""The port's configs equal the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu_torch import config as tcfg

torch.set_num_threads(2)


def test_dataclass_fields_match():
    for name in ("ModelConfig", "SamplingConfig"):
        jf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
        tf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
        assert jf == tf, name


def test_preset_names_match():
    assert list(tcfg.PRESETS) == list(jcfg.PRESETS)
    assert tcfg.HF_REPOS == jcfg.HF_REPOS


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_values_match(name):
    j, t = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("q_dim", "kv_dim", "attn_scale", "is_moe"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert str(j.jnp_dtype) == str(t.torch_dtype).replace("torch.", "")
    assert str(j.kv_jnp_dtype) == str(t.kv_torch_dtype).replace("torch.", "")


@pytest.mark.parametrize(
    "name,want",
    [("float32", torch.float32), ("bfloat16", torch.bfloat16),
     ("float16", torch.float16), ("float8_e4m3fn", torch.float8_e4m3fn)],
)
def test_dtype_strings_map_to_torch(name, want):
    assert tcfg.dtype_of(name) is want
    cfg = dataclasses.replace(tcfg.TINY, dtype=name, kv_dtype="model")
    assert cfg.torch_dtype is want and cfg.kv_torch_dtype is want


def test_kv_dtype_override_and_unknown_names():
    cfg = dataclasses.replace(tcfg.QWEN3_0_6B, kv_dtype="float8_e4m3fn")
    assert cfg.torch_dtype is torch.bfloat16
    assert cfg.kv_torch_dtype is torch.float8_e4m3fn
    with pytest.raises(ValueError):
        tcfg.dtype_of("complex64")
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-model")
