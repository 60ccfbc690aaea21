"""The port's roofline (inferd_tpu_torch/perf/roofline.py) against the JAX
package's: every byte and FLOP count equal field for field, for every
preset x quant mode x KV dtype; the three kernel byte models over a grid
of shapes; the roofline itself on a chip spec built with the same numbers
in both packages; the report table; the chip table and detect_chip."""

import dataclasses

import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.perf import roofline as jrl
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.perf import roofline as rl
from inferd_tpu_torch.perf.__main__ import main as perf_main

torch.set_num_threads(2)

KV_DTYPES = (None, "model", "float8_e4m3fn", "bfloat16", "float32")
CTX_BATCH = ((0, 1), (128, 1), (4096, 8))


def _chips():
    """One chip spec with the same numbers in both packages."""
    nums = ("test-h100", "test chip", 3350.0, 989.0, 1979.0, 74.5)
    return jrl.ChipSpec(*nums), rl.ChipSpec(*nums)


@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_decode_step_cost_and_roofline_equal_jax(preset):
    jchip, tchip = _chips()
    for quant in rl.QUANT_MODES:
        for kv in KV_DTYPES:
            for ctx, batch in CTX_BATCH:
                want = jrl.decode_step_cost(jcfg.get_config(preset), quant=quant, kv_dtype=kv,
                                            ctx=ctx, batch=batch)
                got = rl.decode_step_cost(tcfg.get_config(preset), quant=quant, kv_dtype=kv,
                                          ctx=ctx, batch=batch)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (quant, kv, ctx)
                for prop in ("weight_bytes", "read_bytes", "total_bytes", "flops"):
                    assert getattr(got, prop) == getattr(want, prop)
                jr, tr = jrl.roofline(want, jchip), rl.roofline(got, tchip)
                for f in ("hbm_ms", "compute_ms", "floor_ms", "ceiling_tok_s", "bound"):
                    assert getattr(tr, f) == getattr(jr, f), (quant, kv, ctx, f)
                assert rl.roofline_frac(123.0, got, tchip) == jrl.roofline_frac(123.0, want, jchip)


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="quant mode"):
        rl.decode_step_cost(tcfg.TINY, quant="int3")


@pytest.mark.parametrize("batch", [1, 8])
def test_kernel_byte_models_equal_jax(batch):
    for ctx in (1, 31, 32, 700, 4096):
        for bs in (16, 32):
            for mb in (4, 128):
                for kv_dim, kv_size in ((1024, 2), (512, 1)):
                    assert (rl.paged_attn_step_bytes(batch, ctx, kv_dim, kv_size, bs, mb)
                            == jrl.paged_attn_step_bytes(batch, ctx, kv_dim, kv_size, bs, mb))
    for k, n in ((1024, 151936), (1023, 1024), (3072, 1024), (100, 7)):
        for scheme in ("int8", "int4"):
            assert rl.quant_matvec_bytes(k, n, scheme) == jrl.quant_matvec_bytes(k, n, scheme)
    with pytest.raises(ValueError):
        rl.quant_matvec_bytes(16, 16, "int2")
    for din, r, dout, dsize in ((1024, 16, 3072, 2), (2048, 1, 1024, 4)):
        assert (rl.lora_delta_step_bytes(batch, din, r, dout, dsize)
                == jrl.lora_delta_step_bytes(batch, din, r, dout, dsize))


def test_format_report_parses_and_matches_the_model():
    chip = rl.get_chip("h100")
    cfg = tcfg.get_config("qwen3-0.6b")
    for ctx in (0, 512):
        lines = rl.format_report(cfg, chip, ctx=ctx, batch=2).splitlines()
        assert lines[0].startswith("roofline: qwen3-0.6b  chip=h100") and f"ctx={ctx}" in lines[0]
        assert lines[1].split() == ["quant", "kv_dtype", "read", "MB/step", "floor", "ms",
                                    "ceiling", "tok/s", "bound"]
        rows = [ln.split() for ln in lines[2:]]
        assert len(rows) == len(rl.QUANT_MODES) * (1 if ctx == 0 else 2)
        for quant, kvd, mb, floor, ceil, bound in rows:
            c = rl.decode_step_cost(cfg, quant=quant, kv_dtype=kvd, ctx=ctx, batch=2)
            r = rl.roofline(c, chip)
            assert float(mb) == round(c.total_bytes / 1e6, 1)
            assert float(floor) == round(r.floor_ms, 3)
            assert float(ceil) == round(r.ceiling_tok_s, 1) and bound == r.bound


def test_chip_table_and_detect(monkeypatch):
    h100 = rl.get_chip("H100")
    assert (h100.hbm_gbps, h100.peak_bf16_tflops, h100.peak_int8_tops) == (3350.0, 989.0, 1979.0)
    assert round(h100.hbm_gib * 2 ** 30 / 1e9) == 80
    assert sorted(rl.CHIP_SPECS) == ["cpu", "h100"]  # no TPU rows
    with pytest.raises(KeyError, match="unknown chip"):
        rl.get_chip("v5e")
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        assert rl.chip_for_name(name) is h100
    for name in ("NVIDIA A100-SXM4-80GB", "Tesla T4", "NVIDIA H200"):
        with pytest.raises(KeyError, match="no chip spec"):
            rl.chip_for_name(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rl.detect_chip() is rl.CHIP_SPECS["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    assert rl.detect_chip() is h100
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA L4")
    with pytest.raises(KeyError):  # never another chip's numbers
        rl.detect_chip()


def test_report_cli_prints_the_table(capsys):
    assert perf_main(["report", "--preset", "qwen3-0.6b", "--chip", "h100", "--ctx", "128"]) == 0
    out = capsys.readouterr().out
    assert out == rl.format_report(tcfg.get_config("qwen3-0.6b"), rl.get_chip("h100"),
                                   ctx=128) + "\n"
