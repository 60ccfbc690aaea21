# jaxlint: file-disable=J003 -- test code: the loops read each layer's or target's result to ASSERT parity; they are verification loops, not serving hot paths
"""LoRA in the port (inferd_tpu_torch.ops.lora, utils.safetensors_io)
against the JAX package's and the `safetensors` package.

  * the port's safetensors reader reads what `safetensors.numpy.save_file`
    writes (F32, F16, BF16, with and without metadata) bit for bit, the
    package reads what the port writes, and `keys()` reads the header only;
  * the port's load_adapter reads a directory the JAX save_adapter wrote
    (and the JAX load_adapter one the port wrote) to the same layers and
    scale, rsLoRA, mixed ranks and target subsets included; every
    validation error of adapter_from_state_dict and slice_adapter is raised
    where the JAX package raises it; merge_adapter agrees within 1e-6 (f32);
  * fused_lane_delta_reference matches the Pallas `_fused_delta_kernel`
    in interpret mode within 1e-6 (f32: the same sums in another order),
    slot-0 lanes exactly zero; apply_lane_delta's CPU path matches the JAX
    gather form;
  * the wrapper runs its plain version on CPU tensors without building,
    and raises on what the kernel does not take.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.ops import build
from inferd_tpu_torch.ops import lora as tlora
from inferd_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)

TOL = 1e-6  # f32: the same products summed in another order


def _np(t):
    return convert.tensor_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# -- safetensors I/O ---------------------------------------------------------------


def _arrays(seed):
    g = np.random.default_rng(seed)
    f32 = g.standard_normal((3, 5)).astype(np.float32)
    f32[0, 0] = -0.0
    return {
        "w.f32": f32,
        "w.f16": g.standard_normal((4, 2, 3)).astype(np.float16),
        "w.bf16": g.standard_normal((7,)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "w.scalar_row": np.asarray([1.5], np.float32),
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt", "note": "seeded"}])
def test_port_reads_what_safetensors_writes_bit_exact(tmp_path, metadata):
    from safetensors.numpy import save_file

    arrays = _arrays(0)
    path = str(tmp_path / "a.safetensors")
    save_file(arrays, path, metadata=metadata)
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        want = a.astype(np.float32) if a.dtype.name == "bfloat16" else a  # widened exactly
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert np.array_equal(_bits(got[k]), _bits(want)), k
    with safetensors_io.SafeOpen(path) as f:
        assert f.metadata() == metadata


@pytest.mark.parametrize("metadata", [None, {"format": "np"}])
def test_safetensors_reads_what_the_port_writes(tmp_path, metadata):
    from safetensors import safe_open

    arrays = _arrays(1)
    tensors = dict(arrays, **{"w.bf16": torch.from_numpy(
        arrays["w.bf16"].view(np.int16).copy()).view(torch.bfloat16)})
    path = str(tmp_path / "b.safetensors")
    safetensors_io.save_file(tensors, path, metadata=metadata)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(arrays)
        assert f.metadata() == metadata
        for k, a in arrays.items():
            t = f.get_tensor(k)
            if a.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16)), k
            else:
                assert np.array_equal(_bits(t.numpy()), _bits(a)), k
    # and the port reads its own file back
    back = safetensors_io.load_file(path)
    assert np.array_equal(_bits(back["w.f16"]), _bits(arrays["w.f16"]))


def test_keys_read_the_header_only(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "c.safetensors")
    save_file(_arrays(2), path)
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    with open(path, "wb") as f:  # the data section gone: only the header is left
        f.write(raw[:8 + n])
    with safetensors_io.SafeOpen(path) as f:
        assert sorted(f.keys()) == sorted(_arrays(2))
        with pytest.raises(ValueError, match="runs past the end"):
            f.get_tensor("w.f32")


def test_truncated_header_raises(tmp_path):
    path = str(tmp_path / "d.safetensors")
    with open(path, "wb") as f:
        f.write((1000).to_bytes(8, "little") + b'{"a": 1}')
    with pytest.raises(ValueError, match="truncated"):
        safetensors_io.SafeOpen(path)


# -- adapter I/O, validation, merge ---------------------------------------------------


def _mk_layers(cfg, seed, r=4, targets=None, sd=0.25):
    g = np.random.default_rng(seed)
    dims = {
        "q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
        "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size),
        "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
        "up_proj": (cfg.hidden_size, cfg.intermediate_size),
        "down_proj": (cfg.intermediate_size, cfg.hidden_size),
    }
    return {n: (g.normal(0, sd, (cfg.num_layers, din, r)).astype(np.float32),
                g.normal(0, sd, (cfg.num_layers, r, dout)).astype(np.float32))
            for n, (din, dout) in dims.items() if targets is None or n in targets}


ADAPTER_CASES = {
    "all_targets_r4": dict(seed=0, r=4, targets=None, rslora=False, alpha=8),
    "rslora_r4": dict(seed=1, r=4, targets=None, rslora=True, alpha=8),
    "subset_r2": dict(seed=2, r=2, targets=("q_proj", "gate_proj"), rslora=False, alpha=4),
    "subset_r3_mlp": dict(seed=3, r=3, targets=("v_proj", "down_proj"), rslora=False, alpha=6),
}


def _same_adapter(tad, jad):
    assert sorted(tad["layers"]) == sorted(jad["layers"])
    assert tad["scale"] == pytest.approx(jad["scale"], rel=0, abs=0)
    for name, (ja, jb) in jad["layers"].items():
        ta, tb = tad["layers"][name]
        assert ta.dtype == torch.float32 and tb.dtype == torch.float32
        assert np.array_equal(_np(ta), np.asarray(ja)), name
        assert np.array_equal(_np(tb), np.asarray(jb)), name


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_load_adapter_reads_jax_written_dirs(tmp_path, case):
    c = ADAPTER_CASES[case]
    layers = _mk_layers(jcfg.TINY, c["seed"], c["r"], c["targets"])
    path = jlora.save_adapter(str(tmp_path / case), layers, alpha=c["alpha"], r=c["r"],
                              rslora=c["rslora"])
    _same_adapter(tlora.load_adapter(tcfg.TINY, path), jlora.load_adapter(jcfg.TINY, path))


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_jax_load_adapter_reads_port_written_dirs(tmp_path, case):
    c = ADAPTER_CASES[case]
    layers = _mk_layers(jcfg.TINY, c["seed"], c["r"], c["targets"])
    path = tlora.save_adapter(str(tmp_path / case), {n: (torch.from_numpy(a), b)
                                                     for n, (a, b) in layers.items()},
                              alpha=c["alpha"], r=c["r"], rslora=c["rslora"])
    with open(os.path.join(path, "adapter_config.json")) as f:
        assert json.load(f) == {"lora_alpha": c["alpha"], "r": c["r"], "use_rslora": c["rslora"]}
    _same_adapter(tlora.load_adapter(tcfg.TINY, path), jlora.load_adapter(jcfg.TINY, path))


def _full_sd(num_layers, r=4, extra=None):
    sd = {}
    for i in range(num_layers):
        pre = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        sd[f"{pre}.lora_A.weight"] = np.zeros((r, 64), np.float32)
        sd[f"{pre}.lora_B.weight"] = np.zeros((64, r), np.float32)
    if extra:
        sd.update(extra)
    return sd


def _missing_half():
    sd = _full_sd(2)
    del sd["base_model.model.model.layers.1.self_attn.q_proj.lora_B.weight"]
    return sd


# (state dict, alpha, r, the message both packages raise) from tests/test_lora.py
STATE_DICT_ERRORS = {
    "no_lora_parameters": ({"not.a.lora.key": np.zeros(1)}, 8, 4, "no LoRA parameters"),
    "layer_gap": ({k: v for k, v in _full_sd(1).items()}, 8, 4, "misses layers"),
    "out_of_scope_target": (_full_sd(2, extra={
        "base_model.model.lm_head.lora_A.weight": np.zeros((4, 64), np.float32)}), 8, 4,
        "outside the supported"),
    "unsupported_module": (_full_sd(2, extra={
        "base_model.model.model.layers.0.mlp.router.lora_A.weight": np.zeros((4, 64))}), 8, 4,
        "unsupported module 'router'"),
    "layer_overrun": (_full_sd(4), 8, 4, "only 2 layers"),
    "missing_half": (_missing_half(), 8, 4, "layer 1 lora_B"),
    "rank_mismatch": (_full_sd(2, r=4), 8, 8, r"rank mismatch for 'q_proj'.*r=8"),
}


@pytest.mark.parametrize("case", list(STATE_DICT_ERRORS))
def test_adapter_from_state_dict_raises_where_jax_raises(case):
    sd, alpha, r, msg = STATE_DICT_ERRORS[case]
    for lib, cfg in ((jlora, jcfg.TINY), (tlora, tcfg.TINY)):
        with pytest.raises(ValueError, match=msg):
            lib.adapter_from_state_dict(dataclasses.replace(cfg, num_layers=2), sd, alpha, r)


def test_rslora_scale_and_torch_state_dicts():
    cfg = dataclasses.replace(tcfg.TINY, num_layers=2)
    assert tlora.adapter_from_state_dict(cfg, _full_sd(2), 8, 4)["scale"] == pytest.approx(2.0)
    rs = tlora.adapter_from_state_dict(cfg, _full_sd(2), 8, 4, rslora=True)
    assert rs["scale"] == pytest.approx(4.0)
    # torch values (bf16 included) convert losslessly, as the reference's _to_np
    sd = {k: torch.full(v.shape, 0.5, dtype=torch.bfloat16) for k, v in _full_sd(2).items()}
    ad = tlora.adapter_from_state_dict(cfg, sd, 8, 4)
    assert torch.equal(ad["layers"]["q_proj"][0], torch.full((2, 64, 4), 0.5))


SLICE_ERRORS = {
    "empty": (1, 1, "node0 stage 3", "stage 3.*no-op"),
    "inverted": (2, 1, "", "inverted|no-op"),
    "past_the_end": (0, 3, "node0 stage 1", "runs past the adapter's 2"),
}


@pytest.mark.parametrize("case", list(SLICE_ERRORS))
def test_slice_adapter_bounds_raise_with_stage_identity(case):
    start, end, owner, msg = SLICE_ERRORS[case]
    for lib, mk in ((jlora, np.zeros), (tlora, torch.zeros)):
        ad = {"layers": {"q_proj": (mk((2, 8, 4)), mk((2, 4, 8)))}, "scale": 2.0}
        with pytest.raises(ValueError, match=msg):
            lib.slice_adapter(ad, start, end, owner=owner)
        assert lib.slice_adapter(ad, 0, 2)["layers"]["q_proj"][0].shape[0] == 2


def test_exclusive_modes_loud():
    tlora.check_exclusive_modes("", "")
    tlora.check_exclusive_modes("/a", None)
    tlora.check_exclusive_modes(None, "/a,/b")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tlora.check_exclusive_modes("/a", "/b,/c", owner="node0")


@pytest.fixture(scope="module")
def jax_full():
    return jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))


@pytest.mark.parametrize("case", ["all_targets_r4", "subset_r2"])
def test_merge_adapter_matches_jax(tmp_path, jax_full, case):
    c = ADAPTER_CASES[case]
    path = jlora.save_adapter(str(tmp_path / case), _mk_layers(jcfg.TINY, c["seed"], c["r"],
                                                               c["targets"]),
                              alpha=c["alpha"], r=c["r"])
    want = jlora.merge_adapter(jax_full, jlora.load_adapter(jcfg.TINY, path))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jax_full))
    got = tlora.merge_adapter(tparams, tlora.load_adapter(tcfg.TINY, path))
    for name in tlora.TARGETS:
        np.testing.assert_allclose(_np(got["layers"][name]), np.asarray(want["layers"][name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
        changed = c["targets"] is None or name in c["targets"]
        assert (got["layers"][name] is tparams["layers"][name]) != changed, name
    assert got["embed"] is tparams["embed"]
    # a stage's slice merges as the full merge's slice (the run_node --lora path)
    ad = tlora.load_adapter(tcfg.TINY, path)
    stage = {"layers": {n: w[1:3] for n, w in tparams["layers"].items()}}
    part = tlora.merge_adapter(stage, tlora.slice_adapter(ad, 1, 3))
    for name in tlora.TARGETS:
        assert torch.allclose(part["layers"][name], got["layers"][name][1:3], rtol=TOL, atol=TOL)


def test_merge_adapter_refuses_absent_and_unstacked_targets():
    ad = {"layers": {"q_proj": (torch.zeros(1, 4, 2), torch.zeros(1, 2, 4))}, "scale": 1.0}
    with pytest.raises(ValueError, match="absent from params"):
        tlora.merge_adapter({"layers": {}}, ad)
    with pytest.raises(ValueError, match="not a stacked"):
        tlora.merge_adapter({"layers": {"q_proj": torch.zeros(4, 4)}}, ad)


# -- the plain delta against the Pallas kernel ------------------------------------------


def _lora_pools(rng, slots=4, n_layers=3, d_in=32, r=4, d_out=48):
    """Stacked pools, slot 0 the zero base, slot 2 of effective rank 2 (its
    tail rank columns zero-padded, as the registry stacks a narrower
    adapter), as tests/test_kernels.py builds them."""
    a = rng.randn(slots, n_layers, d_in, r).astype(np.float32) * 0.3
    b = rng.randn(slots, n_layers, r, d_out).astype(np.float32) * 0.3
    a[0] = 0.0
    b[0] = 0.0
    a[2, :, :, 2:] = 0.0
    b[2, :, 2:, :] = 0.0
    scale = np.asarray([0.0, 2.0, 0.5, 1.25], np.float32)[:slots]
    return a, b, scale


@pytest.mark.parametrize("s", [1, 5])
def test_fused_lane_delta_reference_matches_pallas_interpret(s):
    rng = np.random.RandomState(8 + s)
    a, b, scale = _lora_pools(rng)
    ids = np.asarray([2, 0, 1, 3], np.int32)
    x = rng.randn(4, s, 32).astype(np.float32)
    for layer in range(a.shape[1]):
        want = jlora.fused_lane_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(scale), jnp.asarray(ids), jnp.int32(layer),
                                      interpret=True)
        got = tlora.fused_lane_delta_reference(
            torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(scale), torch.from_numpy(ids), layer)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, s, 48)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"layer {layer}")
        assert not got[1].any()  # the slot-0 lane: an exact zero
    zero = tlora.fused_lane_delta_reference(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(scale), torch.zeros(4, dtype=torch.int32), 1)
    assert torch.equal(zero, torch.zeros_like(zero))


def test_cpu_wrapper_runs_the_plain_version_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not reach the kernel build")

    monkeypatch.setattr(build, "load", no_build)
    a, b, scale = (torch.from_numpy(t) for t in _lora_pools(np.random.RandomState(3)))
    x = torch.randn(4, 2, 32)
    ids = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    before = tlora.fused_lane_delta.launches
    got = tlora.fused_lane_delta(x, a, b, scale, ids, 2)
    assert torch.equal(got, tlora.fused_lane_delta_reference(x, a, b, scale, ids, 2))
    assert tlora.fused_lane_delta.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tlora.fused_lane_delta(x.to("meta"), a, b, scale, ids, 2)


def _launch_args():
    a, b, scale = (torch.from_numpy(t) for t in _lora_pools(np.random.RandomState(4)))
    return dict(x=torch.randn(4, 2, 32), a_pool=a, b_pool=b, scale_pool=scale,
                ids=torch.tensor([1, 2, 3, 0], dtype=torch.int32), layer=1)


LAUNCH_REFUSALS = {
    "x_not_contiguous": (lambda kw: dict(kw, x=torch.randn(4, 32, 2).transpose(1, 2)),
                         ValueError, "x must be contiguous"),
    "pools_not_contiguous": (lambda kw: dict(kw, a_pool=kw["a_pool"].transpose(0, 1).contiguous()
                                             .transpose(0, 1)), ValueError, "a_pool must be"),
    "x_width": (lambda kw: dict(kw, x=torch.randn(4, 2, 31)), ValueError, "do not fit"),
    "rank_too_large": (lambda kw: dict(kw, a_pool=torch.zeros(4, 3, 32, 129),
                                       b_pool=torch.zeros(4, 3, 129, 48)), ValueError, "rank 129"),
    "layer_out_of_range": (lambda kw: dict(kw, layer=3), ValueError, "layer 3"),
    "ids_int64": (lambda kw: dict(kw, ids=kw["ids"].long()), TypeError, "int32 ids"),
    "scale_f16": (lambda kw: dict(kw, scale_pool=kw["scale_pool"].half()), TypeError, "f32 scale"),
    "x_f16": (lambda kw: dict(kw, x=kw["x"].half()), TypeError, "f32 or bf16"),
    "ids_width": (lambda kw: dict(kw, ids=kw["ids"][:3]), ValueError, "ids"),
}


@pytest.mark.parametrize("case", list(LAUNCH_REFUSALS))
def test_launch_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    """The kernel wrapper's checks run before the library is touched."""
    def no_build(name):
        raise AssertionError("a refused call must not reach the kernel build")

    monkeypatch.setattr(build, "load", no_build)
    edit, exc, msg = LAUNCH_REFUSALS[case]
    with pytest.raises(exc, match=msg):
        tlora._launch(**edit(_launch_args()))


def test_apply_lane_delta_cpu_path_matches_jax_gather_form():
    """layer_adapters on the CPU gathers once and applies lane_delta per
    projection: y + delta equals the JAX package's gather form, layer by
    layer, and targets outside the pools pass y through untouched."""
    rng = np.random.RandomState(5)
    a, b, scale = _lora_pools(rng)
    ids = np.asarray([3, 0, 2, 1], np.int32)
    x = rng.randn(4, 3, 32).astype(np.float32)
    y = rng.randn(4, 3, 48).astype(np.float32)
    jads = {"a": {"q_proj": jnp.asarray(a)}, "b": {"q_proj": jnp.asarray(b)},
            "scale": jnp.asarray(scale), "ids": jnp.asarray(ids)}
    tads = {"a": {"q_proj": torch.from_numpy(a)}, "b": {"q_proj": torch.from_numpy(b)},
            "scale": torch.from_numpy(scale), "ids": torch.from_numpy(ids)}
    jper, jscale = jlora.gather_lanes(jads)
    per_layer = tlora.layer_adapters(tads, torch.device("cpu"))
    for layer in range(a.shape[1]):
        jla = {"layers": {n: (pa[layer], pb[layer]) for n, (pa, pb) in jper.items()},
               "scale": jscale}
        want = jlora.apply_lane_delta(jnp.asarray(y), jnp.asarray(x), "q_proj", jla)
        tla = per_layer(layer)
        assert "layers" in tla
        got = tlora.apply_lane_delta(torch.from_numpy(y), torch.from_numpy(x), "q_proj", tla)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        assert torch.equal(got[1], torch.from_numpy(y[1]))  # the base lane: y itself
        yt = torch.from_numpy(y)
        assert tlora.apply_lane_delta(yt, torch.from_numpy(x), "v_proj", tla) is yt
    assert tlora.layer_adapters(None, torch.device("cpu"))(0) is None
    assert tlora.layer_adapters(tads, torch.device("cuda"))(2) == {"pools": tads, "layer": 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_lane_delta_y_mode_matches_jax_apply_lane_delta(dtype):
    """fused_lane_delta(..., y=y) on the CPU, returned and in place, against
    the JAX package's apply_lane_delta on its kernel form (the pools and a
    layer index: the Pallas kernel in interpret mode), through
    models/convert. f32 within TOL; bf16 within one bf16 step of the value,
    since both add an f32 delta (the same products summed in another order)
    to y in f32 and round once. Base lanes are y, bit for bit."""
    rng = np.random.RandomState(11)
    a, b, scale = _lora_pools(rng)
    ids = np.asarray([2, 0, 1, 3], np.int32)
    x = rng.randn(4, 3, 32).astype(np.float32)
    y = rng.randn(4, 3, 48).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jads = {"a": {"q_proj": jnp.asarray(a, jdt)}, "b": {"q_proj": jnp.asarray(b, jdt)},
            "scale": jnp.asarray(scale), "ids": jnp.asarray(ids)}
    ta, tb, tx, ty = (convert.tensor_from_numpy(np.asarray(jnp.asarray(v, jdt)))
                      for v in (a, b, x, y))
    for layer in range(a.shape[1]):
        want = jlora.apply_lane_delta(jnp.asarray(y, jdt), jnp.asarray(x, jdt), "q_proj",
                                      {"pools": jads, "layer": jnp.int32(layer)})
        got = tlora.fused_lane_delta(tx, ta, tb, torch.from_numpy(scale), torch.from_numpy(ids),
                                     layer, y=ty)
        y_in = ty.clone()
        back = tlora.fused_lane_delta(tx, ta, tb, torch.from_numpy(scale),
                                      torch.from_numpy(ids), layer, y=y_in, inplace=True)
        assert got.dtype == ty.dtype and back is y_in and torch.equal(y_in, got)
        assert torch.equal(got[1], ty[1])  # the slot-0 lane: y itself
        w = np.asarray(want).astype(np.float32)
        g = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"layer {layer}")
        else:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0, err_msg=f"layer {layer}")
