"""Weight loading: HF checkpoints -> the port's params (port of
inferd_tpu/models/loader.py).

HF stores a dense decoder as one tensor per layer and projection, named
`model.layers.{i}.self_attn.q_proj.weight` and so on, linear weights
[out, in]. The port keeps every layer STACKED on a leading axis and its
weights [in, out] (models/qwen3.py), so a parameter is read layer by layer,
transposed, stacked on the host and moved to its device once, in the
config's dtype.

`params_from_hf_state_dict` converts a state dict in memory (a
`transformers` model's `state_dict()` in the tests); `load_params` reads
every `*.safetensors` file of a local directory or of the local HF cache
through utils/safetensors_io, BF16 kept as bf16 (half the host memory of
the reference's float32 arrays, the same values). It reads local files
only and never downloads.

Mixture-of-experts checkpoints come in three layouts, told apart by their
names: Qwen3-MoE (`mlp.gate`, `mlp.experts.{e}.{gate,up,down}_proj`),
Mixtral (`block_sparse_moe.gate`, `experts.{e}.{w1,w3,w2}`) and GPT-OSS
(stacked `mlp.experts.gate_up_proj` with gate and up interleaved on the
last axis, already [in, out], in bf16 or as MXFP4 `*_blocks` / `*_scales`
pairs that `dequant_mxfp4` widens, plus the router and expert biases).
Every expert stack lands as [L, E, in, out].
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import HF_REPOS, ModelConfig
from inferd_tpu_torch.utils import safetensors_io

Params = Dict[str, Any]

# FP4 e2m1 code values (sign in the top bit of the nibble): the MXFP4 table
# of the GPT-OSS checkpoints (transformers' mxfp4 integration)
_FP4_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    dtype=np.float32,
)


def dequant_mxfp4(blocks, scales) -> torch.Tensor:
    """Dequantize MXFP4 expert weights (GPT-OSS checkpoint storage).

    blocks [*prefix, rows, G, B] uint8, two FP4 codes per byte (low nibble
    first); scales [*prefix, rows, G] uint8, E8M0 shared exponents (value
    = fp4 * 2**(scale - 127)). Returns float32 [*prefix, G*B*2, rows] on
    the CPU: dequantized along the packed axis, then the last two axes
    swapped (transformers' convert_moe_packed_tensors), the [E, in, out]
    orientation the params store. The reference's numpy steps, one for
    one: numpy's float32 exp2 is not exact everywhere (2**127 comes out
    one ulp high), and the scales must be its bits."""
    blocks = np.asarray(blocks).astype(np.uint8)
    exp = np.asarray(scales).astype(np.int32) - 127
    out = np.empty(blocks.shape[:-1] + (blocks.shape[-1] * 2,), np.float32)
    out[..., 0::2] = _FP4_VALUES[blocks & 0x0F]
    out[..., 1::2] = _FP4_VALUES[blocks >> 4]
    out *= np.exp2(exp.astype(np.float32))[..., None]
    *prefix, rows, g, b2 = out.shape
    return torch.from_numpy(np.swapaxes(out.reshape(*prefix, rows, g * b2), -1, -2))


def params_from_hf_state_dict(cfg: ModelConfig, sd: Mapping[str, torch.Tensor],
                              device=None) -> Params:
    """Map HF parameter names (Qwen3, Qwen2, Llama; the sandwich norms,
    output bias and sinks of the other families; the three MoE layouts)
    to the stacked params on `device` (default: the CPU)."""
    dt = cfg.torch_dtype
    n_layers = cfg.num_layers

    def get_host(name: str) -> torch.Tensor:
        return sd[name if name in sd else f"model.{name}"].detach().cpu()

    def placed(host: torch.Tensor, transpose: bool) -> torch.Tensor:
        # one move, then [out, in] -> [in, out] where the tensor now lies
        # (on the card a transpose is a fraction of a host copy's time)
        t = host.to(device=device, dtype=dt)
        return t.transpose(-1, -2).contiguous() if transpose else t.contiguous()

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        return placed(get_host(name), transpose)

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        # stack on the host, one move per parameter (not one per layer)
        return placed(torch.stack([get_host(fmt.format(i=i)) for i in range(n_layers)]),
                      transpose)

    layers: Params = {
        "input_norm": stack("layers.{i}.input_layernorm.weight"),
        "q_proj": stack("layers.{i}.self_attn.q_proj.weight", transpose=True),
        "k_proj": stack("layers.{i}.self_attn.k_proj.weight", transpose=True),
        "v_proj": stack("layers.{i}.self_attn.v_proj.weight", transpose=True),
        "o_proj": stack("layers.{i}.self_attn.o_proj.weight", transpose=True),
        "post_norm": stack("layers.{i}.post_attention_layernorm.weight"),
    }
    if cfg.sandwich_norm:  # Gemma-2's extra MLP norms
        layers["pre_ffn_norm"] = stack("layers.{i}.pre_feedforward_layernorm.weight")
        layers["post_ffn_norm"] = stack("layers.{i}.post_feedforward_layernorm.weight")
    if cfg.qk_norm:  # Qwen3
        layers["q_norm"] = stack("layers.{i}.self_attn.q_norm.weight")
        layers["k_norm"] = stack("layers.{i}.self_attn.k_norm.weight")
    if cfg.attn_bias:  # Qwen2, GPT-OSS
        layers["q_bias"] = stack("layers.{i}.self_attn.q_proj.bias")
        layers["k_bias"] = stack("layers.{i}.self_attn.k_proj.bias")
        layers["v_bias"] = stack("layers.{i}.self_attn.v_proj.bias")
    if cfg.o_bias:  # GPT-OSS
        layers["o_bias"] = stack("layers.{i}.self_attn.o_proj.bias")
    if cfg.attn_sinks:  # GPT-OSS per-head sink logits
        layers["sinks"] = stack("layers.{i}.self_attn.sinks")
    gptoss_bf16 = any(k.endswith("layers.0.mlp.experts.gate_up_proj") for k in sd)
    gptoss_mxfp4 = any(k.endswith("layers.0.mlp.experts.gate_up_proj_blocks") for k in sd)
    if cfg.is_moe and (gptoss_bf16 or gptoss_mxfp4):
        # GPT-OSS: stacked experts, [in, out] already; gate_up_proj [E, H, 2D]
        # interleaves gate ([..., ::2]) and up ([..., 1::2])
        layers["router"] = stack("layers.{i}.mlp.router.weight", transpose=True)
        if cfg.router_bias:
            layers["router_bias"] = stack("layers.{i}.mlp.router.bias")

        def expert_tensor(i: int, name: str) -> torch.Tensor:
            if gptoss_mxfp4:
                return dequant_mxfp4(get_host(f"layers.{i}.mlp.experts.{name}_blocks"),
                                     get_host(f"layers.{i}.mlp.experts.{name}_scales"))
            return get_host(f"layers.{i}.mlp.experts.{name}")

        # per layer: dequantize, de-interleave and cast BEFORE stacking, so
        # a float32 intermediate exists for one layer at a time
        gates, ups, downs = [], [], []
        for i in range(n_layers):
            gu = expert_tensor(i, "gate_up_proj")
            gates.append(gu[..., ::2].to(dt))
            ups.append(gu[..., 1::2].to(dt))
            del gu
            downs.append(expert_tensor(i, "down_proj").to(dt))
        layers["gate_proj"] = placed(torch.stack(gates), False)
        layers["up_proj"] = placed(torch.stack(ups), False)
        layers["down_proj"] = placed(torch.stack(downs), False)
        del gates, ups, downs
        if cfg.moe_bias:
            gub = torch.stack([get_host(f"layers.{i}.mlp.experts.gate_up_proj_bias")
                               for i in range(n_layers)])  # [L, E, 2D]
            layers["gate_bias"] = placed(gub[..., ::2], False)
            layers["up_bias"] = placed(gub[..., 1::2], False)
            layers["down_bias"] = stack("layers.{i}.mlp.experts.down_proj_bias")
    elif cfg.is_moe:
        # Qwen3-MoE: mlp.gate + mlp.experts.{e}.{gate,up,down}_proj; Mixtral:
        # block_sparse_moe.gate + experts.{e}.{w1,w3,w2} (w1 gate, w3 up,
        # w2 down; the same routing)
        mixtral = any(k.endswith("layers.0.block_sparse_moe.gate.weight") for k in sd)
        prefix = "block_sparse_moe" if mixtral else "mlp"
        names = ({"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"} if mixtral
                 else {p: p for p in ("gate_proj", "up_proj", "down_proj")})
        layers["router"] = stack("layers.{i}." + prefix + ".gate.weight", transpose=True)
        e = cfg.num_experts
        for key, proj in names.items():
            per = [get_host(f"layers.{i}.{prefix}.experts.{x}.{proj}.weight")
                   for i in range(n_layers) for x in range(e)]
            stacked = torch.stack(per).reshape(n_layers, e, *per[0].shape)
            del per
            layers[key] = placed(stacked, True)
            del stacked
    else:
        layers["gate_proj"] = stack("layers.{i}.mlp.gate_proj.weight", transpose=True)
        layers["up_proj"] = stack("layers.{i}.mlp.up_proj.weight", transpose=True)
        layers["down_proj"] = stack("layers.{i}.mlp.down_proj.weight", transpose=True)

    params: Params = {
        "embed": get("embed_tokens.weight"),
        # in name order, as the reference's pytree functions leave its
        # layers, so a stage file split from these params is its bytes
        "layers": dict(sorted(layers.items())),
        "final_norm": get("norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight", transpose=True)
    return params


# ---------------------------------------------------------------------------
# safetensors loading (local dir or HF cache)
# ---------------------------------------------------------------------------


def _repo_dir(model: str) -> str:
    """The cache directory of `model`'s repo (a preset name mapped by
    HF_REPOS, or a repo id) in the HF cache ($HF_HOME, else
    ~/.cache/huggingface)."""
    repo = HF_REPOS.get(model.lower(), model)
    cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    return os.path.join(cache, "hub", "models--" + repo.replace("/", "--"))


def searched(model: str) -> str:
    """Where _find_checkpoint_dir looks for `model`, for an error message."""
    return f"{model!r} is not a directory, and {os.path.join(_repo_dir(model), 'snapshots')} " \
           "holds no snapshot with *.safetensors"


def _find_checkpoint_dir(model: str) -> Optional[str]:
    """Resolve a local dir containing *.safetensors for `model`.

    `model` may be a path, a preset name (mapped via HF_REPOS), or an HF
    repo id; the HF cache is searched without network access.
    """
    if os.path.isdir(model):
        return model
    base = _repo_dir(model)
    hub = os.path.join(base, "snapshots")
    if not os.path.isdir(hub):
        return None
    # Resolve refs/main (the snapshot huggingface_hub considers current);
    # fall back to newest-mtime snapshot containing safetensors.
    candidates = []
    ref = os.path.join(base, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            candidates.append(os.path.join(hub, f.read().strip()))
    candidates += sorted(
        (os.path.join(hub, s) for s in os.listdir(hub)),
        key=os.path.getmtime,
        reverse=True,
    )
    for d in candidates:
        if os.path.isdir(d) and any(f.endswith(".safetensors") for f in os.listdir(d)):
            return d
    return None


def load_params(cfg: ModelConfig, model_path: Optional[str] = None, device="cuda") -> Params:
    """Load real weights from safetensors (local path or HF cache) onto
    `device` (the card unless the caller asks for the CPU).

    Raises FileNotFoundError when no checkpoint is available locally; the
    caller decides what that means (the CLIs stop: no random weights in
    its place).
    """
    d = _find_checkpoint_dir(model_path or cfg.name)
    if d is None:
        raise FileNotFoundError(
            f"no local safetensors checkpoint for {model_path or cfg.name!r}"
        )
    sd: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".safetensors"):
            continue
        with safetensors_io.SafeOpen(os.path.join(d, fname)) as f:
            for k in f.keys():
                sd[k] = f.get_torch(k)
    return params_from_hf_state_dict(cfg, sd, device=device)
