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

Dense decoders only in this slice: the MoE branches (Qwen3-MoE, Mixtral,
GPT-OSS experts and their MXFP4 storage) raise NotImplementedError naming
ROADMAP A5c.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from inferd_tpu_torch.config import HF_REPOS, ModelConfig
from inferd_tpu_torch.utils import safetensors_io

Params = Dict[str, Any]
_MOE = "MoE checkpoints are not ported yet: ROADMAP A5c"


def dequant_mxfp4(blocks, scales):
    """MXFP4 expert weights (GPT-OSS's storage): waits for the MoE slice."""
    raise NotImplementedError(f"MXFP4 dequantization: {_MOE}")


def params_from_hf_state_dict(cfg: ModelConfig, sd: Mapping[str, torch.Tensor],
                              device=None) -> Params:
    """Map HF dense-decoder parameter names (Qwen3, Qwen2, Llama; the
    sandwich norms, output bias and sinks of the other families) to the
    stacked params on `device` (default: the CPU)."""
    dt = cfg.torch_dtype
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: {_MOE}")

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
        return placed(torch.stack([get_host(fmt.format(i=i)) for i in range(cfg.num_layers)]),
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
