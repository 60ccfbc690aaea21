"""Parameter conversion between the JAX package's pytrees and the port.

The JAX package keeps params as a nested dict of arrays in the same layout
the port uses (stacked layers, [in, out] weights), so conversion is leaf by
leaf. numpy has no bfloat16 without ml_dtypes, which the port does not
import: a bf16 leaf (dtype name "bfloat16") crosses as its raw 16-bit
pattern through a uint16 view, which keeps it bit-exact.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.ops import quant


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy-like array (bf16 included) -> torch tensor, bit-exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype: Optional[np.dtype] = None) -> np.ndarray:
    """torch tensor -> numpy. bf16 comes back as its uint16 bit pattern,
    viewed as `bf16_dtype` when the caller has a numpy bf16 dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def _quant_class(leaf: Any):
    """The port's quantized-weight class for a leaf with `q` and `scale`
    fields (Int4Weight when it also has `packed`), else None."""
    if not (hasattr(leaf, "q") and hasattr(leaf, "scale")):
        return None
    return quant.Int4Weight if hasattr(leaf, "packed") else quant.QuantWeight


def _map_quant(leaf: Any, cls, fn) -> Any:
    extra = {"packed": bool(leaf.packed)} if cls is quant.Int4Weight else {}
    return cls(q=fn(leaf.q), scale=fn(leaf.scale), **extra)


def params_from_numpy(tree: Any, cfg: Optional[ModelConfig] = None, device=None) -> Any:
    """The JAX package's param pytree (numpy leaves) -> the port's params
    (same nesting, torch leaves on `device`; quantized weights become the
    port's ops.quant classes). `cfg`, when given, is checked against the
    embedding shape."""
    if isinstance(tree, dict):
        out = {k: params_from_numpy(v, None, device) for k, v in tree.items()}
        if cfg is not None and "embed" in out:
            want = (cfg.vocab_size, cfg.hidden_size)
            if tuple(out["embed"].shape) != want:
                raise ValueError(f"embed shape {tuple(out['embed'].shape)} != {want} for {cfg.name}")
        return out
    cls = _quant_class(tree)
    if cls is not None:
        return _map_quant(tree, cls, lambda a: tensor_from_numpy(a, device))
    return tensor_from_numpy(tree, device)


def params_to_numpy(params: Any, bf16_dtype: Optional[np.dtype] = None) -> Any:
    """Inverse of params_from_numpy: torch leaves -> numpy leaves."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in params.items()}
    cls = _quant_class(params)
    if cls is not None:
        return _map_quant(params, cls, lambda t: tensor_to_numpy(t, bf16_dtype))
    return tensor_to_numpy(params, bf16_dtype)
