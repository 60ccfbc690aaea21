"""Per-session KV cache (port of inferd_tpu/core/cache.py, uniform layout).

Layout: k/v are [num_layers, batch, max_len, num_kv_heads, head_dim];
`length` is the number of populated positions, a host-side int.

The JAX cache is functional and its jitted steps donate the buffers so the
update happens in place on the device. Here the buffers are simply written
IN PLACE (models/qwen3.decoder_layer slices into them), and `grow` copies
into a larger allocation. Overflow is checked on the host before dispatch
(`ensure_room`).

Ring buffers for sliding-window layers, lane slicing and the paged block
pool wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from inferd_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, T, Nkv, D]
    v: torch.Tensor  # [L, B, T, Nkv, D]
    length: int = 0  # populated positions

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2

    @staticmethod
    def create(
        cfg: ModelConfig,
        num_layers: int,
        batch: int,
        max_len: int,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> "KVCache":
        """Zeroed buffers; the dtype defaults to the config's KV dtype."""
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: ring KV storage for sliding windows is not ported yet"
            )
        dt = dtype or cfg.kv_torch_dtype
        shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            length=0,
        )

    def ensure_room(self, new_tokens: int, owner: Optional[str] = None) -> None:
        """Host-side overflow guard: call before writing `new_tokens`."""
        if self.length + new_tokens > self.max_len:
            who = f" ({owner})" if owner else ""
            raise BufferError(
                f"KV cache overflow{who}: {self.length} used + {new_tokens} new > "
                f"{self.max_len}"
            )


def grow(cache: KVCache, new_max_len: int) -> KVCache:
    """Reallocate to a larger bucket, copying the populated slots (the
    whole old buffer, as the JAX pad does)."""
    if new_max_len <= cache.max_len:
        return cache
    l, b, t, n, d = cache.k.shape
    k = cache.k.new_zeros((l, b, new_max_len, n, d))
    v = cache.v.new_zeros((l, b, new_max_len, n, d))
    k[:, :, :t] = cache.k
    v[:, :, :t] = cache.v
    return KVCache(k=k, v=v, length=cache.length)
