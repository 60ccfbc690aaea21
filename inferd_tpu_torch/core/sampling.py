"""Token sampling: temperature, top-k, top-p and min-p on the device (port
of inferd_tpu/core/sampling.py).

The same filters as the JAX package, as plain functions on tensors, with
its fast paths: temperature 0 is an argmax; with top-k active the nucleus
and min-p filters and the draw run over the k sorted candidates only
(`torch.topk`), never over the whole vocabulary; temperature-only configs
build no filter op at all.

The draw is a Gumbel-max over the candidates `jax.random.categorical`
would draw from: argmax(filtered - log(-log(u))). `sample_from_uniforms`
takes the uniforms `u` from the caller; `sample` draws them from a key.

Port decision, the key: JAX's threefry streams cannot be reproduced in
PyTorch, so sampled tokens differ from the JAX package's (and between the
CPU and the card, whose generators differ). The key keeps the wire's shape,
a [2] uint32 pair (`prng_key(seed)` is [0, seed mod 2**32], as
`jax.random.PRNGKey` makes it without 64-bit mode), and is split on the
HOST by `split_key`, a splitmix64 mix of the pair. A split depends on no token, so the K subkeys
of a fused window are known before its first launch, with no device sync.
`uniforms(sub, shape, device)` seeds a `torch.Generator` on the device with
the sub's 64 bits (never the global generator). Within the port, the same
starting key gives the same tokens whether the steps run one at a time,
fused K at a time, or as one fixed-length loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.ops.attention import NEG_INF

_M64 = (1 << 64) - 1


def prng_key(seed: int) -> np.ndarray:
    """The root key of `seed`: uint32 [2], [0, seed mod 2**32], as
    jax.random.PRNGKey lays it out (without 64-bit mode)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def _mix64(z: int) -> int:
    """splitmix64's output function (Steele, Lea and Flood, 2014)."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _as_pair(x: int) -> np.ndarray:
    return np.array([x >> 32, x & 0xFFFFFFFF], dtype=np.uint32)


def key_bits(key) -> int:
    """The 64 bits of a [2] uint32 key as one int."""
    k = np.asarray(key, dtype=np.uint64).reshape(2)
    return (int(k[0]) << 32) | int(k[1])


def split_key(key) -> Tuple[np.ndarray, np.ndarray]:
    """(key', sub) from a [2] uint32 key, on the host: two splitmix64 mixes
    of its 64 bits under different constants. Chained as `key, sub =
    split_key(key)` once per step, exactly where the JAX package splits."""
    x = key_bits(key)
    return _as_pair(_mix64(x ^ 0x243F6A8885A308D3)), _as_pair(_mix64(x ^ 0x13198A2E03707344))


def split_keys(keys) -> Tuple[np.ndarray, np.ndarray]:
    """split_key over the rows of [B, 2] keys -> (keys' [B, 2], subs [B, 2])."""
    pairs = [split_key(k) for k in np.asarray(keys, dtype=np.uint32).reshape(-1, 2)]
    return (np.stack([p[0] for p in pairs]).reshape(-1, 2),
            np.stack([p[1] for p in pairs]).reshape(-1, 2))


def uniforms(sub, shape, device) -> torch.Tensor:
    """float32 uniforms in [tiny, 1) of `shape` on `device`, from a
    generator on that device seeded with the sub's 64 bits (the floor keeps
    -log(-log(u)) finite, as jax.random.gumbel's minval does)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key_bits(sub))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row, others -> NEG_INF. k <= 0 disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches p (the token that crosses it is kept). p >= 1
    disables."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p  # the mass BEFORE a sorted position is < p
    thresh = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def min_p_filter(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """min-p filtering in its denominator-free logit form: keep iff
    l >= l_max + ln(min_p), so it composes exactly on a top-k candidate row.
    min_p <= 0 disables; min_p >= 1 would mask every token and is refused."""
    if min_p <= 0.0:
        return logits
    if min_p >= 1.0:
        raise ValueError(f"min_p must be in [0, 1), got {min_p}")
    lmax = logits.amax(dim=-1, keepdim=True)
    return torch.where(logits < lmax + math.log(min_p), NEG_INF, logits)


def passthrough_filters(top_k: int, top_p: float, min_p: float, vocab: int) -> bool:
    """True when the filter chain is the identity (greedy or temperature-only
    configs): the samplers then build no filter op over the vocabulary."""
    return (top_k <= 0 or top_k >= vocab) and top_p >= 1.0 and min_p <= 0.0


def candidate_count(vocab: int, top_k: int) -> int:
    """How many candidates a draw runs over: k with top-k active, else V."""
    return top_k if 0 < top_k < vocab else vocab


def _candidates(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
                min_p: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(filtered candidate logits, their vocab ids or None for the whole
    row) at temperature > 0."""
    logits = logits / temperature
    if passthrough_filters(top_k, top_p, min_p, logits.shape[-1]):
        return logits, None
    if 0 < top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)  # sorted descending
        return min_p_filter(top_p_filter(vals, top_p), min_p), idx
    return min_p_filter(top_p_filter(logits, top_p), min_p), None


def warped_logits(
    logits: torch.Tensor, temperature: float, top_k: int, top_p: float, min_p: float = 0.0,
) -> torch.Tensor:
    """The fully warped logits whose softmax is the distribution `sample`
    draws from. Temperature 0 is the greedy point mass: NEG_INF everywhere
    but the argmax (ties to the first index). With top-k active the k
    filtered candidates are scattered back into a NEG_INF row."""
    if temperature == 0.0:
        best = torch.argmax(logits, dim=-1, keepdim=True)
        return torch.full_like(logits, NEG_INF).scatter(-1, best, 0.0)
    cand, idx = _candidates(logits, temperature, top_k, top_p, min_p)
    if idx is None:
        return cand
    return torch.full_like(logits, NEG_INF).scatter(-1, idx, cand)


def sample_from_uniforms(
    logits: torch.Tensor,  # [B, V] float32
    u: torch.Tensor,  # [B, candidate_count(V, top_k)] float32 in (0, 1)
    temperature: float = 0.6,
    top_k: int = 20,
    top_p: float = 0.95,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Token ids [B] (int64): argmax at temperature 0 (u unused), else the
    Gumbel-max draw argmax(candidates - log(-log(u))) over the filtered
    candidates (the top-k when active, else the whole row)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    cand, idx = _candidates(logits, temperature, top_k, top_p, min_p)
    choice = torch.argmax(cand - torch.log(-torch.log(u)), dim=-1)
    if idx is None:
        return choice
    return idx.gather(-1, choice[:, None])[:, 0]


def sample(
    logits: torch.Tensor,  # [B, V] float32
    key,  # [2] uint32: the step's subkey
    temperature: float = 0.6,
    top_k: int = 20,
    top_p: float = 0.95,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Next token ids [B]: the uniforms for every row drawn from `key`,
    then sample_from_uniforms. Temperature 0 draws nothing."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    n = candidate_count(logits.shape[-1], top_k)
    u = uniforms(key, (logits.shape[0], n), logits.device)
    return sample_from_uniforms(logits, u, temperature, top_k, top_p, min_p)


def sample_cfg(logits: torch.Tensor, key, cfg: Optional[SamplingConfig]) -> torch.Tensor:
    c = cfg or SamplingConfig()
    return sample(logits, key, c.temperature, c.top_k, c.top_p, c.min_p)


def warped_probs(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """softmax(warped_logits): the exact distribution `sample` draws from."""
    return torch.softmax(
        warped_logits(logits, cfg.temperature, cfg.top_k, cfg.top_p, cfg.min_p), dim=-1)


def logprob_topn(logits: torch.Tensor, tok: torch.Tensor, n: int):
    """Model log-probabilities from the RAW logits (log-softmax, the
    serving-API meaning, not the warped distribution): (lp of tok [B] f32,
    top ids [B, n] int32, top lps [B, n] f32, descending), on the device."""
    lf = logits.float()
    lps = lf - torch.logsumexp(lf, dim=-1, keepdim=True)
    lp_tok = lps.gather(-1, tok.long()[:, None])[:, 0]
    b = logits.shape[0]
    if n <= 0:
        return (lp_tok, torch.zeros((b, 0), dtype=torch.int32, device=logits.device),
                torch.zeros((b, 0), dtype=torch.float32, device=logits.device))
    top_lps, top_ids = torch.topk(lps, n, dim=-1)
    return lp_tok, top_ids.to(torch.int32), top_lps
