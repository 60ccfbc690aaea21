"""Single-process generation engine: prefill and decode over one KV cache,
with the sampler on the device (port of inferd_tpu/core/generate.py).

As in the JAX package:

  * prompts pad to power-of-two buckets (`bucket_len`), so the stage
    executors and the engine write the same KV slots;
  * a decode step samples on the device, so the host loop reads one int
    per token; `chunk` > 1 fuses power-of-two windows of steps
    (models/qwen3.decode_k) with one read per window;
  * `generate_scan` runs a fixed number of steps with a done mask and
    reads nothing until the end (the benchmark path);
  * `pin_prefix` keeps a prompt prefix's KV snapshot (LRU-capped at
    `max_pins`) that later prompts starting with it reuse.

What differs, by PyTorch idiom: the cache is written in place, so a pinned
snapshot is deep-copied into every session that reuses it (no storage is
shared with a live cache); the prefill unembeds only the last real row (the
JAX engine unembeds the whole bucket; the results are the same); the steps
are Python loops. The engine runs on its parameters' device and never
moves to another. Sampled tokens follow core.sampling's key (not JAX's
threefry), identical across chunk sizes, generate_scan and the host loop.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig, SamplingConfig
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.core.cache import KVCache, device_to_host, grow, host_to_device
from inferd_tpu_torch.models import qwen3


def bucket_len(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two multiple of `minimum` that is >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


class Engine:
    """Owns one model's params and runs generation on their device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_len: int = 2048,
        sampling_cfg: Optional[SamplingConfig] = None,
        max_pins: int = 4,
    ):
        qwen3.check_supported(cfg)
        if max_pins < 1:
            raise ValueError(f"max_pins must be >= 1, got {max_pins}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_len = max_len
        self.sampling = sampling_cfg or SamplingConfig()
        # pinned prompt prefix -> (KV snapshot, last logits [1, V]); LRU-capped
        # at max_pins because each pin holds a whole KV snapshot
        self._pins: "OrderedDict[Tuple[int, ...], Tuple[KVCache, torch.Tensor]]" = OrderedDict()
        self.max_pins = max_pins

    @property
    def pins_resident(self) -> int:
        """Pinned prefix snapshots currently held."""
        return len(self._pins)

    def new_cache(self, batch: int, max_len: Optional[int] = None) -> KVCache:
        return KVCache.create(self.cfg, self.cfg.num_layers, batch, max_len or self.max_len,
                              device=self.device)

    # -- steps ---------------------------------------------------------------

    def _tokens(self, rows) -> torch.Tensor:
        return host_to_device(np.asarray(rows, dtype=np.int64), self.device)

    def _forward(self, tokens: torch.Tensor, start: int, cache: KVCache,
                 real_len: int) -> torch.Tensor:
        """Write `tokens` [B, S] into the cache from slot `start` (= their
        first position) and return the float32 logits of row real_len - 1
        only, [B, V]."""
        hidden = qwen3.embed(self.params, tokens, self.cfg)
        hidden, _ = qwen3.forward_layers_cached(
            self.params["layers"], self.cfg, hidden, start, cache, start,
            real_end=start + real_len,
        )
        return qwen3.unembed(self.params, self.cfg, hidden[:, real_len - 1:real_len])[:, 0]

    def _sample(self, logits: torch.Tensor, sub) -> torch.Tensor:
        s = self.sampling
        return samplib.sample(logits, sub, s.temperature, s.top_k, s.top_p, s.min_p)

    @torch.no_grad()
    def prefill(self, prompt_ids: Sequence[int], cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Pad to a bucket and prefill from slot 0; returns (last-token
        logits [1, V], cache)."""
        n = len(prompt_ids)
        cache.ensure_room(n)
        b = min(bucket_len(n), cache.max_len)
        logits = self._forward(self._tokens([list(prompt_ids) + [0] * (b - n)]), 0, cache, n)
        cache.length = n
        return logits, cache

    @torch.no_grad()
    def prefill_at(self, ids: Sequence[int], cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Prefill `ids` at the cache's frontier (the positions before it
        are already cached: a pinned prefix); returns (logits, cache)."""
        n = len(ids)
        cache.ensure_room(n)
        b = min(bucket_len(n), cache.max_len - cache.length)
        logits = self._forward(self._tokens([list(ids) + [0] * (b - n)]), cache.length, cache,
                               n)
        cache.length += n
        return logits, cache

    @torch.no_grad()
    def decode(self, tok: torch.Tensor, cache: KVCache, sub, top_n: Optional[int] = None):
        """One decode step from tokens [B] on the device: (next [B], cache),
        and with `top_n` not None also (lp [B], top ids, top lps) of the
        emitted token under the raw logits (core.sampling.logprob_topn)."""
        cache.ensure_room(1)
        logits = self._forward(tok[:, None], cache.length, cache, 1)
        cache.length += 1
        nxt = self._sample(logits, sub)
        if top_n is None:
            return nxt, cache
        return (nxt, cache, *samplib.logprob_topn(logits, nxt, top_n))

    @torch.no_grad()
    def decode_chunk(self, tok: torch.Tensor, cache: KVCache, key, s: int, top_n: int = 0,
                     want_lp: bool = False):
        """`s` fused decode steps of one row (models/qwen3.decode_k), the key
        chained as the host loop chains it, so the tokens equal `s` decode
        calls. Returns (seq [s, 1], cache, key', lps [s, 1], top ids
        [s, 1, n], top lps [s, 1, n]), all on the device but key'."""
        if cache.batch != 1:
            raise ValueError(f"decode_chunk decodes one row, the cache has {cache.batch}")
        c = self.sampling
        cache, seq, _n, keys, lps, tis, tls = qwen3.decode_k(
            self.params, self.cfg, tok, cache, [cache.length], [True],
            np.asarray(key, np.uint32)[None], s, temperature=c.temperature, top_k=c.top_k,
            top_p=c.top_p, min_p=c.min_p, top_n=top_n, want_lp=want_lp,
        )
        cache.length += s
        if c.temperature == 0.0:  # decode_k splits no key when greedy; the host loop does
            keys = np.asarray(key, np.uint32)[None]
            for _ in range(s):
                keys = samplib.split_keys(keys)[0]
        return seq, cache, keys[0], lps, tis, tls

    # -- prefix caching --------------------------------------------------------

    def pin_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Prefill `prefix_ids` once and keep the KV snapshot; later prompts
        that start with these ids copy it instead of recomputing the prefix.
        LRU-capped at `max_pins`."""
        ids = prefixlib.normalize_ids(prefix_ids)
        if ids in self._pins:
            self._pins.move_to_end(ids)
            return
        logits, cache = self.prefill(list(ids), self.new_cache(1, bucket_len(len(ids))))
        self._pins[ids] = (cache, logits)
        while len(self._pins) > self.max_pins:
            self._pins.popitem(last=False)

    def unpin_prefix(self, prefix_ids: Sequence[int]) -> None:
        self._pins.pop(tuple(int(t) for t in prefix_ids), None)

    def _cache_from_pin(self, pinned: KVCache) -> KVCache:
        """A session cache seeded from a pinned snapshot, sharing no storage
        with it: the session's steps write their cache in place."""
        target = max(self.max_len, pinned.max_len)
        if pinned.max_len < target:
            return grow(pinned, target)  # fresh buffers, the snapshot copied in
        return KVCache(k=pinned.k.clone(), v=pinned.v.clone(), length=pinned.length)

    # -- generation ----------------------------------------------------------

    def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        logprob_sink: Optional[List[float]] = None,
        top_n: int = 0,
        top_sink: Optional[List[Tuple[List[int], List[float]]]] = None,
        chunk: int = 1,
    ) -> List[int]:
        """Host-loop generation with an EOS stop; returns the new ids.

        `logprob_sink` (cleared) collects each emitted token's model
        log-probability (log-softmax of the raw logits); `top_sink` with
        `top_n` > 0 the top-N (ids, logprobs) per step. Tokens are the same
        with or without the sinks. `chunk` > 1 fuses up to that many steps
        per window (power-of-two sizes, at most the room left), with one
        host read per window; tokens equal chunk=1's, and an EOS inside a
        window discards its tail."""
        if len(prompt_ids) == 0:
            raise ValueError("prompt_ids must be non-empty")
        steps = self.sampling.max_new_tokens if max_new_tokens is None else max_new_tokens
        if steps <= 0:
            return []
        with torch.no_grad():
            return self._generate(list(prompt_ids), steps, eos_token_id, seed, logprob_sink,
                                  top_n, top_sink, chunk)

    def _generate(self, prompt_ids, steps, eos_token_id, seed, logprob_sink, top_n, top_sink,
                  chunk) -> List[int]:
        pin = prefixlib.longest_prefix_match(self._pins, prompt_ids)
        if pin is not None:
            pcache, plogits = self._pins[pin]
            self._pins.move_to_end(pin)
            cache = self._cache_from_pin(pcache)
            rest = prompt_ids[len(pin):]
            logits = self.prefill_at(rest, cache)[0] if rest else plogits
        else:
            logits, cache = self.prefill(prompt_ids, self.new_cache(1))
        want_lp = logprob_sink is not None or top_sink is not None
        if logprob_sink is not None:
            logprob_sink.clear()
        if top_sink is not None:
            top_sink.clear()

        def append(lp, ti, tl):  # host values of one emitted token
            if logprob_sink is not None:
                logprob_sink.append(float(lp))
            if top_sink is not None:
                top_sink.append((np.asarray(ti).tolist(), np.asarray(tl).tolist()))

        def append_dev(lp, ti, tl):
            append(*device_to_host(lp[0], ti[0], tl[0]))

        key, sub = samplib.split_key(samplib.prng_key(seed))
        tok = self._sample(logits, sub)
        if want_lp:
            append_dev(*samplib.logprob_topn(logits, tok, top_n))
        out = [int(tok[0])]
        if eos_token_id is not None and out[-1] == eos_token_id:
            return out
        while len(out) < steps:
            room = self.max_len - cache.length
            s = min(chunk, steps - len(out), max(room, 1))
            if s > 1:
                s = 1 << (s.bit_length() - 1)  # power of two: few window sizes
            if s > 1:
                seq, cache, key, lps, tis, tls = self.decode_chunk(tok, cache, key, s, top_n,
                                                                   want_lp)
                host = device_to_host(seq, lps, tis, tls) if want_lp else device_to_host(seq)
                for j in range(s):
                    t = int(host[0][j, 0])
                    out.append(t)
                    if want_lp:
                        append(host[1][j, 0], host[2][j, 0], host[3][j, 0])
                    if (eos_token_id is not None and t == eos_token_id) or len(out) >= steps:
                        return out
                tok = seq[-1]
                continue
            key, sub = samplib.split_key(key)
            if want_lp:
                tok, cache, lp, ti, tl = self.decode(tok, cache, sub, top_n)
                append_dev(lp, ti, tl)
            else:
                tok, cache = self.decode(tok, cache, sub)
            out.append(int(tok[0]))
            if eos_token_id is not None and out[-1] == eos_token_id:
                break
        return out

    @torch.no_grad()
    def generate_scan(
        self,
        prompt_tokens,  # [B, S] already padded (a bucket), host or device
        prompt_len: int,
        steps: int,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
    ) -> torch.Tensor:
        """Fixed-length generation with nothing read back until the end:
        `steps` tokens per row ([B, steps] on the device). After EOS a row
        keeps re-emitting it, marked done on the device. The key schedule is
        the host loop's, so the tokens equal `generate`'s for one row."""
        toks = torch.as_tensor(prompt_tokens)
        toks = (toks.to(self.device, torch.int64) if toks.device.type != "cpu"
                else host_to_device(toks.to(torch.int64), self.device))
        b, s = toks.shape
        cache = self.new_cache(b, bucket_len(s + steps))
        key, subs = samplib.prng_key(seed), []
        for _ in range(steps):
            key, sub = samplib.split_key(key)
            subs.append(sub)
        logits = self._forward(toks, 0, cache, prompt_len)
        cache.length = prompt_len
        eos = -1 if eos_token_id is None else int(eos_token_id)
        tok = self._sample(logits, subs[0])
        done = tok == eos
        out = [tok]
        for sub in subs[1:]:
            ntok, cache = self.decode(tok, cache, sub)
            tok = torch.where(done, tok, ntok)
            done = done | (tok == eos)
            out.append(tok)
        return torch.stack(out, dim=1)


def generate_text(
    engine: Engine,
    tokenizer,
    prompt: str,
    max_new_tokens: int = 64,
    seed: int = 0,
    chat: bool = True,
) -> str:
    """Text in, text out, through the tokenizer's chat template."""
    if chat:
        ids = tokenizer.apply_chat_template(
            [{"role": "user", "content": prompt}], add_generation_prompt=True)
    else:
        ids = tokenizer.encode(prompt)
    out = engine.generate(ids, max_new_tokens, eos_token_id=tokenizer.eos_token_id, seed=seed)
    return tokenizer.decode(out)
