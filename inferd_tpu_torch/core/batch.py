"""Continuous batching on one device: N session lanes decode in one step
(port of inferd_tpu/core/batch.py).

One decode step of a lone sequence reads every weight for one token; a
step over all lanes reads them once for all of them, so the tokens per
second a card serves grow with the lanes until the step stops being
bound by weight bytes.

As in the JAX package:

  * one KV cache with batch == lanes, each lane one sequence's row (dense),
    or a paged block pool whose chains the lanes map (`block_size` > 0,
    core.cache.BlockPool);
  * prefill is per lane (a batch-1 forward writing that lane's rows), so
    ragged prompt lengths never pad against each other;
  * decode is one step over all lanes (forward, sample, eos mask), with
    inactive lanes computing garbage that is never read;
  * `generate_all` frees a lane on eos or length and refills it from the
    queue (continuous batching), `chunk` > 1 fusing up to that many steps
    per host read. Per-sequence key chains start from `seed + index`, the
    solo core.generate.Engine's schedule.

What differs, by PyTorch idiom: the cache is written in place (the JAX
engine donates it to its jits), so the serving entries return only their
outputs; and on a CUDA device every decode step and `decode_chunk` window
replays a captured CUDA graph (utils/cuda_graph) keyed by (buffer, kv
bound, sampling, inputs), as the Engine's do. Prefill runs eagerly.

The kv bound of a lane step is the buffer's length (`max_len`), not a
bucket of the co-batch's fills: flash_gqa's split plan follows the bound,
so a bound from the fills would make a lane's bits depend on which lanes
share its step, and a fused window (whose lanes finish and refill on its
boundaries) would differ from the same steps one at a time. With the
whole buffer a lane's tokens depend on its own sequence only: `chunk` 8
gives chunk 1's tokens bit for bit, and a whole-model lane node
(runtime/batch_executor, the same step at the same `max_len`) serves the
library loop's tokens. The split-KV CTAs past a lane's frontier write
empty partials.

The serving entries (`_decode_logits`, `_prefill_lane_logits`, their
paged siblings, `_copy_blocks`, `_decode_k_serve`) are what the
whole-model lane executor (runtime/batch_executor) dispatches; `lane_step`
and `lane_prefill` below are their bodies, shared with the pipeline
stage's lane executor (runtime/stage_batch). A paged engine serves only
through them: its library loop raises, as the reference's does.

`fork_lane` seeds a lane with another's first slots (a session fork on the
dense layout, runtime/batch_executor; the paged layout forks through
core.cache.BlockPool.fork_lane). Not ported here: lane-batched speculation
(A7) and sliding-window rings (A5b).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig, SamplingConfig
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.core.cache import (
    BlockPool, KVCache, PagedKVCache, device_to_host, host_staged, host_to_device, lane_slice,
    paged_copy_blocks,
)
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.utils.cuda_graph import GraphCache, graph_stats, run_step

Params = Dict[str, Any]

# graphs a lane engine keeps: its library windows (one per window size and
# sampling config) and, serving, one co-batched step per table width and
# tenant state plus the K-step windows of its requests' sampling configs
LANE_GRAPHS = 64


def lane_step(graphs: Optional[GraphCache], params: Params, cfg: ModelConfig, cache, xs, lens,
              *, first: bool, last: bool, active=None, table=None, ads=None) -> torch.Tensor:
    """One co-batched decode step over EVERY lane (models/qwen3.stage_step)
    of a dense lane slab or, with `table` (a host-staged [L, W] table, the
    chain_clamp width: core.cache.sync_paged), a paged pool: [L, V] logits
    (`last`) or [L, 1, H] hidden on the device, a graph's static output on
    a card (read it before the next step of `graphs`).

    xs: host tokens [L, 1] (`first`) or hidden [L, 1, H]; lens [L]: each
    lane's fill; active [L] (paged): the lanes with an entry; ads: the
    adapter operand with host ids (AdapterBindingMixin._ads(staged=True)).
    Dense: lanes without an entry compute garbage at their own frontier
    slot, which the lane's next real step rewrites before it can be read
    (a full idle lane writes its last slot, which only a replay below it
    can reach, and a replay rewrites it first). Paged: rows of inactive
    lanes write only to the scratch block.

    On a card the step replays the graph keyed by the layout, the table's
    width, the adapter pools' address and whether a tenant lane rides;
    xs, lens, active, the table and the adapter ids are its static inputs,
    each copied once from the host straight into its buffer. The dense
    attention walks the whole lane slab: a bound from the co-batch's fills
    would make a lane's bits depend on which sessions share its step."""
    dev = cache.k.device
    inputs = {"x": host_staged(xs, dev), "lens": host_staged(lens, dev)}
    pools = None
    if ads is not None:
        pools = {k: v for k, v in ads.items() if k != "ids"}
        inputs["ids"] = ads["ids"]
    if table is not None:
        inputs["table"] = table
        inputs["active"] = host_staged(active, dev)
        key = ("paged", int(table.shape[1]))
    else:
        key = ("dense",)
    key += (None if pools is None else pools["scale"].data_ptr(), ads is not None)
    max_len = cache.max_len

    def step(x, lens, table=None, active=None, ids=None):
        adapters = None if ids is None else {**pools, "ids": ids}
        if table is None:  # dense: an idle full lane writes its last slot
            lens = lens.clamp(max=max_len - 1)
        return qwen3.stage_step(params, cfg, x, cache.k, cache.v, lens, first=first, last=last,
                                table=table, write_mask=active, adapters=adapters)

    return run_step(graphs, key, step, inputs, dev)


def lane_prefill(params: Params, cfg: ModelConfig, cache, xd: torch.Tensor, lane: int,
                 start: int, n: int, *, first: bool, last: bool, table_row=None,
                 layer_offset: int = 0, ads=None) -> torch.Tensor:
    """Chunk-ingest ONE lane, eagerly: xd [1, S_bucket] tokens (`first`) or
    [1, S_bucket, H] hidden on the device, at absolute `start`, of which
    the first n rows are real. Dense: the lane's view of the slab; paged:
    `table_row`, the lane's own [1, W] table as wide as this chunk can
    reach. Returns [1, V] logits of the last real row (`last`), or the
    [1, S_bucket, H] hidden."""
    hidden = qwen3.embed(params, xd, cfg) if first else xd
    if table_row is not None:
        lc = PagedKVCache(k=cache.k, v=cache.v, table=host_to_device(table_row, cache.k.device))
    else:
        lc = lane_slice(cache, lane)  # a view: the writes land in the slab
    hidden, _ = qwen3.forward_layers_cached(
        params["layers"], cfg, hidden, start, lc, start, real_end=start + n,
        layer_offset=layer_offset, adapters=ads,
    )
    if last:
        return qwen3.unembed(params, cfg, hidden[:, n - 1:n])[:, 0]
    return hidden


class BatchedEngine:
    """N-lane continuous-batching engine on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        lanes: int = 8,
        max_len: int = 2048,
        sampling_cfg: Optional[SamplingConfig] = None,
        block_size: int = 0,
        kv_blocks: int = 0,
        device=None,
    ):
        qwen3.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        want = self.device if device is None else torch.device(device)
        if want.type != self.device.type or want.index not in (None, self.device.index):
            raise ValueError(f"BatchedEngine on {want}: the params are on {self.device}")
        self.lanes = lanes
        self.max_len = max_len
        self.sampling = sampling_cfg or SamplingConfig()
        # paged KV (block_size > 0): lanes map to refcounted block chains of
        # one pool; the serving entries grow paged siblings, the library loop
        # stays dense (runtime/batch_executor is the paged consumer)
        self.pool: Optional[BlockPool] = None
        if block_size > 0:
            self.pool = BlockPool(cfg, cfg.num_layers, lanes, max_len, block_size=block_size,
                                  num_blocks=kv_blocks or None, device=self.device)
            self.cache = self.pool.cache
        else:
            self.cache = KVCache.create(cfg, cfg.num_layers, lanes, max_len, device=self.device)
        # host mirrors (a device read per step would stall the pipeline)
        self.lengths = [0] * lanes
        self.free: List[int] = list(range(lanes))
        # decode steps and windows as graph replays on a card, eager on the
        # CPU; set to None for the eager steps on a card (the reference the
        # graphs are held to)
        self.graphs: Optional[GraphCache] = (
            GraphCache(max_graphs=LANE_GRAPHS, device=self.device)
            if self.device.type == "cuda" else None)
        # serving-path K-step windows: the shared factory holds the definition
        self._decode_k_serve = qwen3.make_decode_k_serve(cfg)

    def graph_stats(self) -> Dict[str, int]:
        return graph_stats(self.graphs)

    @torch.no_grad()
    def fork_lane(self, src: int, dst: int, m: int) -> None:
        """Copy the first `m` KV slots of lane `src` into lane `dst`, in
        place on the device (a session fork on the dense slab). The caller
        manages the lanes' bookkeeping and holds the device lock."""
        if self.pool is not None:
            raise RuntimeError("a paged engine forks through core.cache.BlockPool.fork_lane")
        self.cache.k[:, dst, :m] = self.cache.k[:, src, :m]
        self.cache.v[:, dst, :m] = self.cache.v[:, src, :m]

    # -- lane management -----------------------------------------------------

    def _dense_only(self) -> None:
        if self.pool is not None:
            raise RuntimeError(
                "paged BatchedEngine serves through the executor surface "
                "(runtime/batch_executor): the library loop is dense-only")

    def _sample(self, logits: torch.Tensor, sub) -> torch.Tensor:
        s = self.sampling
        return samplib.sample(logits, sub, s.temperature, s.top_k, s.top_p, s.min_p)

    @torch.no_grad()
    def admit(self, prompt_ids: Sequence[int], key=None, top_n: int = 0, want_lp: bool = False):
        """Claim a lane and prefill it; returns (lane, first_token), or
        (lane, first_token, lp, (top_ids, top_lps)) when want_lp. `key` is
        the first token's sampling subkey."""
        self._dense_only()
        if not self.free:
            raise RuntimeError("no free lanes")
        n = len(prompt_ids)
        if n + 1 > self.max_len:
            raise BufferError(f"prompt of {n} exceeds max_len")
        lane = self.free.pop()
        b = min(bucket_len(n), self.max_len)
        toks = host_to_device(np.asarray([list(prompt_ids) + [0] * (b - n)], np.int64),
                              self.device)
        logits = self._prefill_lane_logits(toks, lane, 0, n)
        tok = self._sample(logits, samplib.prng_key(0) if key is None else key)
        self.lengths[lane] = n
        if want_lp:
            lp, ti, tl = device_to_host(*samplib.logprob_topn(logits, tok, top_n))
            return lane, int(tok[0]), float(lp[0]), (ti[0].tolist(), tl[0].tolist())
        return lane, int(tok[0])

    def release(self, lane: int) -> None:
        self.lengths[lane] = 0
        self.free.append(lane)

    def _lane_keys(self, keys) -> np.ndarray:
        if keys is None:
            return np.zeros((self.lanes, 2), np.uint32)
        return np.asarray(keys, np.uint32).reshape(self.lanes, 2)

    @torch.no_grad()
    def decode(self, toks: Sequence[int], active: Sequence[bool], keys=None) -> np.ndarray:
        """One step for every lane, lane i sampled with keys[i] as its
        subkey; returns the next tokens [lanes] (numpy). Callers advance
        nothing: the active lanes' lengths advance here."""
        self._dense_only()
        sc = self.sampling
        act = np.asarray(active, bool)
        # an inactive lane writes at its fill: keep it inside the slab
        fill = np.where(act, self.lengths, np.minimum(self.lengths, self.max_len - 1))
        inputs = {"tok": host_staged(np.asarray(toks, np.int64), self.device),
                  "fill": host_staged(fill.astype(np.int64), self.device),
                  "active": host_staged(act, self.device)}
        if sc.temperature != 0.0:
            n_cand = samplib.candidate_count(self.cfg.vocab_size, sc.top_k)
            inputs["u"] = torch.cat([samplib.uniforms(k, (1, n_cand), self.device)
                                     for k in self._lane_keys(keys)])[None]
        seq = qwen3.run_window(self.graphs, self.params, self.cfg, self.cache, inputs,
                               (self.max_len,), (sc.temperature, sc.top_k, sc.top_p, sc.min_p),
                               0, False)[0]
        for i, a in enumerate(active):
            if a:
                self.lengths[i] += 1
        return device_to_host(seq[0])[0]

    @torch.no_grad()
    def decode_chunk(self, toks: Sequence[int], active: Sequence[bool], steps: int, keys=None,
                     top_n: int = 0, want_lp: bool = False):
        """`steps` fused decode steps for every active lane in one window
        (models/qwen3.decode_k, the keys chained inside it as `steps`
        decode calls chain them). Returns (tokens [steps, lanes], the
        advanced keys [lanes, 2]), and with want_lp also (lps [steps,
        lanes], top ids [steps, lanes, top_n], top lps), all numpy. The
        caller guarantees headroom: every active lane's fill + steps <=
        max_len."""
        self._dense_only()
        sc = self.sampling
        _c, seq, _n, nkeys, lps, tis, tls = qwen3.decode_k(
            self.params, self.cfg, np.asarray(toks, np.int64), self.cache, self.lengths,
            np.asarray(active, bool), self._lane_keys(keys), steps, sc.temperature, sc.top_k,
            sc.top_p, sc.min_p, top_n=top_n, want_lp=want_lp, graphs=self.graphs,
            kv_bound=self.max_len)
        for i, a in enumerate(active):
            if a:
                self.lengths[i] += steps
        if want_lp:
            seq, lps, tis, tls = device_to_host(seq, lps, tis, tls)
            return seq, nkeys, lps, tis, tls
        return device_to_host(seq)[0], nkeys

    # -- a whole workload with refill ----------------------------------------

    def generate_all(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        chunk: int = 1,
        logprob_sink: Optional[List[List[float]]] = None,
        top_n: int = 0,
        top_sink: Optional[List] = None,
    ) -> List[List[int]]:
        """Run a queue of prompts to completion with continuous lane refill.

        Per-sequence key chains match core.generate.Engine's (one split per
        emitted token from prng_key(seed + index)). chunk > 1 fuses up to
        `chunk` decode steps per window (power-of-two sizes, bounded by the
        KV headroom and the LONGEST remaining budget); tokens are those of
        chunk=1: a lane finishing mid-window (eos or budget) wastes the rest
        of it, truncated on the host, and refills land on window boundaries.

        `logprob_sink` (cleared) gets one list per sequence of the emitted
        tokens' model log-probabilities; `top_sink` with `top_n` > 0 the
        per-step (top ids, top lps) pairs. Tokens are the same with or
        without them."""
        self._dense_only()
        want_lp = logprob_sink is not None or top_sink is not None
        results: List[Optional[List[int]]] = [None] * len(prompts)
        lp_results: List[Optional[List[float]]] = [None] * len(prompts)
        top_results: List[Optional[List]] = [None] * len(prompts)
        queue = list(range(len(prompts)))
        lane_seq: Dict[int, int] = {}
        lane_key: Dict[int, np.ndarray] = {}
        out: Dict[int, List[int]] = {}
        lp_out: Dict[int, List[float]] = {}
        top_out: Dict[int, List] = {}

        def finish(lane, cap: Optional[int] = None):
            i = lane_seq.pop(lane)
            results[i] = out.pop(lane)[:cap]
            if want_lp:
                lp_results[i] = lp_out.pop(lane)[:cap]
                top_results[i] = top_out.pop(lane)[:cap]
            del lane_key[lane]
            self.release(lane)

        def admit_next():
            while queue and self.free:
                i = queue.pop(0)
                key, sub = samplib.split_key(samplib.prng_key(seed + i))
                if want_lp:
                    lane, tok, lp, top = self.admit(prompts[i], sub, top_n=top_n, want_lp=True)
                    lp_out[lane] = [lp]
                    top_out[lane] = [top]
                else:
                    lane, tok = self.admit(prompts[i], sub)
                lane_seq[lane] = i
                lane_key[lane] = key
                out[lane] = [tok]
                if (eos_token_id is not None and tok == eos_token_id) or max_new_tokens <= 1:
                    finish(lane, cap=max_new_tokens)

        admit_next()
        while lane_seq:
            s = 1
            if chunk > 1:
                # bounded by KV headroom (head - 1: a per-token max_len release
                # lands only on a window boundary) and the LONGEST remaining
                # budget (a lane done mid-window is truncated on the host)
                rem = max(max_new_tokens - len(out[lane]) for lane in lane_seq)
                head = self.max_len - max(self.lengths[lane] for lane in lane_seq)
                s = max(1, min(chunk, rem, head - 1))
                s = 1 << (s.bit_length() - 1)  # powers of two: few window graphs
            toks = [0] * self.lanes
            active = [False] * self.lanes
            keys = np.zeros((self.lanes, 2), np.uint32)
            for lane in lane_seq:
                toks[lane] = out[lane][-1]
                active[lane] = True
                keys[lane] = lane_key[lane]
            if want_lp:
                seq, nkeys, lps, tis, tls = self.decode_chunk(toks, active, s, keys,
                                                              top_n=top_n, want_lp=True)
            else:
                seq, nkeys = self.decode_chunk(toks, active, s, keys)
            for lane in list(lane_seq):
                lane_key[lane] = nkeys[lane]
                done = False
                for j in range(s):
                    t = int(seq[j, lane])
                    out[lane].append(t)
                    if want_lp:
                        lp_out[lane].append(float(lps[j, lane]))
                        top_out[lane].append((tis[j, lane].tolist(), tls[j, lane].tolist()))
                    if len(out[lane]) >= max_new_tokens or (
                            eos_token_id is not None and t == eos_token_id):
                        done = True
                        break
                if done or self.lengths[lane] + 1 >= self.max_len:
                    finish(lane)
            admit_next()
        if logprob_sink is not None:
            logprob_sink.clear()
            logprob_sink.extend(r if r is not None else [] for r in lp_results)
        if top_sink is not None:
            top_sink.clear()
            top_sink.extend(r if r is not None else [] for r in top_results)
        return [r if r is not None else [] for r in results]

    # -- the serving entries (runtime/batch_executor), cache written in place --

    def _decode_logits(self, toks, lengths, ads=None) -> torch.Tensor:
        """One step over every lane of the dense slab: [L, V] logits (a
        graph's static output on a card; read it before the next step).
        toks [L] and lengths [L] on the host; lanes not served this step
        advance nothing on the host and their rows are discarded."""
        xs = np.asarray(toks, np.int64).reshape(self.lanes, 1)
        return lane_step(self.graphs, self.params, self.cfg, self.cache, xs,
                         np.asarray(lengths, np.int64), first=True, last=True, ads=ads)

    def _decode_logits_paged(self, toks, lengths, active, table, ads=None) -> torch.Tensor:
        """The paged sibling: reads and writes go through `table` (the
        sync_paged one), and lanes not in this step (`active` False) write
        to the scratch block."""
        xs = np.asarray(toks, np.int64).reshape(self.lanes, 1)
        return lane_step(self.graphs, self.params, self.cfg, self.cache, xs,
                         np.asarray(lengths, np.int64), first=True, last=True,
                         active=np.asarray(active, bool), table=table, ads=ads)

    def _prefill_lane_logits(self, tokens: torch.Tensor, lane: int, start: int, n: int,
                             ads=None) -> torch.Tensor:
        """Chunk-ingest [1, S_bucket] tokens into ONE lane at `start`:
        the last real token's logits [1, V]."""
        return lane_prefill(self.params, self.cfg, self.cache, tokens, lane, start, n,
                            first=True, last=True, ads=ads)

    def _prefill_lane_logits_paged(self, tokens: torch.Tensor, table_row, start: int, n: int,
                                   ads=None) -> torch.Tensor:
        """The paged sibling, through ONE lane's [1, W] table row."""
        return lane_prefill(self.params, self.cfg, self.cache, tokens, -1, start, n,
                            first=True, last=True, table_row=table_row, ads=ads)

    def _copy_blocks(self, pairs) -> None:
        """Apply queued copy-on-write (src, dst) block copies in place."""
        paged_copy_blocks(self.cache, pairs)
