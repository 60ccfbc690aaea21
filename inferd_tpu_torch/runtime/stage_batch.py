"""Continuous batching for a pipeline stage: concurrent sessions' decode
steps through this stage run as ONE device step (port of
inferd_tpu/runtime/stage_batch.py).

Sessions map to LANES of one shared stage KV cache, either the dense lane
slab [layers, lanes, max_len, ...] (`block_size` 0) or a paged block pool
(`block_size` > 0, core.cache.BlockPool), and single-token decode steps of
whichever sessions co-arrive stack into one [lanes, 1, H] stage forward:
the weights are read once per step instead of once per session per token.

Division of labour with runtime/node.py: the NODE owns the arrival window
(runtime/window.WindowedBatcher); this executor owns lanes, admission and
the batched device step (`process_batch`). `process()` keeps the
single-session executor contract: prefill chunks run per lane, and a solo
decode step is a batch of one.

Concurrency: `_mu` guards lane/session bookkeeping, `_dev_lock` serializes
device steps, and `_mu` is never held while waiting for `_dev_lock`. A
session is marked in flight for the duration of its step, so eviction or
teardown can never hand its lane to a new claimant while a write is
pending (a teardown mid-step defers the lane's free until the step drains).

What differs from the reference, by PyTorch idiom: the four jitted step
closures are plain methods that write the cache IN PLACE; the host-side
per-lane values (lengths, the `active` mask, the block table, the adapter
ids) reach the card through pinned buffers, non-blocking. The co-batched
decode step, the reference's compiled `_decode_all`, replays a captured
CUDA graph on a card (utils/cuda_graph; see `_decode_all`); prefill
dispatches run eagerly. The reference's `cache_intact`
check, which stops a window after a failed dispatch because the jit had
donated (and so invalidated) the shared cache, has no counterpart: nothing
is donated here, a failed dispatch leaves the buffers valid, and a window
is one dispatch.

Multi-tenant LoRA (`adapters`, a runtime/adapters.AdapterRegistry holding
this stage's layer slice): a session admitted with an `adapter` key binds a
registry slot (runtime/adapters.AdapterBindingMixin), resolved and maybe
hot-loaded before any executor lock; each dispatch hands the forward the
pools plus every lane's slot id, so a window mixing tenants is one
dispatch, and a dispatch whose lanes all ride slot 0 carries no adapter
operand at all. Paged prefix keys are salted with the adapter's name, so
tenants never share prefix KV.

Not ported in this slice: `decode_steps` items (fused K-step decode; a
per-item ValueError), `fork_session` (and with it the fork-time adapter
binding), `anatomy_target` and `prefix_digest`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.core.cache import (
    BlockPool, KVCache, PagedKVCache, host_staged, host_to_device, lane_slice, lane_write,
    sync_paged,
)
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime.adapters import AdapterBindingMixin
from inferd_tpu_torch.runtime.executor import _as_tensor
from inferd_tpu_torch.utils.cuda_graph import GraphCache, graph_stats, run_step

Params = Dict[str, Any]


class CapacityError(RuntimeError):
    """Every lane is held by an in-flight request: transient, retryable."""


class BatchedStageExecutor(AdapterBindingMixin):
    """Lane-slotted multi-session executor for one pipeline stage.

    Node executor contract: process(session_id, payload) -> {"hidden":
    [1, S, H]} or {"logits": [1, V]} (+ start_pos/real_len), as CPU tensors;
    end_session(session_id). Extra surface: process_batch(items), the
    node's window flush callback, runs every item's decode step in ONE
    device dispatch and returns per-item results (an exception per item,
    never batch-wide, so one bad session cannot fail its co-batch)."""

    def __init__(
        self,
        cfg: ModelConfig,
        spec: StageSpec,
        stage_params: Params,
        lanes: int = 8,
        max_len: int = 4096,
        session_ttl_s: float = 600.0,
        block_size: int = 0,
        kv_blocks: int = 0,
        prefill_chunk: int = 0,
        adapters=None,
    ):
        qwen3.check_supported(cfg)
        self.cfg = cfg
        self.spec = spec
        self.params = stage_params
        self.device = next(iter(stage_params["layers"].values())).device
        self.lanes = lanes
        self.max_len = max_len
        self.ttl_s = session_ttl_s
        # multi-tenant LoRA registry (None: single-model serving); the lane's
        # slot mirror is what each dispatch hands the forward as its ids
        self.adapters = adapters
        self._session_adapter: Dict[str, str] = {}
        self._lane_slot = [0] * lanes  # slot 0 = the zero base adapter
        # dispatches that carried an adapter operand (a tenant lane): each
        # launches the LoRA kernel once per covered projection and layer
        self.adapter_steps = 0
        self.adapter_prefill_steps = 0
        # server-side chunked prefill: a prompt longer than this many tokens
        # ingests as several dispatches, RELEASING the device lock between
        # chunks so co-batched decode windows interleave (0 = off)
        self.prefill_chunk = int(prefill_chunk)
        self.pool: Optional[BlockPool] = None
        if block_size > 0:
            self.pool = BlockPool(
                cfg, spec.num_layers, lanes, max_len, block_size=block_size,
                num_blocks=kv_blocks or None, device=self.device,
            )
            self.cache = self.pool.cache
        else:
            self.cache = KVCache.create(cfg, spec.num_layers, lanes, max_len, device=self.device)
        self.lengths = [0] * lanes  # host mirror (no device read per step)
        self.free: List[int] = list(range(lanes))
        # prefill dispatches and the tokens they computed (a shared-prefix
        # skip shows as the gap to the tokens admitted)
        self.prefill_steps = 0
        self.prefill_tokens = 0
        self._dev_lock = threading.Lock()  # serializes device steps
        self._mu = threading.Lock()  # guards session/lane bookkeeping
        self._sessions: Dict[str, int] = {}  # session -> lane
        self._last_used: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}
        self._dying: Dict[int, str] = {}  # lane -> session ended mid-step
        # set by the node so a dropped session's entries still waiting in the
        # arrival window fail fast instead of racing the lane's next owner
        self.on_drop: Optional[Callable[[str], None]] = None
        self._batched_steps = 0
        self._batched_tokens = 0
        # paged decode dispatches by the stamped table width (chain_clamp):
        # with the lane count it fixes ops.attention.paged_plan's cut
        self._decode_widths: Dict[int, int] = {}
        # co-batched decode steps as graph replays on a card, eager on the
        # CPU; set to None for the eager step on a card too (the reference
        # the graphs are held to)
        self.graphs: Optional[GraphCache] = (
            GraphCache(device=self.device) if self.device.type == "cuda" else None)
        self._pools_ptr: Optional[int] = None  # the adapter pools' address the graphs read

    def co_possible(self) -> bool:
        """More than one live session: a window wait can pay off. LOCK-FREE
        (dict len is atomic): called under the batcher's lock while
        _drop_locked holds self._mu to invalidate that same batcher."""
        return len(self._sessions) > 1

    def gang_target(self) -> int:
        """How many decode entries a window flusher should hope for: the
        live sessions not mid-step here. LOCK-FREE and advisory (the window
        cap bounds any staleness)."""
        return len(self._sessions) - len(self._inflight)

    # -- lane/session bookkeeping (call under self._mu) ----------------------

    def _lane_for(self, session_id: str, new_ok: bool) -> int:
        lane = self._sessions.get(session_id)
        if lane is not None:
            self._last_used[session_id] = time.monotonic()
            return lane
        if not new_ok:
            raise ValueError(
                f"session {session_id}: unknown session resumed mid-stream "
                "(cache evicted or node restarted)"
            )
        if not self.free:
            victims = [s for s in self._sessions if not self._inflight.get(s)]
            if not victims:
                raise CapacityError("all lanes busy with in-flight requests")
            self._drop_locked(min(victims, key=lambda s: self._last_used.get(s, 0.0)))
        lane = self.free.pop()
        self._sessions[session_id] = lane
        self._last_used[session_id] = time.monotonic()
        return lane

    def _drop_locked(self, session_id: str) -> None:
        lane = self._sessions.pop(session_id, None)
        self._last_used.pop(session_id, None)
        self._release_adapter_locked(session_id)
        if lane is None:
            return
        # fail entries still waiting in the node's window: a later flush
        # must never write this lane for the old session once a new claimant
        # may own it
        if self.on_drop is not None:
            self.on_drop(session_id)
        if self._inflight.get(session_id):
            self._dying[lane] = session_id  # free deferred until the step drains
        else:
            self._free_lane_locked(lane)

    def _free_lane_locked(self, lane: int) -> None:
        self.lengths[lane] = 0
        self._lane_slot[lane] = 0  # back to the base adapter
        if self.pool is not None:
            # cached/pinned prefix blocks survive through their index
            # references; everything else returns to the pool
            self.pool.release_lane(lane)
        self.free.append(lane)

    def _finish_locked(self, session_id: str, lane: int) -> None:
        self._inflight.pop(session_id, None)
        if self._dying.get(lane) == session_id:  # ended mid-step
            del self._dying[lane]
            self._free_lane_locked(lane)

    # -- admission (shared by decode co-batches and solo prefill) ------------

    def _admit_locked(
        self, session_id: str, start_pos: int, real_len: int, new_ok: bool,
        ensure_upto: Optional[int] = None,
    ) -> int:
        """Validate and in-flight-mark one chunk; returns its lane. MUST hold
        self._mu. One definition of the admission protocol (concurrency,
        restart reset, overflow, out-of-order, replay rollback) for the
        co-batched decode path and the per-lane prefill path.

        Paged extras: `ensure_upto` allocates the lane's chain to cover that
        many positions before the dispatch writes them, a restart releases
        the old chain block by block, and a replay rollback into a SHARED
        region queues copy-on-write splits for the device lock to apply:
        the rewrite must never scribble on blocks other lanes or the prefix
        index still read."""
        if self._inflight.get(session_id):
            raise ValueError(
                f"session {session_id}: concurrent request (one step at a time per session)"
            )
        lane = self._lane_for(session_id, new_ok=new_ok)
        owner = f"session {session_id}, lane {lane}"
        have = self.lengths[lane]
        if start_pos == 0 and have:
            # session restart under the same id: reset the lane
            self.lengths[lane] = 0
            if self.pool is not None:
                self.pool.release_lane(lane)
            have = 0
        if start_pos + real_len > self.max_len:
            raise BufferError(
                f"session {session_id}: KV overflow "
                f"({start_pos}+{real_len} > {self.max_len}, lane {lane})"
            )
        if start_pos != have:
            if not 0 < start_pos < have:
                raise ValueError(
                    f"session {session_id}: start_pos {start_pos} != cache "
                    f"length {have} (out-of-order chunk)"
                )
            # deterministic chunk REPLAY: roll the frontier back and
            # recompute (identical KV)
            self.lengths[lane] = start_pos
            if self.pool is not None:
                self.pool.make_writable(lane, start_pos, owner=owner)
        if self.pool is not None and ensure_upto is not None:
            self.pool.ensure(lane, ensure_upto, owner=owner)
        self._inflight[session_id] = 1
        return lane

    # -- device steps (call under self._dev_lock) ----------------------------

    def _embed_or_hidden(self, x: torch.Tensor) -> torch.Tensor:
        return qwen3.embed(self.params, x, self.cfg) if self.spec.is_first else x

    def _decode_all(self, xs: torch.Tensor, lens: np.ndarray, active: np.ndarray,
                    ads=None) -> torch.Tensor:
        """One co-batched decode step over EVERY lane (models/qwen3.
        stage_step); returns [L, V] logits or [L, 1, H] hidden on the
        device, a graph's static output on a card: read it before the next
        step. xs: host tokens [L, 1] or hidden [L, 1, H]; lens [L]: per-lane
        fill; active [L]: the lanes with an entry; ads: the adapter operand
        with host ids (`_ads(..., staged=True)`). Dense: lanes without an
        entry compute garbage at their own frontier slot, which the lane's
        next real step rewrites before it can be read (a full idle lane
        writes its last slot, which only a replay below it can reach, and a
        replay rewrites it first). Paged: rows of inactive lanes write only
        to the scratch block (blocks are shared property).

        On a card the step replays the graph keyed by the layout, the
        table's width W (paged) and whether a tenant lane rides; xs, lens,
        active, the table and the adapter ids are its static inputs, each
        staged on the host and copied once, straight into its static buffer
        (utils/cuda_graph.run_step); the cache and the adapter pools are
        read by address. The queued CoW copies and the decode_widths count
        stay on the host side, before the replay. The dense attention walks the whole lane slab, as the
        eager step always did: a bound from the co-batch's fills would make
        a lane's bits depend on which sessions share its window."""
        cfg, p, spec = self.cfg, self.params, self.spec
        dev = self.device
        inputs = {"x": host_staged(xs, dev), "lens": host_staged(lens, dev)}
        pools = None
        if ads is not None:
            pools = {k: v for k, v in ads.items() if k != "ids"}
            inputs["ids"] = ads["ids"]
            ptr = pools["scale"].data_ptr()
            if self._pools_ptr is None:
                self._pools_ptr = ptr
            elif ptr != self._pools_ptr:
                # the graphs read the pools by address: they are written in
                # place for good (runtime/adapters), never reallocated
                raise RuntimeError("adapter pools moved: the lane graphs read the old ones")
        if self.pool is not None:
            cache, table = self._sync_paged()
            width = int(table.shape[1])
            with self._mu:
                self._decode_widths[width] = self._decode_widths.get(width, 0) + 1
            inputs["table"] = table
            inputs["active"] = host_staged(active, dev)
            key = ("paged", width, ads is not None)
        else:
            cache = self.cache
            key = ("dense", ads is not None)

        def step(x, lens, table=None, active=None, ids=None):
            adapters = None if ids is None else {**pools, "ids": ids}
            if table is None:  # dense: an idle full lane writes its last slot
                lens = lens.clamp(max=self.max_len - 1)
            return qwen3.stage_step(p, cfg, x, cache.k, cache.v, lens, first=spec.is_first,
                                    last=spec.is_last, table=table, write_mask=active,
                                    adapters=adapters)

        return run_step(self.graphs, key, step, inputs, dev)

    def _prefill_lane(self, xd: torch.Tensor, lane: int, start: int, n: int,
                      ads=None) -> torch.Tensor:
        """Chunk-ingest ONE lane: xd [1, S_bucket] tokens or [1, S_bucket, H]
        hidden at absolute `start`, of which the first n rows are real.
        Returns [1, V] logits of the last real row, or [1, S_bucket, H]."""
        cfg, p = self.cfg, self.params
        hidden = self._embed_or_hidden(xd)
        s = hidden.shape[1]
        if self.pool is not None:
            # the lane's own table row, as wide as this chunk can reach
            width = min(self.pool.blocks_for(start + s), self.pool.max_blocks)
            with self._mu:
                row = host_to_device(self.pool.table[lane:lane + 1, :width], self.device)
            lc = PagedKVCache(k=self.cache.k, v=self.cache.v, table=row)
            hidden, _ = qwen3.forward_layers_cached(
                p["layers"], cfg, hidden, start, lc, start, real_end=start + n,
                layer_offset=self.spec.start_layer, adapters=ads,
            )
        else:
            lc = lane_slice(self.cache, lane)
            hidden, lc = qwen3.forward_layers_cached(
                p["layers"], cfg, hidden, start, lc, start, real_end=start + n,
                layer_offset=self.spec.start_layer, adapters=ads,
            )
            lane_write(self.cache, lane, lc)
        if self.spec.is_last:
            return qwen3.unembed(p, cfg, hidden[:, n - 1:n])[:, 0]
        return hidden

    def _sync_paged(self) -> Tuple[PagedKVCache, torch.Tensor]:
        """core.cache.sync_paged over this executor's state (under the
        device lock): (the cache, its queued CoW copies applied; the table
        at the chain_clamp width, staged on the host)."""
        self.cache, table = sync_paged(self.pool, self.cache, self._mu)
        return self.cache, table

    # -- executor contract ---------------------------------------------------

    def _parse(self, payload: Dict[str, Any]):
        """(x, start_pos, real_len) with x the raw [1, S(, H)] array: int64
        numpy tokens on the first stage, else a CPU tensor of hidden."""
        start_pos = int(payload.get("start_pos", 0))
        if self.spec.is_first:
            x = np.asarray(payload["tokens"], dtype=np.int64)
        else:
            x = _as_tensor(payload["hidden"])
        if x.ndim < 2 or x.shape[0] != 1:
            raise ValueError(f"stage batch expects [1, S(, H)], got {tuple(x.shape)}")
        real_len = int(payload.get("real_len", x.shape[1]))
        return x, start_pos, real_len

    def process_batch(
        self,
        items: List[Tuple[str, Dict[str, Any]]],
        drain: Optional[Callable[[], List[Tuple[str, Dict[str, Any]]]]] = None,
    ) -> List[Any]:
        """ONE co-batched device step for every item's single-token decode.

        items: [(session_id, payload)], each a decode step ({"tokens":
        [1, 1]} or {"hidden": [1, 1, H]}, start_pos > 0, real_len == 1).
        Returns a list aligned with `items` (plus any drained extras,
        appended in drain order): a result dict per served item, or the
        Exception that rejected it.

        `drain` (optional) is called once the DEVICE LOCK is held and may
        return more items to fold into the same step (continuous batching:
        entries that arrived while the previous step ran join this one)."""
        out: List[Any] = [None] * len(items)
        served: List[Tuple[int, str, int, Any, int]] = []
        taken: set = set()

        def admit(batch_items, base: int) -> None:
            """Validate and mark each item (under self._mu)."""
            for j, (sid, payload) in enumerate(batch_items):
                i = base + j
                try:
                    x, start_pos, real_len = self._parse(payload)
                    if int(payload.get("decode_steps") or 0) > 0:
                        raise ValueError(
                            "decode_steps (fused K-step decode) is not ported yet; "
                            "send one token per step"
                        )
                    nm = payload.get("adapter")
                    if nm is not None and (
                        self.adapters is None or self._session_adapter.get(sid) != str(nm)
                    ):
                        # decode steps are mid-session: the binding happened at
                        # admission, and a mismatch is a routing bug, never
                        # served with other weights
                        raise ValueError(
                            f"session {sid}: decode-step adapter {nm!r} "
                            "does not match the admitted binding"
                        )
                    if real_len != 1 or start_pos <= 0:
                        raise ValueError(
                            "process_batch co-batches single-token decode steps only "
                            f"(real_len={real_len}, start_pos={start_pos})"
                        )
                    if sid in taken:
                        raise ValueError(
                            f"session {sid}: concurrent request (two steps in one window)"
                        )
                    lane = self._admit_locked(sid, start_pos, 1, new_ok=False,
                                              ensure_upto=start_pos + 1)
                    taken.add(sid)
                    served.append((i, sid, lane, x, start_pos))
                except Exception as e:  # per-item rejection
                    out[i] = e

        with self._mu:
            admit(items, 0)
        if not served and drain is None:
            return out
        try:
            with self._dev_lock:
                if drain is not None:
                    extra = drain()
                    if extra:
                        base = len(out)
                        out.extend([None] * len(extra))
                        with self._mu:
                            admit(extra, base)
                if not served:
                    return out
                with self._mu:
                    lens = np.asarray(self.lengths, np.int64)
                    slot_ids = list(self._lane_slot)
                ads = self._ads(slot_ids, staged=True)
                active = np.zeros((self.lanes,), bool)
                if self.spec.is_first:
                    xs = torch.zeros((self.lanes, 1), dtype=torch.int64)
                else:
                    # the wire's dtype cast to the stage's (bf16 stays bf16)
                    h = served[0][3].shape[-1]
                    xs = torch.zeros((self.lanes, 1, h), dtype=self.cfg.torch_dtype)
                for _i, _sid, lane, x, _sp in served:
                    xs[lane] = _as_tensor(x)[0]
                    active[lane] = True
                with torch.no_grad():
                    res = self._decode_all(xs, lens, active, ads).cpu()  # before the next replay
                with self._mu:
                    for _i, _sid, lane, _x, _sp in served:
                        self.lengths[lane] += 1
                    self._batched_steps += 1
                    self._batched_tokens += len(served)
                    self.adapter_steps += ads is not None
                key = "logits" if self.spec.is_last else "hidden"
                for i, _sid, lane, _x, sp in served:
                    out[i] = {key: res[lane:lane + 1], "real_len": 1, "start_pos": sp}
        except Exception as e:
            for i, _sid, _lane, _x, _sp in served:
                if out[i] is None:
                    out[i] = e
        finally:
            with self._mu:
                for _i, sid, lane, _x, _sp in served:
                    self._finish_locked(sid, lane)
        return out

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Single-session contract: prefill chunks run per lane; a decode
        step is a co-batch of one (the node's window is where decode steps
        actually coalesce)."""
        _x, start_pos, real_len = self._parse(payload)
        if real_len == 1 and start_pos > 0:
            res = self.process_batch([(session_id, payload)])[0]
            if isinstance(res, Exception):
                raise res
            return res
        if int(payload.get("decode_steps") or 0) > 0:
            raise ValueError("decode_steps (fused K-step decode) is not ported yet; "
                             "send one token per step")
        return self._prefill_solo(session_id, payload, start_pos, real_len)

    def _prefill_solo(
        self, session_id: str, payload: Dict[str, Any], start_pos: int, real_len: int,
    ) -> Dict[str, Any]:
        """Per-lane prompt ingestion, in up to three phases:

          1. shared-prefix SKIP (paged, whole-model stages, start_pos 0):
             full blocks whose chained token key is already in the pool's
             prefix index map read-only into this lane: no prefill compute
             for the shared region, CoW on later divergence. The prompt's
             last token always computes (its logits are the response).
          2. chunked prefill: the remaining tokens ingest in
             `prefill_chunk`-token dispatches, RELEASING the device lock
             between chunks so co-batched decode windows interleave.
          3. registration (paged, whole-model stages): the prompt's full
             blocks publish into the prefix index for later sessions.
        """
        x, _, _ = self._parse(payload)
        acquired = self._resolve_adapter(session_id, payload, start_pos)
        try:
            with self._mu:
                lane = self._admit_locked(session_id, start_pos, real_len, new_ok=start_pos == 0)
                self._bind_adapter_locked(session_id, lane, start_pos, acquired)
        except Exception:
            # an admission that died before the binding took the reference
            # must give it back, or the slot could never be evicted
            if acquired is not None and acquired[1]:
                self.adapters.release(acquired[0])
            raise
        owner = f"session {session_id}, lane {lane}"
        key = "logits" if self.spec.is_last else "hidden"
        parts: List[torch.Tensor] = []  # device results, one boundary copy after the loop
        saved = 0
        try:
            pos = start_pos
            keys = None
            with self._mu:
                ad_name = self._session_adapter.get(session_id)
                ads = self._ads([self._lane_slot[lane]])
            whole = self.spec.is_first and self.spec.is_last
            if self.pool is not None and whole and start_pos == 0:
                # a tenant's chain is salted with its adapter: tenants never
                # share prefix KV (core.prefix.block_keys)
                keys = prefixlib.block_keys([int(t) for t in x[0, :real_len]],
                                            self.pool.block_size, salt=ad_name)
                # map at most the blocks covering real_len - 1 tokens: the
                # LAST prompt token must compute (its logits seed decode)
                nmap = (real_len - 1) // self.pool.block_size
                with self._mu:
                    cov = self.pool.map_prefix(lane, keys[:nmap])
                    if cov:
                        self.lengths[lane] = cov
                pos = saved = cov
            end = start_pos + real_len
            step = self.prefill_chunk if self.prefill_chunk > 0 else end - pos
            while pos < end:
                n = min(step, end - pos)
                # cap the padded bucket so it never runs past the cache;
                # paged chains are ensured per chunk instead
                b = min(bucket_len(n), self.max_len - pos)
                chunk = x[:, pos - start_pos: pos - start_pos + n]
                if self.spec.is_first:
                    padded = torch.zeros((1, b), dtype=torch.int64)
                    padded[0, :n] = torch.from_numpy(np.ascontiguousarray(chunk[0]))
                else:
                    padded = torch.zeros((1, b, x.shape[2]), dtype=self.cfg.torch_dtype)
                    padded[0, :n] = chunk[0].to(self.cfg.torch_dtype)
                if self.pool is not None:
                    with self._mu:
                        self.pool.ensure(lane, pos + n, owner=owner)
                with self._dev_lock:
                    if self.pool is not None:
                        self._sync_paged()
                    with torch.no_grad():
                        res = self._prefill_lane(host_to_device(padded, self.device), lane, pos, n,
                                                 ads)
                    parts.append(res if key == "logits" else res[:, :n])
                    # advance BEFORE releasing the device lock: a window
                    # flush snapshots lengths under the same lock order
                    with self._mu:
                        self.lengths[lane] = pos + n
                        self.prefill_steps += 1
                        self.prefill_tokens += n
                        self.adapter_prefill_steps += ads is not None
                pos += n
                if self.prefill_chunk > 0 and pos < end:
                    # threading.Lock is not fair: without a yield the chunk
                    # loop can retake the device before a waiting decode
                    # flusher wakes, and chunking would bound nothing
                    time.sleep(0.0005)
            if keys:
                with self._mu:
                    self.pool.register_prefix(lane, keys)
        finally:
            with self._mu:
                self._finish_locked(session_id, lane)
        if key == "logits":
            val = parts[-1].cpu()
        else:
            # only the real rows cross the wire; downstream re-pads
            val = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)).cpu()
        result: Dict[str, Any] = {key: val, "real_len": real_len, "start_pos": start_pos}
        if saved:
            result["tokens_saved"] = saved
        return result

    def end_session(self, session_id: str) -> None:
        with self._mu:
            self._drop_locked(session_id)

    # -- prefix caching (paged mode) -----------------------------------------

    def pin_prefix(self, prefix_ids) -> int:
        """Prefill `prefix_ids` once into pool blocks and PIN them: they stay
        resident, and every later session whose prompt starts with them maps
        the region read-only instead of recomputing it. Whole-model paged
        stages only. Returns the pinned token coverage (full blocks)."""
        if self.pool is None or not (self.spec.is_first and self.spec.is_last):
            raise ValueError("pin_prefix needs paged KV on a whole-model stage")
        ids = list(prefixlib.normalize_ids(prefix_ids))
        keys = prefixlib.block_keys(ids, self.pool.block_size)
        sid = "__pin__" + keys[-1].hex() if keys else "__pin__short"
        # an ordinary prefill under a reserved session id registers the
        # blocks; the pin marks them, and the teardown returns the lane
        # while the index references keep the blocks
        self.process(sid, {"tokens": [ids], "start_pos": 0, "real_len": len(ids)})
        with self._mu:
            self.pool.pin(keys)
        self.end_session(sid)
        return len(keys) * self.pool.block_size

    def unpin_prefix(self, prefix_ids) -> None:
        if self.pool is None:
            return
        with self._mu:
            self.pool.unpin(prefixlib.block_keys([int(t) for t in prefix_ids],
                                                 self.pool.block_size))

    # -- node surfaces (sweep, /stats) ---------------------------------------

    @property
    def sessions(self):
        return self

    def sweep(self) -> int:
        """Drop sessions idle past their TTL (none mid-step); skips the round
        rather than wait for a busy bookkeeping lock."""
        if not self._mu.acquire(blocking=False):
            return 0
        try:
            now = time.monotonic()
            stale = [s for s, t in self._last_used.items()
                     if now - t > self.ttl_s and not self._inflight.get(s)]
            for s in stale:
                self._drop_locked(s)
            return len(stale)
        finally:
            self._mu.release()

    def kv_occupancy(self) -> float:
        """Fraction of the KV budget in use: blocks used / blocks total when
        paged, filled positions / (lanes x max_len) when dense."""
        with self._mu:
            if self.pool is not None:
                total = self.pool.num_blocks - 1
                return self.pool.blocks_used / float(total) if total else 0.0
            return sum(self.lengths) / float(self.lanes * self.max_len)

    def block_stats(self) -> Optional[Dict[str, Any]]:
        """Block-pool gauges (None on the dense layout)."""
        if self.pool is None:
            return None
        with self._mu:
            return self.pool.block_stats()

    def __len__(self) -> int:
        with self._mu:
            return len(self._sessions)

    def __contains__(self, session_id: str) -> bool:
        with self._mu:
            return session_id in self._sessions

    def stats(self) -> Dict[str, Any]:
        occupancy, paged = self.kv_occupancy(), self.block_stats()
        with self._mu:
            steps, toks = self._batched_steps, self._batched_tokens
            out: Dict[str, Any] = {
                "mode": "stage_batched",
                "stage": self.spec.stage,
                "lanes": self.lanes,
                "lanes_busy": self.lanes - len(self.free),
                "sessions": len(self._sessions),
                "batched_steps": steps,
                "batched_tokens": toks,
                "mean_batch": round(toks / steps, 3) if steps else 0.0,
                "prefill_steps": self.prefill_steps,
                "prefill_tokens": self.prefill_tokens,
                "kv_bytes": self.cache.nbytes,
                "kv_occupancy": occupancy,
                "graphs": graph_stats(self.graphs),
            }
            if self.adapters is not None:
                out["adapter_steps"] = self.adapter_steps
                out["adapter_prefill_steps"] = self.adapter_prefill_steps
        if self.adapters is not None:
            out["adapters"] = self.adapters.stats()
        if paged is not None:
            out["paged"] = paged
            with self._mu:
                out["decode_widths"] = {str(w): n for w, n in sorted(self._decode_widths.items())}
        return out
