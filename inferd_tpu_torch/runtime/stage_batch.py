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

`LaneExecutor` below is what this executor and the whole-model
runtime/batch_executor.BatchedExecutor share: lane bookkeeping (LRU
eviction of idle lanes, deferred frees), the admission protocol, paged
sync and copy-on-write, chunked prefill with the shared-prefix skip, the
co-batched step and the K-step groups of a window, pins and the node
surfaces. Each class keeps what differs: who owns the window, and how a
step reaches the device (the stage's params here, the BatchedEngine's
serving entries there).

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
CUDA graph on a card (utils/cuda_graph; core/batch.lane_step); prefill
dispatches run eagerly. The reference's `cache_intact` check, which stops a
window after a failed dispatch because the jit had donated (and so
invalidated) the shared cache, has no counterpart: nothing is donated here,
and a failed dispatch leaves the buffers valid, so every dispatch of a
window runs and fails only its own items.

K-step items (`decode_steps`, runtime/executor.parse_kstep): on a stage
that is first and last (a whole-model lane node) co-arrived items of one
sampling config run as one fused window (runtime/executor.
fuse_kstep_group over models/qwen3.decode_k: a graph replay per window on
a card), beside the single-token items' step under the same device-lock
hold; a pipeline stage refuses them with the reference's error.

Multi-tenant LoRA (`adapters`, a runtime/adapters.AdapterRegistry holding
this stage's layer slice): a session admitted with an `adapter` key binds a
registry slot (runtime/adapters.AdapterBindingMixin), resolved and maybe
hot-loaded before any executor lock; each dispatch hands the forward the
pools plus every lane's slot id, so a window mixing tenants is one
dispatch, and a dispatch whose lanes all ride slot 0 carries no adapter
operand at all. Paged prefix keys are salted with the adapter's name, so
tenants never share prefix KV. A whole-model paged executor gossips its
hot prefix keys (`prefix_digest`, the record's `pfx`).

Sessions that move: `fork_session` forks a paged parent's prefix block by
block (the dense stage lanes answer False, as the reference's do). Session
export and import are the whole-model executor's
(runtime/batch_executor.BatchedExecutor): the reference's stage-lane
executor has none, so a `--stage-lanes` node answers /export_session with
501 `no_export` and hands nothing off on drain, migration or stop. Not
ported: `anatomy_target` (ROADMAP A9).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.core.batch import LANE_GRAPHS, lane_prefill, lane_step
from inferd_tpu_torch.core.cache import BlockPool, KVCache, PagedKVCache, host_to_device, sync_paged
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime.adapters import AdapterBindingMixin
from inferd_tpu_torch.runtime.executor import _as_tensor, fuse_kstep_group, parse_kstep
from inferd_tpu_torch.utils.cuda_graph import GraphCache, graph_stats

Params = Dict[str, Any]


class CapacityError(RuntimeError):
    """Every lane is held by an in-flight request: transient, retryable."""


# a decode item admitted into a step: (out index, session, lane, x, start_pos,
# parse_kstep's dict or None for a single-token item)
Served = Tuple[int, str, int, Any, int, Optional[Dict[str, Any]]]


class LaneExecutor(AdapterBindingMixin):
    """Lane-per-session serving over one shared KV cache: the part of the
    two lane executors that is the same (see the module docstring).

    A subclass provides `cfg`, `spec` (its layers; first and last for the
    whole model), `params`, `device`, `lanes`, `max_len`, the lane state
    `cache`, `lengths`, `free`, `pool`, `graphs`, the adapter registry
    `adapters`, `_decode_k_fn` (models/qwen3.make_decode_k_serve's form, or
    None where K-step items are refused) and the two device hooks
    `_lane_step` and `_lane_prefill`; then calls `_init_lanes`.

    Concurrency: `_mu` guards lane/session bookkeeping, `_dev_lock`
    serializes device steps, and `_mu` is never held while waiting for
    `_dev_lock`. A session is marked in flight for the duration of its step,
    so eviction or teardown never hands its lane to a new claimant while a
    write is pending (a teardown mid-step defers the lane's free)."""

    threadsafe = True  # the node runs process() with no lock of its own

    def _init_lanes(self, session_ttl_s: float, prefill_chunk: int, adapters) -> None:
        self.ttl_s = session_ttl_s
        # multi-tenant LoRA registry (None: single-model serving); the lane's
        # slot mirror is what each dispatch hands the forward as its ids
        self.adapters = adapters
        self._session_adapter: Dict[str, str] = {}
        self._lane_slot = [0] * self.lanes  # slot 0 = the zero base adapter
        # dispatches that carried an adapter operand (a tenant lane): each
        # launches the LoRA kernel once per covered projection and layer
        self.adapter_steps = 0
        self.adapter_prefill_steps = 0
        # server-side chunked prefill: a prompt longer than this many tokens
        # ingests as several dispatches, RELEASING the device lock between
        # chunks so co-batched decode windows interleave (0 = off)
        self.prefill_chunk = int(prefill_chunk)
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
        # set by whoever owns the arrival window, so a dropped session's
        # entries still waiting there fail fast instead of racing the lane's
        # next owner
        self.on_drop: Optional[Callable[[str], None]] = None
        # decode dispatches (a single-token step or a K-step window each)
        # and the session tokens they served
        self._batched_steps = 0
        self._batched_tokens = 0
        # paged decode steps by the stamped table width (chain_clamp; a
        # K-step window counts its k): with the lane count it fixes
        # ops.attention.paged_plan's cut
        self._decode_widths: Dict[int, int] = {}

    @property
    def whole(self) -> bool:
        """Tokens in, logits out: the stage is the whole model."""
        return self.spec.is_first and self.spec.is_last

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

    def _lane_for(self, session_id: str, new_ok: bool, protect=()) -> int:
        """The session's lane, or a free one for a new session: with none
        free, the least recently used session with no request in flight
        (and not in `protect`) is evicted."""
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
            victims = [s for s in self._sessions if not self._inflight.get(s) and s not in protect]
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
        # fail entries still waiting in the window: a later flush must never
        # write this lane for the old session once a new claimant may own it
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

        Paged extras: `ensure_upto` (a decode item: its step or K-step
        window writes positions [start_pos, ensure_upto)) allocates the
        lane's chain to cover them and makes every block from start_pos on
        writable, queueing copy-on-write splits of shared ones for the
        device lock to apply: a write must never scribble on blocks other
        lanes or the prefix index still read. A restart releases the old
        chain block by block, and a replay rollback splits the same way."""
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
            self.pool.make_writable(lane, start_pos, owner=owner)
        self._inflight[session_id] = 1
        return lane

    def _admit_decode_locked(self, sid: str, payload: Dict[str, Any], taken) -> Served:
        """Validate and admit one decode item (under self._mu): a single-token
        step, or with `decode_steps` a K-step window (whole-model stages
        only). Raises what rejects it; returns its Served tuple with index 0."""
        x, start_pos, real_len = self._parse(payload)
        nm = payload.get("adapter")
        if nm is not None and (self.adapters is None or self._session_adapter.get(sid) != str(nm)):
            # decode steps are mid-session: the binding happened at admission,
            # and a mismatch is a routing bug, never served with other weights
            raise ValueError(
                f"session {sid}: decode-step adapter {nm!r} does not match the admitted binding")
        if real_len != 1 or start_pos <= 0:
            raise ValueError(
                "process_batch co-batches single-token decode steps only "
                f"(real_len={real_len}, start_pos={start_pos})"
            )
        ks = parse_kstep(payload, self.max_len - start_pos)
        if ks is not None and self._decode_k_fn is None:
            raise ValueError(
                "decode_steps requires a single-stage (whole-model) topology — "
                "pipeline stages relay per token")
        if sid in taken:
            raise ValueError(f"session {sid}: concurrent request (two steps in one window)")
        lane = self._admit_locked(sid, start_pos, 1, new_ok=False,
                                  ensure_upto=start_pos + (ks["k"] if ks else 1))
        taken.add(sid)
        return (0, sid, lane, x, start_pos, ks)

    # -- device steps (call under self._dev_lock) ----------------------------

    def _sync_paged(self) -> Tuple[PagedKVCache, torch.Tensor]:
        """core.cache.sync_paged over this executor's state (under the
        device lock): (the cache, its queued CoW copies applied; the table
        at the chain_clamp width, staged on the host)."""
        self.cache, table = sync_paged(self.pool, self.cache, self._mu)
        return self.cache, table

    def _count_width(self, table: torch.Tensor, steps: int) -> None:
        width = int(table.shape[1])
        with self._mu:
            self._decode_widths[width] = self._decode_widths.get(width, 0) + steps

    def _decode_all(self, xs, lens: np.ndarray, active: np.ndarray, ads=None) -> torch.Tensor:
        """One co-batched decode step over EVERY lane (core/batch.lane_step,
        through the subclass's `_lane_step`): [L, V] logits or [L, 1, H]
        hidden on the device, a graph's static output on a card: read it
        before the next step. The queued CoW copies and the decode_widths
        count stay on the host side, before the replay."""
        if self.pool is None:
            return self._lane_step(xs, lens, active, None, ads)
        _cache, table = self._sync_paged()
        self._count_width(table, 1)
        return self._lane_step(xs, lens, active, table, ads)

    def _prefill_lane(self, xd: torch.Tensor, lane: int, start: int, n: int,
                      ads=None) -> torch.Tensor:
        """Chunk-ingest ONE lane (core/batch.lane_prefill, through the
        subclass's `_lane_prefill`); paged, through the lane's own table
        row, as wide as this chunk can reach."""
        row = None
        if self.pool is not None:
            width = min(self.pool.blocks_for(start + xd.shape[1]), self.pool.max_blocks)
            with self._mu:
                row = self.pool.table[lane:lane + 1, :width].copy()
        return self._lane_prefill(xd, lane, start, n, row, ads)

    def _serve_decodes(self, served: List[Served], out: List[Any]) -> None:
        """Run a window's admitted decode items (under the device lock): the
        single-token items as ONE co-batched step, then one fused K-step
        window per sampling config. Failure isolation is per dispatch: a
        dispatch that raises fails only its own items (out[i] = the
        exception) and the others run; nothing is donated, so the buffers
        stay valid (the reference's `cache_intact` has nothing to check)."""
        legacy = [s for s in served if s[5] is None]
        if legacy:
            try:
                self._run_legacy(legacy, out)
            except Exception as e:
                for s in legacy:
                    out[s[0]] = e
        groups: Dict[tuple, List[Served]] = {}
        for s in served:
            if s[5] is not None:
                groups.setdefault(s[5]["sampling"], []).append(s)
        for grp in groups.values():
            try:
                self._run_kstep_group(grp, out)
            except Exception as e:
                for s in grp:
                    out[s[0]] = e

    def _run_legacy(self, legacy: List[Served], out: List[Any]) -> None:
        with self._mu:
            lens = np.asarray(self.lengths, np.int64)
            slot_ids = list(self._lane_slot)
        ads = self._ads(slot_ids, staged=True)
        active = np.zeros((self.lanes,), bool)
        if self.spec.is_first:
            xs = torch.zeros((self.lanes, 1), dtype=torch.int64)
        else:
            # the wire's dtype cast to the stage's (bf16 stays bf16)
            h = legacy[0][3].shape[-1]
            xs = torch.zeros((self.lanes, 1, h), dtype=self.cfg.torch_dtype)
        for _i, _sid, lane, x, _sp, _ks in legacy:
            xs[lane] = _as_tensor(x)[0]
            active[lane] = True
        with torch.no_grad():
            res = self._decode_all(xs, lens, active, ads).cpu()  # before the next replay
        with self._mu:
            for _i, _sid, lane, _x, _sp, _ks in legacy:
                self.lengths[lane] += 1
            self._batched_steps += 1
            self._batched_tokens += len(legacy)
            self.adapter_steps += ads is not None
        key = "logits" if self.spec.is_last else "hidden"
        for i, _sid, lane, _x, sp, _ks in legacy:
            out[i] = {key: res[lane:lane + 1], "real_len": 1, "start_pos": sp}

    def _run_kstep_group(self, grp: List[Served], out: List[Any]) -> None:
        """One sampling group's K-step items as one fused window
        (runtime/executor.fuse_kstep_group): every lane its own key, eos and
        active flag, the dense slab at the lanes' bound (the whole buffer,
        core/batch), a paged pool through the table stamped after every
        item's chain was ensured and made writable up to its fill + k."""
        with self._mu:
            lens = list(self.lengths)
            slot_ids = list(self._lane_slot)
        ads = self._ads(slot_ids, staged=True)
        cache = self.cache
        if self.pool is not None:
            cache, table = self._sync_paged()
            self._count_width(table, min(s[5]["k"] for s in grp))
            cache = PagedKVCache(k=cache.k, v=cache.v, table=table)
        with torch.no_grad():
            kg, seq, n_new, nkeys, _ = fuse_kstep_group(
                self._decode_k_fn, self.params, cache, lens, self.lanes,
                [(lane, int(np.asarray(x).reshape(-1)[0]), ks) for _i, _sid, lane, x, _sp, ks in grp],
                ads=ads, graphs=self.graphs, kv_bound=self.max_len)
        for s in grp:
            if not 1 <= n_new[s[2]] <= kg:  # an active row commits its first step at least
                raise RuntimeError(f"K-step window of {kg} committed {int(n_new[s[2]])} "
                                   f"tokens on lane {s[2]}")
        with self._mu:
            for _i, _sid, lane, _x, _sp, _ks in grp:
                self.lengths[lane] += int(n_new[lane])
            self._batched_steps += 1
            # tokens, not items: a K-step item served n of them
            self._batched_tokens += int(sum(n_new[s[2]] for s in grp))
            self.adapter_steps += ads is not None
        for i, _sid, lane, _x, sp, _ks in grp:
            n = int(n_new[lane])
            out[i] = {"tokens": [seq[:n, lane].tolist()], "real_len": n, "decode_steps": kg,
                      "start_pos": sp, "key": nkeys[lane].tolist()}

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
            raise ValueError(f"lane executor expects [1, S(, H)], got {tuple(x.shape)}")
        real_len = int(payload.get("real_len", x.shape[1]))
        return x, start_pos, real_len

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
            if self.pool is not None and self.whole and start_pos == 0:
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
                        res = self._prefill_lane(host_to_device(padded, self.device), lane, pos,
                                                 n, ads)
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
        lanes only. Returns the pinned token coverage (full blocks)."""
        if self.pool is None or not self.whole:
            raise ValueError("pin_prefix needs paged KV on a whole-model stage")
        ids = list(prefixlib.normalize_ids(prefix_ids))
        if not ids:
            raise ValueError("prefix ids must be non-empty")
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

    def prefix_digest(self) -> Optional[Dict[str, Any]]:
        """The gossip-ready digest of the pool's hot prefix index
        (prefix.make_digest over BlockPool.digest_keys: pinned entries first,
        then the most recently used), the record's `pfx` that entry routers
        score cache affinity against. None on the dense layout, on a stage
        that is not the whole model (its index keys hash token ids it never
        sees: an inner stage's are hidden rows) and for an empty index: the
        key is then left out of the record, never sent empty."""
        if self.pool is None or not (self.spec.is_first and self.spec.is_last):
            return None
        with self._mu:
            keys = self.pool.digest_keys(prefixlib.DIGEST_GOSSIP_KEYS)
            bs = self.pool.block_size
        if not keys:
            return None
        return prefixlib.make_digest(keys, bs)

    # -- session fork (paged) -------------------------------------------------

    def fork_session(self, new_session_id: str, parent_session_id: str, prefix_len: int) -> bool:
        """Seed a new session with the parent's first `prefix_len` positions
        on the paged layout: the parent's full blocks map READ-ONLY into the
        child's lane (refcounts raised, copy-on-write at a divergent write)
        and only the partial tail block is copied, queued for the next
        dispatch's sync (core.cache.BlockPool.fork_lane), which every
        dispatch that reads the lane runs first. False on every miss, and
        the caller prefills in full: no pool (the dense stage lanes, as in
        the reference), an unknown or short parent, a parent bound to an
        adapter (the fork admits the child without one: decoding tenant KV
        on the base weights would diverge silently), no lane free of
        in-flight work (the parent is never evicted for its child), no
        block for the tail."""
        if self.pool is None or prefix_len <= 0:
            return False
        with self._mu:
            if self._session_adapter.get(parent_session_id):
                return False
            plane = self._sessions.get(parent_session_id)
            if (plane is None or self.lengths[plane] < prefix_len
                    or new_session_id in self._sessions):
                return False
            try:
                lane = self._lane_for(new_session_id, new_ok=True, protect=(parent_session_id,))
            except CapacityError:
                return False
            try:
                self.pool.fork_lane(plane, lane, prefix_len,
                                    owner=f"session {new_session_id}, lane {lane}")
            except BufferError:
                self._drop_locked(new_session_id)
                return False
            self.lengths[lane] = prefix_len
        return True

    def anatomy_target(self):
        raise NotImplementedError("the live step anatomy is not ported yet: ROADMAP A9")

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

    def ids(self) -> List[str]:
        """Live session ids."""
        with self._mu:
            return list(self._sessions)

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

    def lane_stats(self) -> Dict[str, Any]:
        """The stats both lane executors report: lanes, co-batched decode
        dispatches and the tokens they served, prefill dispatches, KV
        occupancy, graphs, the adapter registry's and the block pool's."""
        occupancy, paged = self.kv_occupancy(), self.block_stats()
        with self._mu:
            steps, toks = self._batched_steps, self._batched_tokens
            out: Dict[str, Any] = {
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


class BatchedStageExecutor(LaneExecutor):
    """Lane-slotted multi-session executor for one pipeline stage.

    Node executor contract: process(session_id, payload) -> {"hidden":
    [1, S, H]} or {"logits": [1, V]} (+ start_pos/real_len), as CPU tensors;
    end_session(session_id). Extra surface: process_batch(items), the
    node's window flush callback, runs every item's decode step in ONE
    device dispatch (plus one per K-step sampling group) and returns
    per-item results (an exception per item, never batch-wide, so one bad
    session cannot fail its co-batch)."""

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
        # co-batched decode steps and K-step windows as graph replays on a
        # card, eager on the CPU; set to None for the eager steps on a card
        # too (the reference the graphs are held to)
        self.graphs: Optional[GraphCache] = (
            GraphCache(max_graphs=LANE_GRAPHS, device=self.device)
            if self.device.type == "cuda" else None)
        # K-step items: a whole-model stage only (a pipeline stage's next
        # token depends on every other stage)
        self._decode_k_fn = (qwen3.make_decode_k_serve(cfg)
                             if spec.is_first and spec.is_last else None)
        self._init_lanes(session_ttl_s, prefill_chunk, adapters)

    def _lane_step(self, xs, lens, active, table, ads):
        return lane_step(self.graphs, self.params, self.cfg, self.cache, xs, lens,
                         first=self.spec.is_first, last=self.spec.is_last, active=active,
                         table=table, ads=ads)

    def _lane_prefill(self, xd, lane, start, n, table_row, ads):
        return lane_prefill(self.params, self.cfg, self.cache, xd, lane, start, n,
                            first=self.spec.is_first, last=self.spec.is_last,
                            table_row=table_row, layer_offset=self.spec.start_layer, ads=ads)

    def process_batch(
        self,
        items: List[Tuple[str, Dict[str, Any]]],
        drain: Optional[Callable[[], List[Tuple[str, Dict[str, Any]]]]] = None,
    ) -> List[Any]:
        """ONE co-batched device step for every item's single-token decode,
        and one fused window per sampling config of its K-step items.

        items: [(session_id, payload)], each a decode step ({"tokens":
        [1, 1]} or {"hidden": [1, 1, H]}, start_pos > 0, real_len == 1),
        optionally carrying "decode_steps" (+ sampling, eos, key or seed:
        parse_kstep) on a whole-model stage. Returns a list aligned with
        `items` (plus any drained extras, appended in drain order): a result
        dict per served item, or the Exception that rejected it.

        `drain` (optional) is called once the DEVICE LOCK is held and may
        return more items to fold into the same step (continuous batching:
        entries that arrived while the previous step ran join this one)."""
        out: List[Any] = [None] * len(items)
        served: List[Served] = []
        taken: set = set()

        def admit(batch_items, base: int) -> None:
            """Validate and mark each item (under self._mu)."""
            for j, (sid, payload) in enumerate(batch_items):
                try:
                    served.append((base + j,) + self._admit_decode_locked(sid, payload, taken)[1:])
                except Exception as e:  # per-item rejection
                    out[base + j] = e

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
                if served:
                    self._serve_decodes(served, out)
        except Exception as e:
            for s in served:
                if out[s[0]] is None:
                    out[s[0]] = e
        finally:
            with self._mu:
                for _i, sid, lane, _x, _sp, _ks in served:
                    self._finish_locked(sid, lane)
        return out

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Single-session contract: prefill chunks run per lane; a decode
        step (or K-step window) is a co-batch of one (the node's window is
        where decode steps actually coalesce)."""
        _x, start_pos, real_len = self._parse(payload)
        if real_len == 1 and start_pos > 0:
            res = self.process_batch([(session_id, payload)])[0]
            if isinstance(res, Exception):
                raise res
            return res
        return self._prefill_solo(session_id, payload, start_pos, real_len)

    def stats(self) -> Dict[str, Any]:
        return {"mode": "stage_batched", "stage": self.spec.stage, **self.lane_stats()}
