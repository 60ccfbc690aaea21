"""Whole-model continuous batching behind a node: concurrent sessions'
decode steps coalesce into ONE device step (port of
inferd_tpu/runtime/batch_executor.py, `run_node --batch-lanes N`).

The executor keeps the node's `/forward` contract with client-side
sampling (logits out), maps sessions to lanes of a core.batch.
BatchedEngine and runs the single-token decode steps of whichever sessions
arrive within a short window as one step of all the lanes: the weights
are read once per step, not once per session. It is the whole model, so
it is the first and the last stage of a one-stage topology (relay mode
works as for `--stage-lanes`: the model is stage 0 and final).

Unlike the pipeline stage's lane executor, whose node owns the arrival
window, this executor owns its window (runtime/window.WindowedBatcher, a
plain `window_ms` wait with no gang target): `process()` co-batches by
itself, from the node's worker threads, with no node in between, and the
node wraps it in no window of its own. Each thread admits its item (lane,
chain, adapter binding) before it joins the window; a flusher that holds
the device lock drains every entry pending then (the reference's
swap-at-wake-up flush is not ported: runtime/window says why) and runs
them as one batch: the single-token items as one step, then one fused
K-step window per sampling config (`decode_steps` items,
runtime/executor.fuse_kstep_group over models/qwen3.decode_k), a failure
failing only its own dispatch's items. `batched_tokens` and the window's
`n_served` count tokens, not items.

Prefill chunks run per lane under the device lock, RELEASED between
`prefill_chunk`-token chunks; with paged KV a prompt's full blocks map
read-only from the pool's prefix index (salted by the session's adapter)
instead of being recomputed. All of that, and the lane bookkeeping, is
runtime/stage_batch.LaneExecutor, shared with the stage executor; the
device steps here are the BatchedEngine's serving entries.

On a card every decode step and K-step window replays a captured CUDA
graph (the engine's GraphCache); `graphs = None` gives the eager steps.

Sessions that move: `fork_session` forks a parent lane's prefix, on the
paged layout block by block (runtime/stage_batch.LaneExecutor) and on the
dense one by a device copy of the prefix into the child's lane;
`export_sessions` ships live sessions as runtime/handoff payloads (a paged
session gathered through its chain, one gather and one transfer per
session, into the dense schema, so paged and dense replicas exchange
sessions freely), stamped with the session's `adapter`; `import_session`
adopts one into a free lane (paged: a fresh chain), binding the tenant's
adapter slot or declining; `export_session_delta` ships a session's KV
past a replication frontier (runtime/repl): paged, the full blocks past it
through the chain; dense, the slab's new slots. Not ported: lane-batched
speculation (`enable_spec` raises, ROADMAP A7) and `anatomy_target` (A9).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core.batch import BatchedEngine
from inferd_tpu_torch.core.cache import host_to_device, kv_to_host
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime import handoff
from inferd_tpu_torch.runtime.repl import START_KEY
from inferd_tpu_torch.runtime.stage_batch import CapacityError, LaneExecutor
from inferd_tpu_torch.runtime.window import WindowedBatcher

__all__ = ["BatchedExecutor", "CapacityError"]

Params = Dict[str, Any]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte (fp8) tensor as its uint8 view, others as they are: indexed
    gathers and writes have no fp8 kernel on every build."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


class BatchedExecutor(LaneExecutor):
    """Whole-model, lane-per-session executor with windowed decode batching.

    Node executor contract: process(session_id, payload) -> {"logits":
    [1, V], "real_len", "start_pos"} (a K-step item: {"tokens", "real_len",
    "decode_steps", "start_pos", "key"}); end_session(session_id)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        lanes: int = 8,
        max_len: int = 4096,
        window_ms: float = 3.0,
        session_ttl_s: float = 600.0,
        block_size: int = 0,
        kv_blocks: int = 0,
        prefill_chunk: int = 0,
        adapters=None,
        device=None,
    ):
        self.engine = BatchedEngine(cfg, params, lanes=lanes, max_len=max_len,
                                    block_size=block_size, kv_blocks=kv_blocks, device=device)
        self.cfg = cfg
        self.spec = StageSpec(0, 1, 0, cfg.num_layers - 1)
        self.params = params
        self.device = self.engine.device
        self.lanes = lanes
        self.max_len = max_len
        # the lane state is the engine's (the same objects)
        self.lengths = self.engine.lengths
        self.free = self.engine.free
        self.pool = self.engine.pool
        self._decode_k_fn = self.engine._decode_k_serve
        self._init_lanes(session_ttl_s, prefill_chunk, adapters)
        self.delta_lock_ms: Optional[float] = None  # the last delta export's device-lock hold
        self._batcher = WindowedBatcher(
            window_ms / 1e3, self._run_decode_batch,
            # a solo session should not pay the window
            co_possible=self.co_possible)
        self.on_drop = lambda sid: self._batcher.invalidate(
            lambda payload, _sid=sid: payload[1] == _sid,
            ValueError(f"session {sid} ended mid-request"))

    @property
    def cache(self):
        return self.engine.cache

    @cache.setter
    def cache(self, value) -> None:
        self.engine.cache = value

    @property
    def graphs(self):
        return self.engine.graphs

    @graphs.setter
    def graphs(self, value) -> None:
        self.engine.graphs = value

    def enable_spec(self, draft_layers: int, k: int) -> None:
        raise NotImplementedError(
            "lane-batched speculation (--spec-draft-layers) is not ported yet: ROADMAP A7")

    # -- the engine's serving entries behind LaneExecutor's hooks ------------

    def _lane_step(self, xs, lens, active, table, ads):
        if table is None:
            return self.engine._decode_logits(xs, lens, ads=ads)
        return self.engine._decode_logits_paged(xs, lens, active, table, ads=ads)

    def _lane_prefill(self, xd, lane, start, n, table_row, ads):
        if table_row is None:
            return self.engine._prefill_lane_logits(xd, lane, start, n, ads=ads)
        return self.engine._prefill_lane_logits_paged(xd, table_row, start, n, ads=ads)

    # -- executor contract ---------------------------------------------------

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A prefill chunk runs per lane; a decode step (or `decode_steps`
        window) is admitted here and joins the window, whose flusher serves
        every entry it holds as one batch."""
        _x, start_pos, real_len = self._parse(payload)
        if not (real_len == 1 and start_pos > 0):
            return self._prefill_solo(session_id, payload, start_pos, real_len)
        # a decode step is mid-session: its adapter key (if any) must match
        # the binding, which _admit_decode_locked checks
        with self._mu:
            item = self._admit_decode_locked(session_id, payload, set())
        try:
            return self._batcher.submit(item)
        finally:
            with self._mu:
                self._finish_locked(session_id, item[2])

    def _run_decode_batch(self) -> None:
        """The window's flush (no locks held): take the device, drain every
        pending entry, and serve them under ONE device-lock hold
        (LaneExecutor._serve_decodes); each entry gets its result or its
        own dispatch's error, and its event. The window counted one unit
        per entry: a K-step entry served its n tokens, a failed one none."""
        with self._dev_lock:
            entries = self._batcher.drain_pending()
            out = [None] * len(entries)
            try:
                self._serve_decodes([(i,) + e.payload[1:] for i, e in enumerate(entries)], out)
            finally:
                served_tokens = 0
                for e, res in zip(entries, out):
                    if isinstance(res, Exception) or res is None:
                        e.error = res or RuntimeError("decode window dropped an entry")
                    else:
                        e.result = res
                        served_tokens += res["real_len"]
                    e.event.set()
                self._batcher.count_served(served_tokens - len(entries))

    # -- sessions that move (runtime/handoff) ---------------------------------

    def fork_session(self, new_session_id: str, parent_session_id: str, prefix_len: int) -> bool:
        """Seed a new session's lane with the parent lane's first `prefix_len`
        slots: paged, block by block (LaneExecutor.fork_session); dense, a
        device copy of those slots into a lane claimed
        without evicting the parent. False on any miss (an unknown, short
        or tenant parent; no claimable lane): the caller prefills in full."""
        if self.pool is not None:
            return super().fork_session(new_session_id, parent_session_id, prefix_len)
        if prefix_len <= 0:
            return False
        with self._dev_lock:  # the lock order of _prefill_solo
            with self._mu:
                if self._session_adapter.get(parent_session_id):
                    return False
                plane = self._sessions.get(parent_session_id)
                if (plane is None or self.lengths[plane] < prefix_len
                        or new_session_id in self._sessions):
                    return False
                try:
                    lane = self._lane_for(new_session_id, new_ok=True,
                                          protect=(parent_session_id,))
                except CapacityError:
                    return False
                # in flight while the copy runs outside _mu: a concurrent
                # claim must not evict the child and take its lane mid-fork
                self._inflight[new_session_id] = 1
            try:
                self.engine.fork_lane(plane, lane, prefix_len)
                with self._mu:
                    self.lengths[lane] = prefix_len
            finally:
                with self._mu:
                    self._finish_locked(new_session_id, lane)
        return True

    def export_sessions(self, only: Optional[str] = None):
        """Live sessions' lane KV as handoff payloads [(sid, payload)] (`only`:
        one session), read with the device quiet: a paged pool's queued
        copies (a fork's tail, a CoW split) land first, or the export would
        read blocks not yet written. A paged session is gathered through its
        chain on the device (never the whole pool to the host) into the dense
        schema; every session's K/V reach the host in one transfer."""
        out = []
        with self._dev_lock, torch.no_grad():
            if self.pool is not None:
                self._sync_paged()
            with self._mu:
                for sid, lane in list(self._sessions.items()):
                    if only is not None and sid != only:
                        continue
                    n = self.lengths[lane]
                    if n == 0:
                        continue
                    cache = self.cache
                    if self.pool is None:
                        k, v = cache.k[:, lane:lane + 1, :n], cache.v[:, lane:lane + 1, :n]
                    else:
                        k, v = (x[:, :, :n] for x in
                                self._chain_kv(lane, 0, self.pool.blocks_for(n)))
                    k, v = kv_to_host(k, v)
                    out.append((sid, self._stamp_adapter(sid, handoff.encode(k, v, n))))
        return out

    def _chain_kv(self, lane: int, lo: int, hi: int):
        """K and V of blocks [lo, hi) of a paged lane's chain, [L, 1, (hi -
        lo) x block_size, Nkv, D] on the device: one gather of just those
        blocks, never the whole pool to the host."""
        cache = self.cache
        chain = host_to_device(self.pool.table[lane, lo:hi].astype(np.int64), cache.k.device)
        return tuple(_bytes(pool)[:, chain].view(pool.dtype)
                     .reshape(pool.shape[0], 1, -1, *pool.shape[3:])
                     for pool in (cache.k, cache.v))

    def _stamp_adapter(self, sid: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Ride the session's adapter binding on its payload (caller holds
        _mu): the importer binds the tenant's adapter or declines; a base
        session's payload gains no key."""
        name = self._session_adapter.get(sid)
        if name is not None:
            payload["adapter"] = name
        return payload

    def session_lengths(self) -> Dict[str, int]:
        """{session_id: committed KV length} of the live lanes: what a drain
        compares after its snapshot flew (no KV is read)."""
        with self._mu:
            return {sid: int(self.lengths[lane]) for sid, lane in self._sessions.items()
                    if self.lengths[lane] > 0}

    def export_session_delta(self, session_id: str, since: int):
        """The incremental export of standby replication (runtime/repl): the
        handoff payload of the session's slots [since, length) plus
        START_KEY, stamped with its adapter, or None when there is nothing
        new. A PAGED lane ships exactly the full blocks past the frontier
        (the tail block is still being written: it ships once it fills, so a
        standby's loss is bounded by block_size on top of the tick), a
        foreign frontier realigned down to a block boundary, gathered
        through its chain on the device after the queued copies land; a
        dense lane ships its slab delta. The nothing-new check takes _mu
        alone: a tick polls every resident session and must not contend for
        the device lock to learn that no block or slot completed. The device
        lock's hold is kept in `delta_lock_ms` (the node's `repl.lock_ms`)."""
        since = max(0, int(since))
        with self._mu:
            lane = self._sessions.get(session_id)
            if lane is None:
                return None
            n = int(self.lengths[lane])
            if self.pool is not None:
                bs = self.pool.block_size
                if (n // bs) * bs <= (since // bs) * bs:
                    return None
            elif n <= since:
                return None
        with self._dev_lock, torch.no_grad():
            t0 = time.perf_counter()
            if self.pool is not None:
                self._sync_paged()  # queued copies (a fork's tail, a CoW split) land first
            with self._mu:
                lane = self._sessions.get(session_id)
                if lane is None:
                    return None
                n = int(self.lengths[lane])
                cache = self.cache
                if self.pool is None:
                    if n <= since:
                        return None
                    end = n
                    k, v = cache.k[:, lane:lane + 1, since:n], cache.v[:, lane:lane + 1, since:n]
                else:
                    bs = self.pool.block_size
                    since = (since // bs) * bs  # a foreign frontier restarts block-aligned
                    end = (n // bs) * bs
                    if end <= since:
                        return None
                    k, v = self._chain_kv(lane, since // bs, end // bs)
                k, v = kv_to_host(k, v)
                payload = self._stamp_adapter(session_id, handoff.encode(k, v, end))
            self.delta_lock_ms = (time.perf_counter() - t0) * 1e3
        payload[START_KEY] = since
        return payload

    def import_session(self, session_id: str, payload: Dict[str, Any]) -> bool:
        """Adopt a shipped session into a free lane (a same-model replica;
        runtime/handoff.decode fails closed on any mismatch BEFORE a lane is
        claimed). A tenant payload (`adapter`) binds the tenant's registry
        slot (hot-loading it, before any executor lock) or declines: an
        adopted tenant session must never resume on the base weights. Dense:
        the K/V are copied into the lane's row; paged: a fresh chain is
        allocated and the K/V scattered into its blocks. Never replaces a
        live session of the same id; a failure midway drops the half-adopted
        lane."""
        dec = handoff.decode(payload, self.cfg, self.cfg.num_layers, self.max_len)
        if dec is None:
            return False
        ad_name = payload.get("adapter")
        if ad_name is not None:
            if self.adapters is None:
                return False
            ad_name = str(ad_name)
            try:
                self.adapters.acquire(ad_name)
            except Exception:
                return False
        k, v, n = dec["k"], dec["v"], dec["n"]
        with self._dev_lock, self._mu, torch.no_grad():
            if session_id in self._sessions:
                lane = None
            else:
                try:
                    lane = self._lane_for(session_id, new_ok=True)
                except CapacityError:
                    lane = None
            if lane is None:
                if ad_name is not None:
                    self.adapters.release(ad_name)
                return False
            if ad_name is not None:  # bound first: the rollback's drop releases it
                self._session_adapter[session_id] = ad_name
                self._lane_slot[lane] = self.adapters.slot_of(ad_name)
            try:
                self._write_lane(lane, k[:, 0, :n], v[:, 0, :n], n, session_id)
            except Exception:
                self._drop_locked(session_id)
                return False
            self.lengths[lane] = n
        return True

    def _write_lane(self, lane: int, k: torch.Tensor, v: torch.Tensor, n: int,
                    session_id: str) -> None:
        """An adopted session's K/V [L, n, Nkv, D] into its lane (under the
        device lock and _mu): the dense row's first n slots, or a fresh
        chain's blocks, padded to whole blocks, in one indexed write."""
        cache = self.cache
        if self.pool is None:
            cache.k[:, lane, :n] = k.to(cache.k.device)
            cache.v[:, lane, :n] = v.to(cache.v.device)
            return
        self.pool.ensure(lane, n, owner=f"session {session_id}, lane {lane}")
        bs, nb = self.pool.block_size, self.pool.blocks_for(n)
        chain = host_to_device(self.pool.table[lane, :nb].astype(np.int64), cache.k.device)
        for pool, x in ((cache.k, k), (cache.v, v)):
            blocks = torch.zeros((x.shape[0], nb * bs, *x.shape[2:]), dtype=pool.dtype,
                                 device=pool.device)
            blocks[:, :n] = x.to(pool.device)
            _bytes(pool)[:, chain] = _bytes(blocks.reshape(x.shape[0], nb, bs, *x.shape[2:]))

    def stats(self) -> Dict[str, Any]:
        """Co-batching as LaneExecutor counts it (decode dispatches and the
        tokens they served), and the window's own: batches taken and tokens
        in them."""
        return {"mode": "batched", **self.lane_stats(), "window": self._batcher.stats()}

