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

Not ported: lane-batched speculation (`enable_spec` raises, ROADMAP A7),
session fork, export and import (A4d) and `anatomy_target` (A9).
"""

from __future__ import annotations

from typing import Any, Dict

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core.batch import BatchedEngine
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime.stage_batch import CapacityError, LaneExecutor
from inferd_tpu_torch.runtime.window import WindowedBatcher

__all__ = ["BatchedExecutor", "CapacityError"]

Params = Dict[str, Any]


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

    def stats(self) -> Dict[str, Any]:
        """Co-batching as LaneExecutor counts it (decode dispatches and the
        tokens they served), and the window's own: batches taken and tokens
        in them."""
        return {"mode": "batched", **self.lane_stats(), "window": self._batcher.stats()}

