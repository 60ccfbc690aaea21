"""Stage executor: one pipeline stage's cached forward per session (port of
inferd_tpu/runtime/executor.py).

The compute half of a node. As in the JAX package:

  * one preallocated KV cache per session, bucket-grown on demand and
    LRU/TTL-evicted by SessionStore;
  * prompt chunks padded to power-of-two buckets (core.generate.bucket_len),
    so both packages write the same KV slots; padding rows write garbage
    past the real tokens, which causal masking hides and the next chunk
    overwrites;
  * a chunk starting before the session frontier is a deterministic replay:
    the cache rolls back to the chunk start and recomputes;
  * the non-last stages ship only the chunk's real rows of hidden state,
    the last stage ships float32 logits of the last real token.

The caches are written IN PLACE (the JAX package donates them to its jitted
step for the same effect), so a step that fails midway leaves its partial
KV writes behind; the session frontier only advances on success, and the
slots past it are rewritten by the next step.

`make_executor` routes `--stage-lanes` to the lane-slotted executor of
runtime/stage_batch.py. Not ported in this slice: fused K-step decode
(`decode_steps`, which the JAX package serves on single-stage topologies
only), ring high-water marks, session fork/export/import and the counter
backend.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core.cache import KVCache, grow
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import StageSpec


class SessionStore:
    """session_id -> KVCache with LRU eviction and idle TTL."""

    def __init__(self, max_sessions: int = 64, ttl_s: float = 600.0):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._caches: Dict[str, KVCache] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._last_used: Dict[str, float] = {}

    def lock_for(self, session_id: str) -> threading.Lock:
        with self._lock:
            if session_id not in self._locks:
                self._locks[session_id] = threading.Lock()
            return self._locks[session_id]

    def get(self, session_id: str) -> Optional[KVCache]:
        with self._lock:
            c = self._caches.get(session_id)
            if c is not None:
                self._last_used[session_id] = time.monotonic()
            return c

    def put(self, session_id: str, cache: KVCache) -> None:
        with self._lock:
            self._caches[session_id] = cache
            self._last_used[session_id] = time.monotonic()
            self._evict_locked()

    def drop(self, session_id: str) -> None:
        with self._lock:
            self._caches.pop(session_id, None)
            self._locks.pop(session_id, None)
            self._last_used.pop(session_id, None)

    def kv_bytes(self) -> int:
        """Total bytes of live session KV buffers."""
        with self._lock:
            return sum(c.nbytes for c in self._caches.values())

    def sweep(self) -> int:
        """Drop sessions idle for > ttl_s; returns the count dropped."""
        now = time.monotonic()
        with self._lock:
            stale = [s for s, t in self._last_used.items() if now - t > self.ttl_s]
            for s in stale:
                self._caches.pop(s, None)
                self._locks.pop(s, None)
                self._last_used.pop(s, None)
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._caches)

    def __contains__(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._caches

    def _evict_locked(self) -> None:
        while len(self._caches) > self.max_sessions:
            oldest = min(self._last_used, key=self._last_used.get)
            self._caches.pop(oldest, None)
            self._locks.pop(oldest, None)
            self._last_used.pop(oldest, None)


def _as_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


class Qwen3StageExecutor:
    """Executes one pipeline stage of a Qwen3-family model on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        spec: StageSpec,
        stage_params: Dict[str, Any],
        max_len: int = 4096,
        max_sessions: int = 64,
        session_ttl_s: float = 600.0,
        initial_kv_len: int = 256,
    ):
        qwen3.check_supported(cfg)
        self.cfg = cfg
        self.spec = spec
        self.params = stage_params
        self.device = next(iter(stage_params["layers"].values())).device
        self.max_len = max_len
        self.initial_kv_len = initial_kv_len
        self.sessions = SessionStore(max_sessions, session_ttl_s)

    # -- session cache management ------------------------------------------

    def _cache_for(self, session_id: str, real_len: int, padded_len: int) -> KVCache:
        """Cache with room for the PADDED chunk write (the forward writes
        padded_len rows). The real-token budget is capped at max_len."""
        needed = max(real_len, padded_len)
        cache = self.sessions.get(session_id)
        if cache is None:
            cache = KVCache.create(
                self.cfg, self.spec.num_layers, 1,
                max(self.initial_kv_len, bucket_len(needed)), device=self.device,
            )
        if cache.length + real_len > self.max_len:
            raise BufferError(
                f"session {session_id}: KV overflow ({cache.length}+{real_len} > {self.max_len})"
            )
        if cache.length + needed > cache.max_len:
            cache = grow(cache, bucket_len(cache.length + needed))
        return cache

    @staticmethod
    def _rollback_for(session_id: str, cache: KVCache, start_pos: int) -> int:
        """The write position for a chunk starting at start_pos: the frontier,
        or, for a REPLAY (a chunk starting before it), the chunk start."""
        cur = cache.length
        if start_pos == cur:
            return cur
        if not 0 <= start_pos < cur:
            raise ValueError(
                f"session {session_id}: start_pos {start_pos} != cache "
                f"length {cur} (out-of-order chunk)"
            )
        return start_pos

    def _run(self, x: torch.Tensor, start_pos: int, cache: KVCache, real_len: int):
        cfg, spec, p = self.cfg, self.spec, self.params
        hidden = qwen3.embed(p, x, cfg) if spec.is_first else x
        hidden, _ = qwen3.forward_layers_cached(
            p["layers"], cfg, hidden, start_pos, cache, start_pos,
            real_end=start_pos + real_len, layer_offset=spec.start_layer,
        )
        if spec.is_last:
            # client-side sampling: float32 logits of the LAST real token only
            last = hidden[:, real_len - 1]
            return {"logits": qwen3.unembed(p, cfg, last[:, None, :])[:, 0]}
        return {"hidden": hidden[:, :real_len]}

    # -- public API ---------------------------------------------------------

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Run this stage for one chunk of one session.

        payload: {"tokens": int32 [B, S]} on stage 0, else {"hidden":
        [B, S, H]}; plus "start_pos" (absolute position of the chunk's first
        token) and optionally "real_len" (rows past it are bucket padding).
        Returns {"hidden"} or, on the last stage, {"logits": [B, V]} as CPU
        tensors, plus the relay metadata "real_len" and "start_pos"."""
        if int(payload.get("decode_steps") or 0) > 0:
            raise ValueError(
                "decode_steps (fused K-step decode) is not ported yet; "
                "send one token per step"
            )
        start_pos = int(payload.get("start_pos", 0))
        if self.spec.is_first:
            x = torch.as_tensor(np.asarray(payload["tokens"], dtype=np.int64))
            real_len = int(payload.get("real_len", x.shape[1]))
            if x.shape[1] > 1:  # prompt chunks pad to a bucket; decode steps do not
                x = F.pad(x, (0, bucket_len(x.shape[1]) - x.shape[1]))
            x = x.to(self.device)
        else:
            x = _as_tensor(payload["hidden"])
            real_len = int(payload.get("real_len", x.shape[1]))
            if x.shape[1] > 1:  # upstream ships real rows only: re-pad locally
                x = F.pad(x, (0, 0, 0, bucket_len(max(x.shape[1], real_len)) - x.shape[1]))
            x = x.to(self.device, self.cfg.torch_dtype)

        with self.sessions.lock_for(session_id), torch.no_grad():
            cache = self._cache_for(session_id, real_len, int(x.shape[1]))
            pos = self._rollback_for(session_id, cache, start_pos)
            out = self._run(x, pos, cache, real_len)
            cache.length = pos + real_len
            self.sessions.put(session_id, cache)
            result: Dict[str, Any] = {k: v.cpu() for k, v in out.items()}
        result["real_len"] = real_len
        result["start_pos"] = start_pos
        return result

    def end_session(self, session_id: str) -> None:
        self.sessions.drop(session_id)

    def stats(self) -> Dict[str, Any]:
        return {"sessions": len(self.sessions), "kv_bytes": self.sessions.kv_bytes()}


def make_executor(
    cfg: ModelConfig,
    spec: StageSpec,
    stage_params: Optional[Dict[str, Any]] = None,
    backend: str = "qwen3",
    stage_lanes: int = 0,
    block_size: int = 0,
    kv_blocks: int = 0,
    prefill_chunk: int = 0,
    adapters=None,
    **kw,
):
    """The stage's executor: with `stage_lanes` > 0 the lane-slotted
    continuous-batching executor (runtime/stage_batch; `block_size` > 0
    pages its KV; `adapters`, a runtime/adapters.AdapterRegistry, serves
    multi-tenant LoRA), else the one-cache-per-session Qwen3StageExecutor.
    Refuses the flag combinations the reference node refuses."""
    if backend != "qwen3":
        raise ValueError(f"executor backend {backend!r} is not ported yet (qwen3 only)")
    if stage_params is None:
        raise ValueError("qwen3 backend needs stage params")
    if block_size > 0 and stage_lanes <= 0:
        raise ValueError(
            "--paged-kv runs on the lane executors: pair it with --stage-lanes"
        )
    if adapters is not None and stage_lanes <= 0:
        raise ValueError(
            "--adapters (multi-tenant batched LoRA) runs on the lane "
            "executors — pair it with --stage-lanes"
        )
    if stage_lanes > 0:
        from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

        return BatchedStageExecutor(
            cfg, spec, stage_params, lanes=stage_lanes, block_size=block_size,
            kv_blocks=kv_blocks, prefill_chunk=prefill_chunk, adapters=adapters, **kw,
        )
    return Qwen3StageExecutor(cfg, spec, stage_params, **kw)
