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

A payload with `decode_steps` K runs K decode steps with on-device
sampling in one window (models/qwen3.decode_k) and returns the tokens it
committed: only a single-stage (whole-model) executor serves it, since a
pipeline stage's next token depends on every other stage.

`make_executor` routes `--stage-lanes` to the lane-slotted executor of
runtime/stage_batch.py. Not ported in this slice: ring high-water marks,
session fork/export/import and the counter backend.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.core.cache import KVCache, device_to_host, grow
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.utils.profiling import span


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


def parse_kstep(payload: Dict[str, Any], budget: int) -> Optional[Dict[str, Any]]:
    """The multi-step decode request of a /forward payload, one parse for
    every executor so the wire contract cannot drift.

    Payload keys: "decode_steps" (K requested), optional "sampling"
    ({temperature, top_k, top_p, min_p}; greedy by default), "eos" (a stop
    token id; absent = none), "key" ([2] uint32, the session's key chain)
    or "seed" (the chain's root when no key rides yet).

    Returns None when the payload asks for no multi-step decode, else
    {"k": K clamped into [1, budget], "sampling": (t, top_k, top_p, min_p),
    "eos": int (-1 = none), "key": uint32 [2]}. A budget below 1 raises
    BufferError."""
    k_req = int(payload.get("decode_steps") or 0)
    if k_req <= 0:
        return None
    if budget < 1:
        raise BufferError(f"KV overflow: no budget for a decode step ({budget})")
    s = payload.get("sampling") or {}
    sampling = (
        float(s.get("temperature", 0.0)),
        int(s.get("top_k", 0)),
        float(s.get("top_p", 1.0)),
        float(s.get("min_p", 0.0)),
    )
    key = payload.get("key")
    if key is None:
        key = samplib.prng_key(int(payload.get("seed", 0) or 0))
    eos = payload.get("eos")
    return {
        "k": max(1, min(k_req, int(budget))),
        "sampling": sampling,
        "eos": -1 if eos is None else int(eos),
        "key": np.asarray(key, np.uint32),
    }


def kstep_hi(start: int, n: int, k: int) -> int:
    """The highest slot a K-step window wrote, plus one: the `n` committed
    writes and, when eos froze the row early, the ONE frozen-frontier slot
    it kept rewriting (a frozen row does not advance). The ring high-water
    mark of sliding-window layers, which wait for the model-families
    slice, is advanced by it."""
    return start + min(n + 1, k)


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
            return self._process_decode_k(session_id, payload)
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
            with span("results.cpu"):
                result: Dict[str, Any] = {k: v.cpu() for k, v in out.items()}
        result["real_len"] = real_len
        result["start_pos"] = start_pos
        return result

    def _process_decode_k(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """K decode steps and their sampling on the device, one host read at
        the end (models/qwen3.decode_k).

        payload: {"tokens": [[last token]], "start_pos", "decode_steps": K}
        plus parse_kstep's optional keys. Returns {"tokens": [[t_0 ..
        t_{n-1}]], "real_len": n (the tokens committed: n < K only when
        `eos` fired inside the window), "decode_steps": the K run (clamped
        to the KV budget), "start_pos", "key": the advanced key chain}. The
        session frontier advances by n; a window starting before the
        frontier is a replay and recomputes from its start."""
        if not (self.spec.is_first and self.spec.is_last):
            raise ValueError(
                "decode_steps requires a single-stage (whole-model) "
                "topology — pipeline stages relay per token"
            )
        toks = np.asarray(payload["tokens"], dtype=np.int64)
        if toks.shape != (1, 1):
            raise ValueError(f"multi-step decode expects tokens [1, 1], got {toks.shape}")
        start_pos = int(payload.get("start_pos", 0))
        if start_pos <= 0:
            raise ValueError("multi-step decode needs an established frontier (start_pos > 0)")
        ks = parse_kstep(payload, self.max_len - start_pos)
        k = ks["k"]
        t, tk, tp, mp = ks["sampling"]
        with self.sessions.lock_for(session_id), torch.no_grad():
            cache = self._cache_for(session_id, 1, 1)
            self._rollback_for(session_id, cache, start_pos)  # a replay restarts at start_pos
            if start_pos + k > cache.max_len:
                cache = grow(cache, bucket_len(start_pos + k))
            cache, seq, n_new, nkey, _lps, _tis, _tls = qwen3.decode_k(
                self.params, self.cfg, toks[0], cache, [start_pos], [True], ks["key"][None],
                k, temperature=t, top_k=tk, top_p=tp, min_p=mp, eos=ks["eos"],
            )
            seq, n_new = device_to_host(seq[:, 0], n_new)  # the window's one read
            n = int(n_new[0])
            cache.length = start_pos + n
            self.sessions.put(session_id, cache)
        return {
            "tokens": [seq[:n].tolist()],
            "real_len": n,
            "decode_steps": k,
            "start_pos": start_pos,
            "key": nkey[0].tolist(),
        }

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
