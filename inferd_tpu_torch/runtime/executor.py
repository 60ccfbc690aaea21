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
sampling in one window (models/qwen3.decode_window, with decode_k's keys)
and returns the tokens it committed: only a single-stage (whole-model)
executor serves it, since a pipeline stage's next token depends on every
other stage.

The compiled step. The JAX executor jits every step with the cache
donated. Here, on a card, every single-token step (models/qwen3.stage_step)
and every `decode_steps` window replays a captured CUDA graph
(utils/cuda_graph) keyed by the session's buffer and the step's kv bound
(kv_bucket of the fill, the engine's rule); prompt chunks run eagerly. The
session buffers come from a BufferPool and go back to it when a session
ends, is evicted or swept, or grows, so the next session of the bucket
replays the same graphs; a buffer the pool frees takes its graphs with it.
The pool's idle buffers hold at most max_sessions buffers of the smallest
bucket's bytes, across every bucket (the reference keeps only live
sessions' caches: a bound per bucket let sessions grown to 4096 slots
leave ~1.9x the live KV idle), and the graph cache holds max_sessions x
token_graphs_per_slot graphs, every (buffer, kv bound) pair the live and
idle buffers can key, so the captures grow with the sessions live at
once, never with the sessions served, and no token step's graph is
evicted while its buffer lives (`decode_steps` windows share the cache's
LRU). With `graphs` set to None the same steps run
eagerly: the reference the graphs are held to.

`fuse_kstep_group` is the lane executors' K-step dispatch (the
whole-model runtime/batch_executor and a whole-model runtime/stage_batch):
co-arrived `decode_steps` items that share a sampling config run as one
window. The reference's `cache_intact`, which stops a lane window after a
failed dispatch because its jit had donated (and so invalidated) the
shared cache, has no counterpart: nothing is donated here, so a failed
dispatch leaves the buffers valid and the window's other dispatches run.

`make_executor` routes `--batch-lanes` to the whole-model lane executor of
runtime/batch_executor.py, `--stage-lanes` to the pipeline stage's of
runtime/stage_batch.py, and `backend="counter"` to CounterStageExecutor
(models/counter: no weights, for the swarm's distribution logic).

Sessions that move (the reference's fork_session, export_sessions and
import_session; runtime/handoff is the payload). A fork seeds a new session
with a live one's first slots, an import adopts a shipped session: either
takes a buffer of its own from the BufferPool, at its own bucket, and
copies into it, never a view of another session's buffer (a torch slice is
a view, where the reference's JAX slice is a copy: the child's first step
would write into the parent's KV, or into a buffer a captured graph reads
by address). So a forked or imported session's first decode step captures
or replays a graph like any other. An export pulls each session's K/V,
sliced to its length, to the host in one transfer; `session_lengths`
reads every session's length without touching its KV, and
`export_session_delta` exports the slots past a replication frontier the
same way (runtime/repl, standby replication). Not ported yet: ring
high-water marks (A5b).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.core.cache import (
    BufferPool, KVCache, device_to_host, grow, host_staged, host_to_device, kv_slot_bytes,
    kv_to_host,
)
from inferd_tpu_torch.core.generate import bucket_len
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime import handoff
from inferd_tpu_torch.runtime.repl import START_KEY
from inferd_tpu_torch.utils.cuda_graph import GraphCache, graph_stats, run_step
from inferd_tpu_torch.utils.profiling import span


class SessionStore:
    """session_id -> KVCache with LRU eviction and idle TTL.

    A cache that leaves the store (drop, sweep, eviction, or replaced by a
    grown one in `put`) is handed to `on_release`, which returns the buffer
    for reuse. A session mid-step (its lock held) is never released under
    it: `drop` waits for its step, and eviction and sweep pass it over."""

    def __init__(self, max_sessions: int = 64, ttl_s: float = 600.0, on_release=None):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self.on_release = on_release
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
        """Store (or refresh) a session's cache; call under its lock."""
        with self._lock:
            old = self._caches.get(session_id)
            self._caches[session_id] = cache
            self._last_used[session_id] = time.monotonic()
            gone = [old] if old is not None and old is not cache else []
            gone += self._evict_locked()
        self._release(gone)

    def drop(self, session_id: str) -> None:
        with self._lock:
            lock = self._locks.get(session_id)
        with lock or contextlib.nullcontext():
            with self._lock:
                cache = self._pop_locked(session_id)
        self._release([cache])

    def kv_bytes(self) -> int:
        """Total bytes of live session KV buffers."""
        with self._lock:
            return sum(c.nbytes for c in self._caches.values())

    def sweep(self) -> int:
        """Drop sessions idle for > ttl_s (none mid-step); returns the count
        dropped."""
        now = time.monotonic()
        with self._lock:
            stale = [s for s, t in self._last_used.items() if now - t > self.ttl_s]
            gone = [self._pop_idle_locked(s) for s in stale]
        self._release(gone)
        return sum(c is not None for c in gone)

    def lengths(self) -> Dict[str, int]:
        """{session_id: KV length} of the sessions holding any KV (their
        idle clocks untouched)."""
        with self._lock:
            return {sid: int(c.length) for sid, c in self._caches.items() if c.length > 0}

    def ids(self) -> List[str]:
        """Live session ids in the order they were admitted (the node
        advertises the newest in its gossip record's `sess`)."""
        with self._lock:
            return list(self._caches)

    def __len__(self) -> int:
        with self._lock:
            return len(self._caches)

    def __contains__(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._caches

    def _pop_locked(self, session_id: str) -> Optional[KVCache]:
        self._locks.pop(session_id, None)
        self._last_used.pop(session_id, None)
        return self._caches.pop(session_id, None)

    def _pop_idle_locked(self, session_id: str) -> Optional[KVCache]:
        """Pop a session unless a step holds its lock (then None)."""
        lock = self._locks.get(session_id)
        if lock is not None and not lock.acquire(blocking=False):
            return None
        try:
            return self._pop_locked(session_id)
        finally:
            if lock is not None:
                lock.release()

    def _evict_locked(self) -> List[KVCache]:
        """LRU-evict sessions not mid-step until at most max_sessions remain."""
        gone = []
        for sid in sorted(self._last_used, key=self._last_used.get):
            if len(self._caches) <= self.max_sessions:
                break
            cache = self._pop_idle_locked(sid)
            if cache is not None:
                gone.append(cache)
        return gone

    def _release(self, caches) -> None:
        if self.on_release is not None:
            for c in caches:
                if c is not None:
                    self.on_release(c)


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
    mark of sliding-window layers, which wait for ROADMAP A5b, is
    advanced by it."""
    return start + min(n + 1, k)


def fuse_kstep_group(decode_k_fn, params, cache, lens, lanes: int, grp, ads=None,
                     graphs=None, kv_bound=None):
    """One sampling group of co-batched K-step lanes as ONE fused window,
    the K-step dispatch of both lane executors (port of
    inferd_tpu/runtime/executor.fuse_kstep_group), so the group's rules
    have one definition: K is the group's smallest budget-clamped request,
    each lane keeps its own key, eos and active flag, and the host reads
    the window's K tokens once.

    decode_k_fn: models/qwen3.make_decode_k_serve's signature (params,
    cache, toks, lengths, active, keys, eos, k, t, tk, tp, mp, ads=None,
    graphs=None, kv_bound=None) -> (cache, seq, n_new, keys'). grp:
    [(lane, token, ks)], every parse_kstep dict of one sampling tuple.
    `ads`: the adapter pools and per-lane slot ids; `graphs`, `kv_bound`:
    decode_k's. Returns (kg, seq [kg, L], n_new [L], nkeys [L, 2], cache)
    with the three arrays on the host."""
    kg = min(ks["k"] for _lane, _tok, ks in grp)
    toks = np.zeros((lanes,), np.int64)
    active = np.zeros((lanes,), bool)
    eos = np.full((lanes,), -1, np.int64)
    keys = np.zeros((lanes, 2), np.uint32)
    sampling = None
    for lane, token, ks in grp:
        toks[lane] = token
        active[lane] = True
        eos[lane] = ks["eos"]
        keys[lane] = ks["key"]
        sampling = ks["sampling"]
    t, tk, tp, mp = sampling
    cache, seq, n_new, nkeys = decode_k_fn(params, cache, toks, lens, active, keys, eos, kg,
                                           t, tk, tp, mp, ads=ads, graphs=graphs,
                                           kv_bound=kv_bound)
    seq, n_new = device_to_host(seq, n_new)  # the window's one read
    return kg, seq, n_new, nkeys, cache


def token_graphs_per_slot(initial_kv_len: int, max_len: int) -> int:
    """The most token-step graphs one session slot's buffers can key: the
    pool holds at most one buffer of each bucket per session live at once
    (initial_kv_len up to bucket_len(max_len)), and a buffer of bucket T
    keys one graph per kv bound its steps can take (kv_bucket of fills up
    to min(T, max_len)), whichever sessions meet it at which fills."""
    total, t = 0, max(initial_kv_len, 16)
    while True:
        top = min(t, max_len)
        total += len({qwen3.kv_bucket(n, t) for j in range(top.bit_length())
                      for n in (2 ** j, 2 ** j + 1) if n <= top})
        if t >= bucket_len(max_len):
            return total
        t *= 2


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
        # session buffers outlive their sessions, and so do the graphs
        # captured over them (a buffer released for good takes its graphs)
        smallest = max(initial_kv_len, bucket_len(1))
        self.buffers = BufferPool(
            cfg, spec.num_layers, self.device, on_free=self._forget,
            max_free_bytes=max_sessions * smallest * kv_slot_bytes(cfg, spec.num_layers))
        self.sessions = SessionStore(max_sessions, session_ttl_s, on_release=self.buffers.give)
        # token steps and decode_steps windows as graph replays on a card,
        # eager on the CPU; set to None for the eager step on a card too
        # (the reference the graphs are held to). Room for every token-step
        # graph the pool's buffers can key; decode_steps windows share it.
        self.graphs: Optional[GraphCache] = None
        # one graphed step at a time, its outputs read before the next: the
        # graphs share one memory pool (utils/cuda_graph)
        self._step_lock = threading.Lock()
        self.delta_lock_ms: Optional[float] = None  # the last delta export's lock hold
        if self.device.type == "cuda":
            self.graphs = GraphCache(
                max_graphs=max_sessions * token_graphs_per_slot(initial_kv_len, max_len),
                device=self.device)

    # -- session cache management ------------------------------------------

    def _forget(self, cache: KVCache) -> None:
        """A buffer leaves the pool: drop the graphs that read it."""
        if self.graphs is not None:
            ptr = cache.k.data_ptr()
            self.graphs.drop(lambda key: key[0] == ptr)

    def _cache_for(self, session_id: str, start_pos: int, real_len: int, padded_len: int):
        """(cache, write position) for a chunk at start_pos, with room for
        the PADDED chunk write (the forward writes padded_len rows); the
        real-token budget is capped at max_len. A new or grown buffer comes
        from the pool and is stored at once (a grown one returns the old)."""
        needed = max(real_len, padded_len)
        cache = self.sessions.get(session_id)
        have = 0 if cache is None else cache.length
        if have + real_len > self.max_len:
            raise BufferError(
                f"session {session_id}: KV overflow ({have}+{real_len} > {self.max_len})"
            )
        pos = self._rollback_for(session_id, have, start_pos)
        if cache is None:
            cache = self.buffers.take(1, max(self.initial_kv_len, bucket_len(needed)))
            self.sessions.put(session_id, cache)
        elif have + needed > cache.max_len:
            cache = self._grow(session_id, cache, bucket_len(have + needed))
        return cache, pos

    def _grow(self, session_id: str, cache: KVCache, max_len: int) -> KVCache:
        cache = grow(cache, self.buffers.take(1, max_len))
        self.sessions.put(session_id, cache)
        return cache

    @staticmethod
    def _rollback_for(session_id: str, have: int, start_pos: int) -> int:
        """The write position for a chunk starting at start_pos: the
        frontier `have`, or, for a REPLAY (a chunk starting before it), the
        chunk start."""
        if start_pos == have:
            return have
        if not 0 <= start_pos < have:
            raise ValueError(
                f"session {session_id}: start_pos {start_pos} != cache "
                f"length {have} (out-of-order chunk)"
            )
        return start_pos

    def _run(self, x: torch.Tensor, start_pos: int, cache: KVCache, real_len: int):
        """A prompt chunk (eager): host-int positions, so the attention
        splits over the chunk's real span."""
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

    def _token_step(self, x: torch.Tensor, pos: int, cache: KVCache):
        """One token at fill `pos` (models/qwen3.stage_step) from a host x:
        a replay of the graph keyed by (buffer, kv bound), the bound
        kv_bucket(pos + 1, T) that a capture fixes (a replay below the
        frontier is only another fill), x and the fill copied once into its
        static buffers; eager when `graphs` is None, with the same bound."""
        spec = self.spec
        bound = qwen3.kv_bucket(pos + 1, cache.max_len)

        def step(x, fill):
            return qwen3.stage_step(self.params, self.cfg, x, cache.k, cache.v, fill,
                                    first=spec.is_first, last=spec.is_last, kv_bound=bound)

        inputs = {"x": host_staged(x, self.device) if x.device.type == "cpu" else x,
                  "fill": host_staged(np.array([pos], np.int64), self.device)}
        key = (cache.k.data_ptr(), tuple(cache.k.shape), "stage", bound)
        out = run_step(self.graphs, key, step, inputs, self.device)
        return {"logits" if spec.is_last else "hidden": out}

    def _upload(self, x: torch.Tensor) -> torch.Tensor:
        return host_to_device(x, self.device) if x.device.type == "cpu" else x.to(self.device)

    # -- public API ---------------------------------------------------------

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Run this stage for one chunk of one session.

        payload: {"tokens": int32 [B, S]} on stage 0, else {"hidden":
        [B, S, H]}; plus "start_pos" (absolute position of the chunk's first
        token) and optionally "real_len" (rows past it are bucket padding).
        Returns {"hidden"} or, on the last stage, {"logits": [B, V]} as CPU
        tensors, plus the relay metadata "real_len" and "start_pos". A
        single-token step runs `_token_step` (a graph replay on a card), a
        prompt chunk `_run`."""
        if int(payload.get("decode_steps") or 0) > 0:
            return self._process_decode_k(session_id, payload)
        start_pos = int(payload.get("start_pos", 0))
        if self.spec.is_first:
            x = torch.as_tensor(np.asarray(payload["tokens"], dtype=np.int64))
            real_len = int(payload.get("real_len", x.shape[1]))
            if x.shape[1] > 1:  # prompt chunks pad to a bucket; decode steps do not
                x = F.pad(x, (0, bucket_len(x.shape[1]) - x.shape[1]))
        else:
            x = _as_tensor(payload["hidden"])
            real_len = int(payload.get("real_len", x.shape[1]))
            if x.shape[1] > 1:  # upstream ships real rows only: re-pad locally
                x = F.pad(x, (0, 0, 0, bucket_len(max(x.shape[1], real_len)) - x.shape[1]))
            x = x.to(self.cfg.torch_dtype)
        token = x.shape[1] == 1 and real_len == 1
        if not token:
            x = self._upload(x)

        with self.sessions.lock_for(session_id), torch.no_grad():
            cache, pos = self._cache_for(session_id, start_pos, real_len, int(x.shape[1]))
            with self._step_lock if token else contextlib.nullcontext():
                out = (self._token_step(x, pos, cache) if token
                       else self._run(x, pos, cache, real_len))
                # read before any later replay can overwrite a graph's output
                with span("results.cpu"):
                    result: Dict[str, Any] = {k: v.cpu() for k, v in out.items()}
            cache.length = pos + real_len
            self.sessions.put(session_id, cache)
        result["real_len"] = real_len
        result["start_pos"] = start_pos
        return result

    def _process_decode_k(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """K decode steps and their sampling on the device, one host read at
        the end: models/qwen3.decode_k, its window a graph replay on a card
        (run_window, as the engine's decode_chunk).

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
            # a replay restarts at start_pos
            cache, _ = self._cache_for(session_id, start_pos, 1, 1)
            if start_pos + k > cache.max_len:
                cache = self._grow(session_id, cache, bucket_len(start_pos + k))
            with self._step_lock:
                cache, seq, n_new, keys, _l, _i, _t = qwen3.decode_k(
                    self.params, self.cfg, toks[0], cache, [start_pos], [True],
                    ks["key"][None], k, t, tk, tp, mp, eos=ks["eos"], graphs=self.graphs)
                seq, n_new = device_to_host(seq[:, 0], n_new)  # the window's one read
            n = int(n_new[0])
            cache.length = start_pos + n
            self.sessions.put(session_id, cache)
        return {
            "tokens": [seq[:n].tolist()],
            "real_len": n,
            "decode_steps": k,
            "start_pos": start_pos,
            "key": keys[0].tolist(),
        }

    def end_session(self, session_id: str) -> None:
        self.sessions.drop(session_id)

    # -- sessions that move (runtime/handoff) ---------------------------------

    def export_sessions(self, only: Optional[str] = None):
        """Every live session's KV as handoff payloads [(sid, payload)], K/V
        sliced to the session's length and pulled to the host in one
        transfer each (core.cache.kv_to_host); `only` exports one session
        (the deliberate prefill-to-decode handoff). Each session is read
        under its own lock, so no step of it runs meanwhile."""
        out = []
        for sid in self.sessions.ids():
            if only is not None and sid != only:
                continue
            with self.sessions.lock_for(sid), torch.no_grad():
                cur = self.sessions.get(sid)
                if cur is None or cur.length == 0:
                    continue
                n = cur.length
                k, v = kv_to_host(cur.k[:, :, :n], cur.v[:, :, :n])
            out.append((sid, handoff.encode(k, v, n)))
        return out

    def session_lengths(self) -> Dict[str, int]:
        """{session_id: committed KV length}: what a drain compares after
        its snapshot flew (no KV is read)."""
        return self.sessions.lengths()

    def export_session_delta(self, session_id: str, since: int):
        """The incremental export of standby replication (runtime/repl): the
        handoff payload of the session's slots [since, length) plus
        START_KEY, or None when the session is unknown here or holds nothing
        past `since`; `since` 0 gives export_sessions' payload. Read as
        export_sessions reads: under the session's lock (no step of it runs
        meanwhile), in one transfer; the lock covers only that copy, whose
        hold `delta_lock_ms` keeps (the node's `repl.lock_ms`)."""
        since = max(0, int(since))
        with self.sessions.lock_for(session_id), torch.no_grad():
            t0 = time.perf_counter()
            cur = self.sessions.get(session_id)
            if cur is None or cur.length <= since:
                return None
            n = cur.length
            k, v = kv_to_host(cur.k[:, :, since:n], cur.v[:, :, since:n])
            self.delta_lock_ms = (time.perf_counter() - t0) * 1e3
        payload = handoff.encode(k, v, n)
        payload[START_KEY] = since
        return payload

    def import_session(self, session_id: str, payload: Dict[str, Any]) -> bool:
        """Adopt a shipped session's KV (the sender serves the same stage, so
        the layer and head shapes must match; runtime/handoff.decode fails
        closed on any mismatch) into a pooled buffer of max(initial_kv_len,
        bucket_len(n)). Declines a tenant session's payload (`adapter`):
        this executor has no registry, and its KV was built with the
        adapter. Never replaces a live session of the same id."""
        if payload.get("adapter") is not None:
            return False
        dec = handoff.decode(payload, self.cfg, self.spec.num_layers, self.max_len)
        if dec is None:
            return False
        k, v, n = dec["k"], dec["v"], dec["n"]
        with self.sessions.lock_for(session_id), torch.no_grad():
            if self.sessions.get(session_id) is not None:
                return False
            cache = self.buffers.take(1, max(self.initial_kv_len, bucket_len(n)))
            t = min(k.shape[2], cache.max_len)
            cache.k[:, :, :t] = k[:, :, :t].to(self.device)
            cache.v[:, :, :t] = v[:, :, :t].to(self.device)
            cache.length = n
            self.sessions.put(session_id, cache)
        return True

    def fork_session(self, new_session_id: str, parent_session_id: str, prefix_len: int) -> bool:
        """Seed a NEW session's KV with the first `prefix_len` slots of a live
        session's (stage-local prefix caching: every stage of the pipeline
        forks the same parent, the client or the relay drives it). The child
        takes a pooled buffer at its own bucket (a long-running parent does
        not make every child carry its buffer) and the prefix is copied
        into it, under the parent's lock. False when the parent is unknown
        here or too short: the caller prefills in full."""
        if prefix_len <= 0:
            return False
        with self.sessions.lock_for(parent_session_id), torch.no_grad():
            parent = self.sessions.get(parent_session_id)
            if parent is None or parent.length < prefix_len:
                return False
            child = self.buffers.take(
                1, min(max(self.initial_kv_len, bucket_len(prefix_len)), parent.max_len))
            child.k[:, :, :prefix_len] = parent.k[:, :, :prefix_len]
            child.v[:, :, :prefix_len] = parent.v[:, :, :prefix_len]
            child.length = prefix_len
        with self.sessions.lock_for(new_session_id):
            self.sessions.put(new_session_id, child)
        return True

    def stats(self) -> Dict[str, Any]:
        return {"sessions": len(self.sessions), "kv_bytes": self.sessions.kv_bytes(),
                "buffers": self.buffers.stats(), "graphs": graph_stats(self.graphs)}


class CounterStageExecutor:
    """The counter model behind the executors' process() surface: a stage
    with no weights and no device, for the swarm's distribution logic."""

    def __init__(self, spec: StageSpec):
        from inferd_tpu_torch.models.counter import CounterStage

        self.spec = spec
        self.model = CounterStage(spec.stage, spec.num_stages)
        self.sessions = SessionStore()
        self.params: Dict[str, Any] = {}
        self.device = torch.device("cpu")

    def process(self, session_id: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self.model.forward(payload, session_id)

    def end_session(self, session_id: str) -> None:
        self.sessions.drop(session_id)

    def fork_session(self, new_session_id: str, parent_session_id: str, prefix_len: int) -> bool:
        """The counter's state rides the payload, not the session: nothing to
        copy."""
        return True

    def stats(self) -> Dict[str, Any]:
        return {"sessions": len(self.sessions)}


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
    batch_lanes: int = 0,
    window_ms: float = 3.0,
    **kw,
):
    """The stage's executor: `backend="counter"` the weightless counter
    model; else with `batch_lanes` > 0 the whole-model continuous-batching
    executor (runtime/batch_executor, which owns its arrival window of
    `window_ms`), with `stage_lanes` > 0 the pipeline stage's lane executor
    (runtime/stage_batch; `block_size` > 0 pages either's KV; `adapters`, a
    runtime/adapters.AdapterRegistry, serves multi-tenant LoRA on either),
    else the one-cache-per-session Qwen3StageExecutor. Refuses the flag
    combinations the reference node refuses."""
    if backend == "counter":
        return CounterStageExecutor(spec)
    if backend != "qwen3":
        raise ValueError(f"unknown executor backend {backend!r} (qwen3 or counter)")
    if stage_params is None:
        raise ValueError("qwen3 backend needs stage params")
    if stage_lanes > 0 and batch_lanes > 0:
        raise ValueError("--stage-lanes (stage-level continuous batching) is mutually "
                         "exclusive with --batch-lanes")
    lanes = stage_lanes > 0 or batch_lanes > 0
    if block_size > 0 and not lanes:
        raise ValueError(
            "--paged-kv runs on the lane executors: pair it with --stage-lanes or --batch-lanes"
        )
    if adapters is not None and not lanes:
        raise ValueError(
            "--adapters (multi-tenant batched LoRA) runs on the lane "
            "executors — pair it with --stage-lanes or --batch-lanes"
        )
    if batch_lanes > 0:
        from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor

        if spec.num_stages != 1:
            raise ValueError(
                "--batch-lanes hosts the WHOLE model, so the swarm topology must be "
                f"single-stage: needs a 1-stage checkpoint, got stage {spec.stage}/"
                f"{spec.num_stages}")
        return BatchedExecutor(
            cfg, stage_params, lanes=batch_lanes, block_size=block_size, kv_blocks=kv_blocks,
            prefill_chunk=prefill_chunk, adapters=adapters, window_ms=window_ms, **kw,
        )
    if stage_lanes > 0:
        from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

        return BatchedStageExecutor(
            cfg, spec, stage_params, lanes=stage_lanes, block_size=block_size,
            kv_blocks=kv_blocks, prefill_chunk=prefill_chunk, adapters=adapters, **kw,
        )
    return Qwen3StageExecutor(cfg, spec, stage_params, **kw)
