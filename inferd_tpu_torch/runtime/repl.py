"""Asynchronous standby KV replication: crash-tolerant sessions (port of
inferd_tpu/runtime/repl.py).

A graceful exit hands a session's KV to a surviving replica (the drain,
migration and stop handoffs of runtime/node), but a crash loses it, and the
client pays a full restart and re-prefill. This plane closes that hole:

  * the PRIMARY (the replica serving a session) periodically ships the
    session's newly completed KV past a per-session replication frontier to
    a gossip-chosen same-stage STANDBY: a paged lane executor ships exactly
    the full blocks past the frontier, the dense executors ship slab deltas
    (the executors' `export_session_delta`, the incremental twin of the
    `export_sessions` / `import_session` handoff payload of runtime/handoff);
  * the standby accumulates the deltas on the HOST in a `StandbyStore`: no
    lane, no device KV, no executor state is touched until a promotion, so
    shadow sessions cost host memory, never serving capacity;
  * when the primary dies, the standby PROMOTES: the accumulated payload
    imports through the ordinary `import_session` (the handoff decoder,
    which fails closed), the client re-sends only the tokens past the
    frontier (the re-prefill is bounded by the replication lag), and the
    generation goes on token-exact, with no restart.

Best effort and off by default: without `--standby-repl` the wire, the
gossip records and the metrics are what they are without this module, and
a stale or partial shadow always degrades to the client's ordinary restart
(a staleness costs recompute, never a wrong token).

Segments stay host tensors of their own dtype (bf16, or an fp8 cache's
uint8 view named by `kv_dtype`), so a promoted payload is bit for bit what
the primary shipped. Ring fields (`k_loc`, `v_loc`, `hi`: the sliding-window
layers' rings) are refused, as runtime/handoff refuses them, until the
ring KV slice (ROADMAP A5b). The store's lock is a plain
threading.Lock (the reference's lock watchdog is ROADMAP A9's).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from inferd_tpu_torch.runtime.handoff import as_tensor

#: wire key of a replication delta's absolute start position; a payload with
#: start 0 is exactly the handoff payload
START_KEY = "start"

#: shadows not refreshed for this long are swept (a dead primary's session
#: was promoted within seconds, or its client restarted: either way the
#: stale bytes must not accumulate)
STANDBY_TTL_S = 300.0

_RING_KEYS = ("k_loc", "v_loc", "hi")


class _Shadow:
    """One session's accumulated replica KV (host tensors). The deltas are
    kept as SEGMENT LISTS and concatenated once, at promotion: a cat per
    delta would copy the whole accumulated buffer every time, O(length^2)
    over a session's life."""

    __slots__ = ("ks", "vs", "length", "kv_dtype", "stage", "last_update", "adapter")

    def __init__(self, stage: int):
        self.ks: List[torch.Tensor] = []
        self.vs: List[torch.Tensor] = []
        self.length = 0
        self.kv_dtype: Optional[str] = None
        self.stage = stage
        self.last_update = time.monotonic()
        # the tenant adapter the primary's deltas are stamped with: given
        # back at promotion, so import_session binds it or declines
        self.adapter: Optional[str] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StandbyStore:
    """Host-side accumulator of the replicated session KV on a standby.

    apply() appends a delta that starts exactly at the frontier (anything
    else reports the length the store HAS, so the primary re-syncs from
    there); payload() reassembles the whole `import_session` payload at
    promotion. Thread-safe; at most max_sessions shadows (the least recently
    updated evicted first), swept by TTL."""

    def __init__(self, max_sessions: int = 64, ttl_s: float = STANDBY_TTL_S):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._mu = threading.Lock()
        self._shadows: Dict[str, _Shadow] = {}

    def __contains__(self, session_id: str) -> bool:
        with self._mu:
            return session_id in self._shadows

    def __len__(self) -> int:
        with self._mu:
            return len(self._shadows)

    def ids(self) -> List[str]:
        with self._mu:
            return list(self._shadows)

    def length(self, session_id: str) -> Optional[int]:
        """A shadow's replicated frontier (None: no shadow of it here)."""
        with self._mu:
            sh = self._shadows.get(session_id)
            return None if sh is None else sh.length

    def lengths(self) -> Dict[str, int]:
        """{session_id: replicated frontier} of every shadow held."""
        with self._mu:
            return {sid: sh.length for sid, sh in self._shadows.items()}

    def stage_of(self, session_id: str) -> Optional[int]:
        with self._mu:
            sh = self._shadows.get(session_id)
            return None if sh is None else sh.stage

    def apply(self, session_id: str, stage: int, payload: Dict[str, Any]) -> Tuple[bool, int]:
        """Apply one replication delta. Returns (ok, have_length): ok False
        means the delta did not land (a gap, a malformed or ring payload)
        and `have_length` is what the store holds: the primary resets its
        frontier there and ships again. A delta at start 0 always REPLACES
        the shadow (the primary re-synced from scratch)."""
        try:
            start = int(payload.get(START_KEY, 0))
            total = int(payload["length"])
            k = as_tensor(payload["k"])
            v = as_tensor(payload["v"])
        except Exception:
            return False, self.length(session_id) or 0
        if (k.dim() != 5 or tuple(v.shape) != tuple(k.shape) or k.shape[1] != 1
                or start < 0 or total <= start or k.shape[2] != total - start
                or any(key in payload for key in _RING_KEYS)):
            return False, self.length(session_id) or 0
        with self._mu:
            sh = self._shadows.get(session_id)
            if start == 0 or sh is None:
                if start != 0:
                    # a mid-stream delta of an unknown session: ask for a
                    # full re-sync (the primary restarts its frontier)
                    return False, 0
                sh = _Shadow(stage)
                sh.ks, sh.vs = [k], [v]
                self._shadows[session_id] = sh
                self._evict_locked()
            else:
                if sh.length != start or sh.stage != stage:
                    return False, sh.length if sh.stage == stage else 0
                head = sh.ks[0]
                if k.shape[0] != head.shape[0] or tuple(k.shape[3:]) != tuple(head.shape[3:]):
                    return False, sh.length
                if k.dtype != head.dtype:
                    return False, sh.length
                sh.ks.append(k)
                sh.vs.append(v)
            sh.length = total
            kd = payload.get("kv_dtype")
            if kd is not None:
                sh.kv_dtype = str(kd)
            ad = payload.get("adapter")
            if ad is not None:
                sh.adapter = str(ad)
            sh.last_update = time.monotonic()
            return True, sh.length

    def payload(self, session_id: str) -> Optional[Dict[str, Any]]:
        """The whole handoff payload for a promotion (import_session), or
        None. The import's decoder is the real gate: this only reassembles
        the bytes."""
        with self._mu:
            sh = self._shadows.get(session_id)
            if sh is None or not sh.ks or sh.length <= 0:
                return None
            # ONE concatenation, at promotion (_Shadow says why)
            out: Dict[str, Any] = {
                "k": sh.ks[0] if len(sh.ks) == 1 else torch.cat(sh.ks, dim=2),
                "v": sh.vs[0] if len(sh.vs) == 1 else torch.cat(sh.vs, dim=2),
                "length": sh.length,
            }
            if sh.kv_dtype is not None:
                out["kv_dtype"] = sh.kv_dtype
            if sh.adapter is not None:
                out["adapter"] = sh.adapter
            return out

    def drop(self, session_id: str) -> None:
        with self._mu:
            self._shadows.pop(session_id, None)

    def clear(self) -> None:
        """Drop every shadow (a stage migration re-keys this node)."""
        with self._mu:
            self._shadows.clear()

    def sweep(self) -> int:
        """Drop the shadows idle past the TTL; returns how many."""
        cutoff = time.monotonic() - self.ttl_s
        with self._mu:
            stale = [s for s, sh in self._shadows.items() if sh.last_update < cutoff]
            for s in stale:
                del self._shadows[s]
            return len(stale)

    def bytes_held(self) -> int:
        with self._mu:
            return sum(_nbytes(t) for sh in self._shadows.values() for t in (*sh.ks, *sh.vs))

    def _evict_locked(self) -> None:
        while len(self._shadows) > self.max_sessions:
            oldest = min(self._shadows, key=lambda s: self._shadows[s].last_update)
            del self._shadows[oldest]


class SessionReplicator:
    """The primary's half: per-session replication frontiers, shipped to a
    sticky gossip-chosen standby.

    Policy and bookkeeping only: the node supplies `candidates_fn`, the
    ranked same-stage (node_id, record) pairs WITHOUT this node, and ships
    each delta itself. The standby is sticky per session: a frontier means
    something only against the standby that accumulated it, so a change of
    standby resets the frontier to 0 (a whole re-ship). Thread-safe: the
    node's replication thread and its request threads (an ended session's
    pop_standby) share it."""

    def __init__(self, candidates_fn: Callable[[], List[Tuple[str, Dict[str, Any]]]]):
        self.candidates_fn = candidates_fn
        # session_id -> (standby node_id, shipped frontier)
        self.state: Dict[str, Tuple[str, int]] = {}
        self.shipped_bytes = 0
        self.ship_errors = 0
        self._mu = threading.Lock()

    def lag_tokens(self, lengths: Dict[str, int]) -> int:
        """The live sessions' tokens past their shipped frontier, summed: the
        bounded-loss gauge (`repl.lag_tokens`)."""
        total = 0
        with self._mu:
            for sid, n in lengths.items():
                _nid, f = self.state.get(sid, (None, 0))
                total += max(0, int(n) - f)
        return total

    def prune(self, live_sids) -> None:
        """Forget the sessions no longer resident, SILENTLY. Losing residency
        is not the session's end: an LRU eviction or a live handoff takes
        the local KV while the stream may well go on, and the standby's
        shadow is then exactly the crash protection this plane is for (its
        TTL is the backstop). An explicit end goes through pop_standby."""
        live = set(live_sids)
        with self._mu:
            for sid in [s for s in self.state if s not in live]:
                del self.state[sid]

    def pop_standby(self, sid: str) -> Optional[str]:
        """The sticky standby of an EXPLICITLY ended session, its tracking
        removed: the node sends it a drop notice, so a finished session's
        shadow does not sit in the standby's memory, advertised, for the
        whole TTL. None when untracked."""
        with self._mu:
            nid_f = self.state.pop(sid, None)
        return None if nid_f is None else nid_f[0]

    def clear(self) -> None:
        """Forget every frontier (a stage migration re-keys this node)."""
        with self._mu:
            self.state.clear()

    def pick_standby(self, sid: str, cands: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
                     require_ada: bool = False) -> Optional[str]:
        """The sticky standby of `sid`: the current one while it is still a
        candidate, else the best-ranked candidate that is not shedding, else
        (nothing else left) the best-ranked one. Anti-affinity (never the
        replica serving the session) is the candidates' own: they exclude
        this node. `cands` lets plan() rank the stage once per tick. With
        `require_ada` (a tenant session) only peers whose record has `ada`
        (the adapter capability, present even when empty) may hold the
        shadow: another could never promote it. The sticky check uses the
        filtered set, so a shadow on a peer without it moves away."""
        if cands is None:
            cands = list(self.candidates_fn())
        if require_ada:
            cands = [(nid, rec) for nid, rec in cands if "ada" in rec]
        by_id = dict(cands)
        with self._mu:
            cur, _f = self.state.get(sid, (None, 0))
        if cur is not None and cur in by_id:
            return cur
        for nid, rec in cands:
            if not rec.get("shed"):
                return nid
        return cands[0][0] if cands else None

    def plan(self, lengths: Dict[str, int],
             adapters: Optional[Dict[str, str]] = None) -> List[Tuple[str, str, int]]:
        """[(session_id, standby node_id, frontier)] of the sessions with new
        KV to ship this tick; the state changes only in record().
        `adapters`: {session_id: adapter} of the tenant sessions
        (pick_standby's require_ada)."""
        out = []
        cands = list(self.candidates_fn())
        for sid, n in sorted(lengths.items()):
            standby = self.pick_standby(sid, cands,
                                        require_ada=bool(adapters and adapters.get(sid)))
            if standby is None:
                continue
            with self._mu:
                cur, frontier = self.state.get(sid, (None, 0))
            if cur != standby:
                frontier = 0  # a new standby: its store starts empty
            if int(n) > frontier:
                out.append((sid, standby, frontier))
        return out

    def record(self, sid: str, standby: str, ok: bool, peer_length: Optional[int],
               body_bytes: int) -> None:
        """Fold one ship's outcome into the frontiers. A declined delta
        resets the frontier to what the peer says it holds (0 on garbage),
        so the next tick re-syncs from there."""
        with self._mu:
            if ok and peer_length is not None:
                self.state[sid] = (standby, int(peer_length))
                self.shipped_bytes += body_bytes
            else:
                self.ship_errors += 1
                self.state[sid] = (standby, max(0, int(peer_length or 0)))

    def note_standby_dead(self, sid: str) -> None:
        """A ship that failed in transport: forget the standby, so the next
        tick picks again and ships from 0 (the dead peer's store is out of
        reach, so its frontier is worth nothing)."""
        with self._mu:
            self.ship_errors += 1
            self.state.pop(sid, None)

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {"sessions_tracked": len(self.state), "shipped_bytes": self.shipped_bytes,
                    "ship_errors": self.ship_errors}
