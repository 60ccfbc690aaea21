"""Stage node on the standard library (port of the chain and relay surface
of inferd_tpu/runtime/node.py).

One node hosts one pipeline stage and serves both topologies:

  * chain (`relay: false`): the client drives every stage itself
    (client/chain_client.py) and the node answers with its stage's result;
  * relay (`relay` true or absent, the reference's default): a request
    enters at a stage-0 node (client/swarm_client.py), each node computes
    its stage and relays the result to a node of the next stage that it
    picks from the gossip store, and the last stage's answer unwinds back
    along the chain as the downstream node's raw reply bytes (the logits
    are never unpacked and packed again on the way back).

Endpoints, wire-compatible with the JAX node for these topologies:

  POST /forward      one envelope {"task_id", "session_id", "stage",
                     "relay", "payload"}. Chain: {"task_id",
                     "session_id", "stage", "result", "served_by"}. Relay:
                     the last stage's {"task_id", "session_id",
                     "result_for_user", "served_by"}, or whatever error the
                     chain answered
  POST /end_session  {"session_id", "stage", "relay"} -> {"ok": true}; with
                     relay, the end goes on down the chain to the replica
                     that holds the session's next stage
  GET  /health       JSON: status, stage, device
  GET  /stats        JSON: counters (forward passes, relays, dead hops), the
                     wire codec in use (`wire_codec`), the
                     overload plane's `metrics` (counters and histograms),
                     `hedge_budget` and `retry_budget`, the device's name,
                     the serving quantization and the stage's parameter
                     bytes as stored, each kernel's launch
                     count in this process, the executor's stats, the
                     card's allocated and reserved bytes (`memory`), the
                     gossip view `dht` {stage: {"host:port": record}}, the
                     announced `svc_ms`, `routes`: the planner's stats
                     and the newest planned routes, and the elasticity
                     plane's `draining`, `rebalance_period_s` and
                     `last_migration` (its stages, times and memory)
  POST /reassign     {"stage": N}: migrate this node to stage N (below) ->
                     {"ok": true, "stage": N}; 400 for a bad body or a stage
                     out of range, 500 "reassign failed: ..." when the
                     migration raises (no stage loader, a load, build or
                     warm-up that fails: the node keeps its old stage)
  POST /drain        [{"wait_s": S}]: stop admitting new sessions (503
                     "draining" with `retry_after`), gossip `draining: 1`,
                     wait up to S seconds (default 5) while /forward requests
                     are in flight -> {"ok", "draining", "resident",
                     "handed_off": 0}; idempotent, and a garbage body still
                     drains. Resident sessions are served here until they
                     end: nothing is handed off (ROADMAP A4d)
  POST /profile      {"action": "start" [, "name"]} | {"action": "stop"} |
                     {"action": "window", "seconds" S [, "capture_id"]}:
                     an on-demand torch.profiler trace of this process
                     (utils/profiling.Profiler), every thread's host work
                     and the card's kernels, written as a Chrome trace
                     under the node's profile directory. A window stops
                     itself after S seconds (clamped to [0.1, 60]) and lands
                     in <capture_id>/<host>_<port>. Opt-in only
                     (run_node --enable-profiling): 403 without it, 400 for
                     a bad request or a name that escapes the directory,
                     409 for a second start or a stop with none running.

Membership. The node owns a gossip store (control/dht.SwarmDHT) and a
PathFinder over it. It announces {name, stage, load, cap, host, port,
model} at start (urgent) and at stop (a tombstone), and again, not urgent,
whenever its load (the /forward requests in flight) changes; the gossip
thread carries that. `name` is the node's manifest name (run_node --name),
else its host:port. Once it has computed, the record adds `svc_ms`: an EWMA
(0.8 old, 0.2 new) of a forward's compute time, without the wait for the
node's compute lock or its stage window (each entry of a window step counts
that step's time from the moment it holds the device; a whole-model lane
node's own window is inside its executor's call), which the chain planner
charges as latency. A
whole-model paged lane node adds `pfx`, the digest of the prompt prefixes
its block pool holds (core/prefix.make_digest), which an entry router
scores a new prompt against (prefix.AffinityProbe). A node with an adapter
registry (--adapters) adds `ada`, its resident tenant adapters (at most
ADA_GOSSIP_MAX, least recently used first), `[]` when none is resident, as
the key's presence marks the capability; without a registry the key is
left out, so such a record is the bytes it was before the key existed.

Planned routes. A relayed envelope at start_pos 0 with no `route`, on a
stage before the last, is a new session entering here: the node plans its
whole downstream chain (`_plan_route`, PathFinder.find_best_chain over the
long-lived D*-Lite planner) and puts it on the envelope as `route`
{str(stage): node_id}, which every later envelope of that pass carries on
(`route.planned`, or `route.plan_failed` and the per-hop pick). The plan
counts, as the fresh pick does, the sessions this node has routed or
planned through each replica and not ended, and charges a shedding replica
ADMISSION_PENALTY; plan and record are one step under the pick lock, so
sessions arriving together see each other's plans. A tenant session (its
first chunk's payload names an `adapter`) plans with that adapter's
AdapterAffinity: the route's first stage prefers a replica whose `ada`
holds it, by the bounded cache-affinity bonus (a miss hot-loads there).
The next hop (`_pick_next`) is (1) the session's remembered replica for
that stage while its record lives (an LRU of 8192 (session, stage) pairs:
its KV lives there), else (2) a replica advertising the session, else (3)
the route's replica while it lives, is not excluded and is not in its
dead-peer cooldown (`route.followed`; else `route.stale`), else (4) the min-load
live replica, passing over peers in their dead-peer cooldown unless none
else is left. A relay that finds a
peer dead also folds the death into the plan (`kill_node`).

A relay (`_relay`) packs the envelope once and makes up to two attempts: a
transport failure excludes the peer, starts its cooldown and drops the
session's affinity; a 5xx other than 503 starts the cooldown;
when both attempts fail the answer is 502 "next hop unreachable". A stage
with no live replica answers 503 after the PathFinder's retries. An
envelope for another stage is relayed to a replica of it (not to this
node), or refused with 409 "wrong_stage" in chain mode. The first chunk's
`adapter` key rides the relay, so every stage binds the session's adapter.

The overload plane (the reference's `_forward_inner` and relay):
  * deadlines: an envelope's absolute `deadline_ms` (epoch ms) is checked
    at entry, in the rescue loop, before each relay attempt and after
    compute; a spent one answers 408 "deadline" (`deadline.expired` and
    `deadline.expired.<where>` count it), and each hop's HTTP timeout is
    min(hop_timeout_s, what is left + 50 ms). The relay carries the key on.
  * admission shedding: while a paged pool has fewer free blocks than
    admission_reserve x its blocks, a NEW session (start_pos 0) is shed
    with 503 "busy" and `retry_after` (`_retry_after_s`, in the body and as
    an integer Retry-After header), and the record gossips `shed: 1`; a
    new session's plan and fresh pick charge a shedding replica
    ADMISSION_PENALTY. Mid-session chunks are never shed.
  * session rescue: the record gossips `sess`, the hashes of the newest
    128 sessions whose KV this node holds (control/dht.sess_hash). A
    mid-session chunk for a session this node does not hold goes, marked
    `rescued`, to the replica that advertises it (up to rescue_bounces
    one-bounce relays 0.15 s apart, each after the first paid from the
    node's retry budget), else it is served here and answers 409 for the
    client to restart; `_pick_next` takes the advertised holder (tier 2)
    when it remembers no replica for the session, and /end_session
    forwards an end for a session held elsewhere to its holder.
  * hedged decode relays: a single-token decode relay whose primary has
    not answered within the hedge delay (hedge_delay_ms, or 0: the p95 of
    this node's hop times over the trailing 60 s, 250 ms without any, at
    most half the hop timeout) sends the same bytes to a second replica
    (hedge_mode "advertised": one whose record advertises the session;
    "any": the best other one; "off"), within 5% extra load (a ratio
    budget). The primary's answer, whatever it is, settles the exchange;
    the hedge's only with a 200, which repoints the session's affinity.
    The loser's connection is closed.
  * chaos (utils/chaos.py, run_node --chaos): faults injected before each
    forward's compute; `crash()` stops serving and closes every socket
    without a tombstone, like a killed process.
  * drain: after POST /drain a new session (start_pos 0) is shed with 503
    "draining" and `retry_after`, ahead of the pool check; mid-session
    chunks are served. `admission.shed` counts every shed and
    `admission.shed.<code>` each code's.
Not ported yet: standby holders and session handoff (ROADMAP A4d).

Elasticity (the reference's balancer and live stage migration). A node
built with a stage loader (`load_stage(stage) -> executor`; run_node builds
it from --parts and the node's own flags) can change its stage while it
serves: `change_stage` loads the target's executor and warms it up off the
serving path (a throwaway session's first chunk and one decode step, so
the first decode graph is captured and the kernels built before any
request sees it), swaps it in with its spec and, on a --stage-lanes node, a
new arrival window, drops the chain planner, announces at once, counts
`migrations` and observes `reshard.ms_to_serving`, and releases the old
executor once no call holds it: every reference dropped, its cycles
collected and the caching allocator's blocks given back to the card, under
the capture lock (utils/cuda_graph). A failed load, build or warm-up fails
the migration: the node keeps serving its old stage (the reference swallows
a failed warm-up; the port's rule is the kernel or an error). Requests that
took the old executor finish on it (a use count per executor, taken around
each compute; the old window flushes its pending entries to the old
executor); a chunk for the old stage that arrives after the swap is relayed
to a replica of it. The migration takes the balancer's `_migrating` (its
caller's) and its own `_migration_lock`, both without blocking (a second
migration meanwhile fails), and `_exec_cond` briefly; never `_pick_lock` or
`_affinity_lock`, so the PathFinder's empty-stage hook may run a whole
migration from a relay's fresh pick, which holds the pick lock.
The balancer (control/balance.Balancer) runs on a thread every
rebalance_period_s (jittered) and migrates this node toward a starved or
hot stage; its `adopt_stage` is the PathFinder's empty-stage hook. A node
of stage S that relays a stage-T envelope, finds stage T empty and is moved
to T by that hook during the relay's retries serves the envelope itself.
Each decision counts `stage.adopt.<reason>` (empty_stage, rebalance,
path_finder_empty_stage) until the event journal is ported (ROADMAP A9).
A migration strands the old stage's resident sessions: their next chunk
answers 409 at the old stage's other replica and the client restarts them.

The coalesced relay (the reference's `_relay_window` and
`_handle_multi_forward`). On a `--stage-lanes` node the window's flush
relays the entries it computed: final results, chain-mode entries and
errors go back to their handler threads; every other entry's deadline is
checked (408 "deadline", post-compute), its next hop picked (`_pick_next`)
and the entries grouped by it. A group of one takes the ordinary `_relay`
(a hedge included); a larger one goes as ONE `wire.coalesce_forward` POST,
each frame with its own `deadline_ms`, the groups concurrently. Each
entry's handler answers its downstream (status, body) untouched. A group
whose POST fails in transport, answers other than 200 or sends a malformed
multi reply falls back to concurrent per-session `_relay`s
(`hop.coalesced_fallback`, one warning). `hop.count` counts the relay POSTs
(`hop.coalesced`, `hop.coalesced_sessions` the coalesced ones and their
sessions). A /forward whose envelope holds `multi` is split
(`wire.split_forward`, 400 "bad multi envelope" when that fails), its
frames run through the ordinary forward path concurrently, on threads, so
that they co-arrive in this node's window and co-batch (rescue, deadlines,
chaos and admission per frame), and the answer is {"multi": [{"status",
"body"}...]} in frame order (`forward.multi_envelopes`, `.multi_frames`).
The flush runs on a handler thread that holds neither the window (its
flusher slot is free again before the step) nor the executor's lock nor
the device while it waits on a hop: the next window computes meanwhile.

A payload with `decode_steps` K asks a one-stage (whole-model) node for a
fused window of K decode steps sampled on the device (the one-session
executor's `_process_decode_k`; on a lane node, a K-step item that
co-batches with the window's others); the reply's `result` holds the
committed `tokens`, `real_len`, `decode_steps` and the advanced `key`.

Errors are wire-packed {"error", "code"} bodies with the JAX node's codes:
409 "wrong_stage" (the chain's address list is stale), 409 "overflow" (KV
budget, a K-step window's too), 409 "session_state" (out-of-order chunk;
`decode_steps` to a stage of a multi-stage chain), 409
"no_adapter_registry" (the payload names an adapter and this node serves
no `--adapters` registry: serving the base model instead would be silent
tenant corruption), 409 "unknown_adapter" (a name outside the catalog), 503
"busy" (every lane, or every adapter slot, held by live sessions; or a new
session shed, with `retry_after`), 503 (no live node for the next stage),
502 (next hop unreachable), 408 "deadline" (the envelope's deadline is
spent), 500 on a compute failure or a chaos drop.

Requests are served on threads (ThreadingHTTPServer). With the one-cache-
per-session executor, compute is serialized under one node lock. The lane
executors (`threadsafe`) have locks of their own and the node holds none
around their compute. To the pipeline stage's (runtime/stage_batch,
`--stage-lanes`) the node attaches an arrival window (runtime/window):
decode steps of concurrent sessions join it and run as ONE device step,
whose results the flush relays (the coalesced relay above) or returns to
their own handler threads; prefill chunks go straight to the executor's
`process`. The whole-model one (runtime/batch_executor, `--batch-lanes`)
owns its window, so every request goes straight to its `process` and the
node wraps it in no window of its own (a decode step would otherwise queue
twice). Neither the compute lock nor a window is held across a downstream
hop.
"""

from __future__ import annotations

import contextlib
import functools
import http.client
import json
import logging
import math
import os
import select
import socket
import threading
import time
import uuid
import weakref
from collections import Counter, OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferd_tpu_torch.client.base import http_post
from inferd_tpu_torch.control.balance import Balancer
from inferd_tpu_torch.control.dht import SwarmDHT, sess_hash
from inferd_tpu_torch.control.path_finder import NoNodeForStage, PathFinder, node_addr
from inferd_tpu_torch.ops import attention as attention_ops
from inferd_tpu_torch.ops import lora, qmatmul
from inferd_tpu_torch.ops.quant import quantized_bytes
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.adapters import (
    AdapterAffinity, AdapterCapacityError, UnknownAdapterError,
)
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor, CapacityError
from inferd_tpu_torch.runtime.window import WindowedBatcher
from inferd_tpu_torch.utils import retry as retrylib
from inferd_tpu_torch.utils.chaos import Chaos, ChaosDrop
from inferd_tpu_torch.utils.cuda_graph import release_device_memory
from inferd_tpu_torch.utils.metrics import Metrics, TrailingWindow
from inferd_tpu_torch.utils.platform import device_name
from inferd_tpu_torch.utils.profiling import Profiler, span

log = logging.getLogger(__name__)

FORWARD_PATH = "/forward"
END_SESSION_PATH = "/end_session"
PROFILE_PATH = "/profile"
REASSIGN_PATH = "/reassign"
DRAIN_PATH = "/drain"

Reply = Tuple  # (status, content type, body[, headers])
_WIRE = "application/octet-stream"
SWEEP_INTERVAL_S = 30.0  # how often /forward drops sessions idle past their TTL
AFFINITY_MAX_AGE_S = 3600.0  # the sweep drops affinity entries unused this long
HOP_TIMEOUT_S = 120.0  # one relay hop's HTTP timeout (the reference's)
RELAY_ATTEMPTS = 2  # picks per relay: the first, and one past a dead hop
SESSION_NEXT_CAP = 8192  # (session, stage) -> next-hop affinity entries kept
HELD_WINDOW_S = 600.0  # an affinity entry or a plan this old no longer counts as a held session
ROUTES_SHOWN = 16  # the newest planned routes /stats lists
SVC_EWMA_KEEP = 0.8  # svc_ms's EWMA: the old value's weight (the reference's)
SESS_ADVERTISED = 128  # the newest sessions a record's `sess` lists
RESCUE_PAUSE_S = 0.15  # between rescue bounces
HEDGE_MODES = ("advertised", "any", "off")
HEDGE_FALLBACK_S = 0.25  # the hedge delay while no hop time is in the window
TRAILING_WINDOW_S = 60.0  # the hedge delay's window of hop times
DRAIN_WAIT_S = 5.0  # /drain's default wait for the /forward requests in flight
WARMUP_SESSION = "__warmup__"
# reshard.ms_to_serving's buckets: wider than the hop histograms', so a slow
# migration's quantiles do not saturate at the default 10 s cap
RESHARD_BOUNDS_MS = [100, 250, 500, 1000, 2500, 5000, 10_000, 30_000, 60_000, 120_000,
                     300_000, 600_000]
RETIRE_WAIT_S = 300.0  # how long a migration waits for the old executor's calls to end
RETIRE_REF_WAIT_S = 10.0  # and then for the last reference to it to go (longer off-thread)


def _start_pos(payload) -> int:
    """A payload's start_pos, or -1 when it has none (or a malformed one:
    the guarded compute reports that)."""
    try:
        return int(payload.get("start_pos", -1))
    except (TypeError, ValueError, AttributeError):
        return -1


def _is_decode_step(payload) -> bool:
    """True when a /forward payload is a single-token decode step at an
    established frontier: the only shape the window co-batches (prefill
    chunks and new sessions keep the per-session path)."""
    if not isinstance(payload, dict):
        return False
    try:
        if int(payload.get("start_pos", 0)) <= 0:
            return False
        n = payload.get("real_len")
        if n is None:
            x = payload.get("tokens")
            n = (x if x is not None else payload.get("hidden")).shape[1]
        return int(n) == 1
    except (TypeError, ValueError, AttributeError, IndexError):
        return False  # malformed payloads fail in the guarded compute


class _Relayed:
    """A window entry's answer that the flush already has: its downstream
    reply (or a 408/503 of this node's), which the handler sends as is."""

    __slots__ = ("reply",)

    def __init__(self, reply: Tuple):
        self.reply = reply


def _run_all(jobs: Sequence[Callable[[], None]]) -> None:
    """Run the jobs concurrently, the first on this thread and each other on
    a thread of its own, and return when all have. A job reports through
    its own state and must not raise."""
    threads = [threading.Thread(target=job, daemon=True) for job in jobs[1:]]
    for t in threads:
        t.start()
    if jobs:
        jobs[0]()
    for t in threads:
        t.join()


def warm_up(executor) -> None:
    """A freshly loaded executor's first steps, off the serving path: a
    throwaway session's first chunk (two tokens; past the first stage two
    rows of zero hidden state) and one decode step, then the session ends.
    So the new stage's first decode graph is captured and its kernels built
    before any request sees it. The counter model takes one counter step.
    Raises whatever the executor raises: a migration whose warm-up fails
    does not happen."""
    spec, cfg = executor.spec, getattr(executor, "cfg", None)

    def chunk(n: int, start: int) -> Dict[str, Any]:
        if cfg is None:
            return {"state": spec.stage, "start_pos": start, "real_len": n}
        if spec.is_first:
            return {"tokens": np.ones((1, n), np.int32), "start_pos": start, "real_len": n}
        return {"hidden": torch.zeros((1, n, cfg.hidden_size)), "start_pos": start,
                "real_len": n}

    try:
        executor.process(WARMUP_SESSION, chunk(2, 0))
        if cfg is not None:
            executor.process(WARMUP_SESSION, chunk(1, 2))
    finally:
        with contextlib.suppress(Exception):  # a failed step's error is the one raised
            executor.end_session(WARMUP_SESSION)


class _HopPost:
    """One /forward POST to a peer, sent at once, whose reply is awaited in
    steps (`ready`, then `read`), so a hedge can go out beside it while it
    is slow; `close` ends it on this side (a hedge's loser)."""

    def __init__(self, value: Dict[str, Any], body: bytes, timeout_s: float):
        host, port = node_addr(value)
        self.deadline = time.monotonic() + timeout_s
        self.conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            self.conn.request("POST", FORWARD_PATH, body=body,
                              headers={"Content-Type": _WIRE})
        except BaseException:
            self.conn.close()
            raise

    def fileno(self) -> int:  # select() waits on the connection's socket
        return self.conn.sock.fileno()

    def ready(self, wait_s: float) -> bool:
        """Whether the reply (or the peer's close) arrived within wait_s."""
        return bool(select.select([self], [], [], max(0.0, wait_s))[0])

    def read(self) -> Tuple[int, bytes]:
        """(status, body), waiting at most until the POST's timeout runs out."""
        self.conn.sock.settimeout(max(0.001, self.deadline - time.monotonic()))
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def close(self) -> None:
        self.conn.close()


class _Server(ThreadingHTTPServer):
    """The node's HTTP server, which knows its open connections so that
    crash() can cut them as a killed process's die."""

    daemon_threads = True

    def __init__(self, *args, **kw):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kw)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def cut_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            with contextlib.suppress(OSError):
                c.shutdown(socket.SHUT_RDWR)


class Node:
    """One stage: an executor behind a small HTTP server, a member of the
    swarm through its gossip store."""

    def __init__(
        self,
        executor,  # Qwen3StageExecutor, BatchedStageExecutor, BatchedExecutor or the counter
        host: str = "127.0.0.1",
        port: int = 0,
        window_ms: float = 2.0,
        quant: str = "none",  # the run_node --quant flag the params were loaded with
        enable_profiling: bool = False,  # POST /profile (off: any peer could fill the disk)
        profile_dir: str = "profiles",
        gossip_port: int = 0,  # the gossip store's UDP port (0: an ephemeral one)
        bootstrap: Sequence[Tuple[str, int]] = (),  # gossip seeds
        capacity: int = 4,  # the advertised task capacity (`cap`)
        model_name: str = "",  # the advertised model
        hop_timeout_s: float = HOP_TIMEOUT_S,  # a relay hop's HTTP timeout
        hedge_delay_ms: float = 0.0,  # 0: adaptive (the trailing hop p95)
        hedge_mode: str = "advertised",  # HEDGE_MODES
        admission_reserve: float = 0.05,  # shed new sessions under this free-block share
        rescue_bounces: int = 6,  # one-bounce rescue relays before a 409
        chaos: Optional[Chaos] = None,  # faults injected before each forward
        name: Optional[str] = None,  # the record's name (run_node --name), else host:port
        load_stage: Optional[Callable[[int], Any]] = None,  # stage -> its executor (migrations)
        rebalance_period_s: float = 10.0,  # the balancer's period
    ):
        if hedge_mode not in HEDGE_MODES:
            raise ValueError(f"hedge_mode {hedge_mode!r} not in {HEDGE_MODES}")
        self.executor = executor
        self.spec = executor.spec
        self.quant = quant
        self.param_bytes = quantized_bytes(executor.params)
        self.device = device_name(executor.device)
        self.window_ms = window_ms
        self.hop_timeout_s = hop_timeout_s
        self.window: Optional[WindowedBatcher] = (
            self._attach_window(executor) if isinstance(executor, BatchedStageExecutor) else None)
        # the elasticity plane: the executor, its spec and window are swapped
        # together under _exec_cond, which also guards the calls each executor
        # has in flight (_uses; _tls.uses: this thread's)
        self.load_stage = load_stage
        self.rebalance_period_s = rebalance_period_s
        self._exec_cond = threading.Condition(threading.Lock())
        self._uses: Dict[Any, int] = {}
        self._tls = threading.local()
        self._migration_lock = threading.Lock()
        self.last_migration: Optional[Dict[str, Any]] = None
        self._draining = False
        self._compute_lock = threading.Lock()  # around the per-session executor only
        self._stats_lock = threading.Lock()
        self.forward_passes = 0
        self.errors = 0
        self._last_sweep = time.monotonic()
        self._server = _Server((host, port), _handler_for(self))
        self._stopped = False
        self.host, self.port = self._server.server_address[:2]
        self.node_id = f"{self.host}:{self.port}"
        self.name = name or self.node_id
        self._thread: Optional[threading.Thread] = None
        self.enable_profiling = enable_profiling
        self.profiler = Profiler(base_dir=profile_dir)
        # the swarm half: membership, next hops, relays
        self.capacity = capacity
        self.model_name = model_name
        self.dht = SwarmDHT(self.node_id, gossip_port, bootstrap=list(bootstrap), host=host)
        self.balancer = Balancer(self.dht, self.spec.num_stages,
                                 get_own_stage=lambda: self.spec.stage,
                                 change_stage=self.change_stage, period_s=rebalance_period_s,
                                 on_event=self._balancer_event)
        self.path_finder = PathFinder(self.dht, self.spec.num_stages,
                                      on_empty_stage=self._adopt_empty_stage)
        # (session_id, stage) -> (the replica that holds the session's KV
        # there, when this node last routed the session to it)
        self._session_next: "OrderedDict[Tuple[str, int], Tuple[str, float]]" = OrderedDict()
        # session -> (its planned route {str(stage): node_id}, when planned):
        # held sessions for later plans and picks until the session ends
        self._planned: "OrderedDict[str, Tuple[Dict[str, str], float]]" = OrderedDict()
        self._recent_routes: deque = deque(maxlen=ROUTES_SHOWN)
        self._affinity_lock = threading.Lock()
        self._pick_lock = threading.Lock()  # a fresh pick or a plan and its record, as one step
        self._svc_ewma: Optional[float] = None  # the announced svc_ms
        self.inflight = 0  # /forward requests in this node now: the announced load
        self.relays = 0  # envelopes this node relayed (one per relay, whatever its attempts)
        self.dead_hops = 0  # relay attempts that met a transport failure
        # the overload plane
        self.metrics = Metrics()
        self.hop_times = TrailingWindow(TRAILING_WINDOW_S)  # the adaptive hedge delay's window
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_mode = hedge_mode
        self.hedge_budget = retrylib.RatioBudget(ratio=0.05, burst=2)  # hedges <= 5% extra
        self.retry_budget = retrylib.RetryBudget(rate_per_s=4.0, burst=16)  # rescue bounces
        self.admission_reserve = admission_reserve
        self.rescue_bounces = max(1, int(rescue_bounces))
        self.chaos = chaos
        if chaos is not None and chaos.crash_after:
            # crash off the handler thread that tripped it (crash() cuts it too)
            chaos.on_crash = lambda: threading.Thread(target=self.crash, daemon=True).start()

    def _attach_window(self, executor: BatchedStageExecutor) -> WindowedBatcher:
        """The lane executor's arrival window, bound to it: co-arriving
        decode steps of different sessions become ONE process_batch step of
        this executor (a migration gives the new executor a window of its
        own, and the old one flushes what it holds to the old executor)."""
        window = WindowedBatcher(
            self.window_ms / 1e3,
            lambda: self._run_stage_window(executor, window),
            # lock-free live-session count: a solo session must not pay the
            # window (and co_possible runs under the batcher's lock: taking
            # the executor's lock there would invert on_drop -> invalidate)
            co_possible=executor.co_possible,
            # gang formation: wait (up to window_ms) for every live idle
            # session's step, which merges phase-offset cohorts
            gang_target=executor.gang_target,
            # the flush relays its entries: two hop attempts may pass first
            wait_timeout_s=2 * self.hop_timeout_s + 30,
        )
        executor.on_drop = lambda sid: window.invalidate(
            lambda payload, _sid=sid: payload[0] == _sid,
            ValueError(f"session {sid} ended mid-request"),
        )
        return window

    def _run_stage_window(self, executor, window: WindowedBatcher) -> None:
        """WindowedBatcher flush callback (a handler thread, no locks held):
        ONE co-batched device step for every co-arrived decode entry, then
        the relay of the entries that go on (`_relay_window`). The batch is
        drained once the executor holds the device (continuous batching: it
        forms when the step takes the device, not when the flusher wakes);
        the drained entries are ours to deliver, results and events.
        Per-entry failures set entry.error (one stale session must not fail
        its co-batch). Final results and chain-mode entries return to their
        handler threads as computed."""
        drained: list = []
        t0: List[float] = []

        def drain():  # called once the executor holds the device
            if not t0:
                t0.append(time.perf_counter())
            extra = window.drain_pending()
            drained.extend(extra)
            return [(e.payload[0], e.payload[1]) for e in extra]

        try:
            outs = executor.process_batch([], drain=drain)
            if t0:  # each entry of the step counts the step's time
                self._note_compute((time.perf_counter() - t0[0]) * 1e3,
                                   sum(not isinstance(o, Exception) for o in outs))
            relays = []
            for e, out in zip(drained, outs):
                if isinstance(out, Exception):
                    e.error = out
                elif e.payload[2].get("relay", True) and not self._is_final(out):
                    relays.append((e, out))
                else:
                    e.result = out
            if relays:
                self._relay_window(relays)
        except Exception as exc:
            for e in drained:
                if e.error is None and e.result is None:
                    e.error = exc
            raise
        finally:
            for e in drained:
                if e.error is None and e.result is None:
                    e.error = RuntimeError("window flush dropped an entry")
                e.event.set()

    def _relay_window(self, relays) -> None:
        """Relay one flushed window's entries that go on: each one's deadline
        checked, its next hop picked, the entries grouped by hop; a group of
        one takes `_relay`, a larger one ONE coalesced POST (`_relay_group`),
        the groups concurrently. Sets each entry's result or error."""
        groups: "OrderedDict[str, Tuple[Dict[str, Any], list]]" = OrderedDict()
        for e, result in relays:
            session_id, _payload, env = e.payload
            try:
                next_env = self._next_env(env, session_id, result)
                rem = retrylib.remaining_s(next_env.get(retrylib.DEADLINE_KEY))
                if rem is not None and rem <= 0:
                    e.result = _Relayed(self._deadline_error("post-compute"))
                    continue
                nid, value = self._pick_next(session_id, next_env["stage"],
                                             route=next_env.get("route"))
            except NoNodeForStage as exc:
                e.result = _Relayed(self._error(503, f"no next node: {exc}"))
                continue
            except Exception as exc:  # the entry fails alone
                e.error = exc
                continue
            groups.setdefault(nid, (value, []))[1].append((e, next_env))
        _run_all([functools.partial(self._relay_entry, *members[0]) if len(members) == 1
                  else functools.partial(self._relay_group, nid, value, members)
                  for nid, (value, members) in groups.items()])

    def _relay_entry(self, e, next_env: Dict[str, Any]) -> None:
        """One window entry's ordinary relay (the bytes a lone session sends)."""
        t1 = time.perf_counter()
        try:
            reply = self._relay(next_env, next_env["stage"])
        except NoNodeForStage as exc:
            e.result = _Relayed(self._error(503, f"no next node: {exc}"))
            return
        except Exception as exc:
            e.error = exc
            return
        self._observe_hop((time.perf_counter() - t1) * 1e3)
        e.result = _Relayed(reply)

    def _relay_group(self, nid: str, value: Dict[str, Any], members: list) -> None:
        """ONE coalesced POST for a group sharing its next hop; each member
        gets its frame's (status, body). A transport failure, an answer
        other than 200 or a malformed multi reply falls back to concurrent
        per-session relays: coalescing is never a new failure mode."""
        envs = [ne for _e, ne in members]
        deadlines = [retrylib.remaining_s(ne.get(retrylib.DEADLINE_KEY)) for ne in envs]
        timeout_s = self.hop_timeout_s
        if None not in deadlines:  # +50 ms: the next node's own 408s win the race
            timeout_s = min(timeout_s, max(deadlines) + 0.05)
        t1 = time.perf_counter()
        try:
            with span("wire.pack"):
                body = wire.pack(wire.coalesce_forward(envs))
            self.metrics.inc("hop.count")
            self.metrics.inc("hop.coalesced")
            self.metrics.inc("hop.coalesced_sessions", len(members))
            with self._stats_lock:
                self.relays += len(members)
            host, port = node_addr(value)
            with span("relay.hop"):
                status, raw, _ = http_post(f"http://{host}:{port}{FORWARD_PATH}", body,
                                           timeout_s)
            if status != 200:
                raise RuntimeError(f"answered {status}")
            reply = wire.unpack(raw)
            frames = reply.get(wire.MULTI_KEY) if isinstance(reply, dict) else None
            if (not isinstance(frames, list) or len(frames) != len(members)
                    or not all(isinstance(fr, dict) and type(fr.get("status")) is int
                               and isinstance(fr.get("body"), bytes) for fr in frames)):
                raise ValueError("malformed multi reply")
        except Exception as exc:
            log.warning("coalesced relay of %d sessions to %s failed (%s); per-session "
                        "fallback", len(members), nid, exc)
            self.metrics.inc("hop.coalesced_fallback")
            _run_all([functools.partial(self._relay_entry, e, ne) for e, ne in members])
            return
        self._observe_hop((time.perf_counter() - t1) * 1e3)
        if any(fr["status"] >= 500 and fr["status"] != 503 for fr in frames):
            self._note_peer_failure(nid)  # as _relay: it answered, broken
        for (e, _ne), fr in zip(members, frames):
            e.result = _Relayed((fr["status"], _WIRE, fr["body"]))

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Node":
        """Start the gossip store (a failed bind raises), announce this node,
        serve on a background thread and start the balancer; returns self."""
        self.dht.start()
        self.announce()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"node-{self.port}", daemon=True
        )
        self._thread.start()
        self.balancer.start()
        return self

    def stop(self) -> None:
        """Withdraw from the swarm (a tombstone), stop the gossip thread,
        release any chaos-stalled request, stop serving and release the
        sockets; a trace still running is stopped and written."""
        if self._stopped:
            return
        self._stopped = True
        self.balancer.stop()
        self.dht.withdraw()
        self.dht.stop()
        if self.chaos is not None:
            self.chaos.cancel_stalls()  # a stalled handler must not outlive the node
        self._close_server()
        if self.profiler.active_dir is not None:
            try:
                self.profiler.stop()
            except RuntimeError:  # a window's timer stopped it meanwhile
                pass

    def crash(self) -> None:
        """Die like a killed process: no tombstone (peers learn of it when
        its record's TTL runs out), every open connection cut, the sessions'
        KV lost with the node. Fault injection (chaos crash_after, tests);
        a node leaves the swarm with stop()."""
        if self._stopped:
            return
        self._stopped = True
        self.dht.kill()
        self.balancer.stop()
        self._server.cut_connections()  # before a released stall could answer
        if self.chaos is not None:
            self.chaos.cancel_stalls()
        self._close_server(cut=True)  # and whatever arrived meanwhile

    def _close_server(self, cut: bool = False) -> None:
        """Stop accepting, cut the open connections when `cut`, close."""
        if self._thread is not None:
            self._server.shutdown()
        if cut:
            self._server.cut_connections()
        self._server.server_close()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        self._thread = None

    # -- membership -----------------------------------------------------------

    def announce(self, urgent: bool = True) -> None:
        """Publish this node's record: urgent gossips it at once, else the
        gossip thread carries it at its next period."""
        with self._stats_lock:
            load = self.inflight
        ex = self.executor
        record = {
            "name": self.name,
            "stage": ex.spec.stage,
            "load": load,
            "cap": self.capacity,
            "host": self.host,
            "port": self.port,
            "model": self.model_name,
        }
        # the reference's optional keys, in its order; absent when false or
        # empty (svc_ms until the first compute), so such a record is the
        # same bytes as before them
        with self._stats_lock:
            svc = self._svc_ewma
        if svc is not None:
            record["svc_ms"] = round(svc, 3)
        digest = getattr(ex, "prefix_digest", None)
        pfx = digest() if callable(digest) else None
        if pfx:
            record["pfx"] = pfx
        ada = self._adapter_digest(ex)
        if ada is not None:
            record["ada"] = ada
        if self._pool_under_reserve(ex) is not None:
            record["shed"] = 1
        if self._draining:  # both routers leave a draining replica out
            record["draining"] = 1
        sess = self._advertised_sessions(ex)
        if sess:
            record["sess"] = sess
        self.dht.announce(record, urgent=urgent)

    def _adapter_digest(self, ex) -> Optional[List[str]]:
        """The `ada` field: the resident tenant adapters (at most
        ADA_GOSSIP_MAX), which entry routers score a tenant session's
        adapter against (AdapterAffinity); or None, the key left out, on a
        node without --adapters. An empty registry announces [], since the
        key's presence marks the capability."""
        reg = getattr(ex, "adapters", None)
        return None if reg is None else reg.resident_names()

    def _advertised_sessions(self, ex=None) -> list:
        """Hashes of the newest SESS_ADVERTISED sessions whose KV lives here,
        sorted: a peer that meets a chunk of one of them (a failed-over entry,
        a relay whose affinity died) routes it here instead of answering 409."""
        ids = getattr(getattr(self.executor if ex is None else ex, "sessions", None), "ids", None)
        if not callable(ids):
            return []
        return sorted(sess_hash(s) for s in ids()[-SESS_ADVERTISED:])

    def _pool_under_reserve(self, ex=None):
        """(free, total, reserve) while the paged block pool of `ex` (the
        node's executor by default) has fewer free blocks than its admission
        reserve, else None (also without a pool)."""
        pool = getattr(self.executor if ex is None else ex, "pool", None)
        if pool is None:
            return None
        total, free = int(pool.num_blocks), int(pool.blocks_free)
        reserve = max(1, int(self.admission_reserve * total))
        return (free, total, reserve) if free < reserve else None

    def _retry_after_s(self) -> float:
        """A shed's Retry-After: about one arrival window per unit of queue
        pressure (inflight / cap), at least 50 ms, at most 5 s, so shed
        clients come back spread over a few windows, not as one wave."""
        with self._stats_lock:
            inflight = self.inflight
        base = max(self.window_ms / 1e3, 0.05)
        return round(min(5.0, base * (1.0 + inflight / max(1, self.capacity))), 3)

    def _admission_shed(self, ex) -> Optional[Tuple[str, str]]:
        """(code, message) when a NEW session must be shed, else None:
        "draining" after POST /drain, "busy" while the paged pool is under
        its admission reserve."""
        if self._draining:
            return "draining", "node is draining: not admitting new sessions"
        low = self._pool_under_reserve(ex)
        if low is not None:
            return "busy", (f"KV block pool low: {low[0]} free of {low[1]} (admission "
                            f"reserve {low[2]})")
        return None

    def _holds_session(self, session_id: str) -> bool:
        store = getattr(self.executor, "sessions", None)
        return store is not None and session_id in store

    def _gossip_session_holder(self, session_id: str, stage: int, exclude=None) -> Optional[str]:
        """A live replica of `stage` whose record advertises the session."""
        h = sess_hash(session_id)
        for nid, value in self.dht.get_stage(stage).items():
            if not (exclude and nid in exclude) and h in (value.get("sess") or ()):
                return nid
        return None

    def _note_compute(self, ms: float, n: int = 1) -> None:
        """`n` forwards' compute took `ms` each: fold them into svc_ms and
        the `stage.compute_ms` histogram."""
        for _ in range(n):
            self.metrics.observe("stage.compute_ms", ms)
        with self._stats_lock:
            for _ in range(n):
                self._svc_ewma = (ms if self._svc_ewma is None
                                  else SVC_EWMA_KEEP * self._svc_ewma
                                  + (1.0 - SVC_EWMA_KEEP) * ms)

    def _add_inflight(self, n: int) -> None:
        with self._stats_lock:
            self.inflight += n
        self.announce(urgent=False)

    # -- next hops ------------------------------------------------------------

    def _pick_next(self, session_id: Optional[str], stage: int, exclude=None,
                   prefer: Optional[str] = None, new_session: bool = False,
                   route: Optional[Dict[str, str]] = None):
        """The next replica for (session, stage): `prefer` (a replica the
        caller verified, the rescue's holder) while its record lives and it
        is not excluded; else (1) the replica this node routed the session
        to before, while its record lives and it is not excluded (its KV is
        there); else (2) a replica whose record advertises the session;
        else (3) the planned `route`'s replica for the stage while its record
        lives and it is neither excluded nor inside its dead-peer cooldown
        (`route.followed`; `route.stale` otherwise); else (4) the min-load
        live replica, outside the dead-peer cooldown where the stage allows,
        each replica's gossiped load counted with the sessions this node
        holds on it (`_held`), a shedding one ranked worse for a
        `new_session`. The pick is remembered for the session. Raises
        NoNodeForStage."""
        key = (session_id, stage) if session_id else None
        if prefer is not None and not (exclude and prefer in exclude):
            value = self.dht.get_stage(stage).get(prefer)
            if value is not None:
                if key is not None:
                    self._remember(key, prefer)
                return prefer, value
        if key is not None:
            with self._affinity_lock:
                nid, _ = self._session_next.get(key, (None, 0.0))
            if nid is not None:
                value = self.dht.get_stage(stage).get(nid)
                if value is not None and not (exclude and nid in exclude):
                    self._remember(key, nid)
                    return nid, value
                # the remembered replica is gone and the session's KV with it:
                # a replica advertising the session, else a fresh pick (a
                # mid-session chunk there answers 409)
                with self._affinity_lock:
                    self._session_next.pop(key, None)
            nid = self._gossip_session_holder(session_id, stage, exclude)
            value = self.dht.get_stage(stage).get(nid) if nid is not None else None
            if value is not None:
                self.metrics.inc("route.sess_gossip")
                self._remember(key, nid)
                return nid, value
        if route:
            nid = route.get(str(stage))
            value = self.dht.get_stage(stage).get(nid) if nid else None
            if (value is not None and not (exclude and nid in exclude)
                    and nid not in self.path_finder.cooling()):
                self.metrics.inc("route.followed")
                if key is not None:
                    self._remember(key, nid)
                return nid, value
            # the planned replica died, failed this relay or was seen dead
            # since the plan (a route steers; no KV of the session is there
            # yet): the fresh pick, which affinity then pins
            self.metrics.inc("route.stale")
        with self._pick_lock:
            nid, value = self.path_finder.find_best_node(
                stage, exclude=self._with_cooldown(stage, exclude), held=self._held(stage),
                new_session=new_session)
            if key is not None:
                self._remember(key, nid)
        return nid, value

    def _plan_route(self, start_stage: int, session_id: str,
                    affinity: Any = None) -> Optional[Dict[str, str]]:
        """A new session's route {str(stage): node_id} for stages
        start_stage..last (PathFinder.find_best_chain), planned over the
        records with this node's held sessions added to their loads and
        shedding replicas charged ADMISSION_PENALTY, and recorded for the
        session as one step under the pick lock. `affinity` (a tenant
        session's AdapterAffinity) re-ranks the route's first stage by the
        bounded bonus of a replica gossiping the adapter resident. None when
        no complete chain exists (the caller keeps the per-hop pick)."""
        with self._pick_lock:
            try:
                chain = self.path_finder.find_best_chain(
                    start_stage, affinity=affinity, held=self._held(), new_session=True)
            except NoNodeForStage:
                self.metrics.inc("route.plan_failed")
                return None
            except Exception:
                log.exception("chain planning failed; per-hop fallback")
                self.metrics.inc("route.plan_failed")
                return None
            route = {str(s): nid for s, (nid, _) in enumerate(chain, start=start_stage)}
            with self._affinity_lock:
                self._planned[session_id] = (route, time.monotonic())
                self._planned.move_to_end(session_id)
                while len(self._planned) > SESSION_NEXT_CAP:
                    self._planned.popitem(last=False)
                self._recent_routes.append({"session": session_id, "route": route})
        self.metrics.inc("route.planned")
        return route

    def _remember(self, key: Tuple[str, int], nid: str) -> None:
        with self._affinity_lock:
            self._session_next[key] = (nid, time.monotonic())
            self._session_next.move_to_end(key)
            while len(self._session_next) > SESSION_NEXT_CAP:
                self._session_next.popitem(last=False)

    def _held(self, stage: Optional[int] = None) -> Dict[str, int]:
        """Sessions this node routed (its affinity entries) or planned
        through each replica (of `stage`, or of every stage) and has not
        ended, within HELD_WINDOW_S; where both name a replica for a
        session and stage, the routed one. The gossiped load reaches this
        node a gossip period late and counts requests, not sessions: new
        sessions entering here at once would all pick the same replica."""
        cutoff = time.monotonic() - HELD_WINDOW_S
        held: Dict[Tuple[str, int], str] = {}
        with self._affinity_lock:
            for sid, (route, t) in self._planned.items():
                if t >= cutoff:
                    held.update(((sid, int(s)), nid) for s, nid in route.items()
                                if stage is None or int(s) == stage)
            held.update(((sid, s), nid) for (sid, s), (nid, t) in self._session_next.items()
                        if (stage is None or s == stage) and t >= cutoff)
        return Counter(held.values())

    def _with_cooldown(self, stage: int, exclude):
        """The exclude set of a fresh pick, with the peers inside their
        dead-peer cooldown added unless that leaves the stage no candidate
        (availability beats steering)."""
        base = set(exclude or ())
        cooling = self.path_finder.cooling() - base
        if not cooling:
            return exclude
        alive = set(self.dht.get_stage(stage)) - base
        return base | cooling if alive - cooling else exclude

    def _note_peer_failure(self, node_id: str) -> None:
        """Start a peer's dead-peer cooldown: fresh picks steer around it."""
        self.metrics.inc("peer.cooldown")
        self.path_finder.note_peer_dead(node_id)

    def _relay(self, env: Dict[str, Any], stage: int, exclude=None,
               prefer: Optional[str] = None, phase: str = "relay",
               attempts: int = RELAY_ATTEMPTS) -> Reply:
        """Send `env` to a replica of `stage` and answer with its reply, status
        and raw body untouched. The envelope is packed once; a transport
        failure re-picks without the dead peer, up to `attempts` picks (the
        rescue's one-bounce relays take one, to its `prefer`red holder).
        Each attempt first checks the envelope's deadline (408) and clamps
        its timeout to what is left of it; a plain relay of a decode step
        may hedge (`_relay_exchange`). Raises NoNodeForStage when the stage
        has no live replica to pick."""
        exclude = set(exclude or ())
        session_id = env.get("session_id")
        deadline_ms = env.get(retrylib.DEADLINE_KEY)
        payload = env.get("payload")
        route = env.get("route")
        may_hedge = (phase == "relay" and prefer is None and self.hedge_mode != "off"
                     and _is_decode_step(payload))
        new_session = _start_pos(payload) == 0
        with span("wire.pack"):
            body = wire.pack(env)
        self.metrics.inc("hop.count")
        with self._stats_lock:
            self.relays += 1
        self.hedge_budget.note()  # one primary send: the hedges' denominator
        last_err: Optional[Exception] = None
        for attempt in range(attempts):
            node_id, value = self._pick_next(session_id, stage, exclude,
                                             prefer=prefer if attempt == 0 else None,
                                             new_session=new_session, route=route)
            rem = retrylib.remaining_s(deadline_ms)
            if rem is not None and rem <= 0:
                return self._deadline_error("relay")
            # +50 ms: the next node's own 408 wins the race with this timeout
            timeout_s = self.hop_timeout_s if rem is None else min(self.hop_timeout_s, rem + 0.05)
            try:
                with span("relay.hop"):
                    status, raw = self._relay_exchange(
                        body, stage, node_id, value, timeout_s, session_id, exclude,
                        allow_hedge=may_hedge and attempt == 0)
            except (OSError, http.client.HTTPException, ValueError) as e:
                last_err = e
                self._note_peer_failure(node_id)
                exclude.add(node_id)
                if session_id is not None:
                    with self._affinity_lock:  # the replica and the session's KV are gone
                        self._session_next.pop((session_id, stage), None)
                with self._stats_lock:
                    self.dead_hops += 1
                self.metrics.inc("hop.dead")
                log.warning("next hop %s for stage %d unreachable: %s", node_id, stage, e)
                continue
            if status >= 500 and status != 503:
                # it answered, broken: steer fresh picks away for a while (a
                # 503 is a busy or empty stage, not a sick peer)
                self._note_peer_failure(node_id)
            return status, _WIRE, raw
        return self._error(502, f"next hop unreachable: {last_err}")

    def _relay_exchange(self, body: bytes, stage: int, node_id: str, value: Dict[str, Any],
                        timeout_s: float, session_id: Optional[str], exclude: set,
                        allow_hedge: bool) -> Tuple[int, bytes]:
        """One hop: POST `body` to `node_id`; with `allow_hedge`, when it has
        not answered within the hedge delay and a target and budget exist,
        POST the same bytes to the hedge target too. The primary's answer,
        whatever it is, settles the exchange at once (a 409 or 500 must reach
        the caller's bookkeeping about the replica it picked); the hedge's
        only with a 200, which repoints the session's affinity to the hedge.
        The loser's connection is closed. When neither answers, the
        primary's failure is raised. Transport failures raise."""
        if not allow_hedge:
            host, port = node_addr(value)
            status, raw, _ = http_post(f"http://{host}:{port}{FORWARD_PATH}", body, timeout_s)
            return status, raw
        primary = _HopPost(value, body, timeout_s)
        try:
            if not primary.ready(self._hedge_delay_s(timeout_s)):
                target = self._hedge_target(session_id, stage, {node_id, *exclude})
                if target is not None and self.hedge_budget.try_acquire():
                    return self._hedged(primary, target, body, stage, session_id, timeout_s)
            return primary.read()
        finally:
            primary.close()

    def _hedged(self, primary: _HopPost, target, body: bytes, stage: int,
                session_id: Optional[str], timeout_s: float) -> Tuple[int, bytes]:
        """The primary is slow: send the hedge and take the first definitive
        answer (see _relay_exchange)."""
        hid, hvalue = target
        self.metrics.inc("hedge.fired")
        log.info("hedging stage %d for session %s at %s", stage, session_id, hid)
        try:
            hedge = _HopPost(hvalue, body, timeout_s)
        except (OSError, http.client.HTTPException):
            return primary.read()  # the hedge target is gone: the primary alone
        pending = [primary, hedge]
        failure: Optional[Exception] = None
        try:
            while pending:
                wait = min(p.deadline for p in pending) - time.monotonic()
                ready = select.select(pending, [], [], max(0.0, wait))[0]
                if not ready:  # the earlier deadline passed
                    late = [p for p in pending if p.deadline <= time.monotonic()] or pending[:1]
                    for p in late:
                        pending.remove(p)
                        if p is primary:
                            failure = socket.timeout("primary hop timed out")
                    continue
                for p in ready:
                    pending.remove(p)
                    try:
                        status, raw = p.read()
                    except (OSError, http.client.HTTPException) as e:
                        if p is primary:
                            failure = e
                        continue
                    if p is primary:  # it answered: the hedge only covers silence
                        self.metrics.inc("hedge.cancelled")
                        return status, raw
                    if status == 200:
                        self.metrics.inc("hedge.won")
                        if session_id is not None:  # the winner serves the session now
                            self._remember((session_id, stage), hid)
                        return status, raw
        finally:
            hedge.close()
        raise failure if failure is not None else OSError("hedged hop: no answer")

    def _hedge_delay_s(self, timeout_s: float) -> float:
        """How long the primary has before the hedge: hedge_delay_ms when
        set, else the p95 of this node's hop times over the trailing window
        (HEDGE_FALLBACK_S while it is empty), at most half the hop timeout."""
        if self.hedge_delay_ms > 0:
            d = self.hedge_delay_ms / 1e3
        else:
            p95 = self.hop_times.quantile(0.95)
            d = HEDGE_FALLBACK_S if p95 is None else p95 / 1e3
        return max(0.001, min(d, timeout_s * 0.5))

    def _hedge_target(self, session_id: Optional[str], stage: int, exclude: set):
        """(node_id, record) to hedge at, or None: with "advertised" only a
        replica whose record advertises the session's KV (the step is then
        truly idempotent); with "any" the best-ranked other replica (a
        stateless backend)."""
        if self.hedge_mode == "any":
            ranked = self.path_finder.find_ranked(stage, exclude=exclude)
            return ranked[0] if ranked else None
        if session_id is None:
            return None
        nid = self._gossip_session_holder(session_id, stage, exclude=exclude)
        value = self.dht.get_stage(stage).get(nid) if nid is not None else None
        return None if value is None else (nid, value)

    def _observe_hop(self, ms: float) -> None:
        self.metrics.observe("hop.relay_ms", ms)
        self.hop_times.observe(ms)

    @staticmethod
    def _is_final(result: Dict[str, Any]) -> bool:
        """A result for the user, not for a next stage: logits (the last
        stage), a K-step window's tokens, or the counter's last stage."""
        return "logits" in result or "tokens" in result or "result_for_user" in result

    # -- endpoints ------------------------------------------------------------

    def _error(self, status: int, message: str, code: Optional[str] = None,
               retry_after: Optional[float] = None) -> Reply:
        """A wire-packed {"error", "code"} reply; a shed's `retry_after`
        (seconds) rides the body and, rounded up to whole seconds as HTTP
        wants it, the Retry-After header."""
        with self._stats_lock:
            self.errors += 1
        body: Dict[str, Any] = {"error": message}
        if code:
            body["code"] = code
        if retry_after is None:
            return status, _WIRE, wire.pack(body)
        body["retry_after"] = retry_after
        return (status, _WIRE, wire.pack(body),
                {"Retry-After": str(max(0, math.ceil(retry_after)))})

    def _deadline_error(self, where: str) -> Reply:
        """The 408 "deadline": the request's budget is spent, so no replica
        could answer it in time (the client does not retry it)."""
        self.metrics.inc("deadline.expired")
        self.metrics.inc(f"deadline.expired.{where}")
        return self._error(408, f"deadline exceeded ({where})", code="deadline")

    def forward(self, body: bytes) -> Reply:
        try:
            with span("wire.unpack"):
                env = wire.unpack(body)
            if not isinstance(env, dict):
                raise ValueError("envelope is not a dict")
            multi = env.get(wire.MULTI_KEY) is not None
            stage = None if multi else int(env.get("stage", 0))
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            return self._error(400, f"bad envelope: {e}")
        if multi:
            return self._forward_multi(env)
        self._add_inflight(1)
        try:
            return self._forward(env, stage)
        finally:
            self._add_inflight(-1)

    def _forward_multi(self, env: Dict[str, Any]) -> Reply:
        """A coalesced relay envelope: split it, run every frame through the
        ordinary forward path at once (on a lane node they co-arrive in the
        window and co-batch), answer {"multi": [{"status", "body"}...]} in
        frame order."""
        try:
            frames = wire.split_forward(env)
            stage = int(env.get("stage", 0))
        except (ValueError, TypeError) as e:
            return self._error(400, f"bad multi envelope: {e}")
        self.metrics.inc("forward.multi_envelopes")
        self.metrics.inc("forward.multi_frames", len(frames))
        replies: List[Optional[Reply]] = [None] * len(frames)

        def one(i: int) -> None:
            try:
                replies[i] = self._forward(frames[i], stage)
            except Exception as e:  # a frame fails alone
                log.exception("multi frame %d failed", i)
                replies[i] = self._error(500, f"frame failed: {e}")

        self._add_inflight(len(frames))
        try:
            _run_all([functools.partial(one, i) for i in range(len(frames))])
        finally:
            self._add_inflight(-len(frames))
        with span("wire.pack"):
            return 200, _WIRE, wire.pack(
                {wire.MULTI_KEY: [{"status": r[0], "body": r[2]} for r in replies]})

    def _forward(self, env: Dict[str, Any], stage: int) -> Reply:
        session_id = env.get("session_id") or str(uuid.uuid4())
        task_id = env.get("task_id") or str(uuid.uuid4())
        relay = env.get("relay", True)
        deadline_ms = env.get(retrylib.DEADLINE_KEY)
        rem = retrylib.remaining_s(deadline_ms)
        if rem is not None and rem <= 0:  # before any relay, rescue or compute
            return self._deadline_error("entry")
        ex = self.executor  # and its spec: a migration swaps both at once
        if stage != ex.spec.stage:
            if not relay:
                return self._error(
                    409,
                    f"wrong stage: this node serves {ex.spec.stage}, not {stage}",
                    code="wrong_stage",
                )
            # a node of another stage: relay to one of that stage, never back here
            del ex  # the relay's empty-stage hook may migrate this node
            try:
                return self._relay(env, stage, exclude={self.node_id})
            except NoNodeForStage as e:
                if stage != self.spec.stage:
                    return self._error(503, str(e))
                # the empty-stage hook moved this node to `stage` during the
                # relay's retries: serve the envelope here
                return self._forward(env, stage)
        payload = env.get("payload") or {}
        start_pos = _start_pos(payload)
        if start_pos == 0:
            # a new session asks for KV it keeps for its whole life: shed it
            # while the node drains or the block pool is under its reserve
            # (a mid-session chunk never is: finishing it frees blocks)
            shed = self._admission_shed(ex)
            if shed is not None:
                code, message = shed
                self.metrics.inc("admission.shed")
                self.metrics.inc(f"admission.shed.{code}")
                return self._error(503, message, code=code, retry_after=self._retry_after_s())
        if (relay and start_pos == 0 and "route" not in env
                and stage + 1 < ex.spec.num_stages):
            # a new session enters the swarm here: plan its downstream chain,
            # which rides its envelopes (a failed plan leaves the per-hop pick)
            adapter = payload.get("adapter")
            route = self._plan_route(
                stage + 1, session_id,
                affinity=None if adapter is None else AdapterAffinity(str(adapter)))
            if route:
                env["route"] = route
        if (relay and not env.get("rescued") and start_pos > 0
                and env.get("session_id") is not None and not self._holds_session(session_id)):
            rescued = self._rescue(env, session_id, stage, deadline_ms)
            if rescued is not None:
                return rescued
        self.metrics.inc("forward.requests")
        if self.chaos is not None:
            try:
                self.chaos.before_forward()
            except ChaosDrop as e:
                self.metrics.inc("chaos.dropped")
                return self._error(500, str(e))
        if (isinstance(payload, dict) and payload.get("adapter") is not None
                and getattr(ex, "adapters", None) is None):
            return self._error(
                409,
                f"payload names adapter {payload.get('adapter')!r} but this "
                "replica serves no adapter registry (--adapters)",
                code="no_adapter_registry",
            )
        held, window = self._begin_use(ex)
        if not held:  # migrated since: the envelope goes where its stage is served now
            del ex
            return self._forward(env, stage)
        try:
            if not getattr(ex, "threadsafe", False):
                with span("node.lock_wait"):
                    self._compute_lock.acquire()
                try:
                    t0 = time.perf_counter()
                    with span("executor.process"):
                        result = ex.process(session_id, payload)
                    self._note_compute((time.perf_counter() - t0) * 1e3)
                finally:
                    self._compute_lock.release()
            elif window is not None and _is_decode_step(payload):
                with span("window.wait"):  # the flush notes the step's time
                    result = window.submit(
                        (session_id, payload, dict(env, task_id=task_id, relay=relay)))
            else:
                t0 = time.perf_counter()
                with span("executor.process"):
                    result = ex.process(session_id, payload)
                self._note_compute((time.perf_counter() - t0) * 1e3)
            with self._stats_lock:
                self.forward_passes += 1
        except BufferError as e:
            return self._error(409, str(e), code="overflow")
        except (CapacityError, AdapterCapacityError) as e:
            return self._error(503, str(e), code="busy")
        except UnknownAdapterError as e:
            # a permanent configuration error: never the restart-and-retry
            # `session_state` loop
            return self._error(409, str(e), code="unknown_adapter")
        except ValueError as e:
            return self._error(409, str(e), code="session_state")
        except Exception as e:  # compute failure: report it, keep serving
            log.exception("stage compute failed")
            return self._error(500, f"stage compute failed: {e}")
        finally:
            self._end_use(ex)
        self._maybe_sweep()
        if isinstance(result, _Relayed):  # the window's flush relayed it
            return result.reply
        if not relay:  # chain mode: this stage's result goes back to the client
            with span("wire.pack"):
                return 200, _WIRE, wire.pack({
                    "task_id": task_id,
                    "session_id": session_id,
                    "stage": stage,
                    "result": result,
                    "served_by": self.node_id,
                })
        if self._is_final(result):
            with span("wire.pack"):
                return 200, _WIRE, wire.pack({
                    "task_id": task_id,
                    "session_id": session_id,
                    "result_for_user": result,
                    "served_by": self.node_id,
                })
        rem = retrylib.remaining_s(deadline_ms)
        if rem is not None and rem <= 0:
            # the budget died during compute: relaying would be dead work
            # for every later stage
            return self._deadline_error("post-compute")
        if start_pos == 0:
            # every stage binds the session's adapter at admission: the first
            # chunk's key rides the relay
            ad = payload.get("adapter")
            if ad is not None:
                result["adapter"] = ad
        next_env = self._next_env(dict(env, task_id=task_id), session_id, result)
        del ex, window  # nothing of this call holds the executor across the hop
        t1 = time.perf_counter()
        try:
            reply = self._relay(next_env, stage + 1)
        except NoNodeForStage as e:
            return self._error(503, f"no next node: {e}")
        self._observe_hop((time.perf_counter() - t1) * 1e3)
        return reply

    def _next_env(self, env: Dict[str, Any], session_id: str,
                  result: Dict[str, Any]) -> Dict[str, Any]:
        """The envelope that carries this stage's `result` to the next
        stage; the planned route and the deadline ride on."""
        next_env = {"task_id": env.get("task_id"), "session_id": session_id,
                    "stage": int(env.get("stage", 0)) + 1, "payload": result}
        if "route" in env:
            next_env["route"] = env["route"]
        if env.get(retrylib.DEADLINE_KEY) is not None:
            next_env[retrylib.DEADLINE_KEY] = env[retrylib.DEADLINE_KEY]
        return next_env

    def _rescue(self, env: Dict[str, Any], session_id: str, stage: int,
                deadline_ms) -> Optional[Reply]:
        """A mid-session chunk for a session this node does not hold (the
        client failed over to another entry, or a relay's affinity died with
        a node): relay it, marked `rescued` so it bounces once only, to the
        replica whose record advertises the session. Up to rescue_bounces
        tries RESCUE_PAUSE_S apart, each after the first paid from the
        retry budget. The holder's reply below 500 is the answer; None when
        none came (the chunk is then served here, and answers 409)."""
        last = "no holder advertised"
        attempts = 0
        for bounce in range(self.rescue_bounces):
            if self._holds_session(session_id):
                return None  # the session arrived here meanwhile: serve it
            rem = retrylib.remaining_s(deadline_ms)
            if rem is not None and rem <= 0:
                return self._deadline_error("rescue")
            if bounce and not self.retry_budget.try_acquire():
                # bounces are retries too: the budget bounds a dead stage's rate
                self.metrics.inc("rescue.budget_denied")
                last = "rescue retry budget denied"
                break
            attempts = bounce + 1
            holder = self._gossip_session_holder(session_id, stage, exclude={self.node_id})
            if holder is not None:
                self.metrics.inc("sessions.rescue_relay")
                t = time.perf_counter()
                try:
                    reply = self._relay({**env, "rescued": True}, stage, exclude={self.node_id},
                                        prefer=holder, phase="rescue", attempts=1)
                except NoNodeForStage:
                    reply, last = None, "no node for stage"
                else:
                    self._observe_hop((time.perf_counter() - t) * 1e3)
                    if reply[0] < 500:
                        return reply
                    last = f"holder {holder} answered {reply[0]}"
            time.sleep(RESCUE_PAUSE_S)  # a stale advert: wait, look again
        if not self._holds_session(session_id):
            self.metrics.inc("sessions.rescue_failed")
            log.warning("session %s: rescue failed after %d bounces (%s)", session_id,
                        attempts, last)
        return None

    def profile(self, body: bytes) -> Reply:
        """POST /profile: start, stop, or a window that stops itself (the
        reference's handle_profile; its span and journal records of a
        window wait for the port's obs plane)."""
        if not self.enable_profiling:
            return self._error(403, "profiling disabled (start the node with "
                                    "--enable-profiling)")
        try:
            env = wire.unpack(body)
            action = env["action"]
        except Exception as e:
            return self._error(400, f"bad profile request: {e}")
        reply: Dict[str, Any] = {"ok": True}
        try:
            if action == "start":
                reply["dir"] = self.profiler.start(env.get("name") or env.get("dir"))
            elif action == "stop":
                reply["dir"] = self.profiler.stop()
            elif action == "window":
                try:
                    seconds = min(max(float(env.get("seconds", 3.0)), 0.1), 60.0)
                except (TypeError, ValueError):
                    return self._error(400, "bad seconds")
                capture_id = str(env.get("capture_id") or time.strftime("%Y%m%d-%H%M%S"))
                label = os.path.join(capture_id, self.node_id.replace(":", "_"))
                reply["dir"] = self.profiler.start(label)
                timer = threading.Timer(seconds, self._close_window, args=(reply["dir"],))
                timer.daemon = True
                timer.start()
                reply.update(capture_id=capture_id, seconds=seconds)
            else:
                return self._error(400, f"unknown action {action!r}")
        except ValueError as e:
            return self._error(400, str(e))
        except RuntimeError as e:
            return self._error(409, str(e))
        except Exception as e:  # the profiler itself failed: report it, keep serving
            log.exception("profile %s failed", action)
            return self._error(500, f"profile {action} failed: {e}")
        return 200, _WIRE, wire.pack(reply)

    def _close_window(self, d: str) -> None:
        """A window's end: stop its trace unless a stop came first."""
        if self.profiler.active_dir != d:
            return
        try:
            self.profiler.stop()
        except RuntimeError:  # an explicit stop won the race
            pass
        except Exception:
            log.exception("profile window %s: stop failed", d)

    def end_session(self, body: bytes) -> Reply:
        """Drop the session here and, with relay, on the replica of the next
        stage this node routed it to (best effort: nodes sweep idle
        sessions)."""
        try:
            env = wire.unpack(body)
            session_id = env["session_id"]
        except (ValueError, TypeError, KeyError, UnicodeDecodeError) as e:
            return self._error(400, f"bad end_session: {e}")
        relay = env.get("relay", True)
        if relay and not env.get("rescued") and not self._holds_session(session_id):
            # the session's KV for this stage lives on another replica (the
            # client ended it through a failed-over entry): end it there now,
            # not at its idle TTL; one bounce, best effort
            holder = self._gossip_session_holder(session_id, self.spec.stage,
                                                 exclude={self.node_id})
            value = self.dht.get_stage(self.spec.stage).get(holder) if holder else None
            if value is not None:
                host, port = node_addr(value)
                try:
                    status, raw, _ = http_post(f"http://{host}:{port}{END_SESSION_PATH}",
                                               wire.pack({**env, "rescued": True}),
                                               self.hop_timeout_s)
                    return status, _WIRE, raw
                except (OSError, http.client.HTTPException, ValueError):
                    pass  # the holder is gone: its sweep or death took the KV
        ex = self.executor
        held, _ = self._begin_use(ex)
        if held:  # else the node migrated: the session died with the old stage's executor
            try:
                ex.end_session(session_id)
            finally:
                self._end_use(ex)
        del ex
        self.announce(urgent=False)  # stop advertising the session
        stage = int(env.get("stage", self.spec.stage))
        if relay and stage + 1 < self.spec.num_stages:
            try:
                _, value = self._pick_next(session_id, stage + 1)
                host, port = node_addr(value)
                http_post(f"http://{host}:{port}{END_SESSION_PATH}",
                          wire.pack({"session_id": session_id, "stage": stage + 1}),
                          self.hop_timeout_s)
            except (NoNodeForStage, OSError, http.client.HTTPException, ValueError):
                pass
            with self._affinity_lock:
                self._session_next.pop((session_id, stage + 1), None)
        with self._affinity_lock:
            self._planned.pop(session_id, None)
        return 200, _WIRE, wire.pack({"ok": True})

    def _maybe_sweep(self) -> None:
        """Every SWEEP_INTERVAL_S: drop sessions idle past their TTL, and
        affinity entries unused and plans made AFFINITY_MAX_AGE_S ago."""
        with self._stats_lock:
            now = time.monotonic()
            if now - self._last_sweep < SWEEP_INTERVAL_S:
                return
            self._last_sweep = now
        ex = self.executor
        held, _ = self._begin_use(ex)
        if held:
            try:
                ex.sessions.sweep()
            finally:
                self._end_use(ex)
        del ex
        cutoff = now - AFFINITY_MAX_AGE_S
        with self._affinity_lock:  # least recently used first
            while self._session_next and next(iter(self._session_next.values()))[1] < cutoff:
                self._session_next.popitem(last=False)
            while self._planned and next(iter(self._planned.values()))[1] < cutoff:
                self._planned.popitem(last=False)

    # -- elasticity: migration, reassign, drain -----------------------------------

    def _thread_uses(self) -> Dict[int, int]:
        uses = getattr(self._tls, "uses", None)
        if uses is None:
            uses = self._tls.uses = {}
        return uses

    def _begin_use(self, ex) -> Tuple[bool, Optional[WindowedBatcher]]:
        """Take a use of `ex` for one call while it is still the node's
        executor: (True, its window), else (False, None): a migration swapped
        it out meanwhile."""
        with self._exec_cond:
            if self.executor is not ex:
                return False, None
            self._uses[ex] = self._uses.get(ex, 0) + 1
            window = self.window
        mine = self._thread_uses()
        mine[id(ex)] = mine.get(id(ex), 0) + 1
        return True, window

    def _end_use(self, ex) -> None:
        mine = self._thread_uses()
        mine[id(ex)] -= 1
        if not mine[id(ex)]:
            del mine[id(ex)]
        with self._exec_cond:
            n = self._uses[ex] - 1
            if n:
                self._uses[ex] = n
            else:
                del self._uses[ex]
                self._exec_cond.notify_all()

    def _memory(self) -> Dict[str, int]:
        """The caching allocator's allocated and reserved bytes in this
        process (empty off the card)."""
        dev = self.executor.device
        if dev.type != "cuda":
            return {}
        return {"allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev)}

    def _balancer_event(self, etype: str, **attrs: Any) -> None:
        """The balancer's decisions, counted by reason (`stage.adopt.<reason>`)
        until the event journal is ported (ROADMAP A9)."""
        if etype == "stage.adopt":
            self.metrics.inc(f"stage.adopt.{attrs.get('reason')}")

    def _adopt_empty_stage(self, stage: int) -> bool:
        """The PathFinder's empty-stage hook: the balancer's adopt_stage, a
        failed migration logged (the relay's retries go on). It runs inside
        a request whose frames may still reference the old executor, so a
        migration it makes releases that executor on a thread of its own."""
        self._tls.defer_release = True
        try:
            return self.balancer.adopt_stage(stage)
        except Exception:
            log.exception("adopting empty stage %d failed", stage)
            return False
        finally:
            self._tls.defer_release = False

    def change_stage(self, target: int) -> None:
        """Live migration to stage `target`, in the reference's order: load
        the target's executor (`load_stage`) and warm it up (`warm_up`) off
        the serving path; swap it in with its spec, its parameter bytes and,
        on a lane node, a new arrival window; drop the chain
        planner (planned from the old stage's view); announce at once; count
        `migrations` and observe `reshard.ms_to_serving`; then release the
        old executor once no call holds it (`_release`). The compute lock
        mode goes with the executor (`threadsafe`: the lane executors take
        no lock of the node's). A load, build or
        warm-up that raises raises here (`migrations.failed`), and the node
        goes on serving its old stage, unswapped.

        Locks: `_migration_lock`, taken without blocking (a second migration
        meanwhile raises), and `_exec_cond` for the swap; never `_pick_lock`
        or `_affinity_lock`, so the PathFinder's empty-stage hook may run a
        migration from inside a relay's fresh pick. `last_migration` (and
        /stats) records its stages, its end (epoch seconds), the load, warm-up
        and release times and the allocator's bytes before the load, after
        the warm-up and after the release."""
        if not self._migration_lock.acquire(blocking=False):
            raise RuntimeError("a stage migration is already running")
        try:
            old = self.executor
            if target == old.spec.stage:
                return
            if self.load_stage is None:
                raise RuntimeError("this node has no stage loader")
            t0 = time.perf_counter()
            record: Dict[str, Any] = {"from": old.spec.stage, "to": target,
                                      "memory": {"before_load": self._memory()}}
            try:
                new = self.load_stage(target)
                t1 = time.perf_counter()
                warm_up(new)
            except Exception:
                self.metrics.inc("migrations.failed")
                new = None
                release_device_memory()  # what the failed load left
                raise
            t2 = time.perf_counter()
            record["memory"]["after_warmup"] = self._memory()
            window = self._attach_window(new) if isinstance(new, BatchedStageExecutor) else None
            with self._exec_cond:
                self.executor, self.spec, self.window = new, new.spec, window
                self.param_bytes = quantized_bytes(new.params)
            del new, window
            self.path_finder.planner = None
            self.announce()
            ms = (time.perf_counter() - t0) * 1e3
            self.metrics.inc("migrations")
            self.metrics.observe("reshard.ms_to_serving", ms, bounds_ms=RESHARD_BOUNDS_MS)
            record.update(at=time.time(), ms_to_serving=ms, load_ms=(t1 - t0) * 1e3,
                          warmup_ms=(t2 - t1) * 1e3)
            self.last_migration = record
            log.info("node %s migrated from stage %d to %d (serving in %.2f s)", self.node_id,
                     record["from"], target, ms / 1e3)
            ref = weakref.ref(old)
            defer = (self._thread_uses().get(id(old), 0) > 0
                     or getattr(self._tls, "defer_release", False))
            del old
            if defer:
                # a request on this thread still holds the old executor (an
                # adoption from the relay's hook): release it once that ends
                threading.Thread(target=self._release, args=(ref, record, RETIRE_WAIT_S),
                                 daemon=True, name="release-old-stage").start()
            else:
                self._release(ref, record, RETIRE_REF_WAIT_S)
        finally:
            self._migration_lock.release()

    def _release(self, ref, record: Dict[str, Any], ref_wait_s: float) -> None:
        """Free the old executor `ref` points to once no call holds it and
        nothing references it (its graphs, buffers and weights): wait for its
        calls to end, then collect and empty the allocator's cache
        (utils/cuda_graph.release_device_memory) until it is gone, for at most
        `ref_wait_s`. Records the release's time and memory in a copy of
        `record` that replaces it as `last_migration` (/stats may be
        serializing the one it holds)."""
        t0 = time.perf_counter()
        with self._exec_cond:
            if not self._exec_cond.wait_for(lambda: not self._uses.get(ref()),
                                            timeout=RETIRE_WAIT_S):
                log.warning("the old stage's executor is still in use after %.0f s",
                            RETIRE_WAIT_S)
        deadline = time.monotonic() + ref_wait_s
        pause = 0.02
        while True:
            release_device_memory()
            if ref() is None or time.monotonic() > deadline:
                break
            time.sleep(pause)
            pause = min(pause * 2, 0.5)
        released = ref() is None
        if not released:
            log.warning("the old stage's executor is still referenced: its memory stays")
        done = dict(record, released=released, release_ms=(time.perf_counter() - t0) * 1e3,
                    memory=dict(record["memory"], after_release=self._memory()))
        if self.last_migration is record:  # not a later migration's
            self.last_migration = done

    def reassign(self, body: bytes) -> Reply:
        """POST /reassign {"stage": N}: an operator's migration."""
        try:
            env = wire.unpack(body)
            target = int(env["stage"])
        except Exception as e:
            return self._error(400, f"bad reassign request: {e}")
        if not 0 <= target < self.spec.num_stages:
            return self._error(400, f"stage {target} out of range")
        try:
            self.change_stage(target)
        except Exception as e:
            log.exception("reassign failed")
            return self._error(500, f"reassign failed: {e}")
        return 200, _WIRE, wire.pack({"ok": True, "stage": target})

    def drain(self, body: bytes) -> Reply:
        """POST /drain [{"wait_s": S}]: the first call sets the drain (new
        sessions shed with 503 "draining", `drain.requests`, the record's
        `draining: 1` announced at once); every call waits up to S seconds
        (default DRAIN_WAIT_S) while /forward requests are in flight and
        answers the resident sessions. Nothing is handed off (ROADMAP A4d):
        residents are served here until they end."""
        env: Dict[str, Any] = {}
        try:
            parsed = wire.unpack(body) if body else None
            if isinstance(parsed, dict):
                env = parsed
        except Exception:
            pass  # an empty or garbage body still means "drain"
        try:
            wait_s = float(env.get("wait_s", DRAIN_WAIT_S))
        except (TypeError, ValueError):
            wait_s = DRAIN_WAIT_S
        with self._stats_lock:
            first, self._draining = not self._draining, True
        if first:
            self.metrics.inc("drain.requests")
            log.info("node %s draining", self.node_id)
            self.announce()  # urgent: routers leave it out within a gossip beat
        deadline = time.monotonic() + max(0.0, wait_s)
        while time.monotonic() < deadline:
            with self._stats_lock:
                if not self.inflight:
                    break
            time.sleep(0.05)
        store = getattr(self.executor, "sessions", None)
        resident = len(store) if store is not None else 0
        return 200, _WIRE, wire.pack({"ok": True, "draining": True, "resident": resident,
                                      "handed_off": 0})

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "node_id": self.node_id,
            "stage": self.spec.stage,
            "num_stages": self.spec.num_stages,
            "device": self.device,
        }

    def stats(self) -> Dict[str, Any]:
        """Counters, the device's name, the quantization and the stage's
        parameter bytes as stored, each kernel's launch count in this
        process and the executor's stats (for the lane executors: co-batched
        dispatches and tokens, mean co-batch, prefill dispatches and tokens,
        graphs, and the block pool's gauges when paged, the adapter
        registry's with --adapters; the whole-model one adds its window's
        `window`), the node's arrival window's (`window`, stage lanes), and
        the overload plane's counters and histograms (`metrics`) and its
        hedge and retry budgets."""
        ex = self.executor
        lock = (contextlib.nullcontext() if getattr(ex, "threadsafe", False)
                else self._compute_lock)
        with lock:
            executor = ex.stats()
            kernels = {
                "flash_gqa": {"launches": attention_ops.flash_gqa.launches,
                              "split_launches": attention_ops.flash_gqa.split_launches,
                              "mma_launches": attention_ops.flash_gqa.mma_launches},
                "paged_decode_gqa": {
                    "launches": attention_ops.paged_decode_gqa.launches,
                    "split_launches": attention_ops.paged_decode_gqa.split_launches},
                "w8a16_matmul": {"launches": qmatmul.w8a16_matmul.launches,
                                 "mma_launches": qmatmul.w8a16_matmul.mma_launches,
                                 "simt_launches": qmatmul.w8a16_matmul.simt_launches},
                "w4a16_matvec": {"launches": qmatmul.w4a16_matvec.launches,
                                 "mma_launches": qmatmul.w4a16_matvec.mma_launches,
                                 "simt_launches": qmatmul.w4a16_matvec.simt_launches},
                "fused_lane_delta": {"launches": lora.fused_lane_delta.launches},
            }
        with self._stats_lock:
            passes = self.forward_passes
            errors = self.errors
            relays, dead_hops, inflight = self.relays, self.dead_hops, self.inflight
        with self._affinity_lock:
            affinity = len(self._session_next)
            recent = list(self._recent_routes)
        with self._stats_lock:
            svc = self._svc_ewma
        spec = ex.spec
        window = self.window
        del ex
        dht = {str(stage): recs for stage, recs in self.dht.get_all(spec.num_stages).items()}
        return {
            "node_id": self.node_id,
            "stage": spec.stage,
            "num_stages": spec.num_stages,
            "start_layer": spec.start_layer,
            "end_layer": spec.end_layer,
            "device": self.device,
            "quant": self.quant,
            "quantized_bytes": self.param_bytes,
            "forward_passes": passes,
            "errors": errors,
            "relays": relays,
            "dead_hops": dead_hops,
            "inflight": inflight,
            "affinity": affinity,
            "gossip_port": self.dht.port,
            "wire_codec": wire.codec_name(),
            "kernels": kernels,
            "executor": executor,
            "window": None if window is None else window.stats(),
            "memory": self._memory(),
            "dht": dht,
            "metrics": self.metrics.snapshot(),
            "hedge_budget": self.hedge_budget.stats(),
            "retry_budget": self.retry_budget.stats(),
            "svc_ms": svc,
            "routes": {"planner": self.path_finder.planner_stats(), "recent": recent},
            "draining": self._draining,
            "rebalance_period_s": self.rebalance_period_s,
            "last_migration": self.last_migration,
        }


def _handler_for(node: Node):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, ctype: str, body: bytes,
                   headers: Optional[Dict[str, str]] = None) -> None:
            try:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except OSError:  # the caller is gone (a hedge's loser, a crash)
                self.close_connection = True

        def do_POST(self) -> None:  # noqa: N802 (http.server's naming)
            with span("http.request"):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                if self.path == FORWARD_PATH:
                    self._reply(*node.forward(body))
                elif self.path == END_SESSION_PATH:
                    self._reply(*node.end_session(body))
                elif self.path == PROFILE_PATH:
                    self._reply(*node.profile(body))
                elif self.path == REASSIGN_PATH:
                    self._reply(*node.reassign(body))
                elif self.path == DRAIN_PATH:
                    self._reply(*node.drain(body))
                else:
                    self._reply(*node._error(404, f"no endpoint {self.path}"))

        def do_GET(self) -> None:  # noqa: N802
            if self.path == "/health":
                doc = node.health()
            elif self.path == "/stats":
                doc = node.stats()
            else:
                self._reply(*node._error(404, f"no endpoint {self.path}"))
                return
            self._reply(200, "application/json", json.dumps(doc).encode())

        def log_message(self, fmt: str, *args: Any) -> None:
            log.debug("%s " + fmt, self.address_string(), *args)

    return Handler
