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
                     device's name, the serving quantization and the
                     stage's parameter bytes as stored, each kernel's launch
                     count in this process, the executor's stats, the
                     card's allocated and reserved bytes (`memory`), and
                     the gossip view `dht` {stage: {"host:port": record}}
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
thread carries that. The next hop (`_pick_next`) is the session's
remembered replica for that stage while its record lives (an LRU of 8192
(session, stage) pairs: its KV lives there), else the min-load live
replica, passing over peers in their dead-peer cooldown unless none else
is left. A relay (`_relay`) packs the envelope once and makes up to two
attempts: a transport failure excludes the peer, starts its cooldown and
drops the session's affinity; a 5xx other than 503 starts the cooldown;
when both attempts fail the answer is 502 "next hop unreachable". A stage
with no live replica answers 503 after the PathFinder's retries. An
envelope for another stage is relayed to a replica of it (not to this
node), or refused with 409 "wrong_stage" in chain mode. The first chunk's
`adapter` key rides the relay, so every stage binds the session's adapter.
Not ported yet: deadlines, admission shedding, session rescue, hedged
relays, planned routes and coalesced multi-session relays.

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
"busy" (every lane, or every adapter slot, held by live sessions), 503 (no
live node for the next stage), 502 (next hop unreachable), 500 on a
compute failure.

Requests are served on threads (ThreadingHTTPServer). With the one-cache-
per-session executor, compute is serialized under one node lock. The lane
executors (`threadsafe`) have locks of their own and the node holds none
around their compute. To the pipeline stage's (runtime/stage_batch,
`--stage-lanes`) the node attaches an arrival window (runtime/window):
decode steps of concurrent sessions join it and run as ONE device step,
whose results return to their own handler threads; prefill chunks go
straight to the executor's `process`. The whole-model one
(runtime/batch_executor, `--batch-lanes`) owns its window, so every
request goes straight to its `process` and the node wraps it in no window
of its own (a decode step would otherwise queue twice). A handler relays
only after its compute returned: neither the compute lock nor a window is
held across a downstream hop.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import logging
import os
import threading
import time
import uuid
from collections import Counter, OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from inferd_tpu_torch.client.base import http_post
from inferd_tpu_torch.control.dht import SwarmDHT
from inferd_tpu_torch.control.path_finder import NoNodeForStage, PathFinder, node_addr
from inferd_tpu_torch.ops import attention as attention_ops
from inferd_tpu_torch.ops import lora, qmatmul
from inferd_tpu_torch.ops.quant import quantized_bytes
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.adapters import AdapterCapacityError, UnknownAdapterError
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor, CapacityError
from inferd_tpu_torch.runtime.window import WindowedBatcher
from inferd_tpu_torch.utils.platform import device_name
from inferd_tpu_torch.utils.profiling import Profiler, span

log = logging.getLogger(__name__)

FORWARD_PATH = "/forward"
END_SESSION_PATH = "/end_session"
PROFILE_PATH = "/profile"

Reply = Tuple[int, str, bytes]  # (status, content type, body)
_WIRE = "application/octet-stream"
SWEEP_INTERVAL_S = 30.0  # how often /forward drops sessions idle past their TTL
HOP_TIMEOUT_S = 120.0  # one relay hop's HTTP timeout (the reference's)
RELAY_ATTEMPTS = 2  # picks per relay: the first, and one past a dead hop
SESSION_NEXT_CAP = 8192  # (session, stage) -> next-hop affinity entries kept
HELD_WINDOW_S = 600.0  # an affinity entry idle this long no longer counts as a held session


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
    ):
        self.executor = executor
        self.spec = executor.spec
        self.quant = quant
        self.param_bytes = quantized_bytes(executor.params)
        self.device = device_name(executor.device)
        self.window: Optional[WindowedBatcher] = None
        if isinstance(executor, BatchedStageExecutor):
            self._attach_window(executor, window_ms)
        # the executors that take no lock of the node's (the lane executors)
        self._serial = not getattr(executor, "threadsafe", False)
        self._compute_lock = threading.Lock()  # around the per-session executor only
        self._stats_lock = threading.Lock()
        self.forward_passes = 0
        self.errors = 0
        self._last_sweep = time.monotonic()
        self._server = ThreadingHTTPServer((host, port), _handler_for(self))
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self.node_id = f"{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None
        self.enable_profiling = enable_profiling
        self.profiler = Profiler(base_dir=profile_dir)
        # the swarm half: membership, next hops, relays
        self.capacity = capacity
        self.model_name = model_name
        self.dht = SwarmDHT(self.node_id, gossip_port, bootstrap=list(bootstrap), host=host)
        self.path_finder = PathFinder(self.dht, self.spec.num_stages)
        # (session_id, stage) -> (the replica that holds the session's KV
        # there, when this node last routed the session to it)
        self._session_next: "OrderedDict[Tuple[str, int], Tuple[str, float]]" = OrderedDict()
        self._affinity_lock = threading.Lock()
        self._pick_lock = threading.Lock()  # a fresh pick and its record, as one step
        self.inflight = 0  # /forward requests in this node now: the announced load
        self.relays = 0  # envelopes this node relayed (one per relay, whatever its attempts)
        self.dead_hops = 0  # relay attempts that met a transport failure

    def _attach_window(self, executor: BatchedStageExecutor, window_ms: float) -> None:
        """Give the lane executor its arrival window: co-arriving decode
        steps of different sessions become ONE process_batch step."""
        self.window = WindowedBatcher(
            window_ms / 1e3,
            self._run_stage_window,
            # lock-free live-session count: a solo session must not pay the
            # window (and co_possible runs under the batcher's lock: taking
            # the executor's lock there would invert on_drop -> invalidate)
            co_possible=executor.co_possible,
            # gang formation: wait (up to window_ms) for every live idle
            # session's step, which merges phase-offset cohorts
            gang_target=executor.gang_target,
        )
        executor.on_drop = lambda sid: self.window.invalidate(
            lambda payload, _sid=sid: payload[0] == _sid,
            ValueError(f"session {sid} ended mid-request"),
        )

    def _run_stage_window(self) -> None:
        """WindowedBatcher flush callback (worker thread, no locks held):
        ONE co-batched device step for every co-arrived decode entry. The
        batch is drained once the executor holds the device (continuous
        batching: it forms when the step takes the device, not when the
        flusher wakes); the drained entries are ours to deliver, results and
        events. Per-entry failures set entry.error (one stale session must
        not fail its co-batch). Every result returns to its own handler
        thread, which relays it when the envelope asks: this thread never
        waits on a downstream hop."""
        drained: list = []

        def drain():
            extra = self.window.drain_pending()
            drained.extend(extra)
            return [(e.payload[0], e.payload[1]) for e in extra]

        try:
            outs = self.executor.process_batch([], drain=drain)
            for e, out in zip(drained, outs):
                if isinstance(out, Exception):
                    e.error = out
                else:
                    e.result = out
        except Exception as exc:
            for e in drained:
                e.error = exc
            raise
        finally:
            for e in drained:
                if e.error is None and e.result is None:
                    e.error = RuntimeError("window flush dropped an entry")
                e.event.set()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Node":
        """Start the gossip store (a failed bind raises), announce this node,
        and serve on a background thread; returns self."""
        self.dht.start()
        self.announce()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"node-{self.port}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Withdraw from the swarm (a tombstone), stop the gossip thread,
        stop serving and release the sockets; a trace still running is
        stopped and written."""
        self.dht.withdraw()
        self.dht.stop()
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.profiler.active_dir is not None:
            try:
                self.profiler.stop()
            except RuntimeError:  # a window's timer stopped it meanwhile
                pass

    # -- membership -----------------------------------------------------------

    def announce(self, urgent: bool = True) -> None:
        """Publish this node's record: urgent gossips it at once, else the
        gossip thread carries it at its next period."""
        with self._stats_lock:
            load = self.inflight
        self.dht.announce({
            "name": self.node_id,
            "stage": self.spec.stage,
            "load": load,
            "cap": self.capacity,
            "host": self.host,
            "port": self.port,
            "model": self.model_name,
        }, urgent=urgent)

    def _add_inflight(self, n: int) -> None:
        with self._stats_lock:
            self.inflight += n
        self.announce(urgent=False)

    # -- next hops ------------------------------------------------------------

    def _pick_next(self, session_id: Optional[str], stage: int, exclude=None):
        """The next replica for (session, stage): (1) the replica this node
        routed the session to before, while its record lives and it is not
        excluded (its KV is there), else (4) the min-load live replica,
        outside the dead-peer cooldown where the stage allows, each
        replica's gossiped load counted with the sessions this node holds
        on it (`_held`). The pick is remembered for the session. Raises
        NoNodeForStage."""
        key = (session_id, stage) if session_id else None
        if key is not None:
            with self._affinity_lock:
                nid, _ = self._session_next.get(key, (None, 0.0))
            if nid is not None:
                value = self.dht.get_stage(stage).get(nid)
                if value is not None and not (exclude and nid in exclude):
                    self._remember(key, nid)
                    return nid, value
                # the remembered replica is gone and the session's KV with it:
                # a fresh pick (a mid-session chunk there answers 409)
                with self._affinity_lock:
                    self._session_next.pop(key, None)
        with self._pick_lock:
            nid, value = self.path_finder.find_best_node(
                stage, exclude=self._with_cooldown(stage, exclude), held=self._held(stage))
            if key is not None:
                self._remember(key, nid)
        return nid, value

    def _remember(self, key: Tuple[str, int], nid: str) -> None:
        with self._affinity_lock:
            self._session_next[key] = (nid, time.monotonic())
            self._session_next.move_to_end(key)
            while len(self._session_next) > SESSION_NEXT_CAP:
                self._session_next.popitem(last=False)

    def _held(self, stage: int) -> Dict[str, int]:
        """Sessions this node routed to each replica of `stage` and has not
        ended, routed within HELD_WINDOW_S. The gossiped load reaches this
        node a gossip period late and counts requests, not sessions: new
        sessions entering here at once would all pick the same replica."""
        cutoff = time.monotonic() - HELD_WINDOW_S
        with self._affinity_lock:
            return Counter(nid for (_, s), (nid, t) in self._session_next.items()
                           if s == stage and t >= cutoff)

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
        self.path_finder.note_peer_dead(node_id)

    def _relay(self, env: Dict[str, Any], stage: int, exclude=None) -> Reply:
        """Send `env` to a replica of `stage` and answer with its reply, status
        and raw body untouched. The envelope is packed once; a transport
        failure re-picks once without the dead peer. Raises NoNodeForStage
        when the stage has no live replica to pick."""
        exclude = set(exclude or ())
        session_id = env.get("session_id")
        with span("wire.pack"):
            body = wire.pack(env)
        with self._stats_lock:
            self.relays += 1
        last_err: Optional[Exception] = None
        for _ in range(RELAY_ATTEMPTS):
            node_id, value = self._pick_next(session_id, stage, exclude)
            host, port = node_addr(value)
            try:
                with span("relay.hop"):
                    status, raw = http_post(f"http://{host}:{port}{FORWARD_PATH}", body,
                                            HOP_TIMEOUT_S)
            except (OSError, http.client.HTTPException, ValueError) as e:
                last_err = e
                self._note_peer_failure(node_id)
                exclude.add(node_id)
                if session_id is not None:
                    with self._affinity_lock:  # the replica and the session's KV are gone
                        self._session_next.pop((session_id, stage), None)
                with self._stats_lock:
                    self.dead_hops += 1
                log.warning("next hop %s for stage %d unreachable: %s", node_id, stage, e)
                continue
            if status >= 500 and status != 503:
                # it answered, broken: steer fresh picks away for a while (a
                # 503 is a busy or empty stage, not a sick peer)
                self._note_peer_failure(node_id)
            return status, _WIRE, raw
        return self._error(502, f"next hop unreachable: {last_err}")

    @staticmethod
    def _is_final(result: Dict[str, Any]) -> bool:
        """A result for the user, not for a next stage: logits (the last
        stage), a K-step window's tokens, or the counter's last stage."""
        return "logits" in result or "tokens" in result or "result_for_user" in result

    # -- endpoints ------------------------------------------------------------

    def _error(self, status: int, message: str, code: Optional[str] = None) -> Reply:
        with self._stats_lock:
            self.errors += 1
        body: Dict[str, Any] = {"error": message}
        if code:
            body["code"] = code
        return status, _WIRE, wire.pack(body)

    def forward(self, body: bytes) -> Reply:
        try:
            with span("wire.unpack"):
                env = wire.unpack(body)
            if not isinstance(env, dict):
                raise ValueError("envelope is not a dict")
            stage = int(env.get("stage", 0))
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            return self._error(400, f"bad envelope: {e}")
        self._add_inflight(1)
        try:
            return self._forward(env, stage)
        finally:
            self._add_inflight(-1)

    def _forward(self, env: Dict[str, Any], stage: int) -> Reply:
        session_id = env.get("session_id") or str(uuid.uuid4())
        task_id = env.get("task_id") or str(uuid.uuid4())
        relay = env.get("relay", True)
        if stage != self.spec.stage:
            if not relay:
                return self._error(
                    409,
                    f"wrong stage: this node serves {self.spec.stage}, not {stage}",
                    code="wrong_stage",
                )
            # a node of another stage: relay to one of that stage, never back here
            try:
                return self._relay(env, stage, exclude={self.node_id})
            except NoNodeForStage as e:
                return self._error(503, str(e))
        payload = env.get("payload") or {}
        if (isinstance(payload, dict) and payload.get("adapter") is not None
                and getattr(self.executor, "adapters", None) is None):
            return self._error(
                409,
                f"payload names adapter {payload.get('adapter')!r} but this "
                "replica serves no adapter registry (--adapters)",
                code="no_adapter_registry",
            )
        try:
            if self._serial:
                with span("node.lock_wait"):
                    self._compute_lock.acquire()
                try:
                    with span("executor.process"):
                        result = self.executor.process(session_id, payload)
                finally:
                    self._compute_lock.release()
            elif self.window is not None and _is_decode_step(payload):
                with span("window.wait"):
                    result = self.window.submit((session_id, payload))
            else:
                with span("executor.process"):
                    result = self.executor.process(session_id, payload)
            with self._stats_lock:
                self.forward_passes += 1
            self._maybe_sweep()
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
        if isinstance(payload, dict) and payload.get("start_pos", -1) == 0:
            # every stage binds the session's adapter at admission: the first
            # chunk's key rides the relay
            ad = payload.get("adapter")
            if ad is not None:
                result["adapter"] = ad
        next_env = {"task_id": task_id, "session_id": session_id, "stage": stage + 1,
                    "payload": result}
        try:
            return self._relay(next_env, stage + 1)
        except NoNodeForStage as e:
            return self._error(503, f"no next node: {e}")

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
        self.executor.end_session(session_id)
        stage = int(env.get("stage", self.spec.stage))
        if env.get("relay", True) and stage + 1 < self.spec.num_stages:
            try:
                _, value = self._pick_next(session_id, stage + 1)
                host, port = node_addr(value)
                http_post(f"http://{host}:{port}{END_SESSION_PATH}",
                          wire.pack({"session_id": session_id, "stage": stage + 1}),
                          HOP_TIMEOUT_S)
            except (NoNodeForStage, OSError, http.client.HTTPException, ValueError):
                pass
            with self._affinity_lock:
                self._session_next.pop((session_id, stage + 1), None)
        return 200, _WIRE, wire.pack({"ok": True})

    def _maybe_sweep(self) -> None:
        with self._stats_lock:
            now = time.monotonic()
            if now - self._last_sweep < SWEEP_INTERVAL_S:
                return
            self._last_sweep = now
        self.executor.sessions.sweep()

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
        `window`), and the node's arrival window's (`window`, stage lanes)."""
        lock = self._compute_lock if self._serial else contextlib.nullcontext()
        with lock:
            executor = self.executor.stats()
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
        dht = {str(stage): recs
               for stage, recs in self.dht.get_all(self.spec.num_stages).items()}
        memory = {}
        if self.executor.device.type == "cuda":  # the caching allocator's bytes, this process
            memory = {"allocated": torch.cuda.memory_allocated(self.executor.device),
                      "reserved": torch.cuda.memory_reserved(self.executor.device)}
        return {
            "node_id": self.node_id,
            "stage": self.spec.stage,
            "num_stages": self.spec.num_stages,
            "start_layer": self.spec.start_layer,
            "end_layer": self.spec.end_layer,
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
            "kernels": kernels,
            "executor": executor,
            "window": None if self.window is None else self.window.stats(),
            "memory": memory,
            "dht": dht,
        }


def _handler_for(node: Node):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, ctype: str, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

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
