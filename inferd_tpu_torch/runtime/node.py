"""Chain-mode stage node on the standard library (port of the chain-topology
surface of inferd_tpu/runtime/node.py).

One node hosts one pipeline stage and serves the hub-and-spoke chain
topology, where the client drives every stage itself
(client/chain_client.py): no DHT, no relay. Endpoints, wire-compatible with
the JAX node for this topology:

  POST /forward      one envelope {"task_id", "session_id", "stage",
                     "relay": false, "payload"} -> {"task_id",
                     "session_id", "stage", "result", "served_by"}
  POST /end_session  {"session_id", ...} -> {"ok": true}
  GET  /health       JSON: status, stage, device
  GET  /stats        JSON: counters, the device's name, the serving
                     quantization and the stage's parameter bytes as
                     stored, each kernel's launch count in this process,
                     the executor's stats
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

A payload with `decode_steps` K asks a one-stage (whole-model) node for a
fused window of K decode steps sampled on the device (the one-session
executor's `_process_decode_k`); the reply's `result` holds the committed
`tokens`, `real_len`, `decode_steps` and the advanced `key`.

Errors are wire-packed {"error", "code"} bodies with the JAX node's codes:
409 "wrong_stage" (the chain's address list is stale), 409 "overflow" (KV
budget, a K-step window's too), 409 "session_state" (out-of-order chunk;
`decode_steps` to a stage of a multi-stage chain, or to a lane node), 409
"no_adapter_registry" (the payload names an adapter and this node serves
no `--adapters` registry: serving the base model instead would be silent
tenant corruption), 409 "unknown_adapter" (a name outside the catalog), 503
"busy" (every lane, or every adapter slot, held by live sessions), 500 on
a compute failure. A relaying
envelope (`relay` true or absent) gets 409 "relay_unsupported": the swarm
plane (gossip, routing, relay) is not ported.

Requests are served on threads (ThreadingHTTPServer). With the one-cache-
per-session executor, compute is serialized under one node lock. With the
lane executor (runtime/stage_batch, `--stage-lanes`), the node holds no
lock around compute (the executor has its own) and attaches an arrival
window (runtime/window): single-token decode steps of concurrent sessions
join it and run as ONE device step, whose results all return locally
(chain mode: every envelope has `relay: false`). Prefill chunks go
straight to the executor's `process`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

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


class ChainNode:
    """One stage of a chain: an executor behind a small HTTP server."""

    def __init__(
        self,
        executor,  # Qwen3StageExecutor, or BatchedStageExecutor (lanes)
        host: str = "127.0.0.1",
        port: int = 0,
        window_ms: float = 2.0,
        quant: str = "none",  # the run_node --quant flag the params were loaded with
        enable_profiling: bool = False,  # POST /profile (off: any peer could fill the disk)
        profile_dir: str = "profiles",
    ):
        self.executor = executor
        self.spec = executor.spec
        self.quant = quant
        self.param_bytes = quantized_bytes(executor.params)
        self.device = device_name(executor.device)
        self.window: Optional[WindowedBatcher] = None
        if isinstance(executor, BatchedStageExecutor):
            self._attach_window(executor, window_ms)
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
        not fail its co-batch). Chain mode only: every result returns to its
        own request."""
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

    def start(self) -> "ChainNode":
        """Serve on a background thread; returns self."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"chain-node-{self.port}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and release the socket; a trace still running is
        stopped and written."""
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
        session_id = env.get("session_id") or str(uuid.uuid4())
        task_id = env.get("task_id") or str(uuid.uuid4())
        relay = env.get("relay", True)
        if stage != self.spec.stage and not relay:
            return self._error(
                409,
                f"wrong stage: this node serves {self.spec.stage}, not {stage}",
                code="wrong_stage",
            )
        if relay:
            return self._error(
                409,
                "relay is not supported: this node serves the chain topology "
                "(relay: false); the swarm relay plane is not ported",
                code="relay_unsupported",
            )
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
            if self.window is None:
                with span("node.lock_wait"):
                    self._compute_lock.acquire()
                try:
                    with span("executor.process"):
                        result = self.executor.process(session_id, payload)
                finally:
                    self._compute_lock.release()
            elif _is_decode_step(payload):
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
        with span("wire.pack"):
            return 200, _WIRE, wire.pack({
                "task_id": task_id,
                "session_id": session_id,
                "stage": stage,
                "result": result,
                "served_by": self.node_id,
            })

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
        try:
            env = wire.unpack(body)
            session_id = env["session_id"]
        except (ValueError, TypeError, KeyError, UnicodeDecodeError) as e:
            return self._error(400, f"bad end_session: {e}")
        self.executor.end_session(session_id)
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
        process and the executor's stats (for the lane executor: co-batched
        steps and tokens, mean co-batch, prefill dispatches and tokens, and
        the block pool's gauges when paged, the adapter registry's with
        --adapters)."""
        lock = self._compute_lock if self.window is None else contextlib.nullcontext()
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
            "kernels": kernels,
            "executor": executor,
        }


def _handler_for(node: ChainNode):
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
