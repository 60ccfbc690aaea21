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
  GET  /stats        JSON: counters, the device's name and the flash_gqa
                     kernel's launch count in this process

Errors are wire-packed {"error", "code"} bodies with the JAX node's codes:
409 "wrong_stage" (the chain's address list is stale), 409 "overflow" (KV
budget), 409 "session_state" (out-of-order chunk), 500 on a compute
failure. A relaying envelope (`relay` true or absent) gets 409
"relay_unsupported": the swarm plane (gossip, routing, relay) is not ported.

Requests are served on threads (ThreadingHTTPServer); compute is
serialized under one lock, since one device runs one stream.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from inferd_tpu_torch.ops import attention as attention_ops
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
from inferd_tpu_torch.utils.platform import device_name

log = logging.getLogger(__name__)

FORWARD_PATH = "/forward"
END_SESSION_PATH = "/end_session"

Reply = Tuple[int, str, bytes]  # (status, content type, body)
_WIRE = "application/octet-stream"
SWEEP_INTERVAL_S = 30.0  # how often /forward drops sessions idle past their TTL


class ChainNode:
    """One stage of a chain: an executor behind a small HTTP server."""

    def __init__(
        self,
        executor: Qwen3StageExecutor,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.executor = executor
        self.spec = executor.spec
        self.device = device_name(executor.device)
        self._compute_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.forward_passes = 0
        self.errors = 0
        self._last_sweep = time.monotonic()
        self._server = ThreadingHTTPServer((host, port), _handler_for(self))
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self.node_id = f"{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ChainNode":
        """Serve on a background thread; returns self."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"chain-node-{self.port}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and release the socket."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

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
        try:
            with self._compute_lock:
                result = self.executor.process(session_id, env.get("payload") or {})
                self.forward_passes += 1
                self._maybe_sweep()
        except BufferError as e:
            return self._error(409, str(e), code="overflow")
        except ValueError as e:
            return self._error(409, str(e), code="session_state")
        except Exception as e:  # compute failure: report it, keep serving
            log.exception("stage compute failed")
            return self._error(500, f"stage compute failed: {e}")
        return 200, _WIRE, wire.pack({
            "task_id": task_id,
            "session_id": session_id,
            "stage": stage,
            "result": result,
            "served_by": self.node_id,
        })

    def end_session(self, body: bytes) -> Reply:
        try:
            env = wire.unpack(body)
            session_id = env["session_id"]
        except (ValueError, TypeError, KeyError, UnicodeDecodeError) as e:
            return self._error(400, f"bad end_session: {e}")
        self.executor.end_session(session_id)
        return 200, _WIRE, wire.pack({"ok": True})

    def _maybe_sweep(self) -> None:
        now = time.monotonic()
        if now - self._last_sweep >= SWEEP_INTERVAL_S:
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
        with self._compute_lock:
            passes = self.forward_passes
            launches = attention_ops.flash_gqa.launches
            executor = self.executor.stats()
        with self._stats_lock:
            errors = self.errors
        return {
            "node_id": self.node_id,
            "stage": self.spec.stage,
            "num_stages": self.spec.num_stages,
            "start_layer": self.spec.start_layer,
            "end_layer": self.spec.end_layer,
            "device": self.device,
            "forward_passes": passes,
            "errors": errors,
            "kernels": {"flash_gqa": {"launches": launches}},
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
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n)
            if self.path == FORWARD_PATH:
                self._reply(*node.forward(body))
            elif self.path == END_SESSION_PATH:
                self._reply(*node.end_session(body))
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
