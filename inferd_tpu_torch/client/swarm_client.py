"""Swarm generation client: the relay topology (port of the entry-routed
part of inferd_tpu/client/swarm_client.py).

Every chunk enters at a stage-0 node (`entry_nodes`, tried in order) as a
relaying envelope; the swarm routes it on stage by stage and the last
stage's logits unwind back as `result_for_user`, and the client samples
them (client/base.GenerationClient's loop). Server-side KV stays on
whichever replicas the nodes picked for the session. A client bound to a
tenant adapter stamps the `adapter` key on the first chunk only (start_pos
0): the relay carries it to every later stage.

A generation's deadline (generate_ids(deadline_s=...)) rides every
envelope as `deadline_ms`; without one the envelope is byte-identical to
a client's without deadlines.

Beyond the token loop: a pinned prefix forks swarm-wide (`_fork_session`:
/fork_session enters at stage 0 and relays along the parent's route);
`generate_ids_disaggregated` prefills on the entry replica, hands the
session to a decode replica (/export_session) and decodes there;
`generate_server_side` and `generate_server_side_stream` POST /generate and
let the node run the loop (one round trip, or chunked ndjson lines). Not
ported yet: tracing and the tokenizer front end.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferd_tpu_torch.client.base import (
    GenerationClient, ServerError, _emit, deadline_wire, sample_np,
)
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.runtime import wire

log = logging.getLogger(__name__)


class SwarmClient(GenerationClient):
    """Async client of a running swarm (relay topology)."""

    def __init__(
        self,
        entry_nodes: Sequence[Tuple[str, int]],
        sampling: Optional[SamplingConfig] = None,
        timeout_s: float = 300.0,
        prefill_chunk: int = 512,
        adapter: Optional[str] = None,
    ):
        if not entry_nodes:
            raise ValueError("need at least one entry node address")
        super().__init__(sampling, timeout_s, prefill_chunk, adapter=adapter)
        self.entry_nodes = [tuple(a) for a in entry_nodes]

    async def _post(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST to the first entry node that answers: a transport failure, a
        non-wire body or a 5xx moves on to the next entry; a 4xx is raised
        (another entry would answer the same)."""
        last_err: Optional[Exception] = None
        for host, port in self.entry_nodes:
            try:
                return await self._post_url(f"http://{host}:{port}{path}", body)
            except (OSError, ValueError) as e:
                last_err = e
                log.warning("entry node %s:%d unreachable: %s", host, port, e)
            except ServerError as e:
                if e.status < 500:
                    raise
                last_err = e
                log.warning("entry node %s:%d unhealthy: %s", host, port, e)
        if isinstance(last_err, ServerError):
            raise last_err
        raise ConnectionError(f"no entry node reachable: {last_err}")

    def _forward_env(self, session_id: str, tokens: List[int], start_pos: int) -> Dict[str, Any]:
        """The /forward envelope of one chunk, to stage 0, relaying (no
        `relay` key: the node's default); `adapter` on the first chunk only,
        `deadline_ms` while a deadline is active."""
        return {
            "task_id": str(uuid.uuid4()),
            "session_id": session_id,
            "stage": 0,
            "payload": {
                "tokens": np.asarray([tokens], dtype=np.int32),
                "start_pos": start_pos,
                "real_len": len(tokens),
                **({"adapter": self.adapter}
                   if self.adapter is not None and start_pos == 0 else {}),
            },
            **deadline_wire(),
        }

    async def _step(self, session_id: str, tokens: List[int], start_pos: int) -> np.ndarray:
        resp = await self._post("/forward", self._forward_env(session_id, tokens, start_pos))
        return np.asarray(resp["result_for_user"]["logits"])[0]

    async def _end_session(self, session_id: str) -> None:
        await self._post("/end_session", {"session_id": session_id, "stage": 0})

    async def _fork_session(self, new_session_id: str, parent_session_id: str,
                            prefix_len: int) -> bool:
        """Fork the parent's per-stage KV prefix swarm-wide: the request
        enters at stage 0 and each stage relays it along the parent's
        route."""
        resp = await self._post("/fork_session", {
            "session_id": new_session_id, "parent_session_id": parent_session_id,
            "prefix_len": prefix_len, "stage": 0})
        return bool(resp.get("ok"))

    async def generate_ids_disaggregated(
        self,
        prompt_ids: Sequence[int],
        decode_node: Tuple[str, int],
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        sampling: Optional[SamplingConfig] = None,
    ) -> List[int]:
        """Prefill on this client's entry replica, hand the session's KV to
        `decode_node` (/export_session to its /import_session) and run the
        decode loop THERE: token-exact with a one-replica generation, no
        restart. `decode_node` serves the entry's stage (a whole-model node,
        or the stage-0 replica of a pipeline whose later stages stay put)."""
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        s = sampling or self.sampling
        rng = np.random.default_rng(seed)
        sid = str(uuid.uuid4())
        dh, dp = decode_node
        durl = f"http://{dh}:{dp}"
        out: List[int] = []
        handed_off = False
        try:
            pos = 0
            logits = None
            ids = [int(t) for t in prompt_ids]
            for i in range(0, len(ids), self.prefill_chunk):
                chunk = ids[i:i + self.prefill_chunk]
                logits = await self._step(sid, chunk, pos)
                pos += len(chunk)
            assert logits is not None
            resp = await self._post("/export_session",
                                    {"session_id": sid, "target_host": dh, "target_port": dp})
            if not resp.get("ok"):
                raise ServerError(f"handoff declined: {resp}", 502)
            handed_off = True
            tok = sample_np(logits, rng, s.temperature, s.top_k, s.top_p, s.min_p)
            out.append(tok)
            while len(out) < max_new_tokens and tok != eos_token_id:
                r = await self._post_url(f"{durl}/forward", self._forward_env(sid, [tok], pos))
                logits = np.asarray(r["result_for_user"]["logits"])[0]
                pos += 1
                tok = sample_np(logits, rng, s.temperature, s.top_k, s.top_p, s.min_p)
                out.append(tok)
        finally:
            try:
                await self._post_url(f"{durl}/end_session", {"session_id": sid, "stage": 0})
            except Exception:
                pass  # best effort: nodes TTL-sweep orphaned sessions
            if not handed_off:  # the session still lives on the entry replica
                try:
                    await self._end_session(sid)
                except Exception:
                    pass
        return out

    def _generate_body(self, prompt_ids, max_new_tokens, eos_token_id, seed, pin_prefix_len,
                       sampling, **extra) -> Dict[str, Any]:
        """A /generate request; `min_p` rides only when set, as the
        reference's client sends it."""
        s = sampling or self.sampling
        return {
            "prompt_ids": [int(t) for t in prompt_ids],
            "max_new_tokens": max_new_tokens,
            "eos_token_id": eos_token_id,
            "seed": seed,
            "pin_prefix_len": pin_prefix_len,
            **extra,
            "sampling": {"temperature": s.temperature, "top_k": s.top_k, "top_p": s.top_p,
                         **({"min_p": s.min_p} if s.min_p else {})},
        }

    async def generate_server_side(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        pin_prefix_len: int = 0,
        sampling: Optional[SamplingConfig] = None,
        logprob_sink: Optional[List[float]] = None,
        top_logprobs: int = 0,
        top_sink: Optional[List] = None,
    ) -> List[int]:
        """One round trip: the NODE runs the token loop against itself
        (POST /generate) and returns the ids. `pin_prefix_len` marks the
        first N prompt ids as a prefix the node pins and forks. The sinks
        take the per-token logprobs and top-N alternatives."""
        want_lp = logprob_sink is not None
        extra: Dict[str, Any] = {}
        if want_lp:
            extra["logprobs"] = True
        if top_logprobs:
            extra["top_logprobs"] = top_logprobs
        resp = await self._post("/generate", self._generate_body(
            prompt_ids, max_new_tokens, eos_token_id, seed, pin_prefix_len, sampling, **extra))
        if want_lp:
            logprob_sink.clear()
            logprob_sink.extend(float(x) for x in resp.get("logprobs") or [])
        if top_sink is not None:
            top_sink.clear()
            top_sink.extend(([int(i) for i in ti], [float(x) for x in tl])
                            for ti, tl in (resp.get("top_logprobs") or []))
        return [int(t) for t in resp["ids"]]

    async def generate_server_side_stream(
        self,
        prompt_ids: Sequence[int],
        on_token,
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        pin_prefix_len: int = 0,
        sampling: Optional[SamplingConfig] = None,
    ) -> List[int]:
        """The streaming /generate: `on_token(id)` (plain or async) fires as
        each token's ndjson line arrives, None on a restart (the tokens seen
        are void); returns the final ids. An entry that fails in transport
        moves to the next, voiding what was streamed; a non-200 answer is
        raised as a ServerError."""
        body = wire.pack(self._generate_body(prompt_ids, max_new_tokens, eos_token_id, seed,
                                             pin_prefix_len, sampling, stream=True))
        loop = asyncio.get_running_loop()
        last_err: Optional[Exception] = None
        emitted = False
        for host, port in self.entry_nodes:
            lines: asyncio.Queue = asyncio.Queue()
            reader = asyncio.ensure_future(asyncio.to_thread(
                self._read_stream, host, port, body,
                lambda line: loop.call_soon_threadsafe(lines.put_nowait, line)))
            ids: Optional[List[int]] = None
            try:
                while True:
                    line = await lines.get()
                    if line is None:  # the reader is done
                        break
                    obj = json.loads(line)
                    if "t" in obj:
                        emitted = True
                        await _emit(on_token, int(obj["t"]))
                    elif obj.get("restart"):
                        await _emit(on_token, None)
                    elif obj.get("done"):
                        ids = [int(t) for t in obj["ids"]]
                    elif "error" in obj:
                        raise RuntimeError(f"server-side generation: {obj['error']}")
                await reader  # raises the reader's error
                if ids is None:
                    raise ConnectionError(f"{host}:{port} stream ended without its done line")
                return ids
            except (OSError, http.client.HTTPException) as e:
                last_err = e
                log.warning("entry node %s:%d unreachable: %s", host, port, e)
                if emitted:  # the next entry streams from the start
                    await _emit(on_token, None)
                    emitted = False
            finally:
                if not reader.done():
                    reader.cancel()
        raise ConnectionError(f"no entry node reachable: {last_err}")

    def _read_stream(self, host: str, port: int, body: bytes, put) -> None:
        """POST a streaming /generate and hand each ndjson line to `put`,
        then None (on a worker thread; http.client reads the chunked body).
        The timeout bounds each read, not the whole stream. A non-200
        answer raises its ServerError."""
        conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
        try:
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            if resp.status != 200:
                raw = resp.read()
                try:
                    data = wire.unpack(raw)
                except ValueError:
                    data = {}
                detail = data.get("error", raw[:200]) if isinstance(data, dict) else raw[:200]
                code = data.get("code") if isinstance(data, dict) else None
                raise ServerError(f"{host}:{port}/generate error {resp.status}: {detail}",
                                  resp.status, code)
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.strip():
                    put(line)
        finally:
            conn.close()
            put(None)
