"""Shared generation-client front end (port of inferd_tpu/client/base.py).

The generation loop every client topology shares: prefill the prompt in
chunks, then sample-append-step until EOS or the token budget, then drop
the session's server-side KV. Subclasses provide only the transport step.
HTTP runs on the standard library (http.client), on worker threads, so the
event loop never blocks.

Per-token logprobs (`logprob_sink`, `top_n`, `top_sink`) come from the
logits the client samples from. Not ported in this slice: prefix pins,
session-restart retries and retry budgets, deadlines and tracing.
"""

from __future__ import annotations

import asyncio
import http.client
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.runtime import wire


class ServerError(RuntimeError):
    """Non-200 wire response. `code` is the node's machine-readable error
    class; `retryable` says whether a fresh session could possibly help."""

    def __init__(self, message: str, status: int, code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.code = code

    @property
    def retryable(self) -> bool:
        return self.status >= 500 or self.code == "session_state"


def sample_np(
    logits: np.ndarray,  # [V] float32
    rng: np.random.Generator,
    temperature: float = 0.6,
    top_k: int = 20,
    top_p: float = 0.95,
    min_p: float = 0.0,
) -> int:
    """Client-side sampling: greedy at temperature 0, else temperature,
    top-k, top-p and min-p filtering, then a draw from `rng`."""
    logits = np.asarray(logits, dtype=np.float64)
    if temperature == 0.0:
        return int(np.argmax(logits))
    logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    if top_p < 1.0:
        order = np.argsort(logits)[::-1]
        probs = _softmax(logits[order])
        cum = np.cumsum(probs)
        keep = (cum - probs) < top_p
        keep[0] = True
        logits[order[~keep]] = -np.inf
    if min_p >= 1.0:
        raise ValueError(f"min_p must be in [0, 1), got {min_p}")
    if min_p > 0.0:
        logits = np.where(logits < np.max(logits) + np.log(min_p), -np.inf, logits)
    probs = _softmax(logits)
    return int(rng.choice(logits.shape[-1], p=probs))


def logprob_np(logits: np.ndarray, tok: int) -> float:
    """Model log-probability of `tok` under the RAW logits (what the model
    assigned, not what the sampler drew from), float64 log-softmax."""
    l = np.asarray(logits, dtype=np.float64)
    l = l - np.max(l)
    return float(l[tok] - np.log(np.sum(np.exp(l))))


def top_logprobs_np(logits: np.ndarray, n: int):
    """Top-n (ids, logprobs) under the RAW logits, descending (ties to the
    lower id)."""
    l = np.asarray(logits, dtype=np.float64)
    l = l - np.max(l)
    lps = l - np.log(np.sum(np.exp(l)))
    idx = np.argsort(-lps, kind="stable")[:n]
    return idx.astype(int).tolist(), lps[idx].tolist()


def _softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x[np.isfinite(x)]) if np.any(np.isfinite(x)) else 0.0
    e = np.exp(np.clip(x - m, -700, 0))
    return e / e.sum()


def http_post(url: str, body: bytes, timeout_s: float) -> Tuple[int, bytes]:
    """Blocking POST on http.client (which never consults proxy settings:
    chain nodes are addressed directly). Returns (status, body)."""
    u = urllib.parse.urlsplit(url)
    if u.scheme != "http" or not u.hostname:
        raise ValueError(f"unsupported URL {url!r}")
    conn = http.client.HTTPConnection(u.hostname, u.port or 80, timeout=timeout_s)
    try:
        conn.request("POST", u.path or "/", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class GenerationClient:
    """Base: the sampling/EOS/session loop over an abstract transport.

    Subclasses implement `_step` (one pipeline pass: token chunk in,
    last-token logits out) and `_end_session` (drop server-side KV)."""

    def __init__(
        self,
        sampling: Optional[SamplingConfig] = None,
        timeout_s: float = 300.0,
        prefill_chunk: int = 512,
        adapter: Optional[str] = None,
    ):
        self.sampling = sampling or SamplingConfig()
        self.timeout_s = timeout_s
        # multi-tenant LoRA: this client's sessions decode with the named
        # adapter (the `adapter` envelope key on a session's first chunk;
        # None = the base model, envelopes byte-identical to a base client's)
        self.adapter = adapter
        # long prompts prefill in sequential chunks of this many tokens
        self.prefill_chunk = max(1, prefill_chunk)

    async def __aenter__(self) -> "GenerationClient":
        return self

    async def __aexit__(self, *exc) -> None:
        return None  # every request opens and closes its own connection

    # -- transport interface (subclass responsibility) ----------------------

    async def _step(self, session_id: str, tokens: List[int], start_pos: int) -> np.ndarray:
        """One pipeline pass; returns last-token logits [V]."""
        raise NotImplementedError

    async def _end_session(self, session_id: str) -> None:
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------

    async def _post_url(self, url: str, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST a wire envelope off the event loop; a non-200 reply raises
        ServerError with the node's error code."""
        status, raw = await asyncio.to_thread(http_post, url, wire.pack(body), self.timeout_s)
        try:
            data = wire.unpack(raw)
        except ValueError:
            snippet = raw[:200].decode("utf-8", "replace")
            raise ValueError(f"{url} returned non-wire body (HTTP {status}): {snippet!r}")
        if status != 200:
            detail = data.get("error", data) if isinstance(data, dict) else data
            code = data.get("code") if isinstance(data, dict) else None
            raise ServerError(f"{url} error {status}: {detail}", status, code)
        return data

    # -- public API ----------------------------------------------------------

    async def generate_ids(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        sampling: Optional[SamplingConfig] = None,
        on_token=None,
        logprob_sink: Optional[List[float]] = None,
        top_n: int = 0,
        top_sink: Optional[List] = None,
    ) -> List[int]:
        """Prefill + token-by-token decode under a fresh session; returns the
        new ids. `on_token` (sync callable) sees each id as it is sampled.
        `logprob_sink` (cleared first) collects each emitted token's model
        log-probability (log-softmax of the raw logits), and `top_sink` the
        top-`top_n` (ids, logprobs) per step, both from the logits the
        token was sampled from. The session's server-side KV is dropped at
        the end, success or not."""
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        prompt = [int(t) for t in prompt_ids]
        s = sampling or self.sampling
        session_id = str(uuid.uuid4())
        rng = np.random.default_rng(seed)
        out: List[int] = []
        if logprob_sink is not None:
            logprob_sink.clear()
        if top_sink is not None:
            top_sink.clear()
        try:
            pos = 0
            logits: Optional[np.ndarray] = None
            for i in range(0, len(prompt), self.prefill_chunk):
                chunk = prompt[i : i + self.prefill_chunk]
                logits = await self._step(session_id, chunk, pos)
                pos += len(chunk)
            assert logits is not None
            while True:
                tok = sample_np(logits, rng, s.temperature, s.top_k, s.top_p, s.min_p)
                out.append(tok)
                if logprob_sink is not None:
                    logprob_sink.append(logprob_np(logits, tok))
                if top_sink is not None:
                    top_sink.append(top_logprobs_np(logits, top_n))
                if on_token is not None:
                    on_token(tok)
                if len(out) >= max_new_tokens or tok == eos_token_id:
                    break
                logits = await self._step(session_id, [tok], pos)
                pos += 1
        finally:
            try:
                await self._end_session(session_id)
            except (OSError, ServerError, ValueError):
                pass  # best effort: nodes TTL-sweep orphaned sessions
        return out
