"""Shared generation-client front end (port of inferd_tpu/client/base.py).

The generation loop every client topology shares: prefill the prompt in
chunks, then sample-append-step until EOS or the token budget, then drop
the session's server-side KV. Subclasses provide only the transport step.
HTTP runs on the standard library (http.client), on worker threads, so the
event loop never blocks.

Per-token logprobs (`logprob_sink`, `top_n`, `top_sink`) come from the
logits the client samples from. A generation that fails mid-way with a
retryable error restarts under a fresh session (`session_retries`), paced
by full-jitter backoff, a busy node's `retry_after` and the process's
retry budget; `deadline_s` stamps an end-to-end deadline into every wire
envelope the generation sends (`deadline_wire`). `on_token` may be a
plain or an async callable.

Prefix pins (`pin_prefix`): a prompt prefix prefilled once under a
long-lived session whose per-stage KV is the shared prefix cache; a later
generation whose prompt starts with a pinned prefix forks it (`_fork_session`,
each topology's transport) and prefills only its suffix. A clean miss
(`ok: False`: the parent is gone) unpins and prefills in full; a transport
failure keeps the pin and prefills in full once. At most `max_pins` pins
are held (least recently used out); `__aexit__` ends them.

Standby resume offers (crash-tolerant sessions, runtime/repl): a
`session_state` 409 carrying `resume_from` F means the replica that
answered holds the session's replicated KV up to F; the step re-sends only
the tokens from F to its own start (`_step_resuming`, in `prefill_chunk`
pieces, at most RESUMES times per generation) and is tried again, with the
same session and every token already emitted kept. Not ported yet: tracing.
"""

from __future__ import annotations

import asyncio
import contextvars
import http.client
import random
import urllib.parse
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.utils import retry as retrylib


RESUMES = 4  # resume offers one generation acts on before it restarts instead


class ServerError(RuntimeError):
    """Non-200 wire response. `code` is the node's machine-readable error
    class; `retryable` says whether restarting the generation under a fresh
    session could possibly help; `retry_after` (seconds, optional) is a busy
    node's pacing hint: the retry loop waits at least that long;
    `resume_from` (a `session_state` 409's) is a standby's replicated
    frontier: the generation re-sends only the tokens past it."""

    def __init__(self, message: str, status: int, code: Optional[str] = None,
                 retry_after: Optional[float] = None, resume_from: Optional[int] = None):
        super().__init__(message)
        self.status = status
        self.code = code
        self.retry_after = retry_after
        self.resume_from = resume_from

    @property
    def retryable(self) -> bool:
        # 5xx: transient trouble on a node (a compute crash, a dead next hop,
        # a shed). "session_state": the session's KV is gone or out of order
        # where the chunk landed; a fresh session rebuilds it. Everything else
        # (overflow, wrong_stage, a malformed request, an expired deadline)
        # is deterministic for the request: a retry cannot succeed.
        return self.status >= 500 or self.code == "session_state"


# The end-to-end deadline of the generation running in THIS asyncio task
# (generate_ids sets it from deadline_s). A context variable, not a client
# attribute, so concurrent generations on one client each carry their own;
# it carries into asyncio.to_thread. Transports splat deadline_wire() into
# their envelopes: without a deadline the key is absent and the envelope is
# byte-identical to one from a client without deadlines.
_DEADLINE_MS: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "inferd_deadline_ms", default=None
)


def current_deadline_ms() -> Optional[float]:
    """The active generation's absolute deadline (epoch ms), or None."""
    return _DEADLINE_MS.get()


def deadline_wire() -> Dict[str, float]:
    """{"deadline_ms": ...} for the active deadline, {} when none rides."""
    d = _DEADLINE_MS.get()
    return {retrylib.DEADLINE_KEY: d} if d is not None else {}


def _deadline_error(detail: str) -> ServerError:
    """The client's own 408: not retryable (status < 500, code not
    session_state): once the budget is gone another attempt only wastes
    work."""
    return ServerError(f"deadline exceeded: {detail}", 408, code="deadline")


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


async def _emit(cb, token) -> None:
    """Call a plain or async on_token callback."""
    r = cb(token)
    if asyncio.iscoroutine(r):
        await r


def _softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x[np.isfinite(x)]) if np.any(np.isfinite(x)) else 0.0
    e = np.exp(np.clip(x - m, -700, 0))
    return e / e.sum()


def http_post(url: str, body: bytes, timeout_s: float) -> Tuple[int, bytes, Any]:
    """Blocking POST on http.client (which never consults proxy settings:
    chain nodes are addressed directly). Returns (status, body, headers)."""
    u = urllib.parse.urlsplit(url)
    if u.scheme != "http" or not u.hostname:
        raise ValueError(f"unsupported URL {url!r}")
    conn = http.client.HTTPConnection(u.hostname, u.port or 80, timeout=timeout_s)
    try:
        conn.request("POST", u.path or "/", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.headers
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
        # pinned prefixes: prefix ids -> (the pinned session, its last-token
        # logits); LRU-capped, since each pin holds a session on every stage
        self._pins: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.max_pins = 8
        self._pin_lock = asyncio.Lock()

    async def __aenter__(self) -> "GenerationClient":
        return self

    async def __aexit__(self, *exc) -> None:
        """End the pinned sessions (every request opens and closes its own
        connection: nothing else to close)."""
        while self._pins:
            _, (sid, _logits) = self._pins.popitem(last=False)
            try:
                await self._end_session(sid)
            except Exception:
                pass  # best effort: nodes TTL-sweep orphaned sessions

    # -- transport interface (subclass responsibility) ----------------------

    async def _step(self, session_id: str, tokens: List[int], start_pos: int) -> np.ndarray:
        """One pipeline pass; returns last-token logits [V]."""
        raise NotImplementedError

    async def _end_session(self, session_id: str) -> None:
        raise NotImplementedError

    async def _fork_session(self, new_session_id: str, parent_session_id: str,
                            prefix_len: int) -> bool:
        """Seed a new session from a parent's KV prefix on every stage.
        Default: unsupported (the caller prefills in full)."""
        return False

    # -- shared helpers ------------------------------------------------------

    async def _post_url(self, url: str, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST a wire envelope off the event loop; a non-200 reply raises
        ServerError with the node's error code and `retry_after` (from the
        body, else the Retry-After header). With a deadline riding, a spent
        budget fails here without a request, and the timeout is what is
        left of it (plus a beat for the node's own 408 to come back)."""
        timeout_s = self.timeout_s
        rem = retrylib.remaining_s(_DEADLINE_MS.get())
        if rem is not None:
            if rem <= 0:
                raise _deadline_error(f"before POST {url}")
            timeout_s = min(timeout_s, rem + 0.25)
        status, raw, headers = await asyncio.to_thread(http_post, url, wire.pack(body), timeout_s)
        try:
            data = wire.unpack(raw)
        except ValueError:
            snippet = raw[:200].decode("utf-8", "replace")
            raise ValueError(f"{url} returned non-wire body (HTTP {status}): {snippet!r}")
        if status != 200:
            detail = data.get("error", data) if isinstance(data, dict) else data
            code = data.get("code") if isinstance(data, dict) else None
            ra = data.get("retry_after") if isinstance(data, dict) else None
            if ra is None:
                ra = headers.get("Retry-After")
            try:
                ra = None if ra is None else float(ra)
            except (TypeError, ValueError):
                ra = None
            rf = data.get("resume_from") if isinstance(data, dict) else None
            try:
                rf = None if rf is None else int(rf)
            except (TypeError, ValueError):
                rf = None
            raise ServerError(f"{url} error {status}: {detail}", status, code, retry_after=ra,
                              resume_from=rf)
        return data

    # -- prefix pins ----------------------------------------------------------

    def pinned_parent(self, prefix_ids: Sequence[int]):
        """(the pinned session, its last-token logits) of a held pin, or None."""
        return self._pins.get(prefixlib.normalize_ids(prefix_ids))

    async def pin_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Prefill `prefix_ids` under a dedicated long-lived session whose
        per-stage KV becomes a shared prefix cache: later generations whose
        prompt starts with these ids fork it instead of prefilling them.
        Single-flight: concurrent pins of one prefix run one prefill."""
        ids = prefixlib.normalize_ids(prefix_ids)
        if ids in self._pins:
            self._pins.move_to_end(ids)
            return
        async with self._pin_lock:
            if ids in self._pins:
                self._pins.move_to_end(ids)
                return
            sid = str(uuid.uuid4())
            pos = 0
            logits: Optional[np.ndarray] = None
            for i in range(0, len(ids), self.prefill_chunk):
                chunk = list(ids[i:i + self.prefill_chunk])
                logits = await self._step(sid, chunk, pos)
                pos += len(chunk)
            assert logits is not None
            self._pins[ids] = (sid, logits)
            while len(self._pins) > self.max_pins:
                _, (old, _l) = self._pins.popitem(last=False)
                try:
                    await self._end_session(old)
                except Exception:
                    pass  # best effort: nodes TTL-sweep orphaned sessions

    def _longest_pin(self, prompt_ids: List[int]):
        return prefixlib.longest_prefix_match(self._pins, prompt_ids)

    # -- public API ----------------------------------------------------------

    async def generate_ids(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        session_retries: int = 2,
        retry_delay_s: float = 1.0,
        sampling: Optional[SamplingConfig] = None,
        on_token=None,
        logprob_sink: Optional[List[float]] = None,
        top_n: int = 0,
        top_sink: Optional[List] = None,
        deadline_s: Optional[float] = None,
        retry_cap_s: float = 8.0,
        retry_rng: Optional[random.Random] = None,
        retry_budget: Optional[retrylib.RetryBudget] = None,
    ) -> List[int]:
        """Prefill + token-by-token decode under a fresh session; returns the
        new ids. `on_token` (a plain or async callable) sees each id as it is
        sampled.
        `logprob_sink` (cleared at the start of every attempt) collects each
        emitted token's model log-probability (log-softmax of the raw
        logits), and `top_sink` the top-`top_n` (ids, logprobs) per step,
        both from the logits the token was sampled from. The session's
        server-side KV is dropped at the end of each attempt, success or
        not.

        A failure mid-way (a node died and its KV with it, a shed, a session
        the serving replica does not hold) restarts the WHOLE generation
        under a fresh session, up to `session_retries` times; the tokens come
        out the same for the same seed. `on_token` sees None before a
        retried attempt (the tokens it saw are void). Only retryable
        ServerErrors and transport failures restart. The wait before retry
        n is full-jitter backoff (uniform up to min(retry_cap_s,
        retry_delay_s x 2^(n-1)); `retry_rng` seeds it), raised to a busy
        node's `retry_after`; each retry spends a token of `retry_budget`
        (default: the process's shared bucket), and a dry bucket raises the
        original error. `deadline_s` stamps an absolute `deadline_ms` into
        every envelope: hops fail fast with a 408 `deadline` once it is
        spent, and a retry whose wait would outlast it raises that 408."""
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        budget = retry_budget or retrylib.DEFAULT_RETRY_BUDGET
        dl_token = None
        if deadline_s is not None:
            dl_token = _DEADLINE_MS.set(retrylib.deadline_ms_from_now(deadline_s))
        try:
            last_err: Optional[Exception] = None
            for attempt in range(1 + session_retries):
                if attempt:
                    assert last_err is not None
                    if not budget.try_acquire():
                        raise last_err  # a dry bucket: the failure itself, not a storm
                    delay = retrylib.backoff_delay(attempt, retry_delay_s, retry_cap_s,
                                                   retry_rng)
                    ra = getattr(last_err, "retry_after", None)
                    if ra is not None:
                        delay = max(delay, float(ra))  # a shedding node said when
                    rem = retrylib.remaining_s(_DEADLINE_MS.get())
                    if rem is not None and rem <= delay:
                        raise _deadline_error(
                            "retry pacing exceeds the remaining budget") from last_err
                    await asyncio.sleep(delay)
                    if on_token is not None:
                        await _emit(on_token, None)
                try:
                    return await self._generate_once(
                        [int(t) for t in prompt_ids], max_new_tokens, eos_token_id, seed,
                        sampling or self.sampling, on_token, logprob_sink, top_n, top_sink)
                except ServerError as e:
                    if not e.retryable:
                        raise
                    last_err = e
                except (ConnectionError, OSError, asyncio.TimeoutError,
                        http.client.HTTPException) as e:
                    last_err = e  # the transport died: a dead entry or next hop
            assert last_err is not None
            raise last_err
        finally:
            if dl_token is not None:
                _DEADLINE_MS.reset(dl_token)

    async def _step_resuming(self, session_id: str, tokens: List[int], pos: int,
                             known: List[int], resumes: List[int]) -> np.ndarray:
        """`_step`, acting on a standby's resume offer: on a ServerError whose
        `resume_from` F is below `pos`, re-send known[F:pos] (`known`: the
        stream's tokens, prompt and sampled, by position) in prefill_chunk
        pieces, then the step again. A re-sent piece may meet another
        stage's standby with a lower frontier: its own offer walks the
        resume point back (the recursion). `resumes` is the generation's
        budget of offers; past it, or for any other error, the error goes
        to generate_ids' restart loop."""
        try:
            return await self._step(session_id, tokens, pos)
        except ServerError as e:
            f = e.resume_from
            if f is None or not 0 <= f < pos or resumes[0] <= 0:
                raise
            resumes[0] -= 1
            p = f
            replay = known[f:pos]
            for i in range(0, len(replay), self.prefill_chunk):
                chunk = replay[i:i + self.prefill_chunk]
                await self._step_resuming(session_id, chunk, p, known, resumes)
                p += len(chunk)
            return await self._step_resuming(session_id, tokens, pos, known, resumes)

    async def _generate_once(
        self,
        prompt: List[int],
        max_new_tokens: int,
        eos_token_id: Optional[int],
        seed: int,
        s: SamplingConfig,
        on_token,
        logprob_sink: Optional[List[float]],
        top_n: int,
        top_sink: Optional[List],
    ) -> List[int]:
        """One attempt of generate_ids under a fresh session: the fork of the
        longest held pin the prompt starts with, else a full prefill."""
        session_id = str(uuid.uuid4())
        rng = np.random.default_rng(seed)
        out: List[int] = []
        known = list(prompt)  # the stream by position: what a resume re-sends
        resumes = [RESUMES]
        if logprob_sink is not None:
            logprob_sink.clear()
        if top_sink is not None:
            top_sink.clear()
        try:
            pos = 0
            logits: Optional[np.ndarray] = None
            pin = self._longest_pin(prompt)
            if pin is not None:
                parent, pin_logits = self._pins[pin]
                self._pins.move_to_end(pin)
                forked = transient = False
                try:
                    forked = await self._fork_session(session_id, parent, len(pin))
                except Exception:
                    transient = True  # the transport failed: the parent may live
                if forked:
                    pos, logits = len(pin), pin_logits  # as is when the prompt IS the pin
                else:
                    if not transient:
                        self._pins.pop(pin, None)  # a clean miss: the parent is gone
                    try:  # stages that did fork
                        await self._end_session(session_id)
                    except Exception:
                        pass
            for i in range(pos, len(prompt), self.prefill_chunk):
                chunk = prompt[i : i + self.prefill_chunk]
                logits = await self._step_resuming(session_id, chunk, pos, known, resumes)
                pos += len(chunk)
            assert logits is not None
            while True:
                tok = sample_np(logits, rng, s.temperature, s.top_k, s.top_p, s.min_p)
                out.append(tok)
                known.append(tok)
                if logprob_sink is not None:
                    logprob_sink.append(logprob_np(logits, tok))
                if top_sink is not None:
                    top_sink.append(top_logprobs_np(logits, top_n))
                if on_token is not None:
                    await _emit(on_token, tok)
                if len(out) >= max_new_tokens or tok == eos_token_id:
                    break
                logits = await self._step_resuming(session_id, [tok], pos, known, resumes)
                pos += 1
        finally:
            try:
                await self._end_session(session_id)
            except (OSError, ServerError, ValueError, http.client.HTTPException):
                pass  # best effort: nodes TTL-sweep orphaned sessions
        return out
