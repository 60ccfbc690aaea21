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
a client's without deadlines. Not ported yet: the disaggregated
prefill/decode and server-side generate paths (they need session
export/import and /generate), tracing and the tokenizer front end.
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferd_tpu_torch.client.base import GenerationClient, ServerError, deadline_wire
from inferd_tpu_torch.config import SamplingConfig

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
