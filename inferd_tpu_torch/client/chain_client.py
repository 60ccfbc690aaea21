"""Chain generation client: the client drives a FIXED chain of stage nodes
(port of inferd_tpu/client/chain_client.py).

Hub-and-spoke over each node's `/forward` with `relay: false`: stage 0
gets the token chunk and every later stage gets the previous stage's
`hidden`, carried by the client untouched (bf16 stays its raw bytes); the
last stage returns last-token logits and the client samples. No DHT.
`server_addrs[i]` serves stage i.

A client bound to a tenant adapter (`adapter=`) stamps the `adapter` key on
the first chunk's payload (start_pos 0) to EVERY stage: each stage binds
the session's slot at admission. The reference client stamps the entry hop
only and the swarm relay carries the key on; here the client drives each
stage itself, so it carries the key on. A generation's deadline rides each
hop's envelope as `deadline_ms` (absent without one). A pinned prefix
forks on every stage server at once (`_fork_session`).
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferd_tpu_torch.client.base import GenerationClient, deadline_wire
from inferd_tpu_torch.config import SamplingConfig


class ChainClient(GenerationClient):
    """Drives each stage node in fixed order, carrying activations."""

    def __init__(
        self,
        server_addrs: Sequence[Tuple[str, int]],  # [(host, port)] per stage, in order
        sampling: Optional[SamplingConfig] = None,
        timeout_s: float = 300.0,
        prefill_chunk: int = 512,
        adapter: Optional[str] = None,
    ):
        if not server_addrs:
            raise ValueError("need at least one stage server address")
        super().__init__(sampling, timeout_s, prefill_chunk, adapter=adapter)
        self.server_addrs = [tuple(a) for a in server_addrs]

    async def _post(self, addr: Tuple[str, int], path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        host, port = addr
        return await self._post_url(f"http://{host}:{port}{path}", body)

    async def _forward_through_chain(
        self, session_id: str, tokens: List[int], start_pos: int
    ) -> np.ndarray:
        """One pipeline pass, client-carried: tokens -> ... -> last-token logits."""
        stamp = {"adapter": self.adapter} if self.adapter is not None and start_pos == 0 else {}
        payload: Dict[str, Any] = {
            "tokens": np.asarray([tokens], dtype=np.int32),
            "start_pos": start_pos,
            "real_len": len(tokens),
            **stamp,
        }
        for stage, addr in enumerate(self.server_addrs):
            env = {
                "task_id": str(uuid.uuid4()),
                "session_id": session_id,
                "stage": stage,
                "relay": False,
                "payload": payload,
                **deadline_wire(),  # every hop re-derives its budget from one deadline
            }
            result = (await self._post(addr, "/forward", env))["result"]
            if "logits" in result:
                return np.asarray(result["logits"])[0]
            payload = {
                "hidden": result["hidden"],
                "start_pos": int(result.get("start_pos", start_pos)),
                "real_len": int(result.get("real_len", len(tokens))),
                **stamp,
            }
        raise RuntimeError("last stage returned no logits: is the chain complete?")

    async def _step(self, session_id: str, tokens: List[int], start_pos: int) -> np.ndarray:
        return await self._forward_through_chain(session_id, tokens, start_pos)

    async def _end_session(self, session_id: str) -> None:
        """Drop the session's KV on every stage node, concurrently."""
        async def one(stage: int, addr: Tuple[str, int]) -> None:
            await self._post(
                addr, "/end_session", {"session_id": session_id, "stage": stage, "relay": False}
            )

        await asyncio.gather(
            *(one(s, a) for s, a in enumerate(self.server_addrs)),
            return_exceptions=True,  # best effort: nodes TTL-sweep orphans
        )

    async def _fork_session(self, new_session_id: str, parent_session_id: str,
                            prefix_len: int) -> bool:
        """Fork the parent's KV prefix on EVERY stage server (the client
        addresses each itself). A stage's clean `ok: False` makes the fork a
        miss (the caller ends the stages that forked and prefills); a
        transport failure is raised (the parent may be fine: the pin stays)."""
        async def one(stage: int, addr: Tuple[str, int]):
            return await self._post(addr, "/fork_session", {
                "session_id": new_session_id, "parent_session_id": parent_session_id,
                "prefix_len": prefix_len, "stage": stage, "relay": False})

        results = await asyncio.gather(*(one(s, a) for s, a in enumerate(self.server_addrs)),
                                       return_exceptions=True)
        if any(isinstance(r, dict) and not r.get("ok") for r in results):
            return False
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return True

    async def end_session(self, session_id: str) -> None:
        await self._end_session(session_id)
