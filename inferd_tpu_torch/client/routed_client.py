"""Routed chain client: D*-Lite plans each session's chain over the live
gossip view, and live costs replan it while its first pass walks (port of
inferd_tpu/client/routed_client.py).

  * The client joins the gossip store as a records-less observer (it
    announces nothing; it merges everyone's {load, cap, svc_ms} records).
  * A new session builds a SwarmChainPlanner (one D*-Lite instance) and
    walks the chain stage by stage as the ChainClient does (`/forward` with
    relay false, the client carrying each stage's hidden states on). Before
    each hop it folds the gossip view in (`refresh`), after it moves the
    agent (`advance`): a load spike on a replica planned for a LATER stage
    replans the remaining stages incrementally, before any KV commits there.
  * Once the first pass returns logits the chain is FROZEN for the session:
    every stage holds its KV, so later chunks and decode steps go where it
    lives. A frozen hop that fails in transport or with a retryable error
    moves to a replica whose record advertises the session (`sess`), else
    its replicated prefix (`standby`: it promotes the shadow, or offers a
    resume), when one does; else a retryable 503 `no_holder` restarts the
    session. A standby's resume offer (`resume_from`) is no hop failure:
    it goes up to the base's `_step_resuming`, which re-sends the tail.

A stage with no live replica in the view is a retryable 503 `no_chain`.
`planner_stats(session_id)` gives the D*-Lite counters (expansions at build
against at replan), and `hop_hook` (an async callable (session_id,
completed_stage)) runs between first-pass hops. A pinned prefix forks on
the parent's committed chain (where its KV lives), and the child inherits
that chain, committed.
"""

from __future__ import annotations

import asyncio
import http.client
import logging
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from inferd_tpu_torch.client.base import GenerationClient, ServerError, deadline_wire
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control.dht import SwarmDHT, sess_hash
from inferd_tpu_torch.control.dstar import SwarmChainPlanner
from inferd_tpu_torch.control.path_finder import NoNodeForStage, node_addr

log = logging.getLogger(__name__)


class _SessionPlan:
    """One session's routing state: the planner while its first pass walks,
    the frozen chain once committed."""

    __slots__ = ("planner", "chain", "committed", "stats")

    def __init__(self, planner: Optional[SwarmChainPlanner]):
        self.planner = planner
        self.chain: List[Tuple[str, Dict[str, Any]]] = []  # [(node_id, record)] per stage
        self.committed = False
        self.stats: Optional[Dict[str, int]] = None  # the planner's stats at the freeze


class RoutedChainClient(GenerationClient):
    """A chain client whose chain comes from D*-Lite over the live swarm
    view. `dht` is a started SwarmDHT bootstrapped into the swarm; the
    client never announces on it."""

    def __init__(
        self,
        dht: SwarmDHT,
        num_stages: int,
        sampling: Optional[SamplingConfig] = None,
        timeout_s: float = 300.0,
        prefill_chunk: int = 512,
    ):
        super().__init__(sampling, timeout_s, prefill_chunk)
        self.dht = dht
        self.num_stages = num_stages
        self._plans: Dict[str, _SessionPlan] = {}
        self.hop_hook = None  # async (session_id, completed_stage) -> None

    # -- planning -----------------------------------------------------------

    def _snapshot(self) -> Dict[int, Dict[str, Dict[str, Any]]]:
        return self.dht.get_all(self.num_stages)

    def planner_stats(self, session_id: str) -> Optional[Dict[str, int]]:
        """The planner's counters while the first pass walks, the frozen copy
        after; None for an unknown session."""
        plan = self._plans.get(session_id)
        if plan is None:
            return None
        if plan.planner is not None:
            return dict(plan.planner.stats)
        return dict(plan.stats) if plan.stats else None

    def _plan_for(self, session_id: str) -> _SessionPlan:
        plan = self._plans.get(session_id)
        if plan is None:
            plan = _SessionPlan(SwarmChainPlanner(self._snapshot(), 0, self.num_stages))
            self._plans[session_id] = plan
        return plan

    @staticmethod
    def _routing_unavailable(e: Exception) -> ServerError:
        """A planning failure as a RETRYABLE 503: a stage with no live
        replica in the view is the transient state the relay answers 503
        for (a lost gossip round, a replica restarting)."""
        return ServerError(f"routing unavailable: {e}", 503, code="no_chain")

    # -- transport ----------------------------------------------------------

    async def _post(self, addr: Tuple[str, int], path: str, body: Dict[str, Any]):
        host, port = addr
        return await self._post_url(f"http://{host}:{port}{path}", body)

    async def _hop(self, addr: Tuple[str, int], stage: int, session_id: str,
                   payload: Dict[str, Any]) -> Dict[str, Any]:
        env = {
            "task_id": str(uuid.uuid4()),
            "session_id": session_id,
            "stage": stage,
            "relay": False,
            "payload": payload,
            **deadline_wire(),
        }
        return (await self._post(addr, "/forward", env))["result"]

    async def _step(self, session_id: str, tokens: List[int], start_pos: int) -> np.ndarray:
        plan = self._plan_for(session_id)
        payload: Dict[str, Any] = {
            "tokens": np.asarray([tokens], dtype=np.int32),
            "start_pos": start_pos,
            "real_len": len(tokens),
        }
        if plan.committed:
            for stage, (nid, value) in enumerate(plan.chain):
                try:
                    result = await self._hop(node_addr(value), stage, session_id, payload)
                except Exception as e:
                    if not self._hop_failure_rescuable(e):
                        raise
                    nid, value = self._find_session_holder(session_id, stage, nid, e)
                    plan.chain[stage] = (nid, value)  # for the session's later steps too
                    log.info("session %s: the stage-%d hop failed (%s); moved to the "
                             "advertised holder %s", session_id, stage, e, nid)
                    result = await self._hop(node_addr(value), stage, session_id, payload)
                if "logits" in result:
                    return np.asarray(result["logits"])[0]
                payload = self._next_payload(result, payload)
            raise RuntimeError("the chain ended without logits: is it complete?")

        # the first pass: walk with the planner, replanning ahead of the agent
        planner = plan.planner
        assert planner is not None
        # the walk so far, where _end_session finds what a failed pass touched
        walked = plan.chain = []
        for stage in range(self.num_stages):
            try:
                planner.refresh(self._snapshot())
                nxt = planner.chain()[0]  # (stage, node_id, record): the next hop
            except NoNodeForStage as e:
                raise self._routing_unavailable(e) from e
            if nxt[0] != stage:
                raise RuntimeError(f"the planner skipped stage {stage}: {nxt}")
            _, nid, value = nxt
            result = await self._hop(node_addr(value), stage, session_id, payload)
            walked.append((nid, value))
            planner.advance(stage, nid)
            if self.hop_hook is not None:
                await self.hop_hook(session_id, stage)
            if "logits" in result:
                if stage != self.num_stages - 1:
                    raise RuntimeError(f"stage {stage} returned logits before the last stage")
                plan.committed = True
                plan.stats = dict(planner.stats)
                plan.planner = None  # frozen: the planner's state goes
                return np.asarray(result["logits"])[0]
            payload = self._next_payload(result, payload)
        raise RuntimeError("walked every stage without logits")

    @staticmethod
    def _hop_failure_rescuable(e: Exception) -> bool:
        """Whether a committed hop's failure is worth a holder lookup: the
        peer died in transport (refused, reset, timed out, a garbled body)
        or answered a retryable error (a 5xx, or `session_state`: it lost
        the session's KV, which another replica may hold), unless the error
        is a resume offer, which the base's `_step_resuming` acts on."""
        if isinstance(e, (OSError, TimeoutError, http.client.HTTPException, ValueError)):
            return True
        return isinstance(e, ServerError) and e.retryable and e.resume_from is None

    def _find_session_holder(self, session_id: str, stage: int, exclude: str,
                             cause: Exception) -> Tuple[str, Dict[str, Any]]:
        """A live replica of `stage` other than `exclude` whose record
        advertises the session (`sess`), else its replicated prefix
        (`standby`); else a retryable 503 `no_holder`, and generate_ids
        restarts the session."""
        h = sess_hash(session_id)
        replicas = self.dht.get_stage(stage).items()
        for key in ("sess", "standby"):
            for nid, value in replicas:
                if nid != exclude and h in (value.get(key) or ()):
                    return nid, value
        raise ServerError(
            f"the stage-{stage} hop failed ({cause}) and no replica advertises the "
            "session: restarting it", 503, code="no_holder") from cause

    @staticmethod
    def _next_payload(result: Dict[str, Any], prev: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "hidden": result["hidden"],
            "start_pos": int(result.get("start_pos", prev["start_pos"])),
            "real_len": int(result.get("real_len", prev["real_len"])),
        }

    async def _end_session(self, session_id: str) -> None:
        """Drop the session's KV on every replica its chain reached."""
        plan = self._plans.pop(session_id, None)
        if plan is None or not plan.chain:
            return
        await asyncio.gather(
            *(self._post(node_addr(value), "/end_session",
                         {"session_id": session_id, "stage": stage, "relay": False})
              for stage, (_, value) in enumerate(plan.chain)),
            return_exceptions=True,  # best effort: nodes sweep idle sessions
        )

    async def _fork_session(self, new_session_id: str, parent_session_id: str,
                            prefix_len: int) -> bool:
        """Fork on the PARENT's committed chain, every stage at once; the
        child inherits the chain. A parent without one, or a stage's clean
        `ok: False`, is a miss; a transport failure is raised."""
        parent = self._plans.get(parent_session_id)
        if parent is None or not parent.committed:
            return False
        results = await asyncio.gather(*(
            self._post(node_addr(value), "/fork_session", {
                "session_id": new_session_id, "parent_session_id": parent_session_id,
                "prefix_len": prefix_len, "stage": stage, "relay": False})
            for stage, (_, value) in enumerate(parent.chain)), return_exceptions=True)
        if any(isinstance(r, dict) and not r.get("ok") for r in results):
            return False
        for r in results:
            if isinstance(r, BaseException):
                raise r
        child = _SessionPlan(None)
        child.chain = list(parent.chain)
        child.committed = True
        self._plans[new_session_id] = child
        return True

    async def end_session(self, session_id: str) -> None:
        await self._end_session(session_id)
