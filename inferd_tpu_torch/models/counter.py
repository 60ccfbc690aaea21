"""Counter model: a compute backend with no weights, for testing the
distribution logic (port of inferd_tpu/models/counter.py).

Each stage adds one to the payload's `state` and appends its index to
`trace`: a request that traverses stages 0..N-1 in order arrives with
state == N and trace [0, ..., N-1], proving exactly-once, in-order
traversal through whatever routing and relaying carried it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class CounterStage:
    """forward(payload) -> payload with `state` + 1 and this stage on `trace`;
    the last stage also returns them as `result_for_user`."""

    def __init__(self, stage: int, num_stages: int):
        self.stage = stage
        self.num_stages = num_stages
        self.is_first = stage == 0
        self.is_last = stage == num_stages - 1

    def forward(self, payload: Dict[str, Any], session_id: Optional[str] = None) -> Dict[str, Any]:
        state = int(payload.get("state", 0))
        trace = list(payload.get("trace", []))
        trace.append(self.stage)
        out: Dict[str, Any] = {"state": state + 1, "trace": trace}
        if self.is_last:
            out["result_for_user"] = {"state": state + 1, "trace": trace}
        return out
