"""First-arrival-flushes micro-batch window (port of
inferd_tpu/runtime/window.py; thread-safe, executor-agnostic).

Decode requests from concurrent sessions that arrive within a short window
run as ONE device step. The first arriving thread becomes the flusher: it
waits `window_s` for co-arrivals (skipped when none are possible), then
calls the executor's `run_batch` callback; co-arrived threads block on
their entry until the flusher's step delivers their results.

The executor's `run_batch()` takes no entries: once it holds its own device
lock it pulls the batch with `drain_pending()`, so entries arriving
mid-step join the next step instead of fragmenting into mini-batches queued
on the device lock. It owns the drained entries end to end (each one's
result or error, and its event). If run_batch raises, whatever it did not
drain fails with that error.

The window wait ends early once every live idle session's entry is pending
(`gang_target`), which merges phase-offset session cohorts into one
lockstep co-batch; it is skipped when `co_possible()` says no co-arrival
can come.

`invalidate(pred, error)` lets session teardown fail entries that are still
waiting in the window (never started), so a freed lane can be reused
without a stale write racing its new owner.

The reference's `swap_in_run=False` flush (the batch swapped out when the
flusher wakes) and its plain `sleep(window_s)` wait without a gang target
serve the whole-model batch executor, which is not ported; stage-level
continuous batching (runtime/node + runtime/stage_batch) uses only this
mode. Co-batch counters live in the executor (`BatchedStageExecutor.stats`).

The reference's lock-order-checking proxies and its `window.stall` journal
event wait for the observability slice; a stalled flusher still raises
TimeoutError in its waiters.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional


class Entry:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload: Any):
        self.payload = payload
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[Exception] = None


class WindowedBatcher:
    def __init__(
        self,
        window_s: float,
        run_batch: Callable[[], None],
        co_possible: Callable[[], bool],
        gang_target: Callable[[], int],
        wait_timeout_s: float = 120.0,
    ):
        self.window_s = window_s
        self._run_batch = run_batch
        self._co_possible = co_possible
        self._wait_timeout_s = wait_timeout_s
        self._gang_target = gang_target
        self._mu = threading.Lock()
        self._pending: List[Entry] = []
        self._flusher_active = False

    def _wait(self, entry: Entry, where: str) -> Any:
        entry.event.wait(timeout=self._wait_timeout_s)
        if entry.error is not None:
            raise entry.error
        if not entry.event.is_set():
            raise TimeoutError(f"batched decode flusher never completed ({where})")
        return entry.result

    def submit(self, payload: Any) -> Any:
        entry = Entry(payload)
        with self._mu:
            self._pending.append(entry)
            i_flush = not self._flusher_active
            if i_flush:
                self._flusher_active = True
            wait = self._co_possible()

        if not i_flush:
            return self._wait(entry, "co_arrival")

        if wait:
            # bounded gang wait: poll until every live idle session's step is
            # pending or the window cap elapses
            deadline = time.monotonic() + self.window_s
            while True:
                if entry.event.is_set():
                    break  # our entry was invalidated mid-wait
                want = self._gang_target()
                with self._mu:
                    have = len(self._pending)
                if want and have >= want:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(0.0005, left))
        # release the flusher slot BEFORE running: a co-arrival during our
        # device step becomes the next flusher and queues on the device lock,
        # draining everything that accumulated meanwhile
        with self._mu:
            self._flusher_active = False
        try:
            self._run_batch()
        except Exception as exc:
            # entries the callback never drained would hang their submitters:
            # fail whatever is still pending, and our own entry if the
            # callback died before delivering it
            for e in self.drain_pending():
                e.error = exc
                e.event.set()
            if not entry.event.is_set():
                entry.error = entry.error or exc
                entry.event.set()
        return self._wait(entry, "flush")

    def drain_pending(self) -> List[Entry]:
        """Atomically take every live entry still waiting in the window.

        For continuous batching: a flusher that has just taken the device
        absorbs the entries that arrived while the previous step ran. The
        caller owns the drained entries end to end: it sets each one's
        result or error AND its `event` when the step completes."""
        with self._mu:
            batch, self._pending = self._pending, []
        return [e for e in batch if e.error is None]

    def invalidate(self, pred: Callable[[Any], bool], error: Exception) -> None:
        """Fail waiting entries whose payload matches `pred` (they have not
        started; entries already drained into a running step are the
        executor's, through its in-flight accounting)."""
        with self._mu:
            still = []
            for e in self._pending:
                if pred(e.payload):
                    e.error = error
                    e.event.set()
                else:
                    still.append(e)
            self._pending[:] = still
