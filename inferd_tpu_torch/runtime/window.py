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
drain fails with that error. Both owners of a window use it: runtime/node
for the pipeline stage's lane executor, and the whole-model
runtime/batch_executor for its own.

The reference's other mode, `swap_in_run=False` (the flusher takes the
pending list when it wakes, before it holds the device), is not ported:
sessions whose steps arrive further apart than the window then form a
convoy of one-entry batches queued on the device lock, and stay in it,
where the drain takes every step that arrived while the device was busy.

The window wait ends early once every live idle session's entry is pending
(`gang_target`), which merges phase-offset session cohorts into one
lockstep co-batch; without a gang target it is a plain `sleep(window_s)`.
It is skipped when `co_possible()` says no co-arrival can come.

`n_steps` and `n_served` count the drains that took entries and the
entries they took (`stats()`); an executor that serves more than one token
per entry (a K-step window) or fails entries adjusts `n_served`
(`count_served`) so it counts tokens.

`invalidate(pred, error)` lets session teardown fail entries that are still
waiting in the window (never started), so a freed lane can be reused
without a stale write racing its new owner.

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
        gang_target: Optional[Callable[[], int]] = None,
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
        self.n_steps = 0  # batches taken
        self.n_served = 0  # entries (tokens, as the executor adjusts it) in them

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

        if wait and self._gang_target is None:
            time.sleep(self.window_s)
        elif wait:
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

    def count_served(self, delta: int) -> None:
        """Adjust `n_served` by the executor's count: tokens, not entries."""
        with self._mu:
            self.n_served += delta

    def stats(self) -> dict:
        """Batches taken, entries (tokens) served, and their mean."""
        with self._mu:
            steps, served = self.n_steps, self.n_served
        return {"batched_steps": steps, "batched_tokens": served,
                "mean_batch": round(served / steps, 3) if steps else 0.0}

    def drain_pending(self) -> List[Entry]:
        """Atomically take every live entry still waiting in the window.

        For continuous batching: a flusher that has just taken the device
        absorbs the entries that arrived while the previous step ran. The
        caller owns the drained entries end to end: it sets each one's
        result or error AND its `event` when the step completes."""
        with self._mu:
            batch, self._pending = self._pending, []
            live = [e for e in batch if e.error is None]
            if live:
                self.n_steps += 1
                self.n_served += len(live)
        return live

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
