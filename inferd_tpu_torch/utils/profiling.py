"""Timing harnesses (port of the measurement half of
inferd_tpu/utils/profiling.py).

`interleaved_pair_times` and `paired_delta_stats` are pure Python, copied
so the port imports nothing of the JAX package: a fixed-length decode is
timed at a short and a long step count in interleaved pairs, and the
per-pair difference gives the steady per-step time with the fixed
overhead (prefill, set-up, the final read) cancelled. `chained_attention_
rate` times an attention callable as n chained calls with one
synchronisation per rep. The trace capture (`Profiler`) waits for the
step-anatomy work.
"""

from __future__ import annotations

import statistics
import time


def chained_attention_rate(fn, q, k, v, n: int, reps: int = 3) -> float:
    """calls/s of `fn(q, k, v) -> out`: n calls chained per rep (each
    query takes a negligible but real contribution from the previous
    output, q + 1e-6 * out, as the reference's scan does), one
    torch.cuda.synchronize per rep on a card, min over reps."""
    import torch

    def loop():
        qc, o = q, None
        for _ in range(n):
            o = fn(qc, k, v)
            qc = q + 1e-6 * o.reshape(q.shape)
        return o

    def sync():
        if q.device.type == "cuda":
            torch.cuda.synchronize(q.device)

    loop()  # warm-up: builds and loads kernels
    sync()
    ts = []
    for _ in range(reps):  # min of reps: one disturbed rep must not decide
        t0 = time.perf_counter()
        loop()
        sync()
        ts.append(time.perf_counter() - t0)
    return n / min(ts)


def interleaved_pair_times(time_short, time_long, pairs: int):
    """Interleaved paired measurement of two timing callables: each pair
    runs one SHORT and one LONG window back to back, alternating which goes
    first, so a linear drift biases half the pairs up and half down and a
    median over per-pair quantities cancels it. Returns (t_shorts, t_longs),
    seconds."""
    ts, tl = [], []
    for i in range(pairs):
        if i % 2 == 0:
            a = time_short()
            b = time_long()
        else:
            b = time_long()
            a = time_short()
        ts.append(a)
        tl.append(b)
    return ts, tl


def paired_delta_stats(ts, tl, n_short: int, n_long: int):
    """Per-pair differenced per-iteration seconds from interleaved
    (short, long) window times.

    A pair is valid iff 0 < (tl - ts) and tl <= (n_long / n_short) * ts:
    the first drops pairs where a disturbance made the long window finish
    faster, the second the pairs that imply a negative fixed overhead. Each
    valid pair's steady per-iteration time is then <= its own end-to-end
    per-iteration time.

    Returns (per_iter_s, n_valid, spread_pt, ts_valid): the median
    per-iteration seconds over valid pairs (median(tl) / n_long when none
    is valid); how many pairs were valid; half the IQR of the per-pair
    times as a percentage of the median (range-based under 3 pairs); the
    valid pairs' short-window times (median(ts_valid) / n_short is then
    >= per_iter_s)."""
    per, ts_valid = [], []
    for a, b in zip(ts, tl):
        d = b - a
        if d > 0 and b <= (n_long / n_short) * a:
            per.append(d / (n_long - n_short))
            ts_valid.append(a)
    if not per:
        return statistics.median(tl) / n_long, 0, 0.0, list(ts)
    med = statistics.median(per)
    if len(per) >= 3:
        qs = statistics.quantiles(per, n=4)
        spread = (qs[2] - qs[0]) / 2
    else:
        spread = (max(per) - min(per)) / 2
    spread_pt = round(spread / med * 100, 1) if med > 0 else 0.0
    return med, len(per), spread_pt, ts_valid
