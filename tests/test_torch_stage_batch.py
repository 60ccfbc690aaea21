"""Stage-level continuous batching in the port: the arrival window
(runtime/window) and the lane executor (runtime/stage_batch), against the
JAX package's.

The lane executor runs the same scripted sequence as the reference's (mixed
prefills, co-batched decode windows at mixed positions, a replay rollback)
on a first, a middle and a last stage, dense and paged, and every item's
hidden state or logits is held to the reference's at atol 1e-4 (f32; the
sums run in another order). The rejection paths must raise the reference's
exception types. Nothing is held bitwise: the reference's own paged-vs-dense
bitwise tests fail on this tree."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.runtime.window import WindowedBatcher

torch.set_num_threads(2)


# -- WindowedBatcher (no model) ----------------------------------------------------


def _submit_into(b, results):
    def submit(tag, payload):
        try:
            results[tag] = b.submit(payload)
        except Exception as e:  # the test reads it back
            results[tag] = e
    return submit


def _drain_flush(b_ref, record):
    """The node's flush callback, without the node: drain once the device
    is held and deliver every drained entry."""
    def run_batch():
        drained = b_ref[0].drain_pending()
        record.append([e.payload for e in drained])
        for e in drained:
            e.result = ("ok", e.payload)
            e.event.set()
    return run_batch


def _batcher(window_s, record, gang_target=lambda: 0, **kw):
    b_ref = [None]
    b_ref[0] = WindowedBatcher(window_s, _drain_flush(b_ref, record), co_possible=lambda: True,
                               gang_target=gang_target, **kw)
    return b_ref[0]


def test_invalidate_fails_waiting_entry_fast():
    """A session torn down while its entry WAITS in the window fails fast
    with the teardown error and never reaches the step."""
    record = []
    b = _batcher(0.05, record)
    results = {}
    submit = _submit_into(b, results)
    t1 = threading.Thread(target=submit, args=("a", ("a", "payload")))
    t1.start()  # the flusher: waits the 50 ms window
    time.sleep(0.01)
    t2 = threading.Thread(target=submit, args=("b", ("b", "payload")))
    t2.start()
    time.sleep(0.01)
    err = ValueError("session b ended mid-request")
    t0 = time.monotonic()
    b.invalidate(lambda p: p[0] == "b", err)
    t1.join(timeout=5)
    t2.join(timeout=5)
    assert not t1.is_alive() and not t2.is_alive()
    assert time.monotonic() - t0 < 2.0
    assert results["b"] is err and results["a"] == ("ok", ("a", "payload"))
    assert all(("b", "payload") not in batch for batch in record)


def test_invalidated_flushers_own_entry_is_skipped():
    record = []
    b = _batcher(0.05, record)
    results = {}
    t = threading.Thread(target=_submit_into(b, results), args=("a", ("a", 1)))
    t.start()
    time.sleep(0.01)
    err = ValueError("session a ended mid-request")
    b.invalidate(lambda p: p[0] == "a", err)
    t.join(timeout=5)
    assert not t.is_alive() and results["a"] is err
    assert all(batch == [] for batch in record)


def test_swap_in_run_drain_serves_all_pending():
    record = []
    b = _batcher(0.03, record)
    results = {}
    ts = [threading.Thread(target=_submit_into(b, results), args=(t, (t,))) for t in "abc"]
    for t in ts:
        t.start()
        time.sleep(0.002)
    for t in ts:
        t.join(timeout=5)
    assert results == {t: ("ok", (t,)) for t in "abc"}
    assert sorted(p for batch in record for (p,) in batch) == ["a", "b", "c"]


def test_swap_in_run_invalidate_still_fails_fast():
    """A flusher in a long gang wait whose own entry is invalidated stops
    waiting at once: the teardown error, not the 5 s window cap."""
    record = []
    b = _batcher(5.0, record, gang_target=lambda: 2)
    results = {}
    t = threading.Thread(target=_submit_into(b, results), args=("a", ("a",)))
    t.start()
    time.sleep(0.01)
    err = ValueError("session a ended mid-request")
    t0 = time.monotonic()
    b.invalidate(lambda p: p[0] == "a", err)
    t.join(timeout=10)
    assert not t.is_alive() and time.monotonic() - t0 < 1.0
    assert results["a"] is err and all(("a",) not in batch for batch in record)


def test_swap_in_run_flush_failure_reaches_every_pending_entry():
    """A flush that dies before draining fails its own entry and every
    entry still pending with the flush's error: nobody waits out the
    timeout."""
    err = RuntimeError("device step failed")

    def run_batch():
        time.sleep(0.02)  # b arrives before the failure
        raise err

    b = WindowedBatcher(0.0, run_batch, co_possible=lambda: False, gang_target=lambda: 0,
                        wait_timeout_s=5.0)
    results = {}
    submit = _submit_into(b, results)
    t1 = threading.Thread(target=submit, args=("a", ("a",)))
    t1.start()
    time.sleep(0.005)
    t2 = threading.Thread(target=submit, args=("b", ("b",)))
    t2.start()
    t0 = time.monotonic()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert time.monotonic() - t0 < 2.0
    assert results["a"] is err
    assert isinstance(results["b"], Exception)


def test_gang_wait_flushes_early_at_target():
    record = []
    b = _batcher(5.0, record, gang_target=lambda: 2)
    results = {}
    submit = _submit_into(b, results)
    t0 = time.monotonic()
    t1 = threading.Thread(target=submit, args=("a", ("a",)))
    t2 = threading.Thread(target=submit, args=("b", ("b",)))
    t1.start()
    time.sleep(0.01)
    t2.start()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert time.monotonic() - t0 < 2.0  # the gang met: no 5 s window
    assert results == {"a": ("ok", ("a",)), "b": ("ok", ("b",))}
    assert record and len(record[0]) == 2  # ONE co-batch of both


# -- the lane executor against the reference ---------------------------------------


@pytest.fixture(scope="module")
def three_stages():
    """TINY split into 3 stages (layers 0-1, 2, 3): first, middle, last."""
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    specs = list(jstages.Manifest.even_split("tiny", 3).stage_specs())
    jsp = [jstages.extract_stage_params(jp, jcfg.TINY, s) for s in specs]
    tsp = [convert.params_from_numpy(jax.tree.map(np.asarray, p), None) for p in jsp]
    return specs, jsp, tsp


def _pair(three_stages, stage, **kw):
    specs, jsp, tsp = three_stages
    kw = dict(dict(lanes=4, max_len=64), **kw)
    return (JExecutor(jcfg.TINY, specs[stage], jsp[stage], **kw),
            BatchedStageExecutor(tcfg.TINY, specs[stage], tsp[stage], **kw))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("block_size", [0, 16])
def test_lane_executors_match_reference_on_every_stage(three_stages, block_size):
    """Each stage's port executor and reference executor get the same items
    (the reference's outputs feed both next stages): prefills of mixed
    lengths, co-batched windows at mixed positions, a replay rollback.
    Every item's output agrees at atol 1e-4, and the last stage's greedy
    tokens are equal."""
    kw = dict(block_size=block_size, prefill_chunk=8 if block_size else 0)
    chain = [_pair(three_stages, s, **kw) for s in range(3)]
    key = ["hidden", "hidden", "logits"]

    def run(per_stage_items, batched):
        """Push items through the 3 stages; returns last-stage logits per item."""
        items = per_stage_items
        for s, (jex, tex) in enumerate(chain):
            if batched:
                jouts, touts = jex.process_batch(items), tex.process_batch(items)
            else:
                jouts = [jex.process(sid, p) for sid, p in items]
                touts = [tex.process(sid, p) for sid, p in items]
            for (sid, p), jo, to in zip(items, jouts, touts):
                assert not isinstance(jo, Exception) and not isinstance(to, Exception), (jo, to)
                np.testing.assert_allclose(_np(to[key[s]]), _np(jo[key[s]]), rtol=0, atol=1e-4,
                                           err_msg=f"stage {s} session {sid}")
                assert to["start_pos"] == jo["start_pos"] and to["real_len"] == jo["real_len"]
            if s < 2:
                items = [(sid, {"hidden": np.asarray(jo["hidden"]), "start_pos": p["start_pos"],
                                "real_len": p["real_len"]}) for (sid, p), jo in zip(items, jouts)]
        return [np.asarray(jo["logits"])[0] for jo in jouts]

    rng = np.random.default_rng(1)
    prompts = {"x": rng.integers(0, 256, 19).tolist(), "y": [5, 2, 8],
               "z": rng.integers(0, 256, 33).tolist()}
    state = {}
    for sid, p in prompts.items():
        (lg,) = run([(sid, {"tokens": [p], "start_pos": 0, "real_len": len(p)})], False)
        state[sid] = {"pos": len(p), "out": [int(np.argmax(lg))]}
    for step in range(4):
        sids = list(prompts) if step % 2 == 0 else ["x", "z"]  # mixed windows
        lgs = run([(sid, {"tokens": [[state[sid]["out"][-1]]], "start_pos": state[sid]["pos"],
                          "real_len": 1}) for sid in sids], True)
        for sid, lg in zip(sids, lgs):
            state[sid]["out"].append(int(np.argmax(lg)))
            state[sid]["pos"] += 1
    # replay: re-send x's last two steps as one chunk from before its frontier
    x = state["x"]
    (lg,) = run([("x", {"tokens": [x["out"][-3:-1]], "start_pos": x["pos"] - 2,
                        "real_len": 2})], False)
    assert int(np.argmax(lg)) == x["out"][-1]
    for jex, tex in chain:
        st = tex.stats()
        assert st["batched_steps"] == 4 and st["batched_tokens"] == 10
        assert st["prefill_tokens"] == jex.stats()["prefill_tokens"]
        if block_size:
            assert st["paged"] == jex.stats()["paged"]


# -- rejection paths: the reference's exception types ------------------------------


@pytest.fixture(scope="module")
def first_pair(three_stages):
    """One first-stage executor pair per layout, shared by the rejection
    tests (each test ends its own sessions)."""
    return {bs: _pair(three_stages, 0, block_size=bs) for bs in (0, 16)}


def _same_outcome(pair, call):
    """Run `call(executor)` on both; returns the port's outcome after
    checking that both raise the same exception type or both succeed."""
    outs = []
    for ex in pair:
        try:
            outs.append(call(ex))
        except Exception as e:  # compared by type
            outs.append(e)
    if isinstance(outs[0], Exception) or isinstance(outs[1], Exception):
        assert type(outs[1]) is type(outs[0]), outs
    return outs[1]


def _end(pair, *sids):
    for ex in pair:
        for sid in sids:
            ex.end_session(sid)


@pytest.mark.parametrize("block_size", [0, 16])
def test_per_item_rejection_does_not_fail_cobatch(first_pair, block_size):
    pair = first_pair[block_size]
    p = [3, 7, 11, 19]
    for ex in pair:
        ex.process("live", {"tokens": [p], "start_pos": 0, "real_len": len(p)})
    items = [("live", {"tokens": [[1]], "start_pos": len(p), "real_len": 1}),
             ("ghost", {"tokens": [[1]], "start_pos": 9, "real_len": 1}),
             ("live", {"tokens": [[2]], "start_pos": len(p) + 1, "real_len": 1}),
             ("live", {"tokens": [[1, 2]], "start_pos": 9, "real_len": 2})]
    jouts, touts = pair[0].process_batch(items), pair[1].process_batch(items)
    assert [type(o) for o in touts] == [type(o) for o in jouts]
    assert isinstance(touts[1], ValueError) and isinstance(touts[2], ValueError)
    assert tuple(touts[0]["hidden"].shape[:2]) == (1, 1)
    np.testing.assert_allclose(_np(touts[0]["hidden"]), _np(jouts[0]["hidden"]), atol=1e-4)
    _end(pair, "live")


@pytest.mark.parametrize("block_size", [0, 16])
def test_overflow_out_of_order_and_replay(first_pair, block_size):
    pair = first_pair[block_size]
    p = [3, 7, 11, 19]
    for ex in pair:
        ex.process("s", {"tokens": [p], "start_pos": 0, "real_len": len(p)})
    step = {"tokens": [[5]], "start_pos": len(p), "real_len": 1}
    r1 = _same_outcome(pair, lambda ex: ex.process("s", step))
    r2 = _same_outcome(pair, lambda ex: ex.process("s", step))  # a replay of the same step
    assert torch.equal(r1["hidden"], r2["hidden"])
    err = _same_outcome(pair, lambda ex: ex.process("s", dict(step, start_pos=50)))
    assert isinstance(err, ValueError) and "out-of-order" in str(err)
    err = _same_outcome(pair, lambda ex: ex.process(
        "s", {"tokens": [[0] * 60], "start_pos": len(p) + 1, "real_len": 60}))
    assert isinstance(err, BufferError)
    err = _same_outcome(pair, lambda ex: ex.process("s", dict(step, decode_steps=4)))
    assert isinstance(err, ValueError)
    _end(pair, "s")


def test_session_end_mid_window_fails_fast_and_lane_is_reusable(three_stages):
    """A session ends while its decode entry waits in the window: the entry
    fails fast with the teardown error, and the freed lane serves a new
    session whose outputs equal the reference's."""
    jex, ex = _pair(three_stages, 0, lanes=2)

    def run_batch():  # the node's wiring, without the node
        drained = window.drain_pending()
        outs = ex.process_batch([(e.payload[0], e.payload[1]) for e in drained])
        for e, o in zip(drained, outs):
            if isinstance(o, Exception):
                e.error = o
            else:
                e.result = o
            e.event.set()

    window = WindowedBatcher(1.0, run_batch, co_possible=ex.co_possible,
                             gang_target=ex.gang_target)
    ex.on_drop = lambda sid: window.invalidate(
        lambda payload, _sid=sid: payload[0] == _sid,
        ValueError(f"session {sid} ended mid-request"))
    prompt = [3, 7, 11, 19]
    for sid in ("a", "b"):
        ex.process(sid, {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    got = {}
    t0 = time.monotonic()
    t = threading.Thread(target=_submit_into(window, got), args=(
        "a", ("a", {"tokens": [[1]], "start_pos": len(prompt), "real_len": 1})))
    t.start()
    time.sleep(0.05)
    ex.end_session("a")
    t.join(timeout=10)
    assert not t.is_alive() and time.monotonic() - t0 < 0.9
    assert isinstance(got["a"], ValueError) and "ended mid-request" in str(got["a"])
    assert "a" not in ex
    out = ex.process("c", {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    step = ex.process("c", {"tokens": [[5]], "start_pos": len(prompt), "real_len": 1})
    jex.process("c", {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    jstep = jex.process("c", {"tokens": [[5]], "start_pos": len(prompt), "real_len": 1})
    assert tuple(out["hidden"].shape[:2]) == (1, len(prompt))
    np.testing.assert_allclose(_np(step["hidden"]), _np(jstep["hidden"]), atol=1e-4)
    assert len(ex) == 2 and "c" in ex and "b" in ex


def test_pool_exhaustion_is_per_item_and_carries_identity(three_stages):
    """A lane that cannot extend its chain fails ALONE, naming its session
    and lane; its co-batch survives. (The reference's case uses K-step
    items, not ported: here b's step crosses into a new block, a's does
    not.)"""
    pair = _pair(three_stages, 0, block_size=16, kv_blocks=5)  # 4 usable blocks
    a, b = list(range(3, 3 + 30)), list(range(40, 40 + 32))
    for ex in pair:
        ex.process("a", {"tokens": [a], "start_pos": 0, "real_len": len(a)})
        ex.process("b", {"tokens": [b], "start_pos": 0, "real_len": len(b)})
    items = [("a", {"tokens": [[1]], "start_pos": 30, "real_len": 1}),
             ("b", {"tokens": [[1]], "start_pos": 32, "real_len": 1})]
    jouts, touts = pair[0].process_batch(items), pair[1].process_batch(items)
    assert [type(o) for o in touts] == [type(o) for o in jouts]
    assert not isinstance(touts[0], Exception) and isinstance(touts[1], BufferError)
    assert "block pool exhausted" in str(touts[1]) and "session b, lane" in str(touts[1])
    np.testing.assert_allclose(_np(touts[0]["hidden"]), _np(jouts[0]["hidden"]), atol=1e-4)


@pytest.fixture(scope="module")
def whole_stage():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    spec = list(jstages.Manifest.even_split("tiny", 1).stage_specs())[0]
    jsp = jstages.extract_stage_params(jp, jcfg.TINY, spec)
    return spec, jsp, convert.params_from_numpy(jax.tree.map(np.asarray, jsp), None)


def _whole(whole_stage, **kw):
    spec, jsp, tsp = whole_stage
    kw = dict(dict(lanes=4, max_len=128), **kw)
    return (JExecutor(jcfg.TINY, spec, jsp, **kw), BatchedStageExecutor(tcfg.TINY, spec, tsp, **kw))


def _drive(ex, sid, prompt, steps):
    r = ex.process(sid, {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt)})
    out, saved = [int(np.argmax(_np(r["logits"])[0]))], r.get("tokens_saved", 0)
    pos = len(prompt)
    for _ in range(steps):
        r = ex.process(sid, {"tokens": [[out[-1]]], "start_pos": pos, "real_len": 1})
        out.append(int(np.argmax(_np(r["logits"])[0])))
        pos += 1
    return out, saved


def test_shared_prefix_skips_prefill_on_a_whole_model_stage(whole_stage):
    """A session admitted against a pinned prefix computes only the
    unshared remainder (tokens_saved), and its stream equals the
    reference's and a dense port executor's."""
    pair = _whole(whole_stage, block_size=16)
    prefix = list(range(3, 3 + 64))
    prompt = prefix + [99, 98, 97]
    outs = []
    for ex in pair:
        assert ex.pin_prefix(prefix) == 64
        before = ex.stats()["prefill_tokens"]
        outs.append(_drive(ex, "s", prompt, 4))
        assert ex.stats()["prefill_tokens"] - before == len(prompt) - 64
        assert ex.stats()["paged"]["prefix_hit_tokens"] == 64
    assert outs[1] == outs[0] and outs[1][1] == 64
    for ex in pair:
        ex.end_session("s")
        ex.unpin_prefix(prefix)
        assert ex.stats()["paged"]["pins_resident"] == 0
    dense = _whole(whole_stage)[1]
    assert _drive(dense, "s", prompt, 4)[0] == outs[1][0]
    err = _same_outcome(_whole(whole_stage), lambda ex: ex.pin_prefix(prefix))
    assert isinstance(err, ValueError)  # pins need paged KV


def test_cow_divergence_does_not_corrupt_sharers(whole_stage):
    """Two sessions share pinned-prefix blocks; one REWRITES inside the
    shared region. CoW splits its blocks, so the other session (and the
    pin) keep the original KV: its next logits equal a dense executor's."""
    jex, ex = _whole(whole_stage, block_size=16)
    dense = _whole(whole_stage)[1]
    prefix = list(range(3, 3 + 32))
    prompt = prefix + [77, 76]
    for e in (jex, ex):
        e.pin_prefix(prefix)
    a1, _ = _drive(ex, "a", prompt, 2)
    _drive(ex, "b", prompt, 2)
    _drive(jex, "b", prompt, 2)
    alt = {"tokens": [[50, 51, 52, 53]], "start_pos": 8, "real_len": 4}
    rb, jrb = ex.process("b", alt), jex.process("b", alt)
    assert ex.stats()["paged"]["cow_splits"] >= 1
    assert ex.stats()["paged"]["cow_splits"] == jex.stats()["paged"]["cow_splits"]
    np.testing.assert_allclose(_np(rb["logits"]), _np(jrb["logits"]), atol=1e-4)
    step = {"tokens": [[a1[-1]]], "start_pos": len(prompt) + 2, "real_len": 1}
    ra = ex.process("a", step)
    _drive(dense, "a", prompt, 2)
    rd = dense.process("a", step)
    np.testing.assert_allclose(_np(ra["logits"]), _np(rd["logits"]), atol=1e-5)
    assert np.argmax(_np(ra["logits"])) == np.argmax(_np(rd["logits"]))


def test_chunked_prefill_interleaves_with_decode_windows(whole_stage):
    """A long chunked prefill runs WHILE three lanes keep decoding through a
    node-style window: decode steps complete during the prefill, and the
    long session's next logits match a one-dispatch dense prefill's."""
    spec, _jsp, tsp = whole_stage
    ex = BatchedStageExecutor(tcfg.TINY, spec, tsp, lanes=6, max_len=384, block_size=16,
                              prefill_chunk=8)

    def run_batch():
        drained = window.drain_pending()
        outs = ex.process_batch([(e.payload[0], e.payload[1]) for e in drained])
        for e, o in zip(drained, outs):
            if isinstance(o, Exception):
                e.error = o
            else:
                e.result = o
            e.event.set()

    window = WindowedBatcher(0.005, run_batch, co_possible=ex.co_possible,
                             gang_target=ex.gang_target, wait_timeout_s=30.0)
    state = {}
    for i in range(3):
        p = [3 + i, 7, 11, 19]
        r = ex.process(f"d{i}", {"tokens": [p], "start_pos": 0, "real_len": len(p)})
        state[f"d{i}"] = {"pos": len(p), "tok": int(np.argmax(_np(r["logits"])[0]))}
    done_ts = {sid: [] for sid in state}

    def decoder(sid):
        st = state[sid]
        for _ in range(30):
            r = window.submit((sid, {"tokens": [[st["tok"]]], "start_pos": st["pos"],
                                     "real_len": 1}))
            st["tok"] = int(np.argmax(_np(r["logits"])[0]))
            st["pos"] += 1
            done_ts[sid].append(time.monotonic())

    long_prompt = list(range(5, 5 + 240))  # 30 chunks of 8
    span = {}

    def prefill():
        span["t0"] = time.monotonic()
        ex.process("long", {"tokens": [long_prompt], "start_pos": 0, "real_len": 240})
        span["t1"] = time.monotonic()

    tds = [threading.Thread(target=decoder, args=(sid,)) for sid in state]
    for t in tds:
        t.start()
    time.sleep(0.03)
    tp = threading.Thread(target=prefill)
    tp.start()
    for t in [tp, *tds]:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(len(v) == 30 for v in done_ts.values())
    during = [ts for v in done_ts.values() for ts in v if span["t0"] <= ts <= span["t1"]]
    assert during, "no decode step completed while the prefill ran"
    dense = BatchedStageExecutor(tcfg.TINY, spec, tsp, lanes=2, max_len=384)
    r1 = ex.process("long", {"tokens": [[1]], "start_pos": 240, "real_len": 1})
    dense.process("long", {"tokens": [long_prompt], "start_pos": 0, "real_len": 240})
    r2 = dense.process("long", {"tokens": [[1]], "start_pos": 240, "real_len": 1})
    assert np.argmax(_np(r1["logits"])[0]) == np.argmax(_np(r2["logits"])[0])
    np.testing.assert_allclose(_np(r1["logits"]), _np(r2["logits"]), atol=1e-4)


def test_paged_decode_dispatches_are_counted_by_table_width(whole_stage):
    """Every paged decode dispatch is recorded under the table width it was
    stamped at (chain_clamp: the power-of-two bucket of the longest chain),
    which with the lane count fixes ops.attention.paged_plan's cut: the
    record chip_smoke derives each node's split launches from. A dense
    executor records none."""
    ex = _whole(whole_stage, block_size=16)[1]
    _drive(ex, "a", list(range(3, 40)), 3)  # 37 + 3 tokens: chains of 3 blocks
    _drive(ex, "b", list(range(3, 70)), 2)  # 67 + 2 tokens: chains of 5 blocks
    st = ex.stats()
    assert st["decode_widths"] == {"4": 3, "8": 2}
    assert sum(st["decode_widths"].values()) == st["batched_steps"]
    dense = _whole(whole_stage)[1]
    _drive(dense, "a", [3, 4, 5], 2)
    assert "decode_widths" not in dense.stats()
