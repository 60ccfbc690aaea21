"""The port's overload plane on the CPU: deadlines, admission shedding, session
rescue, hedged decode relays, chaos, and the client's session restarts with
retry budgets, held to the JAX package's functions where both have one and
to the reference's behaviour on in-process nodes (counter backend, or the
TINY preset with weights 10x the init so greedy streams move).

Cheap by design: delays of at most 0.5 s, hop timeouts of at most 2 s,
gossip every 0.05 s and no TTL waited out; every stall is released in
teardown (a node's stop() or crash() releases its chaos).
"""

import asyncio
import http.client
import json
import math
import random
import time
import uuid
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.control import dht as jdht
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.utils import chaos as jchaos
from inferd_tpu.utils import metrics as jmetrics
from inferd_tpu.utils import retry as jretry
from inferd_tpu_torch.client import base as clientbase
from inferd_tpu_torch.client.base import GenerationClient, ServerError
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control import dht as pdht
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node
from inferd_tpu_torch.utils import chaos as pchaos
from inferd_tpu_torch.utils import metrics as pmetrics
from inferd_tpu_torch.utils import retry as pretry

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
NEW = 8

# -- held against the JAX package's functions -------------------------------------------


@pytest.mark.parametrize("base, cap", [(1.0, 8.0), (0.5, 4.0), (0.01, 0.3)])
def test_backoff_delay_equals_reference(base, cap):
    a, b = random.Random(42), random.Random(42)
    got = [pretry.backoff_delay(n, base, cap, a) for n in range(0, 9)]
    want = [jretry.backoff_delay(n, base, cap, b) for n in range(0, 9)]
    assert got == want
    assert got[0] == 0.0 and all(0.0 <= d <= cap for d in got)


def _budget_script(mod, seed):
    """A seeded run of advances and acquires on both budgets of `mod`."""
    t = [0.0]
    rb = mod.RetryBudget(rate_per_s=2.0, burst=3, clock=lambda: t[0])
    hb = mod.RatioBudget(ratio=0.05, burst=2)
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        t[0] += rng.choice([0.0, 0.0, 0.1, 0.3, 1.0])
        out.append(rb.try_acquire(rng.choice([1.0, 1.0, 2.0])))
        hb.note(rng.randrange(0, 5))
        out.append(hb.try_acquire())
    return out, rb.stats(), hb.stats(), rb.tokens(), hb.extra_frac()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_budgets_grant_as_the_reference(seed):
    assert _budget_script(pretry, seed) == _budget_script(jretry, seed)


def test_deadline_helpers_equal_reference():
    for d in (None, "junk", 1e15, 0.0, 12345.5):
        assert pretry.remaining_s(d, now=100.0) == jretry.remaining_s(d, now=100.0)
    assert pretry.deadline_ms_from_now(1.5, now=10.0) == jretry.deadline_ms_from_now(1.5, now=10.0)
    assert pretry.DEADLINE_KEY == jretry.DEADLINE_KEY == "deadline_ms"


def test_sess_hash_equals_reference():
    rng = np.random.default_rng(5)
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(990)]
    ids += ["", "x", "séance", "a" * 300, "0" * 7, "中文", "s\x00t", "1", "2", "3"]
    assert len(ids) == 1000
    assert [pdht.sess_hash(i) for i in ids] == [jdht.sess_hash(i) for i in ids]


CHAOS_SPECS = [
    "drop=0.2,jitter_ms=5:50,stall_p=0.1,seed=3",  # the reference docstring's examples
    "drop_after=10,delay_ms=50",
    "jitter_ms=5:50,stall_p=0.3,drop_after=7,seed=9",
    "drop=0.1,delay_ms=2,jitter_ms=0:1,stall_p=0.05",
    "die_after=10",
    "crash_after=4,block_ms=3,seed=11",
    "",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_parse_equals_reference(spec):
    got, want = pchaos.Chaos.parse(spec), jchaos.Chaos.parse(spec)
    if want is None:
        assert got is None
        return
    fields = ("drop", "delay_ms", "block_ms", "jitter_ms", "stall_p", "drop_after",
              "die_after", "crash_after", "seed")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


@pytest.mark.parametrize("spec, error", [("jitter_ms=5", "A:B"), ("jitter_ms=9:1", "inverted"),
                                         ("nope=1", "unknown chaos key")])
def test_chaos_parse_refuses_as_the_reference(spec, error):
    for mod in (pchaos, jchaos):
        with pytest.raises(ValueError, match=error):
            mod.Chaos.parse(spec)


@pytest.mark.parametrize("spec", [s for s in CHAOS_SPECS if s and "die_after" not in s])
def test_chaos_draws_replay_the_reference(spec, monkeypatch):
    """The same spec and request sequence: the same sleeps, stalls and drops
    (sleeps recorded, not slept)."""
    want = []

    async def fake_sleep(s):
        want.append(("sleep", round(s, 9)))

    monkeypatch.setattr(jchaos.asyncio, "sleep", fake_sleep)
    # block_ms sleeps synchronously there
    monkeypatch.setattr(jchaos.time, "sleep", lambda s: want.append(("sleep", round(s, 9))))
    ref = jchaos.Chaos.parse(spec)

    async def ref_run():
        for _ in range(40):
            try:
                await ref.before_forward()
                want.append("ok")
            except jchaos.ChaosDrop as e:
                want.append(("drop", str(e)))

    asyncio.run(ref_run())
    port = pchaos.Chaos.parse(spec)
    got = []
    port._sleep = lambda s: got.append(("sleep", round(s, 9)))
    for _ in range(40):
        try:
            port.before_forward()
            got.append("ok")
        except pchaos.ChaosDrop as e:
            got.append(("drop", str(e)))
    assert got == want


def test_chaos_stall_is_released_by_cancel():
    c = pchaos.Chaos.parse("stall_p=1")
    out = []

    def forward():
        try:
            c.before_forward()
            out.append("served")
        except pchaos.ChaosDrop as e:
            out.append(str(e))

    import threading

    t = threading.Thread(target=forward)
    t.start()
    deadline = time.monotonic() + 5
    while c._stalled == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c._stalled == 1 and t.is_alive()
    assert c.cancel_stalls() == 1
    t.join(timeout=5)
    assert not t.is_alive() and out == ["chaos released: the node is stopping"]


def test_quantile_estimates_equal_reference():
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.exponential(30.0, 500), rng.uniform(0, 20000, 20)]).tolist()
    ref = jmetrics.Histogram()
    t = [0.0]
    win = pmetrics.TrailingWindow(horizon_s=60.0, clock=lambda: t[0])
    for v in vals:
        ref.observe(v)
        win.observe(v)
    bounds, counts, total, _ = ref.state()
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert (pmetrics.Histogram._quantile_from(bounds, counts, total, q)
                == jmetrics.Histogram._quantile_from(bounds, counts, total, q))
        assert win.quantile(q) == ref.quantile(q)
    assert pmetrics.Histogram._quantile_from(bounds, [0] * len(counts), 0, 0.5) == 0.0
    ph = pmetrics.Histogram()
    for v in vals:
        ph.observe(v)
    assert ph.summary() == ref.summary()
    # the window forgets what fell out of its horizon
    t[0] = 61.0
    assert win.quantile(0.95) is None
    win.observe(3.0)
    assert win.quantile(0.95) == 5


# -- the client: retries, budgets, deadlines, the wire -----------------------------------


def test_server_error_retryability():
    assert ServerError("x", 500).retryable
    assert ServerError("x", 502).retryable
    assert ServerError("x", 409, code="session_state").retryable
    assert not ServerError("x", 409, code="overflow").retryable
    assert not ServerError("x", 409, code="wrong_stage").retryable
    assert not ServerError("x", 400).retryable
    assert not ServerError("x", 408, code="deadline").retryable
    e = ServerError("x", 503, code="busy", retry_after=0.2)
    assert e.retryable and e.retry_after == 0.2


class _Scripted(GenerationClient):
    """A transport that raises `failures[k]` at its k-th step (counted over
    every attempt) and otherwise serves logits whose argmax follows the
    step's position (no HTTP, no nodes)."""

    def __init__(self, failures=None, vocab=16):
        super().__init__(sampling=GREEDY)
        self.failures = dict(failures or {})
        self.steps = 0
        self.sessions = []
        self.ended = []
        self.vocab = vocab

    async def _step(self, session_id, tokens, start_pos):
        k = self.steps
        self.steps += 1
        if not self.sessions or self.sessions[-1] != session_id:
            self.sessions.append(session_id)
        if k in self.failures:
            raise self.failures[k]
        logits = np.zeros(self.vocab, np.float32)
        logits[(start_pos * 7 + len(tokens)) % self.vocab] = 1.0
        return logits

    async def _end_session(self, session_id):
        self.ended.append(session_id)


def test_retry_budget_exhaustion_surfaces_original_error():
    err = ServerError("boom: stage 1 down", 503)
    c = _Scripted({k: err for k in range(20)})
    budget = pretry.RetryBudget(rate_per_s=0.0, burst=2)  # exactly two retries, ever
    with pytest.raises(ServerError, match="boom"):
        asyncio.run(c.generate_ids([1, 2, 3], max_new_tokens=2, session_retries=10,
                                   retry_delay_s=0.001, retry_budget=budget,
                                   retry_rng=random.Random(0)))
    assert c.steps == 3  # one attempt and the two budgeted retries
    assert budget.stats()["denied"] >= 1
    assert len(c.ended) == 3  # every attempt's session dropped


def test_retry_honours_retry_after():
    c = _Scripted({k: ServerError("busy", 503, code="busy", retry_after=0.3) for k in (0, 1)})
    t0 = time.monotonic()
    with pytest.raises(ServerError):
        asyncio.run(c.generate_ids([1], max_new_tokens=1, session_retries=1,
                                   retry_delay_s=0.001, retry_rng=random.Random(0)))
    assert time.monotonic() - t0 >= 0.28  # waited the hint, not ~1 ms
    assert c.steps == 2


def test_client_deadline_stops_retries():
    c = _Scripted({k: ServerError("transient", 500) for k in range(10)})
    with pytest.raises(ServerError) as ei:
        asyncio.run(c.generate_ids([1], max_new_tokens=1, session_retries=5, retry_delay_s=0.2,
                                   deadline_s=0.0, retry_rng=random.Random(0)))
    assert ei.value.code == "deadline" and ei.value.status == 408 and not ei.value.retryable
    assert c.steps <= 1
    assert clientbase.current_deadline_ms() is None  # reset after the generation


@pytest.mark.parametrize("failure", [ConnectionError("entry gone"), OSError("reset"),
                                     http.client.RemoteDisconnected("closed"),
                                     ServerError("lost", 409, code="session_state")])
def test_a_restart_gives_the_same_tokens_and_marks_the_restart(failure):
    clean = asyncio.run(_Scripted().generate_ids([3, 4], max_new_tokens=5))
    assert len(set(clean)) > 1
    c = _Scripted({2: failure})  # the first attempt's third step fails
    seen, lps = [], []
    got = asyncio.run(c.generate_ids([3, 4], max_new_tokens=5, on_token=seen.append,
                                     retry_delay_s=0.001, logprob_sink=lps,
                                     retry_rng=random.Random(1)))
    assert got == clean and len(lps) == len(got)
    assert seen.count(None) == 1 and seen[:seen.index(None)] == clean[:2]
    assert seen[seen.index(None) + 1:] == clean  # after the marker, the stream again
    assert len(c.sessions) == 2 and c.ended == c.sessions


def test_non_retryable_errors_raise_at_once():
    c = _Scripted({0: ServerError("too long", 409, code="overflow")})
    with pytest.raises(ServerError, match="too long"):
        asyncio.run(c.generate_ids([1], max_new_tokens=3, retry_delay_s=0.001))
    assert c.steps == 1


def test_deadline_rides_every_envelope_and_only_then():
    sw = SwarmClient([("127.0.0.1", 1)])
    env = sw._forward_env("s", [1, 2], 0)
    old = {  # the envelope as the client built it before deadlines
        "task_id": env["task_id"], "session_id": "s", "stage": 0,
        "payload": {"tokens": np.asarray([[1, 2]], np.int32), "start_pos": 0, "real_len": 2},
    }
    assert "deadline_ms" not in env and wire.pack(env) == wire.pack(old)
    tok = clientbase._DEADLINE_MS.set(1e15)
    try:
        env2 = sw._forward_env("s", [1, 2], 0)
    finally:
        clientbase._DEADLINE_MS.reset(tok)
    assert env2["deadline_ms"] == 1e15 and wire.unpack(wire.pack(env2))["deadline_ms"] == 1e15

    sent = []

    class Capture(ChainClient):
        async def _post(self, addr, path, body):
            sent.append(body)
            if body["stage"] == 0:
                return {"result": {"hidden": np.zeros((1, 1, 4), np.float32),
                                   "start_pos": body["payload"]["start_pos"], "real_len": 1}}
            return {"result": {"logits": np.zeros((1, 8), np.float32)}}

        async def _end_session(self, session_id):
            pass

    cc = Capture([("h", 1), ("h", 2)], sampling=GREEDY)
    asyncio.run(cc.generate_ids([5], max_new_tokens=2))
    assert sent and not any("deadline_ms" in e for e in sent)
    sent.clear()
    asyncio.run(cc.generate_ids([5], max_new_tokens=2, deadline_s=30.0))
    dls = {e["deadline_ms"] for e in sent}
    assert len(sent) == 4 and len(dls) == 1  # every hop, one absolute deadline
    assert abs(dls.pop() / 1e3 - (time.time() + 30.0)) < 5.0


# -- nodes: the counter backend --------------------------------------------------------


def _node(stage, *args, seed=None):
    # the balancer's period outlasts the test (the reference's test nodes'):
    # a tick under a transient load skew would move a replica mid-test
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", "600", *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _swarm(specs, common=()):
    """Started nodes, one per (stage, extra args), the first the gossip seed,
    once every view holds every record."""
    (s0, a0), rest = specs[0], specs[1:]
    nodes = [_node(s0, *common, *a0)]
    nodes += [_node(s, *common, *a, seed=nodes[0]) for s, a in rest]
    _wait(lambda: all(sum(len(v) for v in n.dht.get_all().values()) == len(nodes)
                      for n in nodes), "gossip did not converge")
    return nodes


def _wait(cond, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(what)


def _stop(nodes):
    for n in nodes:
        n.stop()


def _post(node, path, body, timeout=30):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=timeout)
    try:
        conn.request("POST", path, body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read()), r.getheader("Retry-After")
    finally:
        conn.close()


def _counters(node):
    return node.stats()["metrics"]["counters"]


def _counter_env(sid, stage=0, start_pos=0, **kw):
    return {"stage": stage, "session_id": sid, "task_id": "t",
            "payload": {"state": stage, "start_pos": start_pos, "real_len": 1}, **kw}


COUNTER2 = ("--backend", "counter", "--num-stages", "2")


def test_deadline_expired_at_entry_fails_before_any_work():
    nodes = _swarm([(0, ()), (1, ())], COUNTER2)
    try:
        status, body, _ = _post(nodes[0], "/forward", _counter_env(
            "dl", deadline_ms=(time.time() - 5.0) * 1e3))
        assert status == 408 and body["code"] == "deadline" and "entry" in body["error"]
        c0, c1 = _counters(nodes[0]), _counters(nodes[1])
        assert c0["deadline.expired"] == 1 and c0["deadline.expired.entry"] == 1
        assert "forward.requests" not in c0 and "forward.requests" not in c1
        assert nodes[0].stats()["forward_passes"] == nodes[1].stats()["forward_passes"] == 0
        assert nodes[0].stats()["relays"] == 0
        # a deadline ahead: served, and carried onto the relayed envelope
        seen = []
        real = nodes[1].forward
        nodes[1].forward = lambda body: (seen.append(body), real(body))[1]
        dl = (time.time() + 30.0) * 1e3
        status, body, _ = _post(nodes[0], "/forward", _counter_env("ok", deadline_ms=dl))
        assert status == 200 and body["result_for_user"]["state"] == 2
        assert wire.unpack(seen[-1])["deadline_ms"] == dl
        # without one, the relayed envelope is the bytes it was before deadlines
        # (a new session's: the planned route rides it)
        status, body, _ = _post(nodes[0], "/forward", _counter_env("plain"))
        relayed = wire.unpack(seen[-1])
        assert status == 200 and "deadline_ms" not in relayed
        assert relayed["route"] == {"1": nodes[1].node_id}
        assert seen[-1] == wire.pack({"task_id": "t", "session_id": "plain", "stage": 1,
                                      "payload": relayed["payload"], "route": relayed["route"]})
    finally:
        _stop(nodes)


def test_deadline_expiring_in_compute_is_not_relayed():
    nodes = _swarm([(0, ("--chaos", "delay_ms=400")), (1, ())], COUNTER2)
    try:
        t0 = time.monotonic()
        status, body, _ = _post(nodes[0], "/forward", _counter_env(
            "dm", deadline_ms=(time.time() + 0.15) * 1e3))
        assert status == 408 and body["code"] == "deadline"
        assert "post-compute" in body["error"] and time.monotonic() - t0 < 2.0
        c0 = _counters(nodes[0])
        assert c0["forward.requests"] == 1 and c0["deadline.expired.post-compute"] == 1
        assert nodes[0].stats()["forward_passes"] == 1  # stage 0 computed ...
        assert "forward.requests" not in _counters(nodes[1])  # ... and relayed nothing
        assert nodes[0].stats()["relays"] == 0
    finally:
        _stop(nodes)


def test_relay_hop_timeout_follows_the_deadline_on_a_stall():
    """A hop to a stalled replica waits what is left of the deadline, not the
    hop timeout, and answers the deadline's 408."""
    nodes = _swarm([(0, ("--hop-timeout", "2", "--hedge-mode", "off")),
                    (1, ("--chaos", "stall_p=1")), (1, ())], COUNTER2)
    seed, stalled, _ = nodes
    try:
        seed._remember(("st", 1), stalled.node_id)
        t0 = time.monotonic()
        status, body, _ = _post(seed, "/forward", _counter_env(
            "st", stage=1, start_pos=3, rescued=True, deadline_ms=(time.time() + 0.3) * 1e3))
        took = time.monotonic() - t0
        assert status == 408 and body["code"] == "deadline" and took < 0.3 + 0.15, took
        assert seed.stats()["dead_hops"] == 1
        assert _counters(seed)["deadline.expired.relay"] == 1
    finally:
        _stop(nodes)
    _wait(lambda: stalled.chaos._stalled == 0, "stop() left a stalled handler")


def test_hedge_wins_when_the_primary_stalls_and_repoints_affinity():
    nodes = _swarm([(0, ("--hedge-mode", "any", "--hedge-delay-ms", "50", "--hop-timeout", "2")),
                    (1, ("--chaos", "stall_p=1")), (1, ())],
                   ("--backend", "counter", "--num-stages", "2"))
    seed, stalled, good = nodes
    try:
        seed._remember(("hsess", 1), stalled.node_id)  # the sick replica holds the session
        env = {"task_id": "t", "session_id": "hsess", "stage": 1, "rescued": True,
               "payload": {"state": 1, "start_pos": 5, "real_len": 1}}
        t0 = time.monotonic()
        status, _, raw = seed._relay(env, 1)
        assert status == 200 and time.monotonic() - t0 < 1.0
        assert wire.unpack(raw)["result_for_user"]["state"] == 2
        c = _counters(seed)
        assert c["hedge.fired"] == c["hedge.won"] == 1 and "hedge.cancelled" not in c
        assert seed._session_next[("hsess", 1)][0] == good.node_id
        assert seed.hedge_budget.stats()["fired"] == 1
        assert stalled.chaos._stalled == 1  # the loser is still held over there ...
        # ... and the session's next step goes straight to the winner
        status, _, raw = seed._relay(dict(env, payload=dict(env["payload"], start_pos=6)), 1)
        assert status == 200 and _counters(seed)["hedge.fired"] == 1
    finally:
        stalled.crash()
        _stop([seed, good])
    _wait(lambda: stalled.chaos._stalled == 0, "crash() left a stalled handler")


def test_hedge_budget_and_the_primary_settles():
    nodes = _swarm([(0, ("--hedge-mode", "any", "--hedge-delay-ms", "20")),
                    (1, ("--chaos", "delay_ms=150")), (1, ("--chaos", "drop=1"))], COUNTER2)
    seed, slow, broken = nodes
    try:
        seed._remember(("h2", 1), slow.node_id)
        env = {"task_id": "t", "session_id": "h2", "stage": 1, "rescued": True,
               "payload": {"state": 1, "start_pos": 5, "real_len": 1}}
        status, _, raw = seed._relay(env, 1)  # the hedge's 500 settles nothing
        assert status == 200 and wire.unpack(raw)["served_by"] == slow.node_id
        c = _counters(seed)
        assert c["hedge.fired"] == 1 and c["hedge.cancelled"] == 1 and "hedge.won" not in c
        seed.hedge_budget.fired = 10  # the budget spent: no hedge, the primary alone
        status, _, raw = seed._relay(env, 1)
        assert status == 200 and _counters(seed)["hedge.fired"] == 1
    finally:
        _stop(nodes)


def test_admission_shed_with_retry_after_and_mid_session_chunks_flow():
    nodes = _swarm([(0, ())], ("--backend", "counter", "--num-stages", "1"))
    n0 = nodes[0]
    try:
        assert "shed" not in n0.dht.get_stage(0)[n0.node_id]
        n0.executor.pool = SimpleNamespace(num_blocks=100, blocks_free=2)  # 2 free < 5
        status, body, header = _post(n0, "/forward", _counter_env("new"))
        assert status == 503 and body["code"] == "busy" and "2 free of 100" in body["error"]
        assert 0.05 <= body["retry_after"] <= 5.0
        assert header == str(math.ceil(body["retry_after"]))
        # the client reads the hint (body first, else the header) and may retry
        with pytest.raises(ServerError) as ei:
            asyncio.run(SwarmClient([(n0.host, n0.port)])._post("/forward", _counter_env("new")))
        assert ei.value.retryable and ei.value.retry_after == body["retry_after"]
        # a mid-session chunk is never shed
        status, body, _ = _post(n0, "/forward", _counter_env("old", start_pos=3, rescued=True))
        assert status == 200 and body["result_for_user"]["state"] == 1
        assert _counters(n0)["admission.shed"] == 2
        assert n0.dht.get_stage(0)[n0.node_id]["shed"] == 1  # gossiped while under reserve
        n0.executor.pool = SimpleNamespace(num_blocks=100, blocks_free=5)
        assert _post(n0, "/forward", _counter_env("new2"))[0] == 200
        assert "shed" not in n0.dht.get_stage(0)[n0.node_id]
    finally:
        _stop(nodes)


def test_new_sessions_steer_around_a_shedding_replica():
    nodes = _swarm([(0, ()), (1, ()), (1, ())], COUNTER2)
    seed, a, b = nodes
    try:
        a.executor.pool = SimpleNamespace(num_blocks=100, blocks_free=0)
        a.announce(urgent=True)
        _wait(lambda: seed.dht.get_stage(1)[a.node_id].get("shed") == 1, "shed not gossiped")
        for i in range(4):  # new sessions: all on b, though a holds none of them
            status, body, _ = _post(seed, "/forward", _counter_env(f"n{i}", stage=1))
            assert status == 200 and body["served_by"] == b.node_id
        # a mid-session chunk still goes where the session's KV is
        seed._remember(("held", 1), a.node_id)
        status, body, _ = _post(seed, "/forward",
                                _counter_env("held", stage=1, start_pos=4, rescued=True))
        assert status == 200 and body["served_by"] == a.node_id
    finally:
        _stop(nodes)


def test_retry_after_and_records_match_the_reference(monkeypatch):
    """For the same executor state, the port's `sess` and `shed` keys and its
    Retry-After are the reference's (the reference's methods run on a stub
    holding that state)."""
    from inferd_tpu.runtime import node as jnode

    nodes = _swarm([(0, ())], ("--backend", "counter", "--num-stages", "1"))
    n0 = nodes[0]
    try:
        before = dict(n0.dht.get_stage(0)[n0.node_id])
        assert list(before) == ["name", "stage", "load", "cap", "host", "port", "model"]
        for held, free, reserve in [(0, 50, 0.05), (3, 4, 0.05), (200, 1, 0.5), (5, 60, 0.5)]:
            ids = [f"sess-{i}" for i in range(held)]
            n0.executor.sessions = SimpleNamespace(ids=lambda ids=ids: list(ids))
            n0.executor.pool = SimpleNamespace(num_blocks=100, blocks_free=free)
            n0.admission_reserve = reserve
            stub = SimpleNamespace(executor=n0.executor, standby=None, admission_reserve=reserve)
            want_sess = jnode.Node._advertised_sessions(stub)
            want_shed = jnode.Node._pool_under_reserve(stub) is not None
            assert n0._advertised_sessions() == want_sess
            assert (n0._pool_under_reserve() is not None) == want_shed
            n0.announce(urgent=False)
            rec = n0.dht.get_stage(0)[n0.node_id]
            assert ("shed" in rec) == want_shed and rec.get("sess", []) == want_sess
            extra = [k for k in rec if k not in before]
            assert extra == [k for k in ("shed", "sess") if k in rec]  # the reference's order
            for inflight, window_ms, cap in [(0, 2.0, 4), (3, 10.0, 4), (50, 3000.0, 1)]:
                n0.inflight, n0.window_ms, n0.capacity = inflight, window_ms, cap
                ref = SimpleNamespace(scheduler=SimpleNamespace(inflight=inflight),
                                      info=SimpleNamespace(capacity=cap), window_ms=window_ms)
                assert n0._retry_after_s() == jnode.Node._retry_after_s(ref)
        n0.inflight = 0
    finally:
        _stop(nodes)


def test_crash_cuts_connections_without_a_tombstone():
    nodes = _swarm([(0, ()), (1, ("--chaos", "stall_p=1"))], COUNTER2)
    seed, victim = nodes
    try:
        import threading

        got = []
        t = threading.Thread(target=lambda: got.append(_stall_post(victim)))
        t.start()
        _wait(lambda: victim.chaos._stalled == 1, "no stall")
        victim.crash()
        t.join(timeout=5)
        assert not t.is_alive() and got and isinstance(got[0], Exception)
        _wait(lambda: victim.chaos._stalled == 0, "crash() left a stalled handler")
        # no tombstone: the seed still lists the dead node until its record's TTL
        assert victim.node_id in seed.dht.get_stage(1)
    finally:
        _stop(nodes)


def _stall_post(node):
    try:
        return _post(node, "/forward", _counter_env("x", stage=1), timeout=10)
    except (OSError, http.client.HTTPException) as e:
        return e


def test_run_node_overload_flags():
    args = run_node.build_parser().parse_args(["--stage", "0"])
    assert (args.hop_timeout, args.hedge_delay_ms, args.hedge_mode, args.admission_reserve,
            args.rescue_bounces, args.chaos) == (120.0, 0.0, "advertised", 0.05, 6, "")
    node = run_node.make_node(run_node.build_parser().parse_args(
        ["--stage", "0", "--port", "0", "--gossip-port", "0", "--device", "cpu", *COUNTER2,
         "--hop-timeout", "5", "--hedge-delay-ms", "50", "--hedge-mode", "any",
         "--admission-reserve", "0.2", "--rescue-bounces", "2", "--chaos", "delay_ms=3"]))
    try:
        assert (node.hop_timeout_s, node.hedge_delay_ms, node.hedge_mode,
                node.admission_reserve, node.rescue_bounces) == (5.0, 50.0, "any", 0.2, 2)
        assert node.chaos.delay_ms == 3.0
        assert node._hedge_delay_s(5.0) == 0.05
        node.hedge_delay_ms = 0
        assert node._hedge_delay_s(5.0) == 0.25  # no hop time yet
        for ms in [3.0] * 19 + [40.0]:
            node.hop_times.observe(ms)
        assert node._hedge_delay_s(5.0) == 0.005  # the p95's bucket bound
        assert node._hedge_delay_s(0.004) == 0.002  # at most half the hop timeout
    finally:
        node._server.server_close()


# -- nodes: the TINY preset ------------------------------------------------------------


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """TINY, every weight but the norms 10x its init, split in two stages."""
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))
    out = str(tmp_path_factory.mktemp("overload_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(7).integers(0, jcfg.TINY.vocab_size, 12).tolist()


def _run(client, prompt, **kw):
    async def go():
        async with client as c:
            return await c.generate_ids(prompt, max_new_tokens=NEW, **kw)

    return asyncio.run(go())


@pytest.fixture(scope="module")
def model_swarm(parts):
    """Stage-0 entries E0 and E1, a stage-1 replica R; rescue bounces 2."""
    common = ("--parts", parts, "--max-len", "64", "--rescue-bounces", "2")
    nodes = _swarm([(0, ()), (0, ()), (1, ())], common)
    yield nodes
    _stop(nodes)


@pytest.fixture(scope="module")
def uninterrupted(model_swarm, prompt):
    e0 = model_swarm[0]
    got = _run(SwarmClient([(e0.host, e0.port)], sampling=GREEDY, prefill_chunk=8), prompt)
    assert len(set(got)) > 2  # the stream moves
    return got


class _Recording(SwarmClient):
    """A SwarmClient that remembers each session id it sends, in order."""

    sids: list

    async def _step(self, session_id, tokens, start_pos):
        self.sids.append(session_id)
        return await super()._step(session_id, tokens, start_pos)


def _failover_client(e0, e1, after, on_switch=None):
    """A client entering at E0 that fails over to [E1] after `after` tokens."""
    c = _Recording([(e0.host, e0.port)], sampling=GREEDY, prefill_chunk=8)
    c.sids, seen = [], []

    def on_token(tok):
        seen.append(tok)
        if tok is not None and len([t for t in seen if t is not None]) == after:
            if on_switch is not None:
                on_switch(c.sids[-1])
            c.entry_nodes = [(e1.host, e1.port)]

    return c, seen, on_token


def test_a_failed_over_stream_is_rescued_through_gossip(model_swarm, prompt, uninterrupted):
    e0, e1, r = model_swarm
    before = dict(_counters(e1))

    def advertised(sid):  # E0's record with the session reaches E1 (no TTL waited)
        e0.announce(urgent=True)
        _wait(lambda: pdht.sess_hash(sid) in e1.dht.get_stage(0)[e0.node_id].get("sess", ()),
              "the session's advert did not reach E1")

    c, seen, on_token = _failover_client(e0, e1, 3, on_switch=advertised)
    got = _run(c, prompt, on_token=on_token)
    assert got == uninterrupted and None not in seen
    sent_to_e1 = NEW - 3  # the decode steps after the switch
    c1 = _counters(e1)
    assert c1["sessions.rescue_relay"] - before.get("sessions.rescue_relay", 0) == sent_to_e1
    assert "sessions.rescue_failed" not in c1
    # the end went through E1 to E0 (one bounce) and down the chain: nothing held
    for n in model_swarm:
        assert n.stats()["executor"]["sessions"] == 0
    assert pdht.sess_hash(c.sids[0]) not in e0.dht.get_stage(0)[e0.node_id].get("sess", ())


def test_a_rescue_that_fails_restarts_the_stream(parts, prompt, uninterrupted):
    common = ("--parts", parts, "--max-len", "64", "--rescue-bounces", "2")
    nodes = _swarm([(0, ()), (0, ()), (1, ())], common)
    e0, e1, r = nodes
    try:
        def kill(sid):
            e0.announce(urgent=True)
            _wait(lambda: pdht.sess_hash(sid) in e1.dht.get_stage(0)[e0.node_id].get("sess", ()),
                  "the session's advert did not reach E1")
            e0.crash()  # its KV dies with it; its record lives on (no tombstone)

        c, seen, on_token = _failover_client(e0, e1, 3, on_switch=kill)
        got = _run(c, prompt, on_token=on_token, retry_delay_s=0.01, retry_rng=random.Random(0))
        assert got == uninterrupted
        assert seen.count(None) == 1 and seen[seen.index(None) + 1:] == uninterrupted
        c1 = _counters(e1)
        assert c1["sessions.rescue_failed"] == 1 and c1["sessions.rescue_relay"] == 2
        assert e1.stats()["errors"] >= 1  # the 409 session_state it answered
        assert len(set(c.sids)) == 2  # one restart, under a fresh session
    finally:
        _stop(nodes)


def test_a_rescue_without_any_holder_answers_409(model_swarm):
    e0 = model_swarm[0]
    before = _counters(e0).get("sessions.rescue_failed", 0)
    status, body, _ = _post(e0, "/forward", {
        "stage": 0, "session_id": "ghost",
        "payload": {"tokens": np.asarray([[5]], np.int32), "start_pos": 9, "real_len": 1}})
    assert status == 409 and body["code"] == "session_state"
    assert _counters(e0)["sessions.rescue_failed"] == before + 1


def test_a_shed_session_restarts_onto_the_other_replica(parts, prompt, uninterrupted):
    nodes = _swarm([(0, ()), (1, ()), (1, ())], ("--parts", parts, "--max-len", "64"))
    e0, r1, r2 = nodes
    try:
        r1.executor.pool = SimpleNamespace(num_blocks=40, blocks_free=1)  # under its reserve
        r1.announce(urgent=True)
        _wait(lambda: e0.dht.get_stage(1)[r1.node_id].get("shed") == 1, "shed not gossiped")

        class FirstOnR1(_Recording):
            async def _step(self, session_id, tokens, start_pos):
                if not self.sids:  # the first attempt meets the shedding replica
                    e0._remember((session_id, 1), r1.node_id)
                return await super()._step(session_id, tokens, start_pos)

        c = FirstOnR1([(e0.host, e0.port)], sampling=GREEDY, prefill_chunk=8)
        c.sids, seen = [], []
        got = _run(c, prompt, on_token=seen.append, retry_delay_s=0.01,
                   retry_rng=random.Random(0))
        assert got == uninterrupted and seen.count(None) == 1 and len(set(c.sids)) == 2
        assert _counters(r1)["admission.shed"] == 1 and r1.stats()["forward_passes"] == 0
        assert r2.stats()["forward_passes"] == 2 + NEW - 1  # the whole restarted session
        assert e0.stats()["affinity"] == 0  # both sessions ended
    finally:
        _stop(nodes)


def test_no_hedge_on_the_model_path(model_swarm, prompt, uninterrupted):
    """advertised mode: the model's decode relays find no second replica
    holding the session's KV, so none hedges whatever the delay."""
    e0, _, r = model_swarm
    e0.hedge_delay_ms = 0.001
    try:
        got = _run(SwarmClient([(e0.host, e0.port)], sampling=GREEDY, prefill_chunk=8), prompt)
    finally:
        e0.hedge_delay_ms = 0.0
    assert got == uninterrupted
    for n in model_swarm:
        assert "hedge.fired" not in _counters(n)
    st = json.loads(json.dumps(e0.stats()))  # /stats stays JSON
    assert st["hedge_budget"]["primary"] >= NEW and st["retry_budget"]["granted"] >= 0
    assert st["metrics"]["histograms"]["hop.relay_ms"]["count"] >= NEW
