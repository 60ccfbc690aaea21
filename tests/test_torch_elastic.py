"""The port's live stage migration, empty-stage adoption and graceful drain on
in-process nodes (run_node.make_node, --gossip-port 0, gossip every 0.05 s),
held to the reference's behaviour and to the JAX package's greedy streams
(the TINY preset, weights 10x the init so greedy streams move):

  * POST /reassign moves a stage-0 replica to stage 1, which then serves
    greedy streams equal to the JAX Engine's through a ChainClient; its
    /stats shows the stage, one migration and one reshard.ms_to_serving;
  * a session stranded by a migration restarts and completes token-exact;
  * a dead stage is adopted by exactly one replica, and the request that
    met it completes, served by the adopter itself;
  * on a --stage-lanes --paged-kv node a decode step pending in the old
    window finishes on the old executor while the migration waits for it;
  * a load or warm-up that raises answers 500 and leaves the node on its
    old stage; a bad or out-of-range stage answers 400; a node without a
    stage loader answers 500 and adopts nothing;
  * POST /drain sheds new sessions with 503 "draining" and Retry-After,
    serves the resident session no replica adopts token-exact, gossips
    `draining: 1`, takes
    the node out of ranked_nodes, and is idempotent;
  * a relayed load skew on a counter swarm moves the min-id replica of the
    cold stage once, and it does not move back within its dwell.
"""

import asyncio
import http.client
import json
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control.path_finder import ranked_nodes
from inferd_tpu_torch.runtime import node as nodemod
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.executor import make_executor
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.tools import run_node
from inferd_tpu_torch.utils.chaos import Chaos

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
NEW = 8
COUNTER2 = ("--backend", "counter", "--num-stages", "2")


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jp):
    out = str(tmp_path_factory.mktemp("elastic_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(7).integers(0, jcfg.TINY.vocab_size, 12).tolist()


@pytest.fixture(scope="module")
def expected(jp, prompt):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return engine.generate(prompt, max_new_tokens=NEW)


def _node(stage, *args, seed=None, period=600):
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", str(period), *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.dht.ttl_s = 1.5
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _swarm(specs, common=(), period=600):
    """Started nodes, one per (stage, extra args), the first the gossip seed,
    once every view holds every record."""
    (s0, a0), rest = specs[0], specs[1:]
    nodes = [_node(s0, *common, *a0, period=period)]
    nodes += [_node(s, *common, *a, seed=nodes[0], period=period) for s, a in rest]
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


def _post(node, path, body, raw=False):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", path, body=body if raw else wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read()), r.getheader("Retry-After")
    finally:
        conn.close()


def _stats(node):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _run(client, prompt, **kw):
    async def go():
        async with client as c:
            return await c.generate_ids(prompt, max_new_tokens=NEW, **kw)

    return asyncio.run(go())


# -- /reassign on a TINY swarm ------------------------------------------------------------


def test_reassign_moves_a_replica_which_serves_its_new_stage(parts, prompt, expected):
    nodes = _swarm([(0, ()), (1, ()), (0, ())], ("--parts", parts, "--max-len", "64"))
    seed, _, extra = nodes
    try:
        old = weakref.ref(extra.executor)
        status, body, _ = _post(extra, "/reassign", {"stage": 1})
        assert status == 200 and body == {"ok": True, "stage": 1}
        assert extra.spec.stage == 1 and extra.executor.spec.is_last and old() is None
        st = _stats(extra)
        assert st["stage"] == 1 and st["metrics"]["counters"]["migrations"] == 1
        hist = st["metrics"]["histograms"]["reshard.ms_to_serving"]
        assert hist["count"] == 1 and hist["mean_ms"] > 0
        mig = st["last_migration"]
        assert mig["from"] == 0 and mig["to"] == 1 and mig["released"]
        assert set(mig["memory"]) == {"before_load", "after_warmup", "after_release"}
        assert mig["ms_to_serving"] >= mig["load_ms"] + mig["warmup_ms"]
        # the warm-up's throwaway session is gone
        assert st["executor"]["sessions"] == 0
        _wait(lambda: len(seed.dht.get_stage(1)) == 2, "the seed never saw two stage-1 replicas")
        got = _run(ChainClient([(seed.host, seed.port), (extra.host, extra.port)],
                               sampling=GREEDY, prefill_chunk=8), prompt)
        assert got == expected and len(set(got)) > 2
        assert _stats(extra)["forward_passes"] == 2 + NEW - 1
        # the same stage again is a no-op
        assert _post(extra, "/reassign", {"stage": 1})[0] == 200
        assert _stats(extra)["metrics"]["counters"]["migrations"] == 1
    finally:
        _stop(nodes)


def test_a_session_stranded_by_a_migration_restarts_token_exact(parts, prompt, expected):
    """Stage 1's only node moves to stage 0 after a session's first chunk:
    the stage is empty until the min-id stage-0 replica, the client's entry,
    adopts it (its relay's empty-stage hook), the session's next chunk meets
    no KV there and the client restarts it: the stream completes,
    token-exact."""
    nodes = _swarm([(0, ()), (0, ()), (1, ())], ("--parts", parts, "--max-len", "64"))
    r = nodes[2]
    entry = min(nodes, key=lambda n: n.node_id)
    try:
        seen = []

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 2:
                status, _, _ = _post(r, "/reassign", {"stage": 0})
                assert status == 200

        got = _run(SwarmClient([(entry.host, entry.port)], sampling=GREEDY, prefill_chunk=8),
                   prompt, on_token=on_token, session_retries=4, retry_delay_s=0.05)
        assert got == expected and None in seen  # one restart
        # one node adopted the emptied stage 1: the reassigned one's move and
        # the adopter's
        assert sorted(n.spec.stage for n in nodes) == [0, 0, 1]
        assert sum(n.stats()["metrics"]["counters"].get("migrations", 0) for n in nodes) == 2
    finally:
        _stop(nodes)


def test_a_dead_stage_is_adopted_by_exactly_one_replica():
    """Stage 0's only node leaves; a stage-0 envelope entering the min-id
    stage-1 replica finds stage 0 empty, the hook moves that replica to
    stage 0 and it serves the envelope itself: state 2, trace [0, 1]."""
    nodes = _swarm([(0, ()), (1, ()), (1, ())], COUNTER2)
    n0, *ones = nodes
    try:
        n0.stop()
        _wait(lambda: all(not n.dht.get_stage(0) for n in ones), "stage 0 never emptied")
        entry = min(ones, key=lambda n: n.node_id)
        status, body, _ = _post(entry, "/forward", {"stage": 0, "session_id": "s3",
                                                    "payload": {}})
        assert status == 200
        r = body["result_for_user"]["result_for_user"]
        assert r == {"state": 2, "trace": [0, 1]}
        assert sorted(n.spec.stage for n in ones) == [0, 1] and entry.spec.stage == 0
        c = entry.stats()["metrics"]["counters"]
        assert c["migrations"] == 1 and c["stage.adopt.path_finder_empty_stage"] == 1
        other = max(ones, key=lambda n: n.node_id)
        assert "migrations" not in other.stats()["metrics"]["counters"]
    finally:
        _stop(ones)


def test_an_adopting_hook_ends_the_path_finders_waits():
    """A hook that moved the caller to the empty stage (it returns True) is
    not called again and the remaining attempts do not wait; one that did
    not keeps the reference's waits."""
    from inferd_tpu_torch.control.path_finder import NoNodeForStage, PathFinder

    class Empty:
        def get_stage(self, stage):
            return {}

    for adopt, want_calls, want_sleeps in ((True, 1, []), (False, 3, [0.5] * 3)):
        calls, sleeps = [], []
        pf = PathFinder(Empty(), 2, on_empty_stage=lambda s: calls.append(s) or adopt,
                        sleep=sleeps.append)
        with pytest.raises(NoNodeForStage):
            pf.find_best_node(0, exclude={"me"})
        assert len(calls) == want_calls and sleeps == want_sleeps


def test_lane_node_reassign_finishes_the_old_windows_entries(parts, jp):
    """A decode step waiting in a --stage-lanes --paged-kv node's window
    (its flush held inside the old executor's step) when /reassign swaps
    the executor: the migration waits, the step finishes on the old
    executor with the logits a sibling replica gives, and the old executor
    is then released; the node serves stage 0 from a window of its own."""
    lane = ("--stage-lanes", "4", "--paged-kv", "16", "--prefill-chunk", "8", "--window-ms", "20")
    nodes = _swarm([(0, lane), (1, lane), (1, lane)], ("--parts", parts, "--max-len", "64"))
    l0, l1, x = nodes
    try:
        toks = np.asarray([[3, 7, 11, 19, 23]], np.int32)

        def fwd(n, stage, sid, payload):
            status, body, _ = _post(n, "/forward", {"session_id": sid, "stage": stage,
                                                    "relay": False, "payload": payload})
            assert status == 200, body
            return body["result"]

        h0 = fwd(l0, 0, "s", {"tokens": toks, "start_pos": 0, "real_len": 5})
        for n in (l1, x):
            fwd(n, 1, "s", h0)
        h1 = fwd(l0, 0, "s", {"tokens": np.asarray([[5]], np.int32), "start_pos": 5,
                              "real_len": 1})
        want = fwd(l1, 1, "s", h1)["logits"]
        old = x.executor
        old_window = x.window
        gate, entered = threading.Event(), threading.Event()
        ref = weakref.ref(old)

        def gated(*a, **kw):  # holds no reference to the executor
            entered.set()
            assert gate.wait(10)
            return type(ref()).process_batch(ref(), *a, **kw)

        old.process_batch = gated
        got, reassigned = {}, {}
        t_dec = threading.Thread(target=lambda: got.update(r=fwd(x, 1, "s", h1)))
        t_dec.start()
        assert entered.wait(10)
        t_re = threading.Thread(target=lambda: reassigned.update(r=_post(x, "/reassign",
                                                                          {"stage": 0})))
        t_re.start()
        _wait(lambda: x.spec.stage == 0, "the executor was never swapped")
        assert x.window is not old_window and t_re.is_alive()  # waiting for the old step
        del old, gated, old_window
        gate.set()
        t_dec.join(10)
        t_re.join(10)
        assert not t_dec.is_alive() and not t_re.is_alive()
        assert reassigned["r"][0] == 200 and np.array_equal(got["r"]["logits"], want)
        assert ref() is None and x.last_migration["released"]
        # stage 0 now, from its own window: a decode step of a new session
        h = fwd(x, 0, "t", {"tokens": toks, "start_pos": 0, "real_len": 5})
        assert np.array_equal(h["hidden"], h0["hidden"])
        fwd(x, 0, "t", {"tokens": np.asarray([[5]], np.int32), "start_pos": 5, "real_len": 1})
        assert x.stats()["window"]["batched_steps"] == 1
    finally:
        _stop(nodes)


def test_migrations_under_concurrent_requests_lose_no_call():
    """Eight threads send stage-0 envelopes to X while X moves between
    stages 0 and 1 ten times, with a short switch interval: every request
    answers state 2, no executor use is left counted, and every old
    executor is released."""
    import sys

    nodes = _swarm([(0, ()), (0, ()), (1, ())], COUNTER2)
    x = nodes[0]
    stop, failures, answered = threading.Event(), [], [0]
    lock = threading.Lock()

    def load(i):
        n = 0
        while not stop.is_set():
            n += 1
            status, body, _ = _post(x, "/forward", {"stage": 0, "session_id": f"t{i}-{n}",
                                                    "payload": {}})
            ok = status == 200 and body["result_for_user"]["result_for_user"]["state"] == 2
            with lock:
                answered[0] += 1
                if not ok:
                    failures.append((status, body))

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=load, args=(i,), daemon=True) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for k in range(10):
            status, body, _ = _post(x, "/reassign", {"stage": (k + 1) % 2})
            assert status == 200, body
            assert x.last_migration["released"]
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(old_interval)
        _stop(nodes)
    assert not any(t.is_alive() for t in threads)
    assert not failures and answered[0] > 50
    assert x.spec.stage == 0 and not x._uses
    assert x.stats()["metrics"]["counters"]["migrations"] == 10


# -- failures ----------------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["load", "warm_up"])
def test_a_failed_load_or_warm_up_keeps_the_old_stage(monkeypatch, where):
    nodes = _swarm([(0, ()), (0, ()), (1, ())], COUNTER2)
    n = nodes[1]
    try:
        def boom(*_a, **_kw):
            raise RuntimeError(f"planted {where} failure")

        if where == "load":
            n.load_stage = boom
        else:
            monkeypatch.setattr(nodemod, "warm_up", boom)
        old = n.executor
        status, body, _ = _post(n, "/reassign", {"stage": 1})
        assert status == 500 and body["error"] == f"reassign failed: planted {where} failure"
        assert n.executor is old and n.spec.stage == 0
        c = n.stats()["metrics"]["counters"]
        assert c["migrations.failed"] == 1 and "migrations" not in c
        status, body, _ = _post(n, "/forward", {"stage": 0, "session_id": "s", "payload": {}})
        assert status == 200 and body["result_for_user"]["state"] == 2
    finally:
        _stop(nodes)


@pytest.mark.parametrize("body, error", [
    ({"stage": 2}, "stage 2 out of range"), ({"stage": -1}, "stage -1 out of range"),
    ({"stage": "x"}, "bad reassign request"), ({}, "bad reassign request"),
    (b"\xff\x00garbage", "bad reassign request")])
def test_reassign_refuses_a_bad_stage(body, error):
    nodes = _swarm([(0, ())], COUNTER2)
    try:
        status, reply, _ = _post(nodes[0], "/reassign", body, raw=isinstance(body, bytes))
        assert status == 400 and reply["error"].startswith(error)
        assert nodes[0].spec.stage == 0
    finally:
        _stop(nodes)


def test_a_node_without_a_loader_answers_500_and_adopts_nothing():
    spec = StageSpec(1, 2, 0, 0)

    def start(**kw):
        n = nodemod.Node(make_executor(None, spec, backend="counter"), rebalance_period_s=600,
                         **kw)
        n.dht.gossip_period_s = 0.05
        n.path_finder.retry_delay_s = 0.05
        return n.start()

    a = start()
    b = start(bootstrap=[("127.0.0.1", a.dht.port)])
    try:
        _wait(lambda: len(a.dht.get_stage(1)) == 2, "gossip did not converge")
        status, body, _ = _post(a, "/reassign", {"stage": 0})
        assert status == 500 and body["error"] == "reassign failed: this node has no stage loader"
        # stage 0 is empty: the hook's adoption fails, the relay answers 503
        entry = min((a, b), key=lambda n: n.node_id)
        status, body, _ = _post(entry, "/forward", {"stage": 0, "session_id": "s", "payload": {}})
        assert status == 503 and a.spec.stage == b.spec.stage == 1
        assert entry.stats()["metrics"]["counters"]["stage.adopt.path_finder_empty_stage"] >= 1
    finally:
        _stop([a, b])


# -- /drain ------------------------------------------------------------------------------------


def test_drain_sheds_new_sessions_and_serves_its_resident(parts, prompt, expected):
    """No replica can adopt the resident (the other stage-0 replica runs the
    stage lanes, which import nothing), so the drain hands nothing off and
    serves it here to its end (tests/test_torch_session_nodes.py drains a
    resident to a replica that adopts it)."""
    lanes = ("--stage-lanes", "2")
    nodes = _swarm([(0, ()), (0, lanes), (1, ())], ("--parts", parts, "--max-len", "64"))
    e, e2, r = nodes
    try:
        drained = {}

        def on_token(tok):
            drained.setdefault("toks", []).append(tok)
            if len(drained["toks"]) == 3:
                drained["reply"] = _post(e, "/drain", {"wait_s": 2.0})

        got = _run(ChainClient([(e.host, e.port), (r.host, r.port)], sampling=GREEDY,
                               prefill_chunk=8), prompt, on_token=on_token)
        assert got == expected and None not in drained["toks"]  # no restart
        status, reply, _ = drained["reply"]
        assert status == 200
        assert reply == {"ok": True, "draining": True, "resident": 1, "handed_off": 0}
        assert e.stats()["forward_passes"] == 2 + NEW - 1  # its resident, served here
        # new sessions: the typed 503 with Retry-After, in chain and relay mode
        for relay in (False, True):
            status, body, retry = _post(e, "/forward", {
                "session_id": f"fresh{relay}", "stage": 0, "relay": relay,
                "payload": {"tokens": np.asarray([[3]], np.int32), "start_pos": 0,
                            "real_len": 1}})
            assert status == 503 and body["code"] == "draining"
            assert body["retry_after"] > 0 and int(retry) >= 1
        c = e.stats()["metrics"]["counters"]
        assert c["admission.shed.draining"] == c["admission.shed"] == 2
        # gossiped: routers leave it out
        _wait(lambda: r.dht.get_stage(0)[e.node_id].get("draining") == 1, "draining not gossiped")
        assert [nid for nid, _ in ranked_nodes(r.dht.get_stage(0))] == [e2.node_id]
        assert e.stats()["draining"] is True
        # idempotent, a garbage body too; counted once
        for body in (wire.pack({"wait_s": 0.1}), b"\xffgarbage", b""):
            status, reply, _ = _post(e, "/drain", body, raw=True)
            assert status == 200 and reply["draining"] and reply["resident"] == 0
        assert e.stats()["metrics"]["counters"]["drain.requests"] == 1
        # new sessions entering the other replica flow
        assert _run(SwarmClient([(e2.host, e2.port)], sampling=GREEDY, prefill_chunk=8),
                    prompt) == expected
    finally:
        _stop(nodes)


# -- the balancer on a counter swarm -------------------------------------------------------


def test_a_relayed_load_skew_moves_the_cold_stages_min_id_replica_once():
    """Stage 1 is one slow replica of capacity 1 (chaos delay), stage 0 two
    replicas of capacity 16: relayed load makes stage 1 hot, and the min-id
    stage-0 replica migrates to it (stage.adopt.rebalance), once. Then the
    skew turns round (stage 0's remaining replica slow): nothing moves back
    within the dwell."""
    nodes = _swarm([(0, ("--capacity", "16")), (0, ("--capacity", "16")),
                    (1, ("--capacity", "1", "--chaos", "delay_ms=150"))], COUNTER2, period=0.1)
    a, b, c = nodes
    mover = min((a, b), key=lambda n: n.node_id)
    other = b if mover is a else a
    stop = threading.Event()

    def load(entry, stage):
        def one(i):
            while not stop.is_set():
                _post(entry, "/forward", {"stage": stage, "session_id": f"s{i}-{time.time()}",
                                          "payload": {"state": stage}})
        return [threading.Thread(target=one, args=(i,), daemon=True) for i in range(8)]

    try:
        threads = load(other, 0)
        for t in threads:
            t.start()
        _wait(lambda: mover.spec.stage == 1, "the min-id stage-0 replica never migrated")
        stop.set()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert other.spec.stage == 0 and c.spec.stage == 1
        cm = mover.stats()["metrics"]["counters"]
        assert cm["migrations"] == 1 and cm["stage.adopt.rebalance"] == 1
        # the other way round: stage 0 slow and loaded, stage 1 idle
        other.chaos = Chaos.parse("delay_ms=150")
        stop.clear()
        threads = load(other, 0)
        for t in threads:
            t.start()
        time.sleep(1.5)  # ~15 balancer ticks on each node
        stop.set()
        for t in threads:
            t.join(10)
        assert mover.spec.stage == 1 and other.spec.stage == 0
        for n in nodes:
            assert n.stats()["metrics"]["counters"].get("migrations", 0) == (n is mover)
    finally:
        stop.set()
        _stop(nodes)
