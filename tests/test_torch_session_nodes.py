"""Sessions that move, across nodes: in-process port nodes (run_node.make_node,
--device cpu, --gossip-port 0, gossip every 0.05 s) on the TINY preset with
weights 10x the init, every greedy stream held to the JAX Engine's:

  * prefix pins fork on every stage through the swarm relay, a fixed chain
    and a routed chain (`fork.ok` per stage), and a pin whose parent ended
    falls back to a full prefill, token-exact;
  * /export_session answers 404, 501 (stage lanes) and 502 (a declining
    target, a garbage 200 body), and the disaggregated handoff continues
    token-exact on the target (`handoff.bytes`, `sessions.handed_off`);
  * a relay follows a handed-off session to its new holder and hedges no
    step to it while the old holder's advert lingers;
  * /drain hands its resident to the replica that adopts it, with no
    client restart, and keeps a session a decode step advanced while its
    snapshot was in flight;
  * a migration and stop() hand their sessions to the stage's other
    replica, crash() hands off nothing, and a tenant payload goes only to
    a replica whose record has `ada`;
  * POST /generate, plain and streamed, with pins and logprobs, equals the
    client loop; the tools/send flags --pin-prefix-ids and --server-side.
"""

import asyncio
import contextlib
import http.client
import http.server
import io
import threading
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.parallel import stages as jstages
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.client.routed_client import RoutedChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control.dht import SwarmDHT, sess_hash
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.tools import run_node, send

torch.set_num_threads(2)

GREEDY = SamplingConfig(temperature=0.0)
NEW = 8
PREFIX = 10
COMMON = ("--max-len", "64")


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jp):
    out = str(tmp_path_factory.mktemp("session_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, jcfg.TINY.vocab_size, PREFIX).tolist()
    return [prefix + rng.integers(0, jcfg.TINY.vocab_size, n).tolist() for n in (3, 6)]


@pytest.fixture(scope="module")
def expected(jp, prompts):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return [engine.generate(p, max_new_tokens=NEW) for p in prompts]


def _node(stage, *args, seed=None):
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", "600", *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.dht.ttl_s = 1.5
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _swarm(parts, specs):
    """Started nodes, one per (stage, extra args), the first the gossip seed,
    once every view holds every record."""
    common = ("--parts", parts, *COMMON)
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


def _post(node, path, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=60)
    try:
        conn.request("POST", path, body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _counter(node, name):
    return node.stats()["metrics"]["counters"].get(name, 0)


def _addr(n):
    return (n.host, n.port)


def _pinned_runs(client, prompts, **kw):
    """Pin the shared prefix, then every prompt in turn, then the client's
    exit ends the pin."""
    async def go():
        async with client as c:
            await c.pin_prefix(prompts[0][:PREFIX])
            return [await c.generate_ids(p, max_new_tokens=NEW, **kw) for p in prompts]

    return asyncio.run(go())


# -- forks -------------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["swarm", "chain", "routed"])
def test_pinned_prefix_forks_on_every_stage(parts, prompts, expected, topology):
    nodes = _swarm(parts, [(0, ()), (1, ())])
    s0, s1 = nodes
    dht = None
    try:
        if topology == "swarm":
            client = SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8)
        elif topology == "chain":
            client = ChainClient([_addr(s0), _addr(s1)], sampling=GREEDY, prefill_chunk=8)
        else:
            dht = SwarmDHT("observer", 0, bootstrap=[("127.0.0.1", s0.dht.port)])
            dht.start()
            _wait(lambda: all(dht.get_all(2)[s] for s in range(2)), "observer view")
            client = RoutedChainClient(dht, 2, sampling=GREEDY, prefill_chunk=8)
        assert _pinned_runs(client, prompts) == expected
        for n in nodes:  # each session forked here, and its suffix only was prefilled
            assert _counter(n, "fork.ok") == len(prompts) and not _counter(n, "fork.miss")
        # the pin's session (the client's exit ended it) and the children are gone
        _wait(lambda: all(len(n.executor.sessions) == 0 for n in nodes), "sessions left")
    finally:
        if dht is not None:
            dht.stop()
        _stop(nodes)


def test_a_pin_whose_parent_ended_falls_back_to_a_full_prefill(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (1, ())])
    s0, s1 = nodes
    try:
        client = SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8)

        async def go():
            async with client as c:
                await c.pin_prefix(prompts[0][:PREFIX])
                parent, _ = c.pinned_parent(prompts[0][:PREFIX])
                await c._end_session(parent)  # evicted on every stage
                got = await c.generate_ids(prompts[0], max_new_tokens=NEW)
                assert c.pinned_parent(prompts[0][:PREFIX]) is None  # a clean miss unpins
                return got

        assert asyncio.run(go()) == expected[0]
        assert _counter(s0, "fork.miss") == 1 and not _counter(s0, "fork.ok")
        status, body = _post(s0, "/fork_session", {"session_id": "c", "parent_session_id": "p",
                                                   "prefix_len": 3, "stage": 1, "relay": False})
        assert status == 409 and body["code"] == "wrong_stage"
    finally:
        _stop(nodes)


# -- /export_session and /import_session ------------------------------------------------


class _Garbage(http.server.BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.send_response(200)
        self.send_header("Content-Length", "7")
        self.end_headers()
        self.wfile.write(b"garbage")

    def log_message(self, *a):
        pass


def test_export_session_answers_and_the_disaggregated_handoff(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (0, ()), (1, ()),
                           (0, ("--stage-lanes", "2", "--paged-kv", "8"))])
    e, d, r, lanes = nodes
    garbage = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Garbage)
    threading.Thread(target=garbage.serve_forever, daemon=True).start()
    try:
        body = {"session_id": "ghost", "target_host": d.host, "target_port": d.port}
        status, reply = _post(e, "/export_session", body)
        assert status == 404 and reply["code"] == "unknown_session"
        status, reply = _post(lanes, "/export_session", body)
        assert status == 501 and reply["code"] == "no_export"
        # a live session, two targets that do not adopt it: it stays here
        e.executor.process("s", {"tokens": np.asarray([prompts[0]], np.int32), "start_pos": 0,
                                 "real_len": len(prompts[0])})
        for host, port in ((r.host, r.port), garbage.server_address[:2]):
            status, reply = _post(e, "/export_session", {"session_id": "s", "target_host": host,
                                                         "target_port": port})
            assert status == 502 and reply["code"] == "import_failed"
        assert "s" in e.executor.sessions
        status, reply = _post(r, "/import_session", {"session_id": "x", "stage": 0, "k": 0,
                                                     "v": 0, "length": 1})
        assert status == 409 and reply["code"] == "wrong_stage"
        e.executor.end_session("s")
        # prefill on E, decode on D: token-exact, no restart
        client = SwarmClient([_addr(e)], sampling=GREEDY, prefill_chunk=8)

        async def go():
            async with client as c:
                return await c.generate_ids_disaggregated(prompts[0], _addr(d),
                                                          max_new_tokens=NEW)

        assert asyncio.run(go()) == expected[0]
        st = e.stats()["metrics"]
        assert st["counters"]["sessions.handed_off"] == 1 and st["counters"]["handoff.bytes"] > 0
        assert st["histograms"]["handoff.ms"]["count"] == 1
        assert _counter(d, "sessions.imported") == 1
        assert d.stats()["forward_passes"] == NEW - 1  # every decode step ran on D
        _wait(lambda: not len(d.executor.sessions) and not len(e.executor.sessions), "leftovers")
    finally:
        garbage.shutdown()
        garbage.server_close()
        _stop(nodes)


def test_a_relay_follows_a_handed_off_session_and_runs_no_step_twice(parts, prompts,
                                                                     expected):
    """S0 relays a session's stage-1 steps to its holder, which hands it to
    the other replica. While S0's view still holds the old holder's stale
    advert, the step bounces through the old holder's rescue and is not
    hedged to the new one (two adverts: a handoff in flight); once the
    advert is gone S0 relays straight to the new holder. Every step after
    the handoff runs once, on the new holder."""
    nodes = _swarm(parts, [(0, ()), (1, ()), (1, ())])
    s0, s1a, s1b = nodes
    s0.hedge_delay_ms = 0.001  # every decode relay would hedge where a target exists
    try:
        seen, moved = [], {}

        def advertises(node, sid):
            rec = s0.dht.get_stage(1).get(node.node_id) or {}
            return sess_hash(sid) in rec.get("sess", ())

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                old = next(n for n in (s1a, s1b) if len(n.executor.sessions))
                new = s1b if old is s1a else s1a
                sid = old.executor.sessions.ids()[0]
                moved.update(old=old, new=new, sid=sid, announce=old.announce)
                old.announce = lambda urgent=True: None  # its record keeps the stale advert
                status, reply = _post(old, "/export_session", {
                    "session_id": sid, "target_host": new.host, "target_port": new.port})
                assert status == 200 and reply["ok"]
                _wait(lambda: advertises(new, sid) and advertises(old, sid), "two adverts")
            elif len(seen) == 4:
                old, sid = moved["old"], moved["sid"]
                del old.announce
                old.announce()
                _wait(lambda: not advertises(old, sid), "the stale advert stayed")

        got = _run(SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8), prompts[0],
                   on_token=on_token)
        assert got == expected[0] and None not in seen
        old, new = moved["old"], moved["new"]
        assert new.stats()["forward_passes"] == NEW - 3  # each step after the handoff, once
        assert _counter(old, "sessions.rescue_relay") == 1  # the step under the stale advert
        assert _counter(s0, "route.sess_moved") == 1 and not _counter(s0, "hedge.fired")
    finally:
        _stop(nodes)


# -- the handoff: drain, migration, stop, crash -----------------------------------------


def _run(client, prompt, **kw):
    async def go():
        async with client as c:
            return await c.generate_ids(prompt, max_new_tokens=NEW, **kw)

    return asyncio.run(go())


def test_drain_hands_its_resident_to_the_replica_that_adopts_it(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (0, ()), (1, ())])
    e, e2, r = nodes
    try:
        seen, drained = [], {}

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                drained["reply"] = _post(e, "/drain", {"wait_s": 1.0})

        got = _run(SwarmClient([_addr(e)], sampling=GREEDY, prefill_chunk=8), prompts[0],
                   on_token=on_token)
        assert got == expected[0] and None not in seen  # no restart
        status, reply = drained["reply"]
        assert status == 200 and reply == {"ok": True, "draining": True, "resident": 1,
                                           "handed_off": 1}
        assert _counter(e, "drain.handed_off") == 1 and _counter(e2, "sessions.imported") == 1
        assert _counter(e, "sessions.rescue_relay") >= 1  # E relayed to the new holder
        assert e2.stats()["forward_passes"] == NEW - 3
    finally:
        _stop(nodes)


def test_drain_keeps_a_session_that_advanced_while_its_snapshot_flew(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (0, ()), (1, ())])
    e, e2, r = nodes
    try:
        seen, drained = [], {}
        ship = e._handoff_sessions

        def racing_ship(exported, stage):
            adopted = ship(exported, stage)
            # a decode step of the session lands while the snapshot is in flight
            sid, payload = exported[0]
            cache = e.executor.sessions.get(sid)
            cache.length = payload["length"] + 1
            racing["sid"], racing["len"] = sid, payload["length"]
            return adopted

        racing = {}
        e._handoff_sessions = racing_ship

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                drained["reply"] = _post(e, "/drain", {"wait_s": 1.0})
                e.executor.sessions.get(racing["sid"]).length = racing["len"]  # undo the fake

        got = _run(SwarmClient([_addr(e)], sampling=GREEDY, prefill_chunk=8), prompts[0],
                   on_token=on_token)
        assert got == expected[0] and None not in seen
        assert drained["reply"][1]["handed_off"] == 0 and not _counter(e, "drain.handed_off")
        assert _counter(e2, "sessions.imported") == 1  # adopted, but the local copy served on
        assert e2.stats()["forward_passes"] == 0
    finally:
        _stop(nodes)


def test_a_migration_hands_its_sessions_to_the_old_stages_replica(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (0, ()), (1, ())])
    a0, a1, b = nodes
    try:
        seen = []

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                assert _post(a1, "/reassign", {"stage": 1})[0] == 200

        got = _run(SwarmClient([_addr(a1)], sampling=GREEDY, prefill_chunk=8), prompts[1],
                   on_token=on_token)
        assert got == expected[1] and None not in seen
        assert a1.spec.stage == 1 and _counter(a0, "sessions.imported") == 1
        assert _counter(a1, "sessions.exported") == 1
        assert a1.last_migration["released"]
        assert a0.stats()["forward_passes"] == NEW - 3
    finally:
        _stop(nodes)


@pytest.mark.parametrize("how", ["stop", "crash"])
def test_stop_hands_off_and_crash_does_not(parts, prompts, expected, how):
    nodes = _swarm(parts, [(0, ()), (1, ()), (1, ())])
    s0, s1a, s1b = nodes
    try:
        seen, gone = [], []

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                holder = next(n for n in (s1a, s1b) if len(n.executor.sessions))
                getattr(holder, how)()
                gone.append(holder)

        got = _run(SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8), prompts[0],
                   on_token=on_token, session_retries=4, retry_delay_s=0.05)
        assert got == expected[0]
        other = s1b if gone[0] is s1a else s1a
        if how == "stop":
            assert None not in seen and _counter(other, "sessions.imported") == 1
        else:  # the KV died with the node: the client restarted the session
            assert None in seen and not _counter(other, "sessions.imported")
    finally:
        _stop(nodes)


class _Importer(http.server.BaseHTTPRequestHandler):
    seen: list = []

    def do_POST(self):  # noqa: N802
        env = wire.unpack(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
        type(self).seen.append((self.server.server_address[1], env["session_id"]))
        body = wire.pack({"ok": True})
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_a_tenant_payload_goes_only_to_replicas_with_ada(parts):
    node = _node(0, "--parts", parts, *COMMON)
    servers = [http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Importer) for _ in range(2)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        plain, ada = (srv.server_address[1] for srv in servers)
        records = {f"127.0.0.1:{plain}": {"host": "127.0.0.1", "port": plain},
                   f"127.0.0.1:{ada}": {"host": "127.0.0.1", "port": ada, "ada": []}}
        node.dht.get_stage = lambda stage: dict(records)
        kv = torch.zeros((2, 1, 3, 2, 16))
        exported = [("tenant", {"k": kv, "v": kv, "length": 3, "adapter": "t0"}),
                    ("base", {"k": kv, "v": kv, "length": 3})]
        _Importer.seen = []
        assert sorted(node._handoff_sessions(exported, 0)) == ["base", "tenant"]
        assert sorted(_Importer.seen) == sorted([(ada, "tenant"), (plain, "base")])
        assert _counter(node, "sessions.exported") == 2
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        node.stop()


# -- POST /generate and tools/send --------------------------------------------------------


def test_generate_plain_and_streamed_with_pins_and_logprobs(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (1, ())])
    s0, s1 = nodes
    try:
        want_lps, want_tops = [], []
        assert _run(SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8), prompts[0],
                    logprob_sink=want_lps, top_n=3, top_sink=want_tops) == expected[0]
        client = SwarmClient([_addr(s0)], sampling=GREEDY, prefill_chunk=8)
        streamed = []

        async def go():
            async with client as c:
                lps, tops = [], []
                plain = await c.generate_server_side(prompts[0], max_new_tokens=NEW,
                                                     pin_prefix_len=PREFIX, logprob_sink=lps,
                                                     top_logprobs=3, top_sink=tops)
                ids = await c.generate_server_side_stream(
                    prompts[1], streamed.append, max_new_tokens=NEW, pin_prefix_len=PREFIX)
                return plain, lps, tops, ids

        plain, lps, tops, ids = asyncio.run(go())
        assert plain == expected[0] and ids == streamed == expected[1]
        np.testing.assert_allclose(lps, want_lps, rtol=0, atol=1e-6)
        assert [t[0] for t in tops] == [t[0] for t in want_tops]
        # both requests forked the node's one pin, on both stages
        for n in nodes:
            assert _counter(n, "fork.ok") == 2
        st = s0.stats()["metrics"]
        assert st["counters"]["generate.requests"] == 2 and "generate.errors" not in st["counters"]
        assert st["counters"]["generate.tokens"] == 2 * NEW
        assert st["histograms"]["generate.ttft_ms"]["count"] == 1  # the streamed one
        # a spent deadline, a bad request, a draining node
        status, reply = _post(s0, "/generate", {"prompt_ids": prompts[0], "deadline_ms": 1.0})
        assert status == 408 and reply["code"] == "deadline"
        assert _post(s0, "/generate", {"prompt_ids": []})[0] == 400
        assert _post(s0, "/generate", {"prompt_ids": [1, 2], "pin_prefix_len": 3})[0] == 400
        _post(s0, "/drain", {"wait_s": 0})
        status, reply = _post(s0, "/generate", {"prompt_ids": prompts[0]})
        assert status == 503 and reply["code"] == "draining"
        assert s0.stats()["metrics"]["counters"]["generate.errors"] == 1
    finally:
        _stop(nodes)
    assert s0._gen is None  # stop() closed the client and its loop


def _send(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = send.main(list(argv))
    return rc, out.getvalue()


def test_send_pins_and_server_side(parts, prompts, expected):
    nodes = _swarm(parts, [(0, ()), (1, ())])
    s0, _ = nodes
    try:
        entry = f"{s0.host}:{s0.port}"
        ids = ",".join(map(str, prompts[0]))
        pin = ",".join(map(str, prompts[0][:PREFIX]))
        common = ("--prompt-ids", ids, "--temperature", "0", "--max-new-tokens", str(NEW),
                  "--prefill-chunk", "8")
        for extra in ((), ("--server-side",), ("--server-side", "--stream")):
            rc, out = _send("--entry", entry, "--pin-prefix-ids", pin, *common, *extra)
            assert rc == 0
            if "--stream" in extra:
                assert out.split() == [str(t) for t in expected[0]]
            else:
                assert f"generated ids: {expected[0]}" in out
        assert _counter(s0, "fork.ok") == 3
        # the reference's checks
        assert _send("--chain", entry, "--server-side", *common)[0] == 2
        assert _send("--entry", entry, "--server-side", "--pin-prefix-ids", "1,2", *common)[0] == 2
    finally:
        _stop(nodes)
