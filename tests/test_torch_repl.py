"""Crash-tolerant sessions (standby KV replication), the port's runtime/repl
and its surfaces held to the JAX package's (the TINY preset, weights 10x the
init so greedy streams move; f32, K/V within atol 1e-5, the session tests'
tolerance):

  * StandbyStore and SessionReplicator driven by the same scripted
    sequences as the reference's (tests/test_failover.py, the tenant cases
    of tests/test_adapters.py), every step's return equal to
    inferd_tpu.runtime.repl's;
  * export_session_delta on the one-session executor and on BatchedExecutor
    (dense and paged) against the reference's on the same inputs: the same
    length, start and slots, K/V within 1e-5; a paged delta ships only full
    blocks; the deltas concatenated equal the full export; a StandbyStore
    payload imported into another executor continues the stream;
  * port nodes (run_node.make_node, --device cpu, gossip every 0.05 s, a
    record's TTL 1.5 s): a two-stage swarm S0, R1a, R1b with --standby-repl
    whose stage-1 holder crashes: promotion with no restart, the resume
    offer (the re-sent tokens = pos - F), a corrupt shadow failing closed
    into a restart (`repl.stale`), an ended session's shadow dropped, and
    with the flag off no `standby` key, 501 `repl_off`, no `repl` in
    /stats; every stream token-exact against the JAX Engine's; a tenant
    session promoted on a whole-model --batch-lanes --adapters pair.
"""

import asyncio
import http.client
import time

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.core.generate import Engine
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime import adapters as jadapters
from inferd_tpu.runtime import repl as jrepl
from inferd_tpu.runtime.batch_executor import BatchedExecutor as JBatched
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.routed_client import RoutedChainClient
from inferd_tpu_torch.client.swarm_client import SwarmClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.control.dht import SwarmDHT
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.parallel.stages import StageSpec
from inferd_tpu_torch.runtime import adapters as tadapters
from inferd_tpu_torch.runtime import repl, wire
from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

WHOLE = StageSpec(0, 1, 0, tcfg.TINY.num_layers - 1)
PROMPT = [3, 7, 11, 19, 5, 2, 17, 13, 23, 29, 31, 37, 41]
MAX_LEN = 64
BS = 4
KINDS = ("one_session", "batched_dense", "batched_paged")
GREEDY = SamplingConfig(temperature=0.0)
NEW = 8


# -- StandbyStore and SessionReplicator, step for step ----------------------------------

def _kv(start, total, layers=2, heads=1, dim=2, dtype=np.float32, fill=0.0):
    return np.full((layers, 1, total - start, heads, dim), fill, dtype)


def _delta(start, total, **kw):
    k = _kv(start, total, **kw)
    return {"k": k, "v": k + 1, "length": total, "start": start}


# each case: the store's kwargs and a script of (method, args); an apply's
# payload is given to the reference as numpy and to the port as torch, as
# the wire hands them over
STORE_CASES = {
    # tests/test_failover.py::test_standby_store_gap_resync_and_sweep
    "gap_resync_and_sweep": ({"ttl_s": 0.0}, [
        ("apply", ("s", 0, _delta(0, 4))),
        ("apply", ("s", 0, _delta(8, 12))),  # a gap: declined, reports what it has
        ("apply", ("s2", 0, _delta(8, 12))),  # mid-stream of an unknown session
        ("apply", ("s", 1, _delta(4, 8))),  # the wrong stage
        ("apply", ("s", 0, _delta(0, 4))),  # start 0 replaces
        ("sweep", ()), ("__len__", ()),
    ]),
    # tests/test_adapters.py::test_standby_store_carries_adapter_to_promotion
    "adapter_to_promotion": ({}, [
        ("apply", ("s", 0, dict(_delta(0, 4, layers=2, heads=2, dim=8), adapter="ten0"))),
        ("payload", ("s",)),
        ("apply", ("b", 0, _delta(0, 4, layers=2, heads=2, dim=8))),
        ("payload", ("b",)),
    ]),
    "segments_concatenate_once": ({}, [
        ("apply", ("s", 0, _delta(0, 5, fill=1.0))),
        ("apply", ("s", 0, _delta(5, 7, fill=2.0))),
        ("apply", ("s", 0, _delta(7, 8, fill=3.0))),
        ("length", ("s",)), ("stage_of", ("s",)), ("ids", ()), ("bytes_held", ()),
        ("payload", ("s",)),
        ("apply", ("s", 0, _delta(8, 9, layers=3))),  # another layer count
        ("apply", ("s", 0, _delta(8, 9, dtype=np.float16))),  # another dtype
        ("apply", ("s", 0, {"k": _kv(8, 9), "v": _kv(8, 10), "length": 9, "start": 8})),
        ("apply", ("s", 0, {"k": _kv(8, 9), "length": 9, "start": 8})),  # no v
        ("apply", ("s", 0, _delta(8, 9) | {"length": 10})),  # slots != length - start
        ("length", ("s",)), ("payload", ("ghost",)), ("drop", ("s",)), ("payload", ("s",)),
    ]),
    "fp8_views_and_eviction": ({"max_sessions": 2}, [
        ("apply", ("a", 0, dict(_delta(0, 3, dtype=np.uint8), kv_dtype="float8_e4m3fn"))),
        ("apply", ("a", 0, dict(_delta(3, 4, dtype=np.uint8), kv_dtype="float8_e4m3fn"))),
        ("payload", ("a",)),
        ("apply", ("b", 0, _delta(0, 2))),
        ("apply", ("c", 0, _delta(0, 2))),  # a third shadow evicts the oldest
        ("ids", ()), ("clear", ()), ("__len__", ()),
    ]),
}


def _to_port(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    return x


def _comparable(x):
    if isinstance(x, torch.Tensor):
        return ("array", str(x.dtype).replace("torch.", ""), x.numpy().tolist())
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _comparable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_comparable(v) for v in x)
    return x


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_standby_store_steps_equal_the_reference(case):
    kw, script = STORE_CASES[case]
    ref, port = jrepl.StandbyStore(**kw), repl.StandbyStore(**kw)
    for i, (name, args) in enumerate(script):
        want = getattr(ref, name)(*args)
        got = getattr(port, name)(*(_to_port(a) for a in args))
        assert _comparable(got) == _comparable(want), (case, i, name)
        if name == "apply":
            time.sleep(0.002)  # distinct update times: the LRU order is the script's


def test_standby_store_refuses_ring_payloads_and_keeps_segment_dtypes():
    store = repl.StandbyStore()
    ring = _to_port(dict(_delta(0, 4), k_loc=_kv(0, 2), v_loc=_kv(0, 2), hi=4))
    assert store.apply("s", 0, ring) == (False, 0) and "s" not in store
    bf = torch.arange(2 * 4 * 2, dtype=torch.float32).reshape(2, 1, 4, 1, 2).bfloat16()
    assert store.apply("s", 0, {"k": bf, "v": bf, "length": 4, "start": 0}) == (True, 4)
    assert store.apply("s", 0, {"k": bf[:, :, :1], "v": bf[:, :, :1], "length": 5,
                                "start": 4}) == (True, 5)
    out = store.payload("s")
    assert out["k"].dtype == torch.bfloat16 and torch.equal(out["k"][:, :, 4:], bf[:, :, :1])
    assert store.bytes_held() == 2 * (bf.numel() + bf[:, :, :1].numel()) * 2


def _cands(*recs):
    return [(nid, dict(rec)) for nid, rec in recs]


# each case: the candidates' script (a ("cands", [...]) step sets them) and
# the replicator's calls; `state` is compared after every step
REPLICATOR_CASES = {
    # tests/test_failover.py::test_replicator_sticky_standby_and_frontier_reset
    "sticky_standby_and_frontier_reset": [
        ("cands", _cands(("b", {}), ("c", {"shed": 1}))),
        ("plan", ({"s": 10},)), ("record", ("s", "b", True, 10, 100)),
        ("plan", ({"s": 10},)), ("plan", ({"s": 14},)), ("lag_tokens", ({"s": 14},)),
        ("note_standby_dead", ("s",)), ("cands", _cands(("c", {"shed": 1}))),
        ("plan", ({"s": 14},)), ("record", ("s", "c", False, 6, 0)), ("plan", ({"s": 14},)),
        ("record", ("x", "c", True, 4, 10)), ("prune", (["s"],)),
        ("pop_standby", ("x",)), ("pop_standby", ("s",)), ("pop_standby", ("s",)),
    ],
    # tests/test_adapters.py::test_standby_pick_requires_adapter_capable_peer
    "tenant_pick_requires_ada": [
        ("cands", _cands(("old", {"load": 0}), ("cap", {"load": 1, "ada": []}))),
        ("pick_standby", ("s",)), ("pick_standby", ("s",), {"require_ada": True}),
        ("record", ("t", "old", True, 7, 0)),
        ("pick_standby", ("t",)), ("pick_standby", ("t",), {"require_ada": True}),
        ("plan", ({"base": 4, "ten": 4},), {"adapters": {"ten": "ten0"}}),
    ],
    "declines_garbage_and_empty_stage": [
        ("cands", []), ("plan", ({"s": 3},)), ("pick_standby", ("s",)),
        ("cands", _cands(("a", {"shed": 1}), ("b", {"shed": 1}))),
        ("plan", ({"s": 3, "t": 0},)), ("record", ("s", "a", False, None, 50)),
        ("record", ("s", "a", True, None, 50)), ("plan", ({"s": 3},)),
        ("lag_tokens", ({"s": 3, "u": 2},)),
    ],
}


@pytest.mark.parametrize("case", sorted(REPLICATOR_CASES))
def test_session_replicator_steps_equal_the_reference(case):
    cands: list = []
    ref = jrepl.SessionReplicator(lambda: list(cands))
    port = repl.SessionReplicator(lambda: list(cands))
    for i, step in enumerate(REPLICATOR_CASES[case]):
        if step[0] == "cands":
            cands[:] = step[1]
            continue
        name, args, kw = (*step, {}) if len(step) == 2 else step
        want = getattr(ref, name)(*args, **kw)
        got = getattr(port, name)(*args, **kw)
        assert got == want, (case, i, name)
        assert port.state == ref.state, (case, i, name)
        assert (port.shipped_bytes, port.ship_errors) == (ref.shipped_bytes, ref.ship_errors)
    assert port.stats() == {"sessions_tracked": len(ref.state),
                            "shipped_bytes": ref.shipped_bytes, "ship_errors": ref.ship_errors}


def test_registry_can_serve_equals_the_reference(tmp_path):
    """The /replicate_session receiver's check (tests/test_adapters.py's
    registry_can_serve case): a registry-less executor, or a catalog without
    the name, can never promote a tenant shadow; base deltas always land."""
    rng = np.random.default_rng(0)
    cfg = jcfg.TINY
    layers = {n: (rng.normal(0, 0.1, (cfg.num_layers, cfg.hidden_size, 2)).astype(np.float32),
                  rng.normal(0, 0.1, (cfg.num_layers, 2, cfg.q_dim)).astype(np.float32))
              for n in ("q_proj",)}
    adir = jlora.save_adapter(str(tmp_path / "ten0"), layers, alpha=4, r=2)

    class Ex:
        adapters = None

    ref_ex, port_ex = Ex(), Ex()
    cases = [None, "ten0", "other_tenant"]
    want = [jadapters.registry_can_serve(ref_ex, n) for n in cases]
    assert [tadapters.registry_can_serve(port_ex, n) for n in cases] == want == [True, False,
                                                                              False]
    ref_ex.adapters = jadapters.AdapterRegistry(cfg, [adir])
    port_ex.adapters = tadapters.AdapterRegistry(tcfg.TINY, [adir])
    want = [jadapters.registry_can_serve(ref_ex, n) for n in cases]
    assert [tadapters.registry_can_serve(port_ex, n) for n in cases] == want == [True, True,
                                                                              False]


# -- export_session_delta against the reference ------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    jsp = jstages.extract_stage_params(jp, jcfg.TINY, jstages.StageSpec(0, 1, 0, 3))
    return jp, jsp, convert.params_from_numpy(jax.tree.map(np.asarray, jsp), None)


def _port(params, kind, **kw):
    if kind == "one_session":
        return Qwen3StageExecutor(tcfg.TINY, WHOLE, params[2], max_len=MAX_LEN,
                                  initial_kv_len=16, **kw)
    return BatchedExecutor(tcfg.TINY, params[2], lanes=4, max_len=MAX_LEN,
                           block_size=BS if kind == "batched_paged" else 0, **kw)


def _jax(params, kind):
    if kind == "one_session":
        return JExecutor(jcfg.TINY, jstages.StageSpec(0, 1, 0, 3), params[1], max_len=MAX_LEN,
                         initial_kv_len=16)
    return JBatched(jcfg.TINY, params[0], lanes=4, max_len=MAX_LEN,
                    block_size=BS if kind == "batched_paged" else 0)


def _step(ex, sid, tokens, pos):
    out = ex.process(sid, {"tokens": np.asarray([tokens], np.int32), "start_pos": pos,
                           "real_len": len(tokens)})
    lg = out["logits"]
    return np.asarray(lg.float() if isinstance(lg, torch.Tensor) else lg, np.float32)[0]


def _greedy(ex, sid, prompt, new, start=0, logits=None):
    """Greedy tokens of `new` steps after prefilling prompt[start:]."""
    pos = start
    if start < len(prompt):
        logits = _step(ex, sid, prompt[start:], start)
        pos = len(prompt)
    toks = []
    for _ in range(new):
        toks.append(int(np.argmax(logits)))
        logits = _step(ex, sid, [toks[-1]], pos)
        pos += 1
    return toks, logits


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_deltas_match_the_reference(params, kind):
    """The same prefilled session in both packages: each frontier's delta
    has the reference's keys, length, start and slots, K/V within 1e-5
    (paged: only the full blocks past the frontier, a foreign frontier
    realigned down to a block); nothing new is None in both."""
    jex, tex = _jax(params, kind), _port(params, kind)
    for ex in (jex, tex):
        _greedy(ex, "s", PROMPT, 4)  # length 17
    n = len(PROMPT) + 4
    for since in (0, 5, 8, 13, 16, n, n + 3):
        want = jex.export_session_delta("s", since)
        got = tex.export_session_delta("s", since)
        if want is None:
            assert got is None, since
            continue
        assert set(got) == set(want) == {"k", "v", "length", "start"}, since
        assert (got["length"], got["start"]) == (want["length"], want["start"]), since
        assert tuple(got["k"].shape) == tuple(np.asarray(want["k"]).shape), since
        np.testing.assert_allclose(_np(got["k"]), _np(want["k"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(got["v"]), _np(want["v"]), rtol=0, atol=1e-5)
        if kind == "batched_paged":
            assert got["length"] % BS == 0 and got["start"] % BS == 0
    assert tex.export_session_delta("ghost", 0) is None is jex.export_session_delta("ghost", 0)


@pytest.mark.parametrize("kind", KINDS)
def test_deltas_concatenate_to_the_full_export(params, kind):
    """A delta shipped after every two decode steps (dense: [0, 15), [15, 17),
    [17, 19); paged: [0, 12), [12, 16), nothing): the store's payload is
    the full export's first slots, bit for bit."""
    ex = _port(params, kind)
    store = repl.StandbyStore()
    frontier, logits = 0, None
    for r in range(3):
        _, logits = _greedy(ex, "s", PROMPT, 2, start=len(PROMPT) + 2 * r if r else 0,
                            logits=logits)
        d = ex.export_session_delta("s", frontier)
        if d is None:
            assert kind == "batched_paged" and r == 2
            continue
        assert d["start"] == frontier and store.apply("s", 0, d) == (True, d["length"])
        frontier = d["length"]
    full = dict(ex.export_sessions(only="s"))["s"]
    got = store.payload("s")
    n = got["length"]
    if kind == "batched_paged":  # the partial tail block never ships
        assert n == (full["length"] // BS) * BS < full["length"]
    else:
        assert n == full["length"]
    assert torch.equal(got["k"], full["k"][:, :, :n]) and torch.equal(got["v"],
                                                                      full["v"][:, :, :n])


@pytest.mark.parametrize("kind", KINDS)
def test_a_promoted_shadow_continues_the_stream(params, kind):
    """Ship [0, F) and [F, pos), import the store's payload into a second
    executor, re-send the tokens past the frontier (a paged primary's tail
    block never shipped) and decode on: the stream equals the uninterrupted
    one."""
    want, _ = _greedy(_port(params, kind), "ref", PROMPT, 10)
    a, b = _port(params, kind), _port(params, kind)
    store = repl.StandbyStore()
    got, logits = _greedy(a, "s", PROMPT, 3)
    d1 = a.export_session_delta("s", 0)
    assert store.apply("s", 0, wire.unpack(wire.pack({"session_id": "s", **d1})))[0]
    got2, logits = _greedy(a, "s", PROMPT, 3, start=len(PROMPT) + 3, logits=logits)
    d2 = a.export_session_delta("s", d1["length"])
    if d2 is not None:
        assert store.apply("s", 0, wire.unpack(wire.pack({"session_id": "s", **d2})))[0]
    got += got2
    pos = len(PROMPT) + 6
    F = store.length("s")
    assert b.import_session("s", store.payload("s"))
    known = PROMPT + got
    if F < pos:
        logits = _step(b, "s", known[F:pos], F)
    tail, _ = _greedy(b, "s", known, 10 - 6, start=pos, logits=logits)
    assert got + tail == want


def test_a_tenant_delta_carries_its_adapter(params, tmp_path):
    rng = np.random.default_rng(1)
    cfg = jcfg.TINY
    layers = {"v_proj": (rng.normal(0, 0.1, (cfg.num_layers, cfg.hidden_size, 2))
                         .astype(np.float32),
                         rng.normal(0, 0.1, (cfg.num_layers, 2, cfg.kv_dim)).astype(np.float32))}
    adir = jlora.save_adapter(str(tmp_path / "ten0"), layers, alpha=4, r=2)
    ex = _port(params, "batched_paged",
               adapters=tadapters.AdapterRegistry(tcfg.TINY, [adir]))
    ex.process("t", {"tokens": np.asarray([PROMPT], np.int32), "start_pos": 0,
                     "real_len": len(PROMPT), "adapter": "ten0"})
    ex.process("b", {"tokens": np.asarray([PROMPT], np.int32), "start_pos": 0,
                     "real_len": len(PROMPT)})
    assert ex.export_session_delta("t", 0)["adapter"] == "ten0"
    assert "adapter" not in ex.export_session_delta("b", 0)


# -- nodes -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0,
        jq.init_params(jcfg.TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jp):
    out = str(tmp_path_factory.mktemp("repl_parts"))
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


@pytest.fixture(scope="module")
def expected(jp):
    engine = Engine(jcfg.TINY, jp, max_len=64, sampling_cfg=jcfg.SamplingConfig(temperature=0.0))
    return engine.generate(PROMPT, max_new_tokens=NEW)


REPL = ("--standby-repl", "--repl-interval", "0.05")


def _node(stage, *args, seed=None):
    argv = ["--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
            "--rebalance-period", "600", "--max-len", "64", *args]
    if seed is not None:
        argv += ["--bootstrap", f"127.0.0.1:{seed.dht.port}"]
    node = run_node.make_node(run_node.build_parser().parse_args(argv))
    node.dht.gossip_period_s = 0.05
    node.dht.ttl_s = 1.5
    node.path_finder.retry_delay_s = 0.05
    return node.start()


def _swarm(parts, flags=REPL, stages=(0, 1, 1)):
    nodes = [_node(stages[0], "--parts", parts, *flags)]
    nodes += [_node(s, "--parts", parts, *flags, seed=nodes[0]) for s in stages[1:]]
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


class _Logged(SwarmClient):
    """A SwarmClient into S0 whose new sessions take stage 1 on a chosen
    replica (`route`), logging each step's (start_pos, tokens)."""

    def __init__(self, entry, route, **kw):
        super().__init__([(entry.host, entry.port)], sampling=GREEDY, prefill_chunk=8, **kw)
        self.route = route
        self.steps: list = []

    def _forward_env(self, session_id, tokens, start_pos):
        return dict(super()._forward_env(session_id, tokens, start_pos), route=self.route)

    async def _step(self, session_id, tokens, start_pos):
        self.steps.append((start_pos, len(tokens)))
        return await super()._step(session_id, tokens, start_pos)


def _run(client, on_token, **kw):
    async def go():
        async with client as c:
            return await c.generate_ids(PROMPT, max_new_tokens=NEW, on_token=on_token, **kw)

    return asyncio.run(go())


def _sid(node):
    ids = node.executor.sessions.ids()
    assert len(ids) == 1, ids
    return ids[0]


def _replicated(primary, standby, block=1):
    """Wait until the standby's shadow of the primary's one session reaches
    the session's committed length (paged: its full blocks of `block`
    slots); returns (session id, that length)."""
    sid = _sid(primary)
    n = primary.executor.session_lengths()[sid] // block * block
    _wait(lambda: standby.standby.length(sid) == n, "the shadow did not catch up")
    return sid, n


def _freeze(node):
    """Stop a node's replication thread (its standby's frontier stays)."""
    node._stop_repl()


def test_promotion_continues_token_exact_with_no_restart(parts, expected):
    nodes = _swarm(parts)
    s0, r1a, r1b = nodes
    # the holder replicates from its first token on: its first ship then
    # carries the whole prompt (both chunks), whenever its first tick falls
    _freeze(r1a)
    try:
        seen, at = [], {}

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 1:
                r1a._start_repl()
            if len(seen) == 3:
                at["sid"], at["F"] = _replicated(r1a, r1b)
                r1a.crash()

        client = _Logged(s0, {"1": r1a.node_id})
        assert _run(client, on_token, session_retries=0) == expected
        assert None not in seen  # no restart
        c = r1b.stats()["metrics"]["counters"]
        assert c.get("repl.promotions") == 1 and c.get("repl.resumed_tokens") == at["F"]
        assert at["F"] >= len(PROMPT) and not c.get("repl.offers") and not c.get("repl.stale")
        assert c.get("repl.recv", 0) >= 1 and _counter(r1a, "repl.ships") >= 1
        # the promoted session served its next steps on R1b, no tail was re-sent
        assert r1b.stats()["forward_passes"] == NEW - 3
        assert [s for s in client.steps if s[1] > 1] == [(0, 8), (8, len(PROMPT) - 8)]
        st = r1a.stats()["repl"]
        assert st["shipped_bytes"] == _counter(r1a, "repl.bytes") > 0
        assert st["first_ship"]["tokens"] >= len(PROMPT) and st["first_ship"]["bytes"] > 0
    finally:
        _stop(nodes)


def test_a_rescue_past_a_dead_holder_finds_the_standby(parts, expected):
    """Three stage-1 replicas: after the holder's crash S0 relays the next
    step to the replica WITHOUT the shadow, whose rescue bounces once to the
    dead holder (its record lives on) and then to the replica advertising
    the shadow, which promotes it: no restart."""
    nodes = _swarm(parts, stages=(0, 1, 1, 1))
    s0, r1a, r1b, r1c = nodes
    try:
        seen, at = [], {}
        real = s0.path_finder.find_best_node

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                sid = _sid(r1a)
                n = r1a.executor.session_lengths()[sid]
                _wait(lambda: any(x.standby.length(sid) == n for x in (r1b, r1c)),
                      "no shadow caught up")
                x = at["x"] = next(x for x in (r1b, r1c) if x.standby.length(sid) == n)
                y = at["y"] = r1c if x is r1b else r1b
                r1a.crash()

                def pick(stage, *a, **kw):  # S0's fresh pick of stage 1: the replica without
                    if stage == 1:  # the shadow
                        return y.node_id, s0.dht.get_stage(1)[y.node_id]
                    return real(stage, *a, **kw)

                s0.path_finder.find_best_node = pick

        assert _run(_Logged(s0, {"1": r1a.node_id}), on_token, session_retries=0) == expected
        assert None not in seen
        x, y = at["x"], at["y"]
        assert _counter(x, "repl.promotions") == 1 and not _counter(y, "repl.promotions")
        assert _counter(y, "sessions.rescue_relay") >= 2  # the dead holder, then the standby
        assert not _counter(y, "sessions.rescue_failed")
    finally:
        _stop(nodes)


def test_a_lagging_frontier_resends_only_the_tail(parts, expected):
    nodes = _swarm(parts)
    s0, r1a, r1b = nodes
    try:
        seen, at = [], {}

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 2:
                at["sid"], at["F"] = _replicated(r1a, r1b)
                _freeze(r1a)  # no further ship: the standby lags from here
            if len(seen) == 4:
                at["pos"] = r1a.executor.session_lengths()[at["sid"]]
                at["steps"] = len(client.steps)
                r1a.crash()

        client = _Logged(s0, {"1": r1a.node_id})
        assert _run(client, on_token, session_retries=0) == expected
        assert None not in seen
        F, pos = at["F"], at["pos"]
        assert pos - F == 2
        # after the crash: the step at pos (offered a resume from F), the tail
        # [F, pos) once, the step at pos again
        assert client.steps[at["steps"]:at["steps"] + 3] == [(pos, 1), (F, pos - F), (pos, 1)]
        c = r1b.stats()["metrics"]["counters"]
        assert c.get("repl.offers") == 1 and c.get("repl.tail_tokens") == pos - F
        assert c.get("repl.promotions") == 1 and c.get("repl.resumed_tokens") == F
    finally:
        _stop(nodes)


def test_a_corrupt_shadow_fails_closed_into_a_restart(parts, expected):
    nodes = _swarm(parts)
    s0, r1a, r1b = nodes
    try:
        seen = []

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 4 and None not in seen:
                sid, _ = _replicated(r1a, r1b)
                _freeze(r1a)
                sh = r1b.standby._shadows[sid]
                sh.ks[0] = sh.ks[0][:, :, :1]  # fewer slots than its length claims
                r1a.crash()

        got = _run(_Logged(s0, {"1": r1a.node_id}), on_token, session_retries=4,
                   retry_delay_s=0.05)
        assert got == expected and None in seen  # restarted, token-exact
        c = r1b.stats()["metrics"]["counters"]
        assert c.get("repl.stale", 0) >= 1 and not c.get("repl.promotions")
    finally:
        _stop(nodes)


def test_an_ended_session_drops_its_shadow(parts, expected):
    nodes = _swarm(parts)
    s0, r1a, r1b = nodes
    try:
        def on_token(tok):
            time.sleep(0.06)  # a tick or so per token: the shadow exists

        assert _run(_Logged(s0, {"1": r1a.node_id}), on_token) == expected
        _wait(lambda: all(len(n.standby) == 0 for n in nodes), "a shadow outlived its session")
        assert _counter(r1b, "repl.recv") >= 1
        # the drop's announce took the `standby` advert out of R1b's record
        _wait(lambda: "standby" not in s0.dht.get_stage(1).get(r1b.node_id, {}),
              "R1b still advertises a shadow")
    finally:
        _stop(nodes)


def test_replicate_session_answers(parts):
    nodes = _swarm(parts, stages=(0, 1))
    s0, r1 = nodes
    try:
        # a session this node serves itself: the primary must pick another
        s0.executor.process("live", {"tokens": np.asarray([[3, 4]], np.int32), "start_pos": 0,
                                     "real_len": 2})
        k0 = torch.zeros((2, 1, 2, tcfg.TINY.num_kv_heads, tcfg.TINY.head_dim))
        assert _post(s0, "/replicate_session", {"session_id": "live", "stage": 0, "k": k0,
                                                "v": k0, "length": 2, "start": 0}) == (
            200, {"ok": False, "have": 0, "serving": True})
        k = torch.zeros((2, 1, 3, tcfg.TINY.num_kv_heads, tcfg.TINY.head_dim))
        delta = {"session_id": "x", "stage": 1, "k": k, "v": k, "length": 3, "start": 0}
        assert _post(r1, "/replicate_session", delta) == (200, {"ok": True, "length": 3})
        assert _post(r1, "/replicate_session", dict(delta, start=5, length=8)) == (
            200, {"ok": False, "have": 3})
        status, body = _post(r1, "/replicate_session", dict(delta, stage=0))
        assert status == 409 and body["code"] == "wrong_stage"
        assert _post(r1, "/replicate_session", {"stage": 1})[0] == 400
        # a tenant delta on a node without a registry: it could never promote it
        assert _post(r1, "/replicate_session", dict(delta, session_id="t", adapter="ten0")) == (
            200, {"ok": False, "have": 0, "unservable": True})
        assert r1.stats()["repl"]["standby_sessions"] == 1
        _wait(lambda: s0.dht.get_stage(1).get(r1.node_id, {}).get("standby"), "no advert")
        assert _post(r1, "/replicate_session", {"session_id": "x", "stage": 1, "drop": True}) == (
            200, {"ok": True, "length": 0})
        c = r1.stats()["metrics"]["counters"]
        assert c["repl.recv"] == 1 and c["repl.recv_declined"] == 2
        assert len(r1.standby) == 0
    finally:
        _stop(nodes)


def test_flag_off_leaves_records_stats_and_the_endpoint_as_they_were(parts, expected):
    nodes = _swarm(parts, flags=())
    s0, r1a, r1b = nodes
    try:
        assert _run(_Logged(s0, {"1": r1a.node_id}), None) == expected
        time.sleep(0.2)  # a few gossip periods
        for n in nodes:
            assert n.standby is None and n.replicator is None and n._repl_thread is None
            for recs in n.dht.get_all().values():
                assert all("standby" not in rec for rec in recs.values())
            st = n.stats()
            assert "repl" not in st and "gauges" not in st["metrics"]
            assert not any(k.startswith("repl.") for k in st["metrics"]["counters"])
        status, body = _post(r1a, "/replicate_session", {"session_id": "x", "stage": 1})
        assert status == 501 and body["code"] == "repl_off"
    finally:
        _stop(nodes)


def test_run_node_flags():
    ap = run_node.build_parser()
    args = ap.parse_args([])
    assert args.standby_repl is False and args.repl_interval == 0.5
    args = ap.parse_args(["--standby-repl", "--repl-interval", "0.2"])
    assert args.standby_repl is True and args.repl_interval == 0.2


def test_run_node_flags_from_the_environment(monkeypatch):
    monkeypatch.setenv("INFERD_STANDBY_REPL", "1")
    monkeypatch.setenv("INFERD_REPL_INTERVAL", "0.25")
    args = run_node.build_parser().parse_args([])
    assert args.standby_repl is True and args.repl_interval == 0.25


def test_stage_lanes_keep_shadows_but_replicate_nothing(parts, caplog):
    with caplog.at_level("WARNING"):
        node = _node(1, "--parts", parts, "--stage-lanes", "2", *REPL)
    try:
        assert "has no export_session_delta" in caplog.text
        k = torch.zeros((2, 1, 3, tcfg.TINY.num_kv_heads, tcfg.TINY.head_dim))
        assert _post(node, "/replicate_session", {"session_id": "x", "stage": 1, "k": k,
                                                  "v": k, "length": 3, "start": 0}) == (
            200, {"ok": True, "length": 3})
        time.sleep(0.2)
        assert not _counter(node, "repl.ships")
    finally:
        node.stop()


def test_a_routed_chain_promotes_on_its_standby(parts, expected):
    """A committed routed chain whose stage-1 replica crashes: the hop moves
    to the replica advertising the session's shadow, which promotes it."""
    nodes = _swarm(parts)
    s0, r1a, r1b = nodes
    dht = SwarmDHT("observer", 0, bootstrap=[("127.0.0.1", s0.dht.port)])
    dht.start()
    try:
        _wait(lambda: len(dht.get_all(2)[1]) == 2 and dht.get_all(2)[0], "observer view")
        seen, at = [], {}

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 3:
                holder = next(n for n in (r1a, r1b) if len(n.executor.sessions))
                other = at["other"] = r1b if holder is r1a else r1a
                _replicated(holder, other)
                holder.crash()
                _wait(lambda: dht.get_stage(1).get(other.node_id, {}).get("standby"),
                      "no standby advert")

        client = RoutedChainClient(dht, 2, sampling=GREEDY, prefill_chunk=8)
        assert _run(client, on_token, session_retries=0) == expected
        assert None not in seen and _counter(at["other"], "repl.promotions") == 1
    finally:
        dht.stop()
        _stop(nodes)


# -- a tenant session on a whole-model lane pair ------------------------------------------

@pytest.fixture(scope="module")
def tenant_setup(tmp_path_factory, jp):
    root = tmp_path_factory.mktemp("repl_tenants")
    parts1 = str(root / "parts1")
    jstages.split_and_save(jp, jcfg.TINY, jstages.Manifest.even_split("tiny", 1), parts1)
    rng = np.random.default_rng(7)
    cfg = jcfg.TINY
    layers = {n: (rng.normal(0, 0.5, (cfg.num_layers, cfg.hidden_size, 4)).astype(np.float32),
                  rng.normal(0, 0.5, (cfg.num_layers, 4, dout)).astype(np.float32))
              for n, dout in (("q_proj", cfg.q_dim), ("v_proj", cfg.kv_dim))}
    adir = jlora.save_adapter(str(root / "ten0"), layers, alpha=8, r=4)
    return parts1, adir


def test_a_tenant_session_promotes_with_its_adapter(tenant_setup):
    parts1, adir = tenant_setup
    flags = ("--batch-lanes", "2", "--paged-kv", str(BS), "--adapters", adir, *REPL)
    nodes = _swarm(parts1, flags=flags, stages=(0, 0))
    a, b = nodes
    try:
        def client(first):
            order = [first, b if first is a else a]
            return SwarmClient([(n.host, n.port) for n in order], sampling=GREEDY,
                               prefill_chunk=8, adapter="ten0")

        want = _run(client(a), None)
        seen, at = [], {}

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 5:
                holder = next(n for n in (a, b) if len(n.executor.sessions))
                other = b if holder is a else a
                at["sid"], at["F"] = _replicated(holder, other, block=BS)
                assert other.standby.payload(at["sid"])["adapter"] == "ten0"
                holder.crash()
                at["other"] = other

        got = _run(client(a), on_token, session_retries=0)
        assert got == want and None not in seen
        other = at["other"]
        c = other.stats()["metrics"]["counters"]
        F = at["F"]
        assert F == (len(PROMPT) + 4) // BS * BS  # full blocks only
        # the tail block never shipped: a resume offer, the tail re-sent, a promotion
        assert c.get("repl.offers") == 1 and c.get("repl.tail_tokens") == len(PROMPT) + 4 - F
        assert c.get("repl.promotions") == 1 and c.get("repl.resumed_tokens") == F
    finally:
        _stop(nodes)
