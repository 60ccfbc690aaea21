"""Multi-tenant LoRA serving in the port (inferd_tpu_torch.runtime.adapters,
the lane executor's adapter binding, run_node --adapters / --lora) against
the JAX package's.

  * the AdapterRegistry's lifecycle (refcounts, LRU eviction, pins, the
    typed errors, slot validation, header-only sizing, the target union)
    as tests/test_adapters.py holds the reference's;
  * three tenants (mixed ranks, target subsets) and a base session
    co-resident on the paged lane executor, in one stage and in two, with
    and without --quant int8: every greedy stream equals the JAX
    BatchedStageExecutor's with the same registry, token for token (logits
    within 1e-4 of max |logit|, f32: the same sums in another order), and,
    unquantized, the port's merged-adapter executor's; the streams differ;
  * a node whose executor serves no registry answers an adapter-stamped
    request with 409 `no_adapter_registry` (the one-session node used to
    serve it the base model);
  * two in-process run_node --adapters nodes serve a ChainClient(adapter=)
    stream equal to the in-process executors', with typed errors for an
    unknown name (409) and full slots (503), refused flag combinations, the
    registry and the kernel counter in /stats; a --lora node pair serves the
    merged stream.
"""

import asyncio
import dataclasses
import http.client
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu.ops import quant as jquant
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.adapters import AdapterRegistry as JRegistry
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JLanes
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.client.base import ServerError
from inferd_tpu_torch.client.chain_client import ChainClient
from inferd_tpu_torch.config import SamplingConfig
from inferd_tpu_torch.core import prefix as prefixlib
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.ops import lora as tlora
from inferd_tpu_torch.ops import quant as tquant
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime import wire
from inferd_tpu_torch.runtime.adapters import (
    AdapterCapacityError, AdapterRegistry, UnknownAdapterError, parse_adapter_dirs,
)
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor, make_executor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.tools import run_node

torch.set_num_threads(2)

PROMPT = [3, 17, 42, 9, 5, 8, 2, 11, 60, 1, 77, 13, 200, 7, 7, 31, 4, 90, 6, 23]
STEPS = 5


@pytest.fixture(autouse=True)
def restore_modes():
    """Pin the JAX executors to the gather path and put back the modes that
    apply_quant_mode sets."""
    saved = (jlora.FORCE_LORA_KERNEL, jquant.QDOT_MODE, jquant.INT4_MODE,
             jquant.FORCE_QUANT_KERNEL, tquant.INT4_MODE)
    jlora.FORCE_LORA_KERNEL = False
    yield
    (jlora.FORCE_LORA_KERNEL, jquant.QDOT_MODE, jquant.INT4_MODE, jquant.FORCE_QUANT_KERNEL,
     tquant.INT4_MODE) = saved


def _mk_layers(cfg, seed, r=4, targets=None, sd=0.25):
    g = np.random.default_rng(seed)
    dims = {
        "q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
        "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size),
        "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
        "up_proj": (cfg.hidden_size, cfg.intermediate_size),
        "down_proj": (cfg.intermediate_size, cfg.hidden_size),
    }
    return {n: (g.normal(0, sd, (cfg.num_layers, din, r)).astype(np.float32),
                g.normal(0, sd, (cfg.num_layers, r, dout)).astype(np.float32))
            for n, (din, dout) in dims.items() if targets is None or n in targets}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """Three synthetic peft tenants written by the JAX save_adapter (mixed
    ranks and target subsets), as tests/test_adapters.py's catalog."""
    root = tmp_path_factory.mktemp("adapters")
    dirs = []
    for name, seed, r, targets in [("ten0", 0, 4, None),
                                   ("ten1", 1, 2, ("q_proj", "gate_proj")),
                                   ("ten2", 2, 4, ("v_proj", "down_proj"))]:
        dirs.append(jlora.save_adapter(str(root / name),
                                       _mk_layers(jcfg.TINY, 100 + seed, r=r, targets=targets),
                                       alpha=8, r=r))
    return dirs


@pytest.fixture(scope="module")
def jax_full():
    return jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))


# -- the registry ------------------------------------------------------------------


def test_registry_refcount_lru_evict_and_events(catalog):
    reg = AdapterRegistry(tcfg.TINY, catalog, slots=3)  # 2 tenant slots
    events = []
    reg.on_event = lambda e, **a: events.append((e, a))
    s0, s1 = reg.acquire("ten0"), reg.acquire("ten1")
    assert s0 != s1 and 0 not in (s0, s1)
    with pytest.raises(AdapterCapacityError):  # both held
        reg.acquire("ten2")
    reg.release("ten0")
    assert reg.acquire("ten2") == s0  # evicts idle ten0, reuses its slot
    names = [e for e, _ in events]
    assert names.count("adapter.load") == 3
    evicts = [a for e, a in events if e == "adapter.evict"]
    assert len(evicts) == 1 and evicts[0]["name"] == "ten0"
    assert evicts[0]["claimant"] == "ten2" and evicts[0]["idle_s"] >= 0
    st = reg.stats()
    assert st["loads"] == 3 and st["evictions"] == 1 and st["resident"] == 2
    assert list(reg._idle_since) == ["ten1", "ten2"]  # LRU order, oldest first
    # the claimant's rows overwrote every row of the victim's slot
    want = tlora.load_adapter(tcfg.TINY, catalog[2])
    pools = reg.device_adapters()
    assert torch.equal(pools["a"]["v_proj"][s0], want["layers"]["v_proj"][0])
    assert not pools["a"]["q_proj"][s0].any()  # ten2 has no q_proj: zero, not ten0's
    assert pools["scale"][s0].item() == pytest.approx(want["scale"])
    assert not pools["a"]["q_proj"][0].any() and pools["scale"][0].item() == 0.0


def test_registry_pin_blocks_eviction_and_unknown_name(catalog):
    reg = AdapterRegistry(tcfg.TINY, catalog, slots=2)  # ONE tenant slot
    reg.pin("ten0")
    with pytest.raises(AdapterCapacityError):
        reg.acquire("ten1")  # the only slot is pinned
    reg.unpin("ten0")
    reg.acquire("ten1")  # now evicts the unpinned idle ten0
    with pytest.raises(UnknownAdapterError, match="unknown adapter"):
        reg.acquire("nope")
    assert issubclass(UnknownAdapterError, ValueError)


@pytest.mark.parametrize("slots", [1, -3])
def test_unservable_adapter_slots_raise(catalog, slots):
    with pytest.raises(ValueError, match="unservable"):
        AdapterRegistry(tcfg.TINY, catalog, slots=slots)
    assert AdapterRegistry(tcfg.TINY, catalog, slots=0).slots == len(catalog) + 1


@pytest.mark.parametrize("variant", ["moe", "sliding_window"])
def test_registry_and_forward_refuse_moe_and_sliding_window(catalog, variant):
    if variant == "moe":
        cfg = dataclasses.replace(tcfg.TINY, num_experts=4, num_experts_per_tok=2,
                                  moe_intermediate_size=32)
        msg = "MoE"
    else:
        cfg = dataclasses.replace(tcfg.TINY, sliding_window=8)
        msg = "sliding-window"
    with pytest.raises(ValueError, match=msg):
        AdapterRegistry(cfg, catalog)
    from inferd_tpu_torch.models import qwen3 as tq

    with pytest.raises(ValueError, match="MoE and sliding-window"):
        tq.forward_layers({}, cfg, torch.zeros(1, 1, 64), 0, adapters={"ids": None})


def test_parse_adapter_dirs_collision():
    assert parse_adapter_dirs("/a/x,/b/y") == {"x": "/a/x", "y": "/b/y"}
    assert parse_adapter_dirs(" /a/x/ , ") == {"x": "/a/x/"}
    with pytest.raises(ValueError, match="collide"):
        parse_adapter_dirs("/a/x,/b/x")
    with pytest.raises(ValueError, match="no adapter directories"):
        AdapterRegistry(tcfg.TINY, "")


def test_registry_sizes_pools_from_headers_and_target_union(catalog, tmp_path):
    """Rank = the catalog's largest, read from adapter_config.json; targets
    from the safetensors header only (the data need not be readable);
    pools cover only the catalog's target union, in cfg's dtype."""
    assert AdapterRegistry._peek_meta(catalog[1]) == (2, {"q_proj", "gate_proj"})
    reg = AdapterRegistry(tcfg.TINY, catalog[1:])
    assert reg.rank == 4 and reg.targets == ("down_proj", "gate_proj", "q_proj", "v_proj")
    assert reg.device_adapters() is None  # nothing loaded yet
    reg.acquire("ten1")
    pools = reg.device_adapters()
    assert set(pools["a"]) == set(reg.targets) and set(pools["b"]) == set(reg.targets)
    assert tuple(pools["a"]["gate_proj"].shape) == (3, 4, 64, 4)
    assert tuple(pools["b"]["down_proj"].shape) == (3, 4, 4, 64)
    assert pools["a"]["q_proj"].dtype == tcfg.TINY.torch_dtype
    assert pools["scale"].dtype == torch.float32
    # ten1 is rank 2 in a rank-4 pool: its tail rank columns stay zero
    slot = reg.slot_of("ten1")
    assert not pools["a"]["q_proj"][slot, :, :, 2:].any()
    assert pools["a"]["q_proj"][slot, :, :, :2].any()
    bf = AdapterRegistry(dataclasses.replace(tcfg.TINY, dtype="bfloat16"), catalog[:1])
    bf.acquire("ten0")
    assert bf.device_adapters()["a"]["q_proj"].dtype == torch.bfloat16
    # a stage's slice holds the catalog's layers [start, end)
    part = AdapterRegistry(tcfg.TINY, catalog[:1], start_layer=1, end_layer=3)
    part.acquire("ten0")
    full = tlora.load_adapter(tcfg.TINY, catalog[0])["layers"]["up_proj"][0]
    assert torch.equal(part.device_adapters()["a"]["up_proj"][1], full[1:3])
    with pytest.raises(ValueError, match="is empty"):
        AdapterRegistry(tcfg.TINY, catalog, start_layer=2, end_layer=2)


def test_unreadable_catalog_entry_never_evicts_residents(catalog, tmp_path):
    ok, ghost = str(tmp_path / "ok"), str(tmp_path / "ghost")
    shutil.copytree(catalog[0], ok)
    shutil.copytree(catalog[1], ghost)
    reg = AdapterRegistry(tcfg.TINY, [ok, ghost], slots=2)  # ONE usable slot
    reg.acquire("ok")
    reg.release("ok")  # resident and idle: evictable
    shutil.rmtree(ghost)  # unreadable after start
    for _ in range(3):
        with pytest.raises(OSError):
            reg.acquire("ghost")
    st = reg.stats()
    assert st["resident"] == 1 and st["evictions"] == 0
    assert list(reg._idle_since) == ["ok"]


# -- the lane executor -------------------------------------------------------------------


def _whole_spec():
    return tstages.StageSpec(0, 1, 0, tcfg.TINY.num_layers - 1)


def _tparams(jax_tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_tree))


def test_ads_all_base_window_carries_no_operand(catalog, jax_full):
    reg = AdapterRegistry(tcfg.TINY, catalog)
    ex = BatchedStageExecutor(tcfg.TINY, _whole_spec(), _tparams(jax_full), lanes=2, max_len=64,
                              adapters=reg)
    assert ex._ads([0, 1]) is None  # nothing loaded yet
    slot = reg.acquire("ten0")
    try:
        assert ex._ads([0, 0]) is None
        mixed = ex._ads([0, slot])
        assert mixed["ids"].dtype == torch.int32 and mixed["ids"].tolist() == [0, slot]
        assert mixed["a"]["q_proj"] is reg.device_adapters()["a"]["q_proj"]  # no copy
    finally:
        reg.release("ten0")
    bare = BatchedStageExecutor(tcfg.TINY, _whole_spec(), _tparams(jax_full), lanes=2, max_len=64)
    assert bare._ads([1, 1]) is None


def test_lane_executor_binding_errors_and_reference_hygiene(catalog, jax_full):
    """No registry: a ValueError naming it (the node answers 409 before it
    gets here). With one: an admission that dies after the acquire gives
    the reference back; a decode step naming another adapter is refused;
    a restart under the same id swaps references; teardown releases."""
    kw = dict(lanes=2, max_len=32, block_size=8)
    bare = BatchedStageExecutor(tcfg.TINY, _whole_spec(), _tparams(jax_full), **kw)
    with pytest.raises(ValueError, match="no adapter registry"):
        bare.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT),
                           "adapter": "ten0"})
    reg = AdapterRegistry(tcfg.TINY, catalog)
    ex = BatchedStageExecutor(tcfg.TINY, _whole_spec(), _tparams(jax_full), adapters=reg, **kw)
    with pytest.raises(BufferError):  # the prompt exceeds max_len
        ex.process("s", {"tokens": [list(range(2, 40))], "start_pos": 0, "real_len": 38,
                         "adapter": "ten0"})
    assert reg._refs == {}
    with pytest.raises(UnknownAdapterError):
        ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT),
                         "adapter": "nope"})
    ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT),
                     "adapter": "ten0"})
    lane = ex._sessions["s"]
    assert reg._refs == {"ten0": 1} and ex._lane_slot[lane] == reg.slot_of("ten0")
    out = ex.process_batch([("s", {"tokens": [[5]], "start_pos": len(PROMPT), "real_len": 1,
                                   "adapter": "ten1"})])
    assert isinstance(out[0], ValueError) and "does not match" in str(out[0])
    with pytest.raises(ValueError, match="mid-session adapter"):
        ex.process("s", {"tokens": [[5, 6]], "start_pos": len(PROMPT), "real_len": 2,
                         "adapter": "ten1"})
    # a restated adapter on a later chunk is fine
    ex.process("s", {"tokens": [[5, 6]], "start_pos": len(PROMPT), "real_len": 2,
                     "adapter": "ten0"})
    ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT),
                     "adapter": "ten2"})  # restart under the same id
    assert reg._refs == {"ten2": 1} and ex.session_adapters() == {"s": "ten2"}
    ex.process("s", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT)})  # as base
    assert reg._refs == {} and ex._lane_slot[lane] == 0
    ex.process("t", {"tokens": [PROMPT], "start_pos": 0, "real_len": len(PROMPT),
                     "adapter": "ten1"})
    ex.end_session("t")
    ex.end_session("s")
    assert reg._refs == {} and ex._lane_slot == [0, 0] and ex.session_adapters() == {}
    st = ex.stats()
    assert st["adapters"]["loads"] == 3 and st["adapter_prefill_steps"] >= 3
    with pytest.raises(ValueError, match="pair it with --stage-lanes"):
        make_executor(tcfg.TINY, _whole_spec(), _tparams(jax_full), adapters=reg)


def _logits(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _check_logits(tl, jl):
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    assert int(np.argmax(tl)) == int(np.argmax(jl))


def _chain(executors, sid, payload, adapter=None):
    """One pass through a chain of executors, the adapter stamped on every
    stage's payload (as the chain client stamps it)."""
    stamp = {"adapter": adapter} if adapter is not None else {}
    payload = dict(payload, **stamp)
    for ex in executors:
        out = ex.process(sid, payload)
        if "logits" in out:
            return out["logits"]
        h = out["hidden"]
        payload = {"hidden": np.asarray(h.float() if isinstance(h, torch.Tensor) else h),
                   "start_pos": out["start_pos"], "real_len": out["real_len"], **stamp}
    raise AssertionError("no logits")


def _greedy(executors, prompt, steps, sid="ref", adapter=None):
    lg = _logits(_chain(executors, sid, {"tokens": np.asarray([prompt], np.int32),
                                         "start_pos": 0, "real_len": len(prompt)}, adapter)[0])
    toks = [int(np.argmax(lg))]
    for i in range(steps - 1):
        lg = _logits(_chain(executors, sid, {"tokens": np.asarray([[toks[-1]]], np.int32),
                                             "start_pos": len(prompt) + i, "real_len": 1})[0])
        toks.append(int(np.argmax(lg)))
    for ex in executors:
        ex.end_session(sid)
    return toks


SESSIONS = (("a0", "ten0"), ("a1", "ten1"), ("a2", "ten2"), ("b", None))


@pytest.mark.parametrize("stages,quant_flag", [(1, None), (2, None), (2, "int8")])
def test_tenants_cobatched_on_paged_lanes_equal_jax_and_merged(catalog, jax_full, stages,
                                                               quant_flag):
    """Three tenants and a base session, same prompt, co-resident on paged
    lane executors (block size 8): prefill one by one, then every decode
    step co-batched (one process_batch per stage per step), the JAX stream
    fed to both packages. Logits agree at every step; the four streams
    differ; unquantized, each equals the port's merged-adapter executors'
    (the base one the plain model's). The prompt spans whole blocks, so an unsalted
    prefix index would hand a tenant another's KV."""
    specs = jstages.Manifest.even_split("tiny", stages).stage_specs()
    kw = dict(lanes=4, max_len=64, block_size=8, prefill_chunk=8)
    jex, tex, tstage = [], [], []
    for spec in specs:
        jsp = jstages.extract_stage_params(jax_full, jcfg.TINY, spec)
        if quant_flag:
            jsp = jquant.apply_quant_mode(quant_flag, jsp, tie_word_embeddings=True,
                                          needs_head=spec.is_last)
        tspec = tstages.StageSpec(spec.stage, spec.num_stages, spec.start_layer, spec.end_layer)
        tsp = _tparams(jsp)
        span = dict(start_layer=spec.start_layer, end_layer=spec.end_layer + 1)
        jex.append(JLanes(jcfg.TINY, spec, jsp, adapters=JRegistry(jcfg.TINY, catalog, **span),
                          **kw))
        tex.append(BatchedStageExecutor(tcfg.TINY, tspec, tsp,
                                        adapters=AdapterRegistry(tcfg.TINY, catalog, **span), **kw))
        tstage.append((tspec, _tparams(jstages.extract_stage_params(jax_full, jcfg.TINY, spec))))
    toks = {}
    for sid, name in SESSIONS:
        payload = {"tokens": np.asarray([PROMPT], np.int32), "start_pos": 0,
                   "real_len": len(PROMPT)}
        jl = _logits(_chain(jex, sid, payload, name)[0])
        _check_logits(_logits(_chain(tex, sid, payload, name)[0]), jl)
        toks[sid] = [int(np.argmax(jl))]
    for step in range(STEPS - 1):
        items = [(sid, {"tokens": [[toks[sid][-1]]], "start_pos": len(PROMPT) + step,
                        "real_len": 1}) for sid, _ in SESSIONS]
        jitems = titems = items
        for j, t in zip(jex, tex):
            jo, to = j.process_batch(jitems), t.process_batch(titems)
            assert not any(isinstance(o, Exception) for o in jo + to), (jo, to)
            if "logits" in jo[0]:
                break
            jitems = [(sid, {"hidden": np.asarray(o["hidden"]), "start_pos": o["start_pos"],
                             "real_len": 1}) for (sid, _), o in zip(items, jo)]
            titems = [(sid, {"hidden": o["hidden"], "start_pos": o["start_pos"], "real_len": 1})
                      for (sid, _), o in zip(items, to)]
        for (sid, _), a, b in zip(SESSIONS, to, jo):
            _check_logits(_logits(a["logits"][0]), _logits(b["logits"][0]))
            toks[sid].append(int(np.argmax(_logits(b["logits"][0]))))
    for t in tex:
        st = t.stats()
        assert st["batched_steps"] == STEPS - 1 and st["batched_tokens"] == 4 * (STEPS - 1)
        assert st["adapter_steps"] == STEPS - 1  # every window carried tenant lanes
        assert st["adapters"]["loads"] == 3
    if stages == 1:
        pool = tex[0].pool
        k0 = prefixlib.block_keys(PROMPT, 8, salt="ten0")
        k1 = prefixlib.block_keys(PROMPT, 8, salt="ten1")
        kb = prefixlib.block_keys(PROMPT, 8)
        assert not set(k0) & set(k1) and not set(k0) & set(kb)
        assert all(k in pool._index for k in (k0[0], k1[0], kb[0]))  # all three published
    assert len({tuple(v) for v in toks.values()}) == len(SESSIONS)
    if quant_flag:
        return  # a merged adapter quantizes with the weights: another function
    # the port's own merged-adapter executors (the run_node --lora path)
    for sid, name in SESSIONS:
        merged = []
        for tspec, tsp in tstage:
            if name is not None:
                path = catalog[[os.path.basename(c) for c in catalog].index(name)]
                ad = tlora.slice_adapter(tlora.load_adapter(tcfg.TINY, path), tspec.start_layer,
                                         tspec.end_layer + 1)
                tsp = tlora.merge_adapter(tsp, ad)
            merged.append(Qwen3StageExecutor(tcfg.TINY, tspec, tsp, max_len=64, initial_kv_len=32))
        assert _greedy(merged, PROMPT, STEPS) == toks[sid], sid


# -- nodes ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parts(tmp_path_factory, jax_full):
    out = str(tmp_path_factory.mktemp("lora_parts"))
    jstages.split_and_save(jax_full, jcfg.TINY, jstages.Manifest.even_split("tiny", 2), out)
    return out


def _node_args(parts, stage, *extra):
    return run_node.build_parser().parse_args(
        ["--parts", parts, "--stage", str(stage), "--port", "0", "--gossip-port", "0", "--device", "cpu",
         "--max-len", "64", *extra])


def _post(node, body):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("POST", "/forward", body=wire.pack(body))
        r = conn.getresponse()
        return r.status, wire.unpack(r.read())
    finally:
        conn.close()


def _get_stats(node):
    conn = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _env(sid, adapter, stage=0, tokens=PROMPT):
    payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": 0, "real_len": len(tokens)}
    if adapter is not None:
        payload["adapter"] = adapter
    return {"task_id": "t", "session_id": sid, "stage": stage, "relay": False, "payload": payload}


@pytest.mark.parametrize("lanes", [False, True])
def test_node_without_registry_refuses_adapter_requests(parts, lanes):
    """409 no_adapter_registry, on the one-session node (which used to serve
    the tenant the base model) and on a lane node built without --adapters;
    a base request still serves."""
    extra = ("--stage-lanes", "2", "--paged-kv", "8") if lanes else ()
    node = run_node.make_node(_node_args(parts, 0, *extra)).start()
    try:
        status, body = _post(node, _env("s", "ten0"))
        assert status == 409 and body["code"] == "no_adapter_registry", body
        assert "ten0" in body["error"]
        status, body = _post(node, _env("s", None))
        assert status == 200 and "hidden" in body["result"]
    finally:
        node.stop()


def test_chain_client_stamps_every_hop_of_the_first_chunk_only():
    """With an adapter the first chunk's payload carries it to every stage;
    later chunks and a base client's envelopes carry no key at all."""
    class Recording(ChainClient):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sent = []

        async def _post(self, addr, path, body):
            self.sent.append(body)
            if body["stage"] == 1:
                return {"result": {"logits": np.zeros((1, 4), np.float32)}}
            return {"result": {"hidden": np.zeros((1, 2, 3), np.float32), "start_pos":
                               body["payload"]["start_pos"], "real_len": 2}}

    for adapter in (None, "ten0"):
        c = Recording([("h", 1), ("h", 2)], adapter=adapter)
        asyncio.run(c._forward_through_chain("s", [1, 2], 0))
        asyncio.run(c._forward_through_chain("s", [3], 2))
        first, later = c.sent[:2], c.sent[2:]
        for env in first:
            assert env["payload"].get("adapter") == adapter
            assert ("adapter" in env["payload"]) == (adapter is not None)
        assert not any("adapter" in env["payload"] for env in later)


@pytest.fixture(scope="module")
def adapter_chain(parts, catalog):
    nodes = [run_node.make_node(_node_args(
        parts, s, "--stage-lanes", "4", "--paged-kv", "8", "--prefill-chunk", "8",
        "--window-ms", "2", "--adapters", ",".join(catalog), "--adapter-slots", "2")).start()
        for s in range(2)]
    yield nodes
    for n in nodes:
        n.stop()


def _serve(nodes, prompt, adapter=None):
    async def go():
        async with ChainClient([(n.host, n.port) for n in nodes],
                               sampling=SamplingConfig(temperature=0.0), prefill_chunk=8,
                               adapter=adapter) as c:
            return await c.generate_ids(prompt, max_new_tokens=STEPS)

    return asyncio.run(go())


def _local_lanes(parts, catalog):
    out = []
    for s in range(2):
        params, spec, _ = tstages.load_stage_checkpoint(tstages.stage_checkpoint_path(parts, s),
                                                        device="cpu")
        reg = AdapterRegistry(tcfg.TINY, catalog, start_layer=spec.start_layer,
                              end_layer=spec.end_layer + 1)
        out.append(BatchedStageExecutor(tcfg.TINY, spec, params, lanes=4, max_len=64,
                                        block_size=8, prefill_chunk=8, adapters=reg))
    return out


def test_adapter_nodes_serve_the_in_process_tenant_stream(adapter_chain, parts, catalog):
    nodes = adapter_chain
    local = _local_lanes(parts, catalog)
    want = _greedy(local, PROMPT, STEPS, adapter="ten0")
    assert _serve(nodes, PROMPT, adapter="ten0") == want
    assert _serve(nodes, PROMPT) == _greedy(local, PROMPT, STEPS)
    assert _serve(nodes, PROMPT) != want
    for n in nodes:
        st = _get_stats(n)
        ex = st["executor"]
        assert st["errors"] == 0 and ex["sessions"] == 0
        assert ex["adapters"]["slots"] == 2 and ex["adapters"]["loads"] == 1
        assert ex["adapter_steps"] == STEPS - 1 and ex["adapter_prefill_steps"] >= 1
        # CPU tensors take the plain delta: no kernel launches here
        assert st["kernels"]["fused_lane_delta"]["launches"] == 0


def test_adapter_nodes_type_unknown_names_and_full_slots(adapter_chain):
    node = adapter_chain[0]
    status, body = _post(node, _env("u", "nope"))
    assert status == 409 and body["code"] == "unknown_adapter", body
    with pytest.raises(ServerError) as ei:
        _serve(adapter_chain, PROMPT, adapter="nope")
    assert ei.value.code == "unknown_adapter" and not ei.value.retryable
    # one tenant slot: a live ten1 session holds it, so ten2 gets a retryable 503
    assert _post(node, _env("h", "ten1"))[0] == 200
    status, body = _post(node, _env("w", "ten2"))
    assert status == 503 and body["code"] == "busy", body
    _post_end = http.client.HTTPConnection(node.host, node.port, timeout=30)
    try:
        _post_end.request("POST", "/end_session", body=wire.pack({"session_id": "h"}))
        assert _post_end.getresponse().status == 200
    finally:
        _post_end.close()
    status, _ = _post(node, _env("w", "ten2"))  # the idle ten1 is evicted now
    assert status == 200
    node.executor.end_session("w")
    assert _get_stats(node)["executor"]["adapters"]["evictions"] >= 1


@pytest.mark.parametrize("extra,msg", [
    (("--stage-lanes", "2", "--lora", "X", "--adapters", "Y"), "mutually exclusive"),
    (("--adapters", "Y"), "pair it with --stage-lanes"),
])
def test_run_node_refuses_flag_combinations_at_start(parts, extra, msg):
    with pytest.raises(ValueError, match=msg):
        run_node.make_node(_node_args(parts, 0, *extra))


def test_lora_nodes_serve_the_merged_stream(parts, catalog, adapter_chain):
    """--lora merges the stage's slice before serving, on either executor:
    the stream is the ten0 tenant's on the --adapters nodes."""
    want = _serve(adapter_chain, PROMPT, adapter="ten0")
    for extra in ((), ("--stage-lanes", "2", "--paged-kv", "8")):
        nodes = [run_node.make_node(_node_args(parts, s, "--lora", catalog[0], *extra)).start()
                 for s in range(2)]
        try:
            assert _serve(nodes, PROMPT) == want
            status, body = _post(nodes[0], _env("x", "ten0"))
            assert status == 409 and body["code"] == "no_adapter_registry"
        finally:
            for n in nodes:
                n.stop()
