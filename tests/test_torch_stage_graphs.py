"""The chain's stage steps as captured programs, held on the CPU.

On a card the one-session executor's token steps and `decode_steps`
windows, and the lane executors' co-batched decode steps, replay CUDA
graphs (utils/cuda_graph). Here a fake graph backend stands in: its
capture runs the step once under a TorchFunctionMode that refuses every
host read of a device value (`item`, `tolist`, `nonzero`, `numpy`, `cpu`,
a tensor's truth value or int), and its replay re-runs the CAPTURED
closure over the same static buffers and copies the result into the
captured outputs. A host value baked into the closure at capture then
gives a wrong answer at the next fill, as it would in a real graph.

On TINY (weights 10x the init, so greedy streams vary), each graphed
executor is held bit for bit to the same executor with `graphs` None, and
to the JAX package's executors (greedy tokens exact, f32 logits atol 1e-4,
the limit of tests/test_torch_stage.py): a 2-stage one-session chain whose
decode crosses the 64-slot kv bucket, with a replay; `decode_steps`
windows; dense and paged lanes with staggered sessions, a shared prefix
split by copy-on-write and a tenant lane. Then the buffers' and graphs'
lifecycle: reuse by the next session of a bucket and by a next wave of
concurrent sessions, and the drop on end_session, eviction, sweep and
grow."""

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from inferd_tpu import config as jcfg
from inferd_tpu.models import qwen3 as jq
from inferd_tpu.ops import lora as jlora
from inferd_tpu.parallel import stages as jstages
from inferd_tpu.runtime.adapters import AdapterRegistry as JRegistry
from inferd_tpu.runtime.executor import Qwen3StageExecutor as JExecutor
from inferd_tpu.runtime.stage_batch import BatchedStageExecutor as JLanes
from inferd_tpu_torch import config as tcfg
from inferd_tpu_torch.core.cache import kv_slot_bytes
from inferd_tpu_torch.models import convert
from inferd_tpu_torch.models import qwen3 as tq
from inferd_tpu_torch.parallel import stages as tstages
from inferd_tpu_torch.runtime.adapters import AdapterRegistry
from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor
from inferd_tpu_torch.utils.cuda_graph import GraphCache, _tensors

torch.set_num_threads(2)

ATOL = 1e-4
SAMPLING = {"temperature": 0.8, "top_k": 8, "top_p": 0.95}


# -- the fake graph backend -----------------------------------------------------------


class _NoHostReads(TorchFunctionMode):
    """Refuses what a captured step may not do: read a device value on the
    host."""

    BANNED = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.nonzero, torch.nonzero,
              torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.__bool__,
              torch.Tensor.__int__, torch.Tensor.__float__, torch.Tensor.__index__,
              torch.Tensor.__array__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"a captured step reads a device value on the host: {func}")
        return func(*args, **(kwargs or {}))


class _ReplayGraph:
    """A replay re-runs the captured closure over the static buffers and
    writes its result into the captured outputs."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        with _in_graph():
            new = self.fn()
        for dst, src in zip(_tensors(self.outputs), _tensors(new)):
            dst.copy_(src)


class _in_graph(_NoHostReads):
    """A capture or a replay: host reads refused, and planted faults told
    (`active`) that the Python they run stands for a graph."""

    active = False

    def __enter__(self):
        _in_graph.active = True
        return super().__enter__()

    def __exit__(self, *exc):
        _in_graph.active = False
        return super().__exit__(*exc)


class _Backend:
    def warmup(self, fn):
        return fn()

    def capture(self, fn):
        with _in_graph():
            out = fn()
        return _ReplayGraph(fn, out), out


def _graphs(max_graphs=32):
    return GraphCache(max_graphs=max_graphs, counters=[], backend=_Backend())


def test_no_host_reads_mode_refuses_each_read():
    x = torch.arange(3)
    for read in (lambda: x.sum().item(), lambda: x.tolist(), lambda: x.nonzero(),
                 lambda: x.numpy(), lambda: x.cpu(), lambda: bool(x[0]), lambda: int(x[0])):
        with _NoHostReads(), pytest.raises(AssertionError, match="host"):
            read()


# -- weights and executors ------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jq.init_params(jcfg.TINY, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x if "norm" in jax.tree_util.keystr(path) else x * 10.0, jp)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), None)


def _stages(params, n):
    """[(jax spec, jax params, port spec, port params)] of an n-stage split."""
    jp, _ = params
    out = []
    for spec in jstages.Manifest.even_split("tiny", n).stage_specs():
        jsp = jstages.extract_stage_params(jp, jcfg.TINY, spec)
        tspec = tstages.StageSpec(spec.stage, spec.num_stages, spec.start_layer, spec.end_layer)
        out.append((spec, jsp, tspec, convert.params_from_numpy(jax.tree.map(np.asarray, jsp))))
    return out


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _key(out):
    return "logits" if "logits" in out else "hidden"


def _same(got, want):
    """Bit for bit, one result dict against another."""
    k = _key(want)
    assert torch.equal(got[k], want[k]), k
    assert got["start_pos"] == want["start_pos"] and got["real_len"] == want["real_len"]


# -- the one-session executor -----------------------------------------------------------


def _one_session(params, n, **kw):
    kw = dict(dict(max_len=128, initial_kv_len=32), **kw)
    jex, eager, graphed = [], [], []
    for spec, jsp, tspec, tsp in _stages(params, n):
        jex.append(JExecutor(jcfg.TINY, spec, jsp, **kw))
        eager.append(Qwen3StageExecutor(tcfg.TINY, tspec, tsp, **kw))
        graphed.append(Qwen3StageExecutor(tcfg.TINY, tspec, tsp, **kw))
        graphed[-1].graphs = _graphs()
    return jex, eager, graphed


def _chain_step(chains, sid, tokens, start_pos):
    """One chunk through each chain (the JAX one first, its hidden state fed
    to every chain's next stage): the graphed chain's results equal the
    eager chain's bit for bit and the JAX chain's at ATOL. Returns the JAX
    logits."""
    jex, eager, graphed = chains
    payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
               "real_len": len(tokens)}
    for j, e, g in zip(jex, eager, graphed):
        jo, eo, go = j.process(sid, payload), e.process(sid, payload), g.process(sid, payload)
        _same(go, eo)
        np.testing.assert_allclose(_np(eo[_key(eo)]), _np(jo[_key(jo)]), rtol=0, atol=ATOL)
        if "logits" in jo:
            assert int(np.argmax(_np(eo["logits"])[0])) == int(np.argmax(_np(jo["logits"])[0]))
            return _np(jo["logits"])[0]
        payload = {"hidden": np.asarray(jo["hidden"]), "start_pos": start_pos,
                   "real_len": len(tokens)}
    raise AssertionError("no logits")


def test_one_session_chain_graphed_equals_eager_and_jax(params):
    """A 58-token prompt on a 2-stage chain, then 12 greedy steps from fill
    58 (the 64-slot buffer grows into 128 at fill 64, and the kv bound goes
    64 -> 128), then a replay at fill 67 and the step after it: bit for bit
    with the eager executors, at ATOL with the JAX chain. Each stage
    captures one graph per (buffer, bound) and replays it after."""
    chains = _one_session(params, 2)
    prompt = np.random.default_rng(3).integers(0, 256, 58).tolist()
    lg = _chain_step(chains, "s", prompt, 0)
    toks = []
    for pos in range(58, 70):
        toks.append(int(np.argmax(lg)))
        lg = _chain_step(chains, "s", [toks[-1]], pos)
    assert len(set(toks)) > 3  # the stream moves
    lg = _chain_step(chains, "s", [toks[9]], 67)  # a replay below the frontier
    assert int(np.argmax(lg)) == toks[10]
    _chain_step(chains, "s", [toks[10]], 68)
    for g in chains[2]:
        assert g.stats()["graphs"] == {"captures": 2, "replays": 12, "resident": 2,
                                       "evictions": 0, "max_graphs": 32}
        assert g.sessions.get("s").max_len == 128
        assert _buffers(g) == {"allocated": 2, "reused": 0, "released": 0, "free": 1}
        g.end_session("s")
        assert g.stats()["buffers"]["free"] == 2 and g.stats()["graphs"]["resident"] == 2
    assert chains[1][0].stats()["graphs"]["captures"] == 0  # graphs None: eager


@pytest.fixture
def frozen_fill(monkeypatch):
    """A planted fault: stage_step captured with each row's fill frozen at
    its value in the warm-up before the capture (a host value baked into
    the graph); eager calls stay right."""
    real = tq.stage_step
    seen, frozen = {}, {}

    def faulty(params, cfg, x, k_cache, v_cache, fill, **kw):
        key = fill.data_ptr()  # a graph's static fill buffer
        if _in_graph.active:
            vals = frozen.setdefault(key, seen[key])
            fill = torch.zeros_like(fill)
            for i, v in enumerate(vals):
                fill[i:i + 1].fill_(v)
        else:
            seen[key] = fill.tolist()
        return real(params, cfg, x, k_cache, v_cache, fill, **kw)

    monkeypatch.setattr(tq, "stage_step", faulty)


def test_frozen_fill_breaks_one_session_equality(params, frozen_fill):
    """The harness catches a graph that freezes the fill: the graphed
    chain's second step leaves the eager one's."""
    chains = _one_session(params, 1)
    prompt = [3, 7, 11, 19, 23]
    with pytest.raises(AssertionError):
        lg = _chain_step(chains, "f", prompt, 0)
        for pos in range(5, 9):
            lg = _chain_step(chains, "f", [int(np.argmax(lg))], pos)


@pytest.mark.parametrize("sampling", [None, SAMPLING])
def test_decode_steps_graphed_equals_eager_and_jax(params, sampling):
    """decode_steps windows of 8 from fill 58 (the buffer grows at 64) and a
    replayed window: tokens, real_len and key equal the eager executor's,
    and greedy the JAX executor's too; one graph per (buffer, bounds)."""
    (spec, jsp, tspec, tsp), = _stages(params, 1)
    kw = dict(max_len=128, initial_kv_len=32)
    eager = Qwen3StageExecutor(tcfg.TINY, tspec, tsp, **kw)
    graphed = Qwen3StageExecutor(tcfg.TINY, tspec, tsp, **kw)
    graphed.graphs = _graphs()
    execs = [eager, graphed] + ([JExecutor(jcfg.TINY, spec, jsp, **kw)] if sampling is None
                                else [])
    prompt = np.random.default_rng(4).integers(0, 256, 58).tolist()
    outs = [ex.process("k", {"tokens": [prompt], "start_pos": 0, "real_len": 58})
            for ex in execs]
    tok = int(np.argmax(_np(outs[0]["logits"])[0]))
    pos, key = 58, None
    for _ in range(3):
        pl = {"tokens": [[tok]], "start_pos": pos, "decode_steps": 8, "seed": 5}
        if sampling is not None:
            pl["sampling"] = sampling
        if key is not None:
            pl["key"] = key
        rs = [ex.process("k", pl) for ex in execs]
        assert all(r == rs[0] for r in rs) and rs[0]["real_len"] == 8
        tok, pos, key = rs[0]["tokens"][0][-1], pos + 8, rs[0]["key"]
    assert len(set(tok for r in rs for tok in r["tokens"][0])) > 2
    again = [ex.process("k", pl) for ex in execs]  # the last window, replayed
    assert all(r == rs[0] for r in again)
    # the first window grows the buffer to 128; its bounds cross 64 -> 128,
    # the next two run at 128 (one graph), the replay too
    assert graphed.stats()["graphs"]["captures"] == 2
    assert graphed.stats()["graphs"]["replays"] == 2


# -- the lane executors ------------------------------------------------------------------


@pytest.fixture(autouse=True)
def gather_path():
    """Pin the JAX lane delta to its gather path (tests/test_torch_adapters.py)."""
    saved = jlora.FORCE_LORA_KERNEL
    jlora.FORCE_LORA_KERNEL = False
    yield
    jlora.FORCE_LORA_KERNEL = saved


@pytest.fixture(scope="module")
def tenant(tmp_path_factory):
    """One synthetic peft tenant (all seven projections, r 4)."""
    cfg = jcfg.TINY
    g = np.random.default_rng(9)
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}
    layers = {n: (g.normal(0, 0.25, (cfg.num_layers, din, 4)).astype(np.float32),
                  g.normal(0, 0.25, (cfg.num_layers, 4, dout)).astype(np.float32))
              for n, (din, dout) in dims.items()}
    root = tmp_path_factory.mktemp("tenant")
    return [jlora.save_adapter(str(root / "ten0"), layers, alpha=8, r=4)]


def _lanes(params, n, tenant, **kw):
    kw = dict(dict(lanes=4, max_len=128), **kw)
    jex, eager, graphed = [], [], []
    for spec, jsp, tspec, tsp in _stages(params, n):
        span = dict(start_layer=spec.start_layer, end_layer=spec.end_layer + 1)
        jex.append(JLanes(jcfg.TINY, spec, jsp, adapters=JRegistry(jcfg.TINY, tenant, **span),
                          **kw))
        for out in (eager, graphed):
            out.append(BatchedStageExecutor(tcfg.TINY, tspec, tsp,
                                            adapters=AdapterRegistry(tcfg.TINY, tenant, **span),
                                            **kw))
        graphed[-1].graphs = _graphs()
    return jex, eager, graphed


def _lane_prefill(chains, sid, tokens, start_pos=0, adapter=None):
    """A prompt chunk through each lane chain; returns the JAX logits."""
    jex, eager, graphed = chains
    stamp = {"adapter": adapter} if adapter else {}
    payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
               "real_len": len(tokens), **stamp}
    for j, e, g in zip(jex, eager, graphed):
        jo, eo, go = j.process(sid, payload), e.process(sid, payload), g.process(sid, payload)
        _same(go, eo)
        np.testing.assert_allclose(_np(eo[_key(eo)]), _np(jo[_key(jo)]), rtol=0, atol=ATOL)
        if "logits" in jo:
            return _np(jo["logits"])[0]
        payload = {"hidden": np.asarray(jo["hidden"]), "start_pos": start_pos,
                   "real_len": len(tokens), **stamp}
    raise AssertionError("no logits")


def _lane_decode(chains, steps):
    """One co-batched decode window of {sid: (token, start_pos)} through
    each lane chain; returns {sid: JAX logits}."""
    jex, eager, graphed = chains
    items = [(sid, {"tokens": [[tok]], "start_pos": pos, "real_len": 1})
             for sid, (tok, pos) in steps.items()]
    for j, e, g in zip(jex, eager, graphed):
        jo, eo, go = j.process_batch(items), e.process_batch(items), g.process_batch(items)
        for a, b, c in zip(jo, eo, go):
            assert not isinstance(a, Exception) and not isinstance(b, Exception), (a, b)
            _same(c, b)
            np.testing.assert_allclose(_np(b[_key(b)]), _np(a[_key(a)]), rtol=0, atol=ATOL)
        if "logits" in jo[0]:
            return {sid: _np(o["logits"])[0] for (sid, _), o in zip(items, jo)}
        items = [(sid, {"hidden": np.asarray(o["hidden"]), "start_pos": p["start_pos"],
                        "real_len": 1}) for (sid, p), o in zip(items, jo)]
    raise AssertionError("no logits")


@pytest.mark.parametrize("stages,block_size", [(2, 0), (1, 8)])
def test_lanes_graphed_equal_eager_and_jax(params, tenant, stages, block_size):
    """Dense lanes on a 2-stage chain, paged lanes (blocks of 8) on a
    whole-model stage, where a prompt's full blocks publish to the prefix
    index. Staggered sessions on 4 lanes: `a` (60 tokens) decodes alone,
    then beside `b`; `b` shares a's first two blocks (paged: mapped from
    the prefix index), then `t`, a tenant, joins. The
    windows run `a` to fill 65 (its chain crosses 8 blocks of 8, so the
    paged table widens 8 -> 16), then `b` replays a step inside its shared
    region, which copy-on-write splits. Every window is bit for bit the
    eager executors' and at ATOL the JAX executors', greedy tokens equal."""
    chains = _lanes(params, stages, tenant, block_size=block_size, prefill_chunk=16)
    rng = np.random.default_rng(6)
    pa = rng.integers(0, 256, 60).tolist()
    pb = pa[:16] + rng.integers(0, 256, 10).tolist()
    pt = rng.integers(0, 256, 12).tolist()
    nxt, pos, streams = {}, {}, {}

    def admit(sid, prompt, adapter=None):
        lg = _lane_prefill(chains, sid, prompt, adapter=adapter)
        nxt[sid], pos[sid], streams[sid] = int(np.argmax(lg)), len(prompt), []

    def window(sids):
        lgs = _lane_decode(chains, {s: (nxt[s], pos[s]) for s in sids})
        for s in sids:
            streams[s].append(nxt[s])
            nxt[s], pos[s] = int(np.argmax(lgs[s])), pos[s] + 1

    admit("a", pa)
    for _ in range(2):
        window(["a"])
    admit("b", pb)
    window(["a", "b"])
    admit("t", pt, adapter="ten0")
    for _ in range(2):
        window(["a", "b", "t"])
    assert pos["a"] == 65 and len(set(streams["a"])) > 2
    # b replays its step at 15, inside the blocks it shares with a's prefix
    lgs = _lane_decode(chains, {"b": (pb[15], 15)})
    np.testing.assert_allclose(lgs["b"], _lane_prefill_logits(chains, pb), rtol=0, atol=ATOL)
    g = chains[2][0]
    st = g.stats()
    assert st["graphs"]["captures"] == len(g.graphs._entries) and st["graphs"]["replays"] > 0
    # the tenant lane rode windows of its own graph, the all-base ones another
    assert {k[-1] for k in g.graphs._entries} == {False, True}
    if block_size:
        assert {k[1] for k in g.graphs._entries} >= {8, 16}  # the table widened
        if stages == 1:
            assert st["paged"]["cow_splits"] >= 1 and st["paged"]["prefix_hit_tokens"] >= 16
    for ex in chains[2]:
        for s in ("a", "b", "t"):
            ex.end_session(s)
        assert ex.stats()["graphs"]["resident"] == ex.stats()["graphs"]["captures"]


def _lane_prefill_logits(chains, prompt):
    """The JAX logits of `prompt[:16]`'s last position, on a fresh session:
    what b's replay at 15 must give."""
    lg = _lane_prefill(chains, "ref", prompt[:16])
    for chain in chains:
        for ex in chain:
            ex.end_session("ref")
    return lg


def test_frozen_fill_breaks_paged_lane_equality(params, tenant, frozen_fill):
    """The harness catches a lane graph that freezes the lanes' fills."""
    chains = _lanes(params, 1, tenant, block_size=8, prefill_chunk=16)
    lg = _lane_prefill(chains, "a", [3, 7, 11, 19, 23])
    tok, pos = int(np.argmax(lg)), 5
    with pytest.raises(AssertionError):
        for _ in range(4):
            lgs = _lane_decode(chains, {"a": (tok, pos)})
            tok, pos = int(np.argmax(lgs["a"])), pos + 1


# -- buffers and graphs: reuse and drops ------------------------------------------------


SLOT = kv_slot_bytes(tcfg.TINY, tcfg.TINY.num_layers)  # one slot of a whole-model buffer


def _solo(params, max_free, **kw):
    """A whole-model executor over 32-slot first buffers whose pool keeps
    idle buffers of up to `max_free` 32-slot buffers' bytes."""
    (_, _, tspec, tsp), = _stages(params, 1)
    ex = Qwen3StageExecutor(tcfg.TINY, tspec, tsp, **dict(dict(max_len=128, initial_kv_len=32),
                                                           **kw))
    ex.graphs = _graphs()
    ex.buffers.max_free_bytes = max_free * 32 * SLOT
    return ex


def _buffers(ex):
    """The pool's counts, without its byte gauges."""
    return {k: v for k, v in ex.stats()["buffers"].items() if "bytes" not in k}


def _session(ex, sid, n=10, steps=2):
    ex.process(sid, {"tokens": [list(range(1, n + 1))], "start_pos": 0, "real_len": n})
    for i in range(steps):
        ex.process(sid, {"tokens": [[5]], "start_pos": n + i, "real_len": 1})


def test_next_session_of_a_bucket_reuses_buffer_and_graphs(params):
    ex = _solo(params, max_free=1)
    _session(ex, "s1")
    ptr = ex.sessions.get("s1").k.data_ptr()
    ex.end_session("s1")
    _session(ex, "s2")
    assert ex.sessions.get("s2").k.data_ptr() == ptr
    assert ex.stats()["graphs"]["captures"] == 1 and ex.stats()["graphs"]["replays"] == 3
    _session(ex, "s3")  # s2 is live: a second buffer, its own graph
    assert _buffers(ex) == {"allocated": 2, "reused": 1, "released": 0, "free": 0}
    ex.end_session("s2")
    ex.end_session("s3")  # the pool holds one: s3's buffer goes, its graph with it
    assert ex.stats()["buffers"]["released"] == 1
    assert ex.stats()["graphs"] == {"captures": 2, "replays": 4, "resident": 1, "evictions": 1,
                                    "max_graphs": 32}
    assert all(k[0] == ptr for k in ex.graphs._entries)


def test_token_graphs_per_slot_counts_every_buffer_and_bound_pair():
    from inferd_tpu_torch.runtime.executor import token_graphs_per_slot

    # buckets 256..4096, each keying the kv bounds 64 up to itself: 3+4+5+6+7
    assert token_graphs_per_slot(256, 4096) == 25
    # buckets 32, 64, 128: bounds {32}, {64}, {64, 128}; a 256 buffer under
    # max_len 64 only ever takes the bound 64
    assert token_graphs_per_slot(32, 128) == 4 and token_graphs_per_slot(256, 64) == 1


def test_waves_of_concurrent_sessions_capture_once(params):
    """Three sessions live at once, their steps interleaved, cross from the
    32-slot into the 64-slot bucket and end together; a second wave of
    three reuses every buffer and every graph: the captures grow with the
    sessions live at once, not with the sessions served (the pool holds
    the six buffers' bytes). The executor's own bound is max_sessions
    buffers of its smallest bucket."""
    from inferd_tpu_torch.runtime.executor import token_graphs_per_slot

    ex = _solo(params, max_free=3 + 3 * 2, max_sessions=3)
    assert (Qwen3StageExecutor(tcfg.TINY, ex.spec, ex.params, max_sessions=3)
            .buffers.max_free_bytes == 3 * 256 * SLOT)
    ex.graphs = _graphs(3 * token_graphs_per_slot(32, 128))
    for wave in range(2):
        sids = [f"w{wave}-{i}" for i in range(3)]
        for sid in sids:
            ex.process(sid, {"tokens": [list(range(1, 11))], "start_pos": 0, "real_len": 10})
        for pos in range(10, 40):
            for sid in sids:
                ex.process(sid, {"tokens": [[5]], "start_pos": pos, "real_len": 1})
        for sid in sids:
            ex.end_session(sid)
        # per session a graph on its 32-slot buffer and one on its 64-slot one
        assert ex.stats()["graphs"]["captures"] == 6
    assert ex.stats()["graphs"]["replays"] == 2 * 3 * 30 - 6
    assert _buffers(ex) == {"allocated": 6, "reused": 6, "released": 0, "free": 6}
    assert ex.stats()["buffers"]["free_bytes"] == 9 * 32 * SLOT


@pytest.mark.parametrize("how", ["end_session", "evict", "sweep", "grow"])
def test_released_buffer_drops_its_graphs(params, how):
    """With no free list, a buffer that leaves its session is freed: its
    graphs go with it (counted as evictions), whichever way it left."""
    ex = _solo(params, max_free=0, max_sessions=1 if how == "evict" else 4,
               session_ttl_s=0.0 if how == "sweep" else 600.0)
    _session(ex, "s1", n=30)  # the 32-slot buffer, its graph at fills 30 and 31
    ptr = ex.sessions.get("s1").k.data_ptr()
    assert [k[0] for k in ex.graphs._entries] == [ptr]
    if how == "end_session":
        ex.end_session("s1")
    elif how == "evict":
        ex.process("s2", {"tokens": [[1, 2, 3]], "start_pos": 0, "real_len": 3})
        assert "s1" not in ex.sessions
    elif how == "sweep":
        assert ex.sessions.sweep() == 1
    else:  # the step at 32 grows the buffer into the 64-slot bucket
        ex.process("s1", {"tokens": [[5]], "start_pos": 32, "real_len": 1})
        assert ex.sessions.get("s1").max_len == 64
    assert ptr not in [k[0] for k in ex.graphs._entries]
    assert ex.stats()["graphs"]["evictions"] == 1 and ex.stats()["buffers"]["released"] == 1


def test_idle_buffers_stay_within_the_pool_bytes_across_buckets(params):
    """Sessions that grow through the 32-, 64- and 128-slot buckets hand
    each outgrown buffer back: the idle buffers of every shape together
    stay within the executor's bound (max_sessions buffers of its smallest
    bucket), the largest released first, and no graph outlives the buffer
    it reads."""
    from inferd_tpu_torch.runtime.executor import token_graphs_per_slot

    (_, _, tspec, tsp), = _stages(params, 1)
    ex = Qwen3StageExecutor(tcfg.TINY, tspec, tsp, max_len=128, initial_kv_len=32,
                            max_sessions=2)
    ex.graphs = _graphs(2 * token_graphs_per_slot(32, 128))
    bound = ex.buffers.max_free_bytes
    assert bound == 2 * 32 * SLOT
    seen = []
    for wave in range(2):
        sids = [f"g{wave}-{i}" for i in range(2)]
        for sid in sids:
            ex.process(sid, {"tokens": [list(range(1, 11))], "start_pos": 0, "real_len": 10})
        for pos in range(10, 100):  # through 32, 64 and 128 slots
            for sid in sids:
                ex.process(sid, {"tokens": [[5]], "start_pos": pos, "real_len": 1})
                seen.append(ex.stats()["buffers"]["free_bytes"])
        assert {ex.sessions.get(sid).max_len for sid in sids} == {128}
        for sid in sids:
            ex.end_session(sid)
            seen.append(ex.stats()["buffers"]["free_bytes"])
    st = ex.stats()["buffers"]
    assert max(seen) <= bound and st["free_bytes"] == bound
    # the two 32-slot buffers stay (every session starts there), the rest go
    assert st["free"] == 2 and st["released"] == st["allocated"] - 2 > 0
    free = {c.k.data_ptr() for v in ex.buffers._free.values() for c in v}
    assert {c.max_len for v in ex.buffers._free.values() for c in v} == {32}
    assert {k[0] for k in ex.graphs._entries} <= free
    assert ex.stats()["graphs"]["evictions"] > 0


def test_sessions_and_buffers_under_concurrent_steps_and_teardown(params):
    """Six threads run sessions (prefill, two steps, end) against a store of
    three live sessions, beside a thread that sweeps and checks, with a
    short switch interval: a live session's buffer is never in the free
    list or held by another session, and at the end every buffer is free or
    released and no graph reads a released one. A session evicted between
    its steps fails its next step with ValueError, as before."""
    import sys
    import threading

    ex = _solo(params, max_free=1, max_sessions=3)
    errors, bad, done = [], [], threading.Event()

    def worker(w):
        for i in range(3):
            sid = f"w{w}-{i}"
            try:
                _session(ex, sid)
            except ValueError:
                pass  # evicted between its steps
            except Exception as e:  # the test reads it back
                errors.append(e)
            finally:
                ex.end_session(sid)

    def monitor():
        while not done.is_set():
            ex.sessions.sweep()
            with ex.sessions._lock, ex.buffers._lock:
                live = [c.k.data_ptr() for c in ex.sessions._caches.values()]
                free = {c.k.data_ptr() for v in ex.buffers._free.values() for c in v}
            if len(set(live)) != len(live) or set(live) & free:
                bad.append((live, free))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
        mon = threading.Thread(target=monitor)
        mon.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        done.set()
        mon.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads) and not mon.is_alive()
    assert not errors and not bad
    st = ex.stats()["buffers"]
    assert len(ex.sessions) == 0 and st["allocated"] == st["free"] + st["released"]
    free = {c.k.data_ptr() for v in ex.buffers._free.values() for c in v}
    assert {k[0] for k in ex.graphs._entries} <= free


# -- whole-model lanes (runtime/batch_executor, core/batch) ----------------------------


@pytest.mark.parametrize("block_size", [0, 8])
def test_batch_lanes_kstep_windows_with_a_tenant_graphed_equal_eager(params, tenant, block_size):
    """The whole-model lane executor with a tenant: a base and a tenant
    session each run decode_steps 4 windows (paged: across blocks of 8)
    and single-token steps. The graphed executor's results equal the eager
    one's exactly, greedy tokens equal the JAX BatchedExecutor's, the
    tenant's stream leaves the base's, and the tenant window replays a
    graph keyed by the adapter pools."""
    from inferd_tpu.runtime.batch_executor import BatchedExecutor as JBatched
    from inferd_tpu_torch.runtime.batch_executor import BatchedExecutor

    jp, tp = params
    kw = dict(lanes=4, max_len=128, window_ms=1.0, block_size=block_size)
    jex = JBatched(jcfg.TINY, jp, adapters=JRegistry(jcfg.TINY, tenant), **kw)
    eager, graphed = (BatchedExecutor(tcfg.TINY, tp, adapters=AdapterRegistry(tcfg.TINY, tenant),
                                      **kw) for _ in range(2))
    graphed.graphs = _graphs()
    prompt = np.random.default_rng(7).integers(0, 256, 13).tolist()
    streams = {}
    for sid, stamp in (("b", {}), ("t", {"adapter": "ten0"})):
        pl = {"tokens": [prompt], "start_pos": 0, "real_len": len(prompt), **stamp}
        outs = [ex.process(sid, pl) for ex in (jex, eager, graphed)]
        _same(outs[2], outs[1])
        out = [int(np.argmax(_np(outs[0]["logits"])[0]))]
        for _ in range(3):
            pl = {"tokens": [[out[-1]]], "start_pos": len(prompt) + len(out) - 1,
                  "decode_steps": 4}
            rs = [ex.process(sid, pl) for ex in (jex, eager, graphed)]
            assert rs[1] == rs[2] and rs[1]["tokens"] == [list(map(int, rs[0]["tokens"][0]))]
            out += rs[1]["tokens"][0]
        pl = {"tokens": [[out[-1]]], "start_pos": len(prompt) + len(out) - 1, "real_len": 1}
        outs = [ex.process(sid, pl) for ex in (jex, eager, graphed)]
        _same(outs[2], outs[1])
        np.testing.assert_allclose(_np(outs[1]["logits"]), _np(outs[0]["logits"]), atol=ATOL)
        streams[sid] = out
    assert streams["t"] != streams["b"] and len(set(streams["b"])) > 2
    keys = list(graphed.graphs._entries)
    # a tenant window: run_window's key (8 fields) ends in the pools' address
    assert any(len(k) == 8 and k[-1] is not None for k in keys)
    st = graphed.stats()["graphs"]
    assert st["replays"] >= 2 and st["captures"] == len(keys)


def test_batched_engine_graphed_windows_equal_eager(params):
    """BatchedEngine.generate_all with its windows graphed (the fake
    backend) gives the eager engine's streams at chunk 1 and 4, sampled,
    and replays its graphs."""
    from inferd_tpu_torch.core.batch import BatchedEngine

    sc = tcfg.SamplingConfig(**SAMPLING)
    prompts = [np.random.default_rng(i).integers(0, 256, n).tolist()
               for i, n in enumerate((5, 17, 30))]
    eager = BatchedEngine(tcfg.TINY, params[1], lanes=2, max_len=64, sampling_cfg=sc)
    graphed = BatchedEngine(tcfg.TINY, params[1], lanes=2, max_len=64, sampling_cfg=sc)
    graphed.graphs = _graphs()
    for chunk in (1, 4):
        want = eager.generate_all(prompts, max_new_tokens=9, seed=3, chunk=chunk)
        assert graphed.generate_all(prompts, max_new_tokens=9, seed=3, chunk=chunk) == want
    st = graphed.graph_stats()
    assert st["captures"] <= 4 and st["replays"] >= 4 * st["captures"]
