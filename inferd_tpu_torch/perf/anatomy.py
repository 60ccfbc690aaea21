"""Step anatomy: where does a decode step's time go? (port of
inferd_tpu/perf/anatomy.py)

One decode step is cut into phases built from the SAME model components the
real step runs (models/qwen3's blocks, the production sampler, the cache
write), each timed alone:

    embed      token-id gather from the embedding table
    attention  L layers: input norm + q/k/v projections + RoPE + attention
               over the populated cache (the production kernel: flash_gqa
               with device spans and the step's kv bound, or, paged,
               paged_decode_gqa through a block table) + o_proj + residual
    mlp        L layers: pre-norm + SwiGLU (or the MoE layer) + residual
    lm_head    final norm + unembed product (the quantized shadow if any)
    sampling   the sampler over a [B, V] row, from uniforms drawn beforehand
    kv_write   one slot of every layer's K and V written in place
    dispatch   HOST cost: the eager, host-driven step (the uniforms drawn
               per step, one host read per token) minus the graphed step

Timing: on the card each phase body is chained `short` and `long_` times
inside one captured CUDA graph each (utils/cuda_graph), and the two graphs
are replayed in interleaved pairs, each replay followed by a synchronize
(utils/profiling.interleaved_pair_times + paired_delta_stats): the fixed
cost of a replay cancels, and a phase's ms is its device time per
iteration with no host dispatch in it. This is the counterpart of the
reference's jitted `lax.scan` loops. The whole step (models/qwen3.
decode_step, as the engine replays it) is timed the same way, and the
residual against the sum of the phases is `unattributed_ms` (launch gaps
inside the graph, work at phase boundaries). On the CPU the loops are
plain Python loops and the times are the CPU's: they say nothing of the
card.

Each phase gets its bound: its bytes (perf/roofline.decode_step_cost, the
reference's attribution field for field) over the chip's bandwidth.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig, SamplingConfig
from inferd_tpu_torch.core import sampling as samplib
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.ops import attention as attention_ops
from inferd_tpu_torch.ops.quant import apply_quant_mode, qdot
from inferd_tpu_torch.perf import roofline as rl
from inferd_tpu_torch.utils.cuda_graph import GraphCache
from inferd_tpu_torch.utils.profiling import interleaved_pair_times, paired_delta_stats

PHASES = (
    "embed", "attention", "mlp", "lm_head", "sampling", "kv_write",
    # host overhead, not device work: per-token ms of the eager K=1 pattern
    # (the host launches every kernel, one read per token) minus the same
    # step replayed from a graph. Excluded from phase_sum / unattributed.
    "dispatch",
)

Carry = Dict[str, torch.Tensor]
Body = Callable[[Carry, int], Carry]  # (carry, iteration) -> carry


def _bounded(x: torch.Tensor) -> torch.Tensor:
    """Rescale a residual-stream carry so it cannot diverge over a long
    loop with random weights (O(B*H): noise next to the phase's reads)."""
    xf = x.float()
    return (xf / (1.0 + xf.abs().amax())).to(x.dtype)


def _chain(body: Body, n: int) -> Callable[..., Carry]:
    def run(**carry):
        for j in range(n):
            carry = body(carry, j)
        return carry

    return run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loops(body: Body, operand: Carry, short: int, long_: int,
           graphs: Optional[GraphCache], name: str):
    """(run_short, run_long): each runs its chain of `body` from `operand`
    and waits for the device. On the card each chain is a captured graph
    (warmed up and captured here, once), so a run is one replay."""
    if graphs is None:
        return (lambda: _chain(body, short)(**operand),
                lambda: _chain(body, long_)(**operand))
    entries = [graphs.capture_only((name, n), _chain(body, n), operand) for n in (short, long_)]
    return tuple(lambda e=e: graphs.replay(e) for e in entries)


def _measure(run_s, run_l, short: int, long_: int, pairs: int, device: torch.device):
    """Per-iteration ms from (run_short, run_long) in interleaved pairs, the
    device synchronized after each window. Returns (ms, n_valid, spread_pt)."""

    def timer(fn):
        def t() -> float:
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            return time.perf_counter() - t0

        return t

    ts, tl = interleaved_pair_times(timer(run_s), timer(run_l), pairs)
    per_s, n_valid, spread, _ = paired_delta_stats(ts, tl, short, long_)
    return per_s * 1e3, n_valid, spread


def _phase_record(ms: float, n_valid: int, spread: float, b: int,
                  chip: rl.ChipSpec) -> Dict[str, Any]:
    roof_ms = b / (chip.hbm_gbps * 1e9) * 1e3
    return {
        "ms": round(ms, 4),
        "bytes": int(b),
        "roofline_ms": round(roof_ms, 4),
        "roofline_frac": round(roof_ms / ms, 4) if ms > 0 else None,
        "pairs_valid": n_valid,
        "spread_pt": spread,
    }


def _build_suite(
    cfg: ModelConfig,
    params: Optional[Any],
    quant: str,
    ctx: int,
    batch: int,
    short: int,
    long_: int,
    sampling: Optional[SamplingConfig],
    paged_block_size: int,
    device: torch.device,
) -> Dict[str, Any]:
    """Every phase body with its operand, the whole step, the host-driven
    eager step and the bytes of each phase, for ONE configuration. Shared
    by profile_step and AnatomySession: the bodies close over the same
    tensors, so a session can keep their captured loops."""
    sc = sampling or SamplingConfig()
    n_layers = cfg.num_layers
    if params is None:
        params = qwen3.init_params(cfg, torch.Generator(device).manual_seed(0), device)
        params = apply_quant_mode(quant, params, tie_word_embeddings=cfg.tie_word_embeddings)
    max_len = ctx + long_ + short + 16
    nkv, d, h = cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    gen = torch.Generator(device).manual_seed(1)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale
        return x.to(dtype)

    kvshape = (n_layers, batch, max_len, nkv, d)
    kc = randn(*kvshape, dtype=cfg.kv_torch_dtype, scale=0.3)
    vc = randn(*kvshape, dtype=cfg.kv_torch_dtype, scale=0.3)
    hid0 = randn(batch, 1, h, dtype=cfg.torch_dtype)
    logits0 = randn(batch, cfg.vocab_size)
    eps, p1 = cfg.rms_norm_eps, cfg.rms_norm_plus_one
    greedy = sc.temperature == 0.0
    n_cand = samplib.candidate_count(cfg.vocab_size, sc.top_k)
    # the uniforms of every iteration, drawn beforehand (the engine draws
    # them outside its graphs too); the host-driven step draws its own
    key, subs = samplib.prng_key(0), []
    for _ in range(long_):
        key, sub = samplib.split_key(key)
        subs.append(sub)
    u_all = None if greedy else torch.stack([samplib.uniforms(s, (batch, n_cand), device)
                                             for s in subs])
    ctx_col = torch.full((batch,), ctx, dtype=torch.int64, device=device)
    q_positions = ctx_col[:, None]
    cos, sin = qwen3.rope_cos_sin(q_positions, d, cfg.rope_theta, cfg)
    attn_bound = qwen3.kv_bucket(ctx + 1, max_len)
    sampling_args = (sc.temperature, sc.top_k, sc.top_p, sc.min_p)

    # ---- the whole step: the engine's decode_step from fill ctx ------------
    def step_body(c: Carry, j: int) -> Carry:
        tok, fill, active, _lp, _ti, _tl = qwen3.decode_step(
            params, cfg, kc, vc, c["tok"], c["fill"], c["active"], None,
            None if greedy else c["u_all"][j], qwen3.kv_bucket(ctx + j + 1, max_len),
            *sampling_args)
        return dict(c, tok=tok, fill=fill, active=active)

    step0 = {"tok": torch.full((batch,), 7, dtype=torch.int64, device=device),
             "fill": ctx_col, "active": torch.ones(batch, dtype=torch.bool, device=device)}
    if not greedy:
        step0["u_all"] = u_all

    def eager_step(c: Carry, sub) -> Carry:
        """The host-driven K=1 step: the uniforms drawn for this step, the
        step's kernels launched by the host, no graph."""
        u = None if greedy else samplib.uniforms(sub, (batch, n_cand), device)
        tok, fill, active, _lp, _ti, _tl = qwen3.decode_step(
            params, cfg, kc, vc, c["tok"], c["fill"], c["active"], None, u,
            qwen3.kv_bucket(int(c["n"]) + ctx + 1, max_len), *sampling_args)
        return {"tok": tok, "fill": fill, "active": active, "n": c["n"] + 1}

    # ---- embed -------------------------------------------------------------
    def embed_body(c: Carry, _j: int) -> Carry:
        tok = c["tok"]
        e = qwen3.embed(params, tok, cfg)
        bump = (e[:, :, 0].float() * 1e3).to(torch.int64) % 7
        return {"tok": (tok + 1 + bump) % cfg.vocab_size}

    # ---- attention (projections + rope + attend + o_proj, all L layers) ----
    # paged: per layer, K/V live in a PERMUTED block pool and the attend
    # reads them through the block table by the production paged read
    # (ops.attention.decode_gqa(block_table=) -> paged_decode_gqa)
    if paged_block_size > 0:
        bs = int(paged_block_size)
        nb = -(-max_len // bs)
        pad = nb * bs - max_len
        kc_pad = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
        vc_pad = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
        perm = np.random.RandomState(0).permutation(batch * nb)
        inv = np.argsort(perm)
        perm_t = torch.as_tensor(perm, device=device)
        kpool = kc_pad.reshape(n_layers, batch * nb, bs, nkv, d)[:, perm_t].contiguous()
        vpool = vc_pad.reshape(n_layers, batch * nb, bs, nkv, d)[:, perm_t].contiguous()
        block_table = torch.as_tensor(inv.reshape(batch, nb), dtype=torch.int32, device=device)
    else:
        kpool = vpool = block_table = None
    layers = params["layers"]

    def attn_body(c: Carry, _j: int) -> Carry:
        hh = c["h"]
        for i in range(n_layers):
            lp = {name: a[i] for name, a in layers.items()}
            x = qwen3.rms_norm(hh, lp["input_norm"], eps, p1)
            q, k, v = qdot(x, lp["q_proj"]), qdot(x, lp["k_proj"]), qdot(x, lp["v_proj"])
            if cfg.attn_bias:
                q, k, v = q + lp["q_bias"], k + lp["k_bias"], v + lp["v_bias"]
            q = q.reshape(batch, 1, q.shape[-1] // d, d)
            k = k.reshape(batch, 1, k.shape[-1] // d, d)
            if cfg.qk_norm:
                q = qwen3.rms_norm(q, lp["q_norm"], eps)
                k = qwen3.rms_norm(k, lp["k_norm"], eps)
            q = qwen3.apply_rope(q, cos, sin)
            qwen3.apply_rope(k, cos, sin)  # the step's work; the write is kv_write's
            sinks = lp["sinks"] if cfg.attn_sinks else None
            if block_table is not None:
                attn = attention_ops.decode_gqa(
                    q, kpool[i], vpool[i], q_positions, ctx_col, scale=cfg.attn_scale,
                    softcap=cfg.attn_logit_softcap, sinks=sinks, block_table=block_table)
            else:
                attn = qwen3._attend(cfg, q, kc[i], vc[i], q_positions, ctx_col, sinks=sinks,
                                     q_start=ctx_col, kv_bound=attn_bound)
            out = qdot(attn, lp["o_proj"])
            if cfg.o_bias:
                out = out + lp["o_bias"]
            hh = hh + out.to(hh.dtype)
        return {"h": _bounded(hh)}

    # ---- mlp ---------------------------------------------------------------
    act = qwen3.act_fn(cfg)

    def mlp_body(c: Carry, _j: int) -> Carry:
        hh = c["h"]
        for i in range(n_layers):
            lp = {name: a[i] for name, a in layers.items()}
            x = qwen3.rms_norm(hh, lp["post_norm"], eps, p1)
            out = qwen3.moe_mlp(lp, cfg, x) if cfg.is_moe else qwen3.swiglu_mlp(lp, x, act)
            hh = hh + out.to(hh.dtype)
        return {"h": _bounded(hh)}

    # ---- lm head -----------------------------------------------------------
    def head_body(c: Carry, _j: int) -> Carry:
        hh = c["h"]
        logits = qwen3.unembed(params, cfg, hh)
        return {"h": hh + (logits[..., :1] * 1e-6).to(hh.dtype)}

    # ---- sampling ----------------------------------------------------------
    def sample_body(c: Carry, j: int) -> Carry:
        lg = c["lg"]
        if greedy:
            tok = torch.argmax(lg, dim=-1)
        else:
            tok = samplib.sample_from_uniforms(lg, c["u_all"][j], *sampling_args)
        return dict(c, lg=lg + (tok[:, None] % 7).float() * 1e-6)

    sample0 = {"lg": logits0}
    if not greedy:
        sample0["u_all"] = u_all

    # ---- kv cache write ----------------------------------------------------
    rem = max_len - ctx

    def kvw_body(c: Carry, _j: int) -> Carry:
        k_, v_, i = c["k"], c["v"], c["i"]
        pos = ctx + i % rem
        k_.index_copy_(2, pos, k_.index_select(2, i % 2))
        v_.index_copy_(2, pos, v_.index_select(2, i % 2))
        return {"k": k_, "v": v_, "i": i + 1}

    cost = rl.decode_step_cost(cfg, quant=quant, ctx=ctx, batch=batch)
    phase_bytes = {
        "embed": cost.embed_gather_bytes,
        "attention": cost.attn_weight_bytes + cost.kv_read_bytes,
        "mlp": cost.mlp_weight_bytes,
        "lm_head": cost.head_bytes,
        "sampling": 0,
        "kv_write": cost.kv_write_bytes,
    }
    return {
        "runs": {
            "embed": (embed_body, {"tok": torch.full((batch, 1), 7, dtype=torch.int64,
                                                     device=device)}),
            "attention": (attn_body, {"h": hid0}),
            "mlp": (mlp_body, {"h": hid0}),
            "lm_head": (head_body, {"h": hid0}),
            "sampling": (sample_body, sample0),
            "kv_write": (kvw_body, {"k": kc.clone(), "v": vc.clone(),
                                    "i": torch.zeros(1, dtype=torch.int64, device=device)}),
        },
        "phase_bytes": phase_bytes,
        "step_body": step_body,
        "step0": step0,
        "eager_step": eager_step,
        "subs": subs,
        "cost": cost,
        "device": device,
    }


def _device_of(params: Optional[Any], device) -> torch.device:
    if params is not None:
        return params["embed"].device
    return torch.device(device)


def _graphs_for(device: torch.device) -> Optional[GraphCache]:
    return GraphCache() if device.type == "cuda" else None


def _host_loop_ms(suite: Dict[str, Any], short: int, long_: int, pairs: int):
    """Per-token ms of the eager step driven by the host, one read of the
    token per step (the K=1 serving pattern without a graph), from fill
    ctx every window. Returns (ms, n_valid, spread_pt)."""
    dev = suite["device"]
    step0 = {k: suite["step0"][k] for k in ("tok", "fill", "active")}
    eager, subs = suite["eager_step"], suite["subs"]

    def host_run(n: int):
        def run():
            c = dict(step0, n=0)
            for j in range(n):
                c = eager(c, subs[j])
                c["tok"].cpu()  # the per-token host read IS the measured pattern
        return run

    host_run(short)()  # kernels built, allocator warm
    return _measure(host_run(short), host_run(long_), short, long_, pairs, dev)


def profile_step(
    cfg: ModelConfig,
    params: Optional[Any] = None,
    quant: str = "none",
    ctx: int = 256,
    batch: int = 1,
    pairs: int = 3,
    short: int = 4,
    long_: int = 12,
    sampling: Optional[SamplingConfig] = None,
    chip: Optional[rl.ChipSpec] = None,
    phases: Optional[Any] = None,
    with_step: bool = True,
    paged_block_size: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Profile one decode step's anatomy at `ctx` cached tokens.

    `params` default to a seeded random init on `device` with `quant`
    applied (ops.quant.apply_quant_mode, as serving applies it); params
    given are used as they are, on their own device, and `quant` then only
    names the byte accounting. Returns a JSON-ready dict: per phase its ms,
    bytes, bound and share of it; the graphed whole step's ms and bound;
    the unattributed residual.

    `phases` (a subset of PHASES) limits the timed phases; the
    reconciliation fields are null unless every device phase is timed.
    `with_step=False` skips the whole step (its fields go null); `dispatch`
    needs the step as its anchor and raises without it.

    `paged_block_size > 0` times the attention phase through the paged
    read path: each layer's K/V in a permuted block pool read through a
    block table by paged_decode_gqa, as a --paged-kv node reads them."""
    dev = _device_of(params, device)
    chip = chip or (rl.detect_chip() if dev.type == "cuda" else rl.get_chip("cpu"))
    want = set(PHASES if phases is None else phases)
    unknown = want - set(PHASES)
    if unknown:
        raise ValueError(f"unknown anatomy phases: {sorted(unknown)}")
    if "dispatch" in want and not with_step:
        raise ValueError("the dispatch phase needs the graphed step as its anchor: drop it "
                         "from phases or keep with_step=True")
    with torch.no_grad():
        suite = _build_suite(cfg, params, quant, ctx, batch, short, long_, sampling,
                             paged_block_size, dev)
        graphs = _graphs_for(dev)
        device_complete = (set(PHASES) - {"dispatch"}) <= want
        phase_out: Dict[str, Any] = {}
        for name, (body, operand) in suite["runs"].items():
            if name not in want:
                continue
            run_s, run_l = _loops(body, operand, short, long_, graphs, name)
            ms, n_valid, spread = _measure(run_s, run_l, short, long_, pairs, dev)
            phase_out[name] = _phase_record(ms, n_valid, spread, suite["phase_bytes"][name], chip)

        if with_step:
            run_s, run_l = _loops(suite["step_body"], suite["step0"], short, long_, graphs,
                                  "step")
            step_ms, step_valid, step_spread = _measure(run_s, run_l, short, long_, pairs, dev)
        else:
            step_ms, step_valid, step_spread = None, 0, 0.0
        phase_sum = sum(p["ms"] for p in phase_out.values())

        if "dispatch" in want:
            host_ms, host_valid, host_spread = _host_loop_ms(suite, short, long_, pairs)
            phase_out["dispatch"] = {
                "ms": round(max(host_ms - step_ms, 0.0), 4),
                "hostloop_step_ms": round(host_ms, 4),
                "bytes": 0,
                "roofline_ms": 0.0,
                "roofline_frac": None,
                "pairs_valid": host_valid,
                "spread_pt": host_spread,
            }

    whole = rl.roofline(suite["cost"], chip)
    return {
        "preset": cfg.name,
        "quant": quant,
        "ctx": ctx,
        "batch": batch,
        "chip": chip.key,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "paged_block_size": int(paged_block_size),
        "phases": phase_out,
        "step_ms": round(step_ms, 4) if step_ms is not None else None,
        "step_pairs_valid": step_valid,
        "step_spread_pt": step_spread,
        "step_roofline_ms": round(whole.floor_ms, 4),
        "step_roofline_frac": (round(whole.floor_ms / step_ms, 4)
                               if step_ms is not None and step_ms > 0 else None),
        "phase_sum_ms": round(phase_sum, 4) if device_complete else None,
        "unattributed_ms": (round(step_ms - phase_sum, 4)
                            if device_complete and step_ms is not None else None),
        "pairs": pairs,
        "window_iters": [short, long_],
        "graphs": graphs.stats() if graphs is not None else None,
    }


class AnatomySession:
    """Capture-once anatomy over one configuration: the phase suite is
    built once and each phase's short and long graphs are captured at its
    first `measure` and replayed by every later one (the live tick of a
    later slice keeps one session per target)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[Any] = None,
        quant: str = "none",
        ctx: int = 256,
        batch: int = 1,
        short: int = 2,
        long_: int = 4,
        sampling: Optional[SamplingConfig] = None,
        chip: Optional[rl.ChipSpec] = None,
        paged_block_size: int = 0,
        device="cuda",
    ):
        dev = _device_of(params, device)
        self.chip = chip or (rl.detect_chip() if dev.type == "cuda" else rl.get_chip("cpu"))
        self.short, self.long_ = short, long_
        with torch.no_grad():
            self._suite = _build_suite(cfg, params, quant, ctx, batch, short, long_, sampling,
                                       paged_block_size, dev)
        self._graphs = _graphs_for(dev)
        self._loops: Dict[str, Any] = {}

    @property
    def phases(self):
        return tuple(self._suite["runs"])

    def measure(self, phase: str, pairs: int = 1) -> Dict[str, Any]:
        """One phase's measurement (profile_step's `phases[...]` record)."""
        if phase not in self._suite["runs"]:
            raise ValueError(f"unknown session phase {phase!r}; have {self.phases}")
        body, operand = self._suite["runs"][phase]
        with torch.no_grad():
            loops = self._loops.get(phase)
            if loops is None:
                loops = self._loops[phase] = _loops(body, operand, self.short, self.long_,
                                                    self._graphs, phase)
            ms, n_valid, spread = _measure(loops[0], loops[1], self.short, self.long_, pairs,
                                           self._suite["device"])
        return _phase_record(ms, n_valid, spread, self._suite["phase_bytes"][phase], self.chip)
