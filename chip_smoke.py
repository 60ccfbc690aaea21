#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inferd_tpu_torch) end to end on one NVIDIA card.

Phases, one or more lines each; any failure raises and the exit code is 1:

  gpu      the card's name and power limit (nvidia-smi), torch and CUDA
           versions; TF32 off for every comparison
  build    build the CUDA kernels from the sources in this checkout
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes (Qwen3-0.6B: bf16, Nq 16, Nkv 8, D 128)
           and feature cases; the per-row error against a stated tolerance,
           beside the readings of planted faults that it must catch;
           kernel / plain / library (SDPA, yardstick only) times from CUDA
           events, and the bound for the work
  serve    split Qwen3-0.6B (seeded random weights, full width, 28 layers)
           into 2 stages with tools/split_model, start two tools/run_node
           --device cuda processes on loopback, drive 4 greedy requests
           through the port's ChainClient, and check: every request
           completes; each node's flash_gqa launches = 14 x its forward
           passes; the streams equal the same two stage executors driven
           in-process; over teacher-forced prefill and decode steps the
           kernel path's hidden states and logits are near the plain
           attention path's, and planted attention faults are not

Then one JSON line listing every kernel, the nvidia-smi line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run from the root of a checkout: python3 chip_smoke.py
Exits non-zero without a CUDA device, and outside a checkout.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse
from typing import Any, Callable, Dict, List

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# flash_gqa against its plain version, on the same inputs. The error of a
# case is read per output row (one query head at one position: D values),
# scaled by that row's RMS in the plain version, and the worst row counts:
# max |kernel - plain| / rms(plain row). An attention row shrinks as
# 1/sqrt(slots attended) (RMS ~0.009 over 32768 slots of N(0, 1) values),
# so one absolute limit would be loose on long rows and tight on short
# ones; this holds each row to its own size. A row the plain version
# leaves at exactly zero (nothing to attend) must be exactly zero. The
# limit sits between the sound kernel's readings and those of planted
# faults (FAULTS), which every run measures beside it (PERF.md has both).
ATTN_TOL = {"bfloat16": 0.05, "float32": 1e-4}
TILE = 64  # the kernel's kv-tile width (kBlockK in csrc/flash_gqa.cu)
# Planted faults: the kernel run on inputs that reproduce what a wrong
# kernel would compute. A case lists under `blind` the faults that cannot
# change its answer beyond bf16 noise, with the reason beside the case.
FAULTS = ("zeros", "kv_heads_rolled", "last_tile_skipped", "causal_off_by_one")
CASES: List[Dict[str, Any]] = [
    dict(name="prefill_512", s=512, t=512, q_start=0, kv_len=512, stream=False),
    dict(name="chunk_188_at_512", s=188, t=1024, q_start=512, kv_len=700, stream=False),
    # decode: kv_len = q_start + 1 already ends the row, so a causal
    # frontier one slot late changes nothing
    dict(name="decode_T4096", s=1, t=4096, q_start=4095, kv_len=4096, stream=False,
         blind=("causal_off_by_one",)),
    dict(name="main_decode_T1024", s=1, t=1024, q_start=731, kv_len=732, stream=False,
         blind=("causal_off_by_one",)),
    dict(name="long_decode_T32768", s=1, t=32768, q_start=32767, kv_len=32768, stream=True,
         blind=("causal_off_by_one",)),
    dict(name="long_chunk_256_T32768", s=256, t=32768, q_start=32512, kv_len=32768,
         stream=True),
    dict(name="window_256", s=128, t=1024, q_start=512, kv_len=640, window=256, stream=False),
    dict(name="softcap_scale", s=64, t=512, q_start=200, kv_len=264, softcap=50.0,
         scale=1.0 / 16.0, stream=False),
    dict(name="sinks", s=64, t=512, q_start=200, kv_len=264, sinks=True, stream=True),
    dict(name="fp8_kv", s=64, t=512, q_start=200, kv_len=264, fp8=True, stream=False),
    dict(name="ragged_b4", b=4, s=16, t=256, q_start=[0, 50, 100, 200],
         kv_len=[16, 0, 116, 216], stream=False),
    dict(name="f32", s=64, t=256, q_start=100, kv_len=164, dtype="float32", stream=False),
]
MAIN_CASE = "main_decode_T1024"  # the serve phase's decode step: T = 1024 bucket

PROMPT_LENS = (16, 100, 300, 700)
NEW_TOKENS = 32
MAX_LEN = 4096
# The kernel path against the plain-attention path (attn_impl="xla"), both
# teacher-forced over the same tokens: every prompt chunk, then the first
# DECODE_CHECKED decode steps of each served stream. Read at each step: the
# last stage's hidden state on every real row (row_rel_err over the hidden
# width) and the last real token's logits (max |diff| / max |plain logit|).
# 28 bf16 layers compound the kernel's other bf16 rounding of p, so a sound
# kernel reads well above the kernel phase's single-call noise; the limits
# sit between those readings and the planted faults' (E2E_FAULTS, measured
# every run beside them; PERF.md has both).
DECODE_CHECKED = 8
HIDDEN_TOL, LOGIT_TOL = 0.5, 0.05
E2E_FAULTS = ("kv_heads_rolled", "last_tile_skipped", "causal_off_by_one")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- timing -------------------------------------------------------------------


def time_ms(fn: Callable[[], Any], iters: int = 20) -> float:
    """Median device time of one call, from CUDA events around each call.
    The calls are enqueued behind a sleep kernel long enough to cover the
    host's enqueue time, so the device runs them back to back and the
    events bracket device work, not host launch gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * max(0.02, 3 * per_call * iters)))
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


# -- kernels phase --------------------------------------------------------------


def row_rel_err(got, ref, width: int) -> float:
    """Worst row of max |got - ref| / rms(ref row), the outputs cut into
    rows of `width` values. A row that ref leaves at exactly zero reads 0
    if got is zero there too, else inf."""
    import torch

    g = got.float().reshape(-1, width)
    r = ref.float().reshape(-1, width)
    diff = (g - r).abs().amax(dim=1)
    rms = r.pow(2).mean(dim=1).sqrt()
    zero = rms == 0
    rel = torch.where(zero, torch.where(diff == 0, 0.0, math.inf), diff / torch.where(zero, 1.0, rms))
    return rel.max().item()


def _per_row(x, b):
    return list(x) if isinstance(x, (list, tuple)) else [x] * b


def work_of(case: Dict[str, Any], nq: int, nkv: int, d: int) -> Dict[str, float]:
    """Bytes and flops the case's data needs: Q read, O written, each K/V
    slot that some query attends read once; 4 * D flops per unmasked
    (query head, kv slot) pair (q.k and p.v)."""
    import torch

    b, s, t = case.get("b", 1), case["s"], case["t"]
    qs, kl = _per_row(case["q_start"], b), _per_row(case["kv_len"], b)
    win = case.get("window") or 0
    q_item = 4 if case.get("dtype") == "float32" else 2
    kv_item = 1 if case.get("fp8") else q_item
    slots = pairs = 0
    for r in range(b):
        qpos = qs[r] + torch.arange(s)[:, None]
        kpos = torch.arange(t)[None, :]  # kv_start 0 in every case
        m = (kpos < kl[r]) & (kpos <= qpos)
        if win > 0:
            m &= kpos > qpos - win
        pairs += int(m.sum())
        slots += int(m.any(dim=0).sum())
    nbytes = 2 * b * s * nq * d * q_item + 2 * slots * nkv * d * kv_item
    flops = 4.0 * d * nq * pairs
    return {"bytes": nbytes, "flops": flops}


def plant_fault(fault: str, k, v, q_start, kv_len):
    """(k, v, q_start, kv_len) on which the sound kernel computes what a
    kernel with `fault` computes on the given ones: K/V of the wrong kv
    head, the kv tile holding the last valid slot skipped, or a causal
    frontier one slot late."""
    import torch

    if fault == "kv_heads_rolled":  # kv head h reads kv head h - 1's K/V
        k, v = (x.view(torch.uint8).roll(1, dims=2).view(x.dtype) for x in (k, v))
    elif fault == "last_tile_skipped":
        kv_len = (kv_len - 1) // TILE * TILE
        kv_len = kv_len.clamp(min=0) if torch.is_tensor(kv_len) else max(kv_len, 0)
    elif fault == "causal_off_by_one":
        q_start = q_start + 1
    else:
        raise ValueError(f"unknown fault {fault}")
    return k, v, q_start, kv_len


def run_kernel_cases() -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from inferd_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    nq, nkv, d = 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    results, failures = [], []
    for c in CASES:
        b = c.get("b", 1)
        dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16

        def rnd(*shape, dtype=dt):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q = rnd(b, c["s"], nq, d)
        k = rnd(b, c["t"], nkv, d)
        v = rnd(b, c["t"], nkv, d)
        if c.get("fp8"):
            k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
        sinks = rnd(nq, dtype=torch.float32) * 2.0 if c.get("sinks") else None
        q_start, kv_len = c["q_start"], c["kv_len"]
        if isinstance(q_start, list):
            q_start = torch.tensor(q_start, device=dev)
            kv_len = torch.tensor(kv_len, device=dev)
        kw = dict(stream=c["stream"], scale=c.get("scale"), softcap=c.get("softcap", 0.0),
                  window=c.get("window"), sinks=sinks)

        def kernel():
            return A.flash_gqa(q, k, v, q_start, kv_len, **kw)

        def plain():
            return A.flash_gqa_reference(q, k, v, q_start, kv_len, **kw)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = row_rel_err(got, ref, d)
        tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]

        def planted(fault):
            if fault == "zeros":
                return torch.zeros_like(ref)
            return A.flash_gqa(q, *plant_fault(fault, k, v, q_start, kv_len), **kw)

        faults = {f: row_rel_err(planted(f), ref, d) for f in FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")

        library_ms = None
        if sinks is None and not c.get("softcap"):
            # SDPA on the same inputs with the kv heads expanded, as a yardstick
            g = nq // nkv
            qh = q.transpose(1, 2)
            kh = k.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
            vh = v.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
            qs_r = torch.as_tensor(c["q_start"], device=dev).reshape(-1, 1, 1)
            kl_r = torch.as_tensor(c["kv_len"], device=dev).reshape(-1, 1, 1)
            qpos = qs_r + torch.arange(c["s"], device=dev)[None, :, None]
            kpos = torch.arange(c["t"], device=dev)[None, None, :]
            mask = (kpos < kl_r) & (kpos <= qpos)
            if c.get("window"):
                mask &= kpos > qpos - c["window"]
            mask = mask[:, None]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=c.get("scale")))
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, iters=10)
        w = work_of(c, nq, nkv, d)
        peak = PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
        t_bytes, t_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / peak
        row = {
            "case": c["name"], "stream": c["stream"], "B": b, "S": c["s"], "T": c["t"],
            "dtype": str(dt).replace("torch.", "") + ("/fp8-kv" if c.get("fp8") else ""),
            "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("kernels", json.dumps(row))
        results.append(row)
    if failures:
        raise AssertionError("kernel cases failed:\n  " + "\n  ".join(failures))
    return results


# -- serve phase ----------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get_json(url: str, timeout: float = 10.0) -> Dict[str, Any]:
    import http.client

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("GET", u.path)
        r = conn.getresponse()
        body = r.read()
        if r.status != 200:
            raise RuntimeError(f"GET {url}: HTTP {r.status}")
        return json.loads(body)
    finally:
        conn.close()


def start_node(parts: str, stage: int, log_dir: str) -> Dict[str, Any]:
    port = free_port()
    log = open(os.path.join(log_dir, f"node{stage}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "inferd_tpu_torch.tools.run_node", "--parts", parts,
         "--stage", str(stage), "--port", str(port), "--device", "cuda",
         "--max-len", str(MAX_LEN)],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    return {"proc": proc, "port": port, "log": log, "stage": stage}


def wait_ready(node: Dict[str, Any], timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if node["proc"].poll() is not None:
            raise RuntimeError(f"node {node['stage']} exited with {node['proc'].returncode}")
        try:
            http_get_json(f"http://127.0.0.1:{node['port']}/health", timeout=2.0)
            return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"node {node['stage']} not ready after {timeout_s}s")


def stop_nodes(nodes: List[Dict[str, Any]], show_logs: bool = False) -> None:
    """Stop the node processes; with show_logs, print each log's tail (the
    run failed and the work directory holding the logs is about to go)."""
    for n in nodes:
        if n["proc"].poll() is None:
            n["proc"].terminate()
    for n in nodes:
        try:
            n["proc"].wait(timeout=30)
        except subprocess.TimeoutExpired:
            n["proc"].kill()
            n["proc"].wait(timeout=30)
        n["log"].close()
        if show_logs:
            with open(n["log"].name, errors="replace") as f:
                tail = f.read()[-4000:]
            print(f"--- node {n['stage']} log tail ---\n{tail}", file=sys.stderr)


def make_local_client(executors, sampling):
    """A GenerationClient whose transport is the stage executors in this
    process: the same generation loop and chunking as the ChainClient."""
    from inferd_tpu_torch.client.base import GenerationClient

    class LocalChain(GenerationClient):
        def _step_sync(self, session_id, tokens, start_pos):
            import numpy as np

            payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
                       "real_len": len(tokens)}
            for ex in executors:
                out = ex.process(session_id, payload)
                if "logits" in out:
                    return out["logits"].numpy()[0]
                payload = {"hidden": out["hidden"], "start_pos": out["start_pos"],
                           "real_len": out["real_len"]}
            raise RuntimeError("no logits")

        async def _step(self, session_id, tokens, start_pos):
            return await asyncio.to_thread(self._step_sync, session_id, tokens, start_pos)

        async def _end_session(self, session_id):
            for ex in executors:
                ex.end_session(session_id)

    return LocalChain(sampling=sampling, prefill_chunk=512)


def _last_stage_probe_class():
    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    class LastStageProbe(Qwen3StageExecutor):
        """The last stage's executor, returning its hidden state on every
        real row beside the last real token's logits."""

        def _run(self, x, start_pos, cache, real_len):
            hidden, _ = qwen3.forward_layers_cached(
                self.params["layers"], self.cfg, x, start_pos, cache, start_pos)
            last = hidden[:, real_len - 1:real_len]
            return {"hidden": hidden[:, :real_len],
                    "logits": qwen3.unembed(self.params, self.cfg, last)[:, 0]}

    return LastStageProbe


def teacher_forced(executors, prompts, streams) -> List[Any]:
    """(last-stage hidden of the real rows, last logits) per step: each
    prompt's 512-token chunks, then its stream's first DECODE_CHECKED
    tokens one at a time, through the stage executors in this process."""
    import numpy as np

    steps = []
    for i, (p, ids) in enumerate(zip(prompts, streams)):
        feed = [(p[c:c + 512], c) for c in range(0, len(p), 512)]
        feed += [([tok], len(p) + j) for j, tok in enumerate(ids[:DECODE_CHECKED])]
        for toks, pos in feed:
            out = {"tokens": np.asarray([toks], np.int32), "start_pos": pos, "real_len": len(toks)}
            for ex in executors:
                out = ex.process(f"forced-{i}", out)
            steps.append((out["hidden"].float(), out["logits"].float()))
        for ex in executors:
            ex.end_session(f"forced-{i}")
    return steps


def compare_steps(got, ref, hidden_size: int):
    """(worst hidden row error, worst logits error as a share of max |logit|)."""
    h_err = max(row_rel_err(g[0], r[0], hidden_size) for g, r in zip(got, ref))
    l_err = max((g[1] - r[1]).abs().max().item() / r[1].abs().max().item()
                for g, r in zip(got, ref))
    return h_err, l_err


@contextlib.contextmanager
def planted_attention_fault(fault: str):
    """Every flash_gqa kernel launch runs on inputs that reproduce `fault`
    (see plant_fault), until the block ends."""
    from inferd_tpu_torch.ops import attention as A

    launch = A._launch

    def faulty(q, k, v, q_start, kv_len, *rest):
        k, v, q_start, kv_len = plant_fault(fault, k, v, q_start, kv_len)
        return launch(q, k, v, q_start, kv_len, *rest)

    A._launch = faulty
    try:
        yield
    finally:
        A._launch = launch


def run_serve(card: str) -> Dict[str, Any]:
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
    from inferd_tpu_torch.tools import split_model

    LastStageProbe = _last_stage_probe_class()

    cfg = get_config("qwen3-0.6b")
    greedy = SamplingConfig(temperature=0.0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    nodes: List[Dict[str, Any]] = []
    try:
        parts = os.path.join(work, "parts")
        t0 = time.perf_counter()
        split_model.main(["--model", cfg.name, "--stages", "2", "--random-init", "--seed", "0",
                          "--out", parts, "--device", "cuda"])
        torch.cuda.empty_cache()
        say("serve", f"split {cfg.name} into 2 stages (14 + 14 layers, bf16) in "
                     f"{time.perf_counter() - t0:.1f}s")
        nodes = [start_node(parts, s, work) for s in range(2)]
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say("serve", f"2 run_node --device cuda processes ready in {time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        if any(s["kernels"]["flash_gqa"]["launches"] or s["forward_passes"] for s in before):
            raise AssertionError(f"nodes did work before the main path: {before}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
        streams, timing = [], []

        async def drive():
            async with ChainClient([("127.0.0.1", n["port"]) for n in nodes],
                                   sampling=greedy, prefill_chunk=512) as client:
                for p in prompts:
                    stamps: List[float] = []
                    t_req = time.perf_counter()
                    ids = await client.generate_ids(
                        p, max_new_tokens=NEW_TOKENS,
                        on_token=lambda _tok: stamps.append(time.perf_counter()))
                    streams.append(ids)
                    timing.append((t_req, stamps))

        asyncio.run(drive())
        after = stats()
        for p, ids, (t_req, stamps) in zip(prompts, streams, timing):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            say("serve", f"prompt {len(p)} tokens: TTFT {ttft:.1f} ms, decode "
                         f"{tps:.1f} tok/s over {len(stamps) - 1} steps ({card})")

        expected_passes = sum(math.ceil(len(p) / 512) + NEW_TOKENS - 1 for p in prompts)
        launches = 0
        for b_, a_ in zip(before, after):
            passes = a_["forward_passes"] - b_["forward_passes"]
            n_launch = a_["kernels"]["flash_gqa"]["launches"] - b_["kernels"]["flash_gqa"]["launches"]
            layers = a_["end_layer"] - a_["start_layer"] + 1
            say("serve", f"node stage {a_['stage']} on {a_['device']}: {passes} forward passes, "
                         f"flash_gqa launches {n_launch} (= {layers} x {passes}: "
                         f"{n_launch == layers * passes})")
            if passes != expected_passes or n_launch != layers * passes or n_launch == 0:
                raise AssertionError(
                    f"stage {a_['stage']}: {passes} passes (want {expected_passes}), "
                    f"{n_launch} launches (want {layers * passes})")
            launches += n_launch
        stop_nodes(nodes)
        nodes = []

        # the same stage executors in this process, over the same parts
        loaded = [load_stage_checkpoint(stage_checkpoint_path(parts, s), device="cuda")
                  for s in range(2)]
        kernel_ex = [Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
                     for params, spec, _ in loaded]
        plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
        plain_ex = [Qwen3StageExecutor(plain_cfg, spec, params, max_len=MAX_LEN)
                    for params, spec, _ in loaded]

        async def local(executors):
            client = make_local_client(executors, greedy)
            return [await client.generate_ids(p, max_new_tokens=NEW_TOKENS) for p in prompts]

        local_streams = asyncio.run(local(kernel_ex))
        for p, a_, b_ in zip(prompts, streams, local_streams):
            if a_ != b_:
                raise AssertionError(f"prompt {len(p)}: served stream != in-process stream")
        say("serve", "served streams equal the in-process executors' streams, token for token "
                     f"({len(prompts)} requests x {NEW_TOKENS} tokens)")

        probe = [kernel_ex[0], LastStageProbe(cfg, loaded[1][1], loaded[1][0], max_len=MAX_LEN)]
        plain_probe = [plain_ex[0], LastStageProbe(plain_cfg, loaded[1][1], loaded[1][0],
                                                   max_len=MAX_LEN)]
        plain_steps = teacher_forced(plain_probe, prompts, streams)
        readings = {"sound": compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                           cfg.hidden_size)}
        for f in E2E_FAULTS:
            with planted_attention_fault(f):
                readings[f] = compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                            cfg.hidden_size)
        for name, (h_err, l_err) in readings.items():
            say("serve", f"kernel path {'' if name == 'sound' else 'with fault ' + name + ' '}vs "
                         f"plain attention over {len(plain_steps)} teacher-forced steps: hidden "
                         f"row error {h_err:.4g} (tol {HIDDEN_TOL}), logits {l_err:.4%} of max "
                         f"|logit| (tol {LOGIT_TOL:.0%})")
        h_err, l_err = readings.pop("sound")
        if not (h_err <= HIDDEN_TOL and l_err <= LOGIT_TOL):
            raise AssertionError(f"kernel path vs plain attention: hidden {h_err}, logits {l_err}")
        for f, (h_f, l_f) in readings.items():
            if not (h_f > HIDDEN_TOL or l_f > LOGIT_TOL):
                raise AssertionError(f"planted fault {f} passes the checks: hidden {h_f}, "
                                     f"logits {l_f}")
        return {"launches": launches, "passes": expected_passes}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)
        shutil.rmtree(work, ignore_errors=True)


# -- main -----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "inferd_tpu_torch")):
        print(f"chip_smoke: no inferd_tpu_torch package beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("gpu", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")

    from inferd_tpu_torch.ops import build

    info = build.build("flash_gqa")
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"flash_gqa: {os.path.relpath(info['path'], REPO)} "
                 f"({'built' if info['built'] else 'cached'} in {info['seconds']:.1f}s); "
                 f"ptxas: {regs[:2]}")

    cases = run_kernel_cases()

    serve = run_serve(card)
    main_case = next(c for c in cases if c["case"] == MAIN_CASE)
    kernels = {"kernels": [{
        "name": "flash_gqa",
        "route": "cuda",
        "source": "inferd_tpu_torch/csrc/flash_gqa.cu",
        "replaces": "inferd_tpu/ops/attention.py:131",
        "also_replaces": "inferd_tpu/ops/attention.py:218",
        "launches": serve["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_row_err": max(c["row_err"] for c in cases if c["dtype"].startswith("bfloat16")),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": f"{MAIN_CASE}: B 1, S 1, T 1024, Nq 16, Nkv 8, D 128, bf16",
    }]}
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # report the failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
