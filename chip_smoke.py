#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inferd_tpu_torch) end to end on one NVIDIA card.

Phases, one or more lines each; any failure raises and the exit code is 1:

  gpu         the card's name and power limit (nvidia-smi), torch and CUDA
              versions; TF32 off for every comparison
  build       build every CUDA kernel from the sources in this checkout, all
              at once (one nvcc each), with ptxas's registers and spills
  kernels     every kernel against its plain PyTorch version on the card, at
              the main path's shapes (Qwen3-0.6B: bf16, Nq 16, Nkv 8, D 128)
              and feature cases; the per-row error against a stated
              tolerance, beside the readings of planted faults that it must
              catch; kernel / plain / library (or yardstick) times from CUDA
              events, and the bound for the work. flash_gqa's cases (each
              asserts the route flash_plan picks moved its launch counter:
              split-KV or tensor cores), then paged_decode_gqa's (each
              asserts its launch and split counters moved as
              ops.attention.paged_plan cuts the chain, and prints the plan),
              all timed with inputs cold in L2; every kernel case checks
              that two calls give the same bits
  qmatmul     the same for the decode GEMVs (w8a16_matmul, w4a16_matvec
              under both int4 schemes) at Qwen3-0.6B's projection and head
              shapes at 1, 8 and 64 rows, plus f32, ragged-N and odd-K cases,
              timed with every input cold in L2; the library call is
              torch._weight_int8pack_mm / torch._weight_int4pack_mm on the
              same quantized weight, and a yardstick torch.matmul against
              the dequantized bf16 weight. Each case asserts the route
              counter that ops.qmatmul.qgemv_plan names (mma or simt) and
              that two calls give the same bits; planted faults include a
              cluster rank's partial dropped or added twice. Then one line
              per kernel with a stage step's sums at 1 and 8 rows (14
              layers x the seven projections) beside the yardstick's and
              the library call's
  serve       split Qwen3-0.6B (seeded random weights, full width, 28 layers)
              into 2 stages with tools/split_model, start two tools/run_node
              --device cuda processes on loopback, drive 4 greedy requests
              one after another through the port's ChainClient, and check:
              every request completes; each node's flash_gqa launches = 14 x
              its forward passes, of which 14 x its decode passes took the
              split-KV route and 14 x its prefill passes the tensor cores; the
              streams equal the same two stage
              executors driven in-process; over teacher-forced prefill and
              decode steps the kernel path's hidden states and logits are
              near the plain attention path's, and planted attention faults
              are not
  serve_lanes the same parts behind two run_node --stage-lanes 8 --paged-kv 32
              processes; 8 ChainClient sessions run CONCURRENTLY, greedy.
              Checks: every stream completes; per node, paged_decode_gqa
              launches = 14 x its decode dispatches, of which split ones =
              14 x the dispatches whose table width (/stats
              executor.decode_widths) paged_plan splits, flash_gqa launches =
              14 x its prefill dispatches (all on the tensor cores), and the
              mean co-batch is above 1; the
              streams equal two in-process lane executors' over the same
              parts; teacher-forced, the kernel path stays near the plain
              attention path on the paged and on the dense lane layout, and
              planted paged-attention faults do not; TTFT and tok/s
  serve_quant_int8, serve_quant_int4
              the serve traffic on two run_node --quant int8 (then int4)
              processes: streams equal in-process quantized executors'; the
              GEMV kernels' launches exact on both nodes (7 per layer on
              every pass of at most 64 rows, plus the head on the last
              stage), per route as qgemv_plan routes each; teacher-forced,
              the kernel path near the plain-GEMV path and planted GEMV
              faults not; TTFT and tok/s beside serve's
  serve_lanes_quant
              the serve_lanes traffic on --quant int8 lane nodes (every
              decode GEMV at 8 rows), with the same checks on the paged
              lanes
  lora        the fused LoRA lane delta (fused_lane_delta, csrc/lora_delta.cu)
              against its plain version at Qwen3-0.6B's seven projections:
              decode (8 lanes on slots 1,2,3,0,1,2,3,0) at ranks 16 and 64,
              prefill (1 lane, S 256 and 1000) on gate and down, f32, ranks
              1 and 33, and every lane on the base slot (exact zeros); five
              planted faults every case; each line prints ops.lora.lora_plan;
              timed with inputs cold in L2 beside a gather + torch.bmm
              yardstick and the bound. Then the y= mode (the residual add in
              the epilogue) at decode and prefill, bf16: bit-identical to
              (y.float() + delta).to(y.dtype), in place too, base lanes equal
              to y, one launch; timed in place beside the four-launch
              sequence it replaces
  serve_lanes_lora
              three synthetic peft tenants at full width (written from a
              seed by ops.lora.save_adapter) behind two --stage-lanes 8
              --paged-kv 32 --adapters nodes; the serve_lanes traffic with
              the 8 sessions bound round-robin to t0, t1, t2 and the base
              model. Checks: streams equal in-process executors with the
              same registries; tenants' streams differ from the base's and
              base sessions' equal serve_lanes'; teacher-forced, the kernel
              path near the plain-delta path and planted delta faults not;
              base lanes of mixed windows bit-identical to an executor
              without a registry; exact launch counts (98 per dispatch that
              carries a tenant lane, none for all-base dispatches; paged split
              launches as in serve_lanes); 3 loads per node
  generate    the whole model in this process (the serve checkpoints joined,
              bf16) through core.generate.Engine: on the serve prompts (32
              new tokens), generate at chunk 1 and at chunk 8 and
              generate_scan give the same tokens, greedy and under the
              default sampling config (0.6/20/0.95) with one seed; flash_gqa
              launches exact per route (28 tensor-core launches per prefill,
              28 split-KV per decode step); a planted fault (decode_k writes
              each step's K/V one slot early) breaks the chunk equality;
              teacher-forced prefill + 8 decode steps within 5% of max
              |logit| of plain attention; the greedy stream's shared prefix
              with serve's chain stream (printed); bench.py's headline regime
              (64-token prompt, 50 and 150 steps in interleaved pairs via
              utils.profiling) for generate_scan, generate(chunk=1) and
              generate(chunk=8): steady ms/token, e2e tok/s, fixed overhead;
              one decode step's device time against its host time, and the
              sampler's device time per call
  generate_quant
              the same engine on --quant int8 weights: chunk 8 equals chunk 1,
              greedy; w8a16 launches exact per route (7 x 28 + 1 per decode
              step, all simt); the headline regime's generate_scan
  serve_kstep one run_node --device cuda process serving a one-stage split of
              the same model, driven by raw /forward payloads: a prefill, then
              decode_steps 8 windows up to 32 tokens, greedy and sampled, eos
              set to the free run's token 5 (a window stops mid-way); tokens,
              real_len, decode_steps and key equal the in-process executor's;
              /stats launches exact; stage 0 of the two-stage chain answers
              decode_steps with 409 session_state ("single-stage")
  cli         python -m inferd_tpu_torch.tools.generate --model qwen3-0.6b
              --random-init --prompt-ids ... --max-new-tokens 16 --chunk 8 as a
              subprocess, on the card by default: exit 0, 16 ids

Then one JSON line listing every kernel, the nvidia-smi line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run from the root of a checkout: python3 chip_smoke.py
Exits non-zero without a CUDA device, and outside a checkout.
`--only paged,lora` (any of flash, paged, qmm, lora, and generate: the
generate and generate_quant phases on a fresh split) builds the kernels and
runs those phases alone, with no serve phase and no result lines.
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
from typing import Any, Callable, Dict, List, Optional

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # main() runs only on the card
MODEL = "qwen3-0.6b"

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_FLUSH_BYTES = 128 << 20  # read before each cold timed call: > 2x the H100's 50 MB L2

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
TILE = 64  # the planted fault's skipped kv block (the tensor-core route's tile, kMmaTile)
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
    # the route boundary: 8 positions x 2 heads = 16 packed rows is the
    # split-KV route's row tile; 9 positions (18 rows) take the tensor cores
    dict(name="route_rows_16", s=8, t=1024, q_start=700, kv_len=708, stream=False),
    dict(name="route_rows_18", s=9, t=1024, q_start=700, kv_len=709, stream=False),
    # decode over many splits: sinks fold once, after the splits merge (this
    # and the next two decode cases are blind to causal_off_by_one as above:
    # each row's kv_len already ends at its query)
    dict(name="decode_sinks_split", s=1, t=4096, q_start=4095, kv_len=4096, sinks=True,
         stream=False, blind=("causal_off_by_one",)),
    # the window floor (slot 2000) falls inside a split
    dict(name="decode_window_split", s=1, t=4096, q_start=2999, kv_len=3000, window=1000,
         stream=False, blind=("causal_off_by_one",)),
    # a dense-lane decode step: per-lane spans from device meta, one lane empty
    dict(name="dense_lanes_decode_b8_T4096", b=8, s=1, t=4096,
         q_start=[16, 0, 229, 700, 999, 2047, 3099, 3999],
         kv_len=[17, 0, 230, 701, 1000, 2048, 3100, 4000], stream=False,
         blind=("causal_off_by_one",)),
    # the lanes' real prefill dispatch: 256 positions over the gathered T 1024
    # view, spans from device meta
    dict(name="lanes_chunk_256_T1024", s=256, t=1024, q_start=[444], kv_len=[700], stream=False),
    # the one-session path's first 512-token chunk in its T 1024 buffer
    dict(name="session_chunk_512_T1024", s=512, t=1024, q_start=0, kv_len=512, stream=False),
]
MAIN_CASE = "main_decode_T1024"  # the serve phase's decode step: T = 1024 bucket
LANES_CHUNK_CASE = "lanes_chunk_256_T1024"  # a lane node's prefill dispatch (tensor cores)

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

# paged_decode_gqa against its plain version: the same per-row rule and
# limits as flash_gqa (ATTN_TOL). Pools [NB, 32, 8, 128] with each lane's
# chain shuffled through them, garbage in the scratch block 0, the table
# stamped at the chain_clamp width (the power-of-two bucket of the longest
# chain), and each lane's query at position kv_len - 1 (a decode step).
# Planted faults, each the kernel run on inputs that reproduce what a wrong
# kernel would compute: the table read one chain slot late, the walk run
# one block past the chain into the scratch block, the last chain block
# skipped, K/V of the wrong kv head.
PAGED_FAULTS = ("table_shifted", "scratch_scored", "last_block_skipped", "kv_heads_rolled")
PAGED_BS = 32
PAGED_CASES: List[Dict[str, Any]] = [
    dict(name="paged_main_b8_bs32", kv_len=[17, 60, 101, 230, 301, 480, 701, 1000], nb=1025),
    # the chain fills the whole table, so there is no block past it to score
    dict(name="paged_long_b1_4096", kv_len=[4096], nb=129, blind=("scratch_scored",)),
    dict(name="paged_zero_lane", kv_len=[0, 300], nb=64),
    dict(name="paged_window_128", kv_len=[230, 701], window=128, nb=64),
    dict(name="paged_softcap_scale", kv_len=[230, 701], softcap=50.0, scale=1.0 / 16.0, nb=64),
    dict(name="paged_sinks", kv_len=[230, 701], sinks=True, nb=64),
    dict(name="paged_fp8", kv_len=[230, 701], fp8=True, nb=64),
    dict(name="paged_f32", kv_len=[230, 701], dtype="float32", nb=64),
    # one long session among short ones: the imbalance a split chain removes
    dict(name="paged_b8_one_long", kv_len=[4096, 17, 60, 101, 150, 230, 260, 300], nb=200),
]
PAGED_MAIN_CASE = "paged_main_b8_bs32"

# serve_lanes: 8 concurrent sessions through two --stage-lanes nodes
LANES = 8
LANE_PROMPT_LENS = (16, 60, 100, 200, 300, 450, 700, 1000)
LANE_PREFILL_CHUNK = 256  # server-side chunks of the client's 512-token chunks
LANE_NODE_ARGS = ["--stage-lanes", str(LANES), "--paged-kv", str(PAGED_BS),
                  "--prefill-chunk", str(LANE_PREFILL_CHUNK), "--window-ms", "2"]
DENSE_LANE_PROMPTS = (16, 100, 300, 700)  # the dense-lane layout's teacher-forced prompts
LANE_E2E_FAULTS = ("table_shifted", "last_block_skipped")

# The decode GEMVs (csrc/qmatmul.cu) against their plain versions: the same
# per-row rule as attention (row_rel_err over an output row of N values),
# with the same limits. Cases: Qwen3-0.6B's projections [K, N] at the main
# path's row counts (1: one session; 8: the lanes; 64: the largest that
# takes the kernel), the tied head's shadow at 1 and 8 rows, an f32 case, a
# ragged N (a partial last tile; and N % 8 != 0, the single-byte loads) and
# an odd K (int4 one value per byte). Each case runs w8a16 and w4a16 under
# both schemes. Planted faults, each what a wrong kernel would compute:
# the scale of the neighbouring column, the nibbles of each byte swapped
# (packed int4 only), the weight bytes zero-extended instead of sign-
# extended, the last ring stage of the last rank (the plan's stage_k
# values) skipped, the last column tile (the plan's block_n columns)
# skipped, the group index one too high (int4 with more than one group),
# and in the cluster's reduction rank 1's partial dropped or the last
# rank's partial added twice (split K only). The stage, tile and ranks come
# from ops.qmatmul.qgemv_plan, so each fault is one a kernel of this design
# could make. A fault that cannot apply to a case reads null.
QMM_TOL = ATTN_TOL
QMM_FAULTS = ("scale_neighbour_column", "nibbles_swapped", "zero_extended",
              "last_k_chunk_skipped", "n_tail_skipped", "group_off_by_one",
              "rank_dropped", "rank_doubled")
# a stage step of one Qwen3-0.6B stage: 14 layers x the seven projections
QMM_STAGE_LAYERS = 14
QMM_PER_LAYER = {"q_proj": 1, "k_v_proj": 2, "o_proj": 1, "gate_up_proj": 2, "down_proj": 1}
QMM_SHAPES = {  # Qwen3-0.6B, hidden 1024, q 2048, kv 1024, intermediate 3072
    "q_proj": (1024, 2048), "k_v_proj": (1024, 1024), "o_proj": (2048, 1024),
    "gate_up_proj": (1024, 3072), "down_proj": (3072, 1024), "lm_head_q": (1024, 151936),
}
QMM_KERNELS = ("w8a16", "w4a16_grouped", "w4a16_dequant")
QMM_CASES: List[Dict[str, Any]] = (
    [dict(name=f"{s}_m{m}", shape=s, m=m) for s in QMM_SHAPES if s != "lm_head_q"
     for m in (1, 8, 64)]
    + [dict(name=f"lm_head_q_m{m}", shape="lm_head_q", m=m) for m in (1, 8)]
    + [dict(name="gate_up_proj_m8_f32", shape="gate_up_proj", m=8, dtype="float32"),
       dict(name="ragged_n1000_m8", k=1024, n=1000, m=8),
       dict(name="ragged_n333_m3", k=1024, n=333, m=3),
       dict(name="odd_k1023_m8", k=1023, n=1024, m=8)]
)
QMM_MAIN_CASE, QMM_LANE_CASE = "lm_head_q_m1", "gate_up_proj_m8"
# The quantized serve phases: the kernel path against the plain-GEMV path
# (the same executors with each GEMV wrapper's plain version), by the
# HIDDEN_TOL / LOGIT_TOL rule, and planted GEMV faults that must break it.
QUANT_E2E_FAULTS = ("last_k_chunk_skipped", "scale_neighbour_column")

# The fused LoRA lane delta (csrc/lora_delta.cu) against its plain version:
# the output is f32 and both sum the same f32 products in another order, so
# the per-row rule (row_rel_err over an output row of `out` values) holds it
# to 1e-4; rows of base-slot lanes must be exactly zero. Pools of LORA_SLOTS
# slots x LORA_LAYERS layers (a 14-layer stage) in the case's dtype, slot 0
# zero, N(0, 0.05) elsewhere; x N(0, 1). Planted faults, each the kernel run
# on inputs that reproduce what a wrong kernel would compute: each lane reads
# the next slot, the layer one too high, the scale skipped (read as 1), the
# last rank column skipped, the last S tile (LORA_S_TILE rows) skipped.
LORA_TOL = 1e-4
LORA_SLOTS, LORA_LAYERS, LORA_LAYER = 4, 14, 5
LORA_SCALES = (0.0, 2.0, 0.5, 1.25)  # slot 0 is the base adapter
LORA_S_TILE = 16  # kRows in csrc/lora_delta.cu
LORA_FAULTS = ("neighbour_slot", "layer_off_by_one", "scale_skipped",
               "last_rank_column_skipped", "last_s_tile_skipped")
LORA_SHAPES = {  # Qwen3-0.6B's projections [in, out]
    "q_proj": (1024, 2048), "k_proj": (1024, 1024), "v_proj": (1024, 1024),
    "o_proj": (2048, 1024), "gate_proj": (1024, 3072), "up_proj": (1024, 3072),
    "down_proj": (3072, 1024),
}
LORA_DECODE_IDS = [1, 2, 3, 0, 1, 2, 3, 0]
LORA_CASES: List[Dict[str, Any]] = (
    [dict(name=f"decode_{t}_r{r}", target=t, r=r, s=1, ids=LORA_DECODE_IDS)
     for r in (16, 64) for t in LORA_SHAPES]
    + [dict(name=f"prefill_s{s}_{t}_r16", target=t, r=16, s=s, ids=[1])
       for s in (256, 1000) for t in ("gate_proj", "down_proj")]
    + [dict(name="decode_gate_proj_r16_f32", target="gate_proj", r=16, s=1, ids=LORA_DECODE_IDS,
            dtype="float32"),
       dict(name="decode_q_proj_r1", target="q_proj", r=1, s=1, ids=LORA_DECODE_IDS),
       dict(name="decode_q_proj_r33", target="q_proj", r=33, s=1, ids=LORA_DECODE_IDS),
       # every lane on the base slot: exact zeros, so only a fault that
       # reads another slot can show
       dict(name="decode_gate_proj_all_base", target="gate_proj", r=16, s=1, ids=[0] * 8,
            blind=LORA_FAULTS[1:])]
)
LORA_MAIN_CASE, LORA_PREFILL_CASE = "decode_gate_proj_r16", "prefill_s256_gate_proj_r16"
# The y= mode (the residual add in the kernel's epilogue) at decode and at
# prefill, bf16: its output must equal the unfused (y.float() + delta).to(y.dtype)
# bit for bit, base lanes must equal y exactly, and it is held to the plain
# version's sum by the bf16 row rule (ATTN_TOL, its output being bf16); timed
# in place beside the four-launch sequence it replaces (delta, cast, add, cast).
LORA_Y_CASES: List[Dict[str, Any]] = [
    dict(name="y_decode_gate_proj_r16", target="gate_proj", r=16, s=1, ids=LORA_DECODE_IDS),
    dict(name="y_prefill_s256_gate_proj_r16", target="gate_proj", r=16, s=256, ids=[1]),
]
LORA_Y_MAIN_CASE = "y_decode_gate_proj_r16"
# serve_lanes_lora: three tenants over all 28 layers, (name, rank, targets),
# bound round-robin with the base model to the serve_lanes sessions
LORA_TENANTS = (("t0", 16, ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                            "down_proj")),
                ("t1", 8, ("q_proj", "v_proj")),
                ("t2", 32, ("gate_proj", "up_proj", "down_proj")))
LORA_TENANT_B_SD = 0.125  # B ~ N(0, (LORA_TENANT_B_SD / sqrt(r))^2), alpha = 2r (write_tenants)
LORA_E2E_FAULTS = ("neighbour_slot", "layer_off_by_one")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- timing -------------------------------------------------------------------


def time_ms(fn: Callable[[], Any], iters: int = 20, cold: bool = False) -> float:
    """Median device time of one call, from CUDA events around each call.
    The calls are enqueued behind a sleep kernel long enough to cover the
    host's enqueue time, so the device runs them back to back and the
    events bracket device work, not host launch gaps. With `cold`, a read
    of L2_FLUSH_BYTES runs before each call, outside its events, so the
    call finds none of its inputs in L2."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold else None

    def evict():
        if flush is not None:
            flush.sum()

    evict()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evict()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * max(0.02, 3 * per_call * iters)))
    for a, b in zip(starts, ends):
        evict()
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

    dev = torch.device(DEVICE)
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

        plan = A.flash_plan(b, c["s"], c["t"], nq, nkv, dt, q_start, kv_len, c.get("window"))
        counts = (A.flash_gqa.split_launches, A.flash_gqa.mma_launches)
        got = kernel()
        moved = {"split": A.flash_gqa.split_launches - counts[0],
                 "mma": A.flash_gqa.mma_launches - counts[1]}
        again, ref = kernel(), plain()
        torch.cuda.synchronize()
        if moved != {r: int(r == plan.route) for r in moved}:
            raise AssertionError(f"{c['name']}: route counts moved {moved}, plan {plan.route}")
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
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
                qh, kh, vh, attn_mask=mask, scale=c.get("scale")), cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        w = work_of(c, nq, nkv, d)
        peak = PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
        t_bytes, t_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / peak
        row = {
            "case": c["name"], "stream": c["stream"], "B": b, "S": c["s"], "T": c["t"],
            "route": plan.route, "splits": plan.splits, "ctas": plan.splits * plan.row_tiles * b * nkv,
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


def paged_work(kv_len, window: int, b: int, nq: int, nkv: int, d: int, q_item: int,
               kv_item: int) -> Dict[str, float]:
    """Bytes and flops one paged decode step needs: Q read and O written,
    each K/V row a query attends read once; 4 * D flops per (query head,
    attended slot). Each lane's query sits at kv_len - 1."""
    slots = 0
    for n in kv_len:
        qpos = max(n - 1, 0)
        lo = max(qpos - window + 1, 0) if window > 0 else 0
        slots += max(min(n, qpos + 1) - lo, 0)
    return {"bytes": 2 * b * nq * d * q_item + 2 * slots * nkv * d * kv_item,
            "flops": 4.0 * d * nq * slots}


def plant_paged_fault(fault: str, k_pool, v_pool, table, q_positions, kv_len):
    """(pools, table, q_positions, kv_len) on which the sound kernel computes
    what a kernel with `fault` computes on the given ones (PAGED_FAULTS)."""
    import torch

    bs, mb = k_pool.shape[1], table.shape[1]
    kv_len = torch.as_tensor(kv_len, device=table.device).expand(table.shape[0])
    if fault == "table_shifted":  # chain slot j read from table slot j + 1
        table = torch.cat([table[:, 1:], torch.zeros_like(table[:, :1])], dim=1).contiguous()
    elif fault == "scratch_scored":  # one block past the chain, masks open to its end
        nblk = (kv_len + bs - 1) // bs
        room = nblk < mb
        kv_len = torch.where(room, (nblk + 1) * bs, kv_len)
        q_positions = torch.where(room[:, None], kv_len[:, None] - 1, q_positions)
    elif fault == "last_block_skipped":
        kv_len = ((kv_len - 1).div(bs, rounding_mode="floor") * bs).clamp(min=0)
    elif fault == "kv_heads_rolled":  # kv head h reads kv head h - 1's K/V
        k_pool, v_pool = (x.view(torch.uint8).roll(1, dims=2).view(x.dtype).contiguous()
                          for x in (k_pool, v_pool))
    else:
        raise ValueError(f"unknown fault {fault}")
    return k_pool, v_pool, table, q_positions, kv_len


def paged_inputs(c: Dict[str, Any], nq: int, nkv: int, d: int, gen, dev):
    """One paged case's inputs: pools with garbage in the scratch block 0,
    chains shuffled through the pool, the table stamped at the chain_clamp
    width, each lane's query at kv_len - 1."""
    import torch

    dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
    kv_len = c["kv_len"]
    b, nb = len(kv_len), c["nb"]
    chains = [-(-n // PAGED_BS) for n in kv_len]
    mb = 1
    while mb < max(chains):
        mb <<= 1
    perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for lane, n in enumerate(chains):
        table[lane, :n] = perm[used:used + n]
        used += n
    k_pool = torch.randn((nb, PAGED_BS, nkv, d), generator=gen, device=dev)
    v_pool = torch.randn((nb, PAGED_BS, nkv, d), generator=gen, device=dev)
    k_pool[0] = k_pool[0] * 4.0 + 3.0  # scratch garbage: visible if ever scored
    v_pool[0] = v_pool[0] * 4.0 - 3.0
    pool_dt = torch.float8_e4m3fn if c.get("fp8") else dt
    k_pool, v_pool = k_pool.to(pool_dt), v_pool.to(pool_dt)
    q = torch.randn((b, 1, nq, d), generator=gen, device=dev).to(dt)
    kl = torch.tensor(kv_len, device=dev)
    qpos = (kl - 1).clamp(min=0)[:, None]
    sinks = torch.randn((nq,), generator=gen, device=dev) * 2.0 if c.get("sinks") else None
    kw = dict(scale=c.get("scale"), softcap=c.get("softcap", 0.0), window=c.get("window"),
              sinks=sinks)
    return q, k_pool, v_pool, table, qpos, kl, kw


def run_paged_cases() -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from inferd_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    nq, nkv, d = 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    results, failures = [], []
    for c in PAGED_CASES:
        q, k_pool, v_pool, table, qpos, kl, kw = paged_inputs(c, nq, nkv, d, gen, dev)
        dt = q.dtype

        def kernel():
            return A.paged_decode_gqa(q, k_pool, v_pool, table, qpos, kl, **kw)

        def plain():
            return A.paged_decode_gqa_reference(q, k_pool, v_pool, table, qpos, kl, **kw)

        plan = A.paged_plan(len(c["kv_len"]), nkv, table.shape[1], PAGED_BS, dt)
        counts = (A.paged_decode_gqa.launches, A.paged_decode_gqa.split_launches)
        got = kernel()
        moved = (A.paged_decode_gqa.launches - counts[0],
                 A.paged_decode_gqa.split_launches - counts[1])
        again, ref = kernel(), plain()
        torch.cuda.synchronize()
        if moved != (1, int(plan.splits > 1)):
            raise AssertionError(f"{c['name']}: launch counts moved {moved}, plan {plan}")
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
        err = (got.float() - ref.float()).abs().max().item()
        rel = row_rel_err(got, ref, d)
        tol = ATTN_TOL["float32" if dt == torch.float32 else "bfloat16"]
        faults = {f: row_rel_err(A.paged_decode_gqa(
            q, *plant_paged_fault(f, k_pool, v_pool, table, qpos, kl), **kw), ref, d)
            for f in PAGED_FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")

        yardstick_ms = None
        if kw["sinks"] is None and not kw["softcap"]:
            # gather + SDPA with the kv heads expanded: a yardstick only, no
            # single PyTorch call computes paged attention
            g = nq // nkv
            t = table.shape[1] * PAGED_BS
            kpos = torch.arange(t, device=dev)[None, None, None, :]
            mask = (kpos < kl[:, None, None, None]) & (kpos <= qpos[:, :, None, None])
            if kw["window"]:
                mask &= kpos > qpos[:, :, None, None] - kw["window"]
            qh = q.transpose(1, 2)

            def yardstick():
                kd, vd = A.gather_block_kv(k_pool, v_pool, table)
                kh = kd.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
                vh = vd.to(dt).repeat_interleave(g, dim=2).transpose(1, 2)
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      scale=kw["scale"])

            yardstick_ms = time_ms(yardstick, cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        q_item = 4 if dt == torch.float32 else 2
        w = paged_work(c["kv_len"], c.get("window") or 0, len(c["kv_len"]), nq, nkv, d, q_item,
                       k_pool.element_size())
        peak = PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
        t_bytes, t_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / peak
        row = {
            "case": c["name"], "B": len(c["kv_len"]), "MB": table.shape[1], "bs": PAGED_BS,
            "kv_len": c["kv_len"], "plan": plan._asdict(),
            "ctas": plan.splits * nkv * len(c["kv_len"]),
            "dtype": str(dt).replace("torch.", "") + ("/fp8-pools" if c.get("fp8") else ""),
            "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "gather_sdpa_yardstick_ms": yardstick_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("kernels", json.dumps(row))
        results.append(row)
    if failures:
        raise AssertionError("paged kernel cases failed:\n  " + "\n  ".join(failures))
    return results


# -- decode GEMV cases ------------------------------------------------------------


def qmm_call(kernel: str, x, q8, q4):
    """One GEMV wrapper call: the kernel on CUDA tensors."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.w8a16_matmul(x, q8.q, q8.scale)
    return Q.w4a16_matvec(x, q4, kernel.split("_")[1])


def qmm_plain(kernel: str, x, q8, q4):
    """The same call's plain version."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.w8a16_matmul_reference(x, q8.q, q8.scale)
    return Q.w4a16_matvec_reference(x, q4, kernel.split("_")[1])


def qmm_plan(kernel: str, x, q8, q4):
    """ops.qmatmul.qgemv_plan of the case's launch."""
    from inferd_tpu_torch.ops import qmatmul as Q

    if kernel == "w8a16":
        return Q.qgemv_plan(x.shape[0], x.shape[1], q8.q.shape[1], 1, "int8", "grouped", x.dtype)
    k, n = q4.shape
    return Q.qgemv_plan(x.shape[0], k, n, q4.scale.shape[0], "int4" if q4.packed else "int4_bytes",
                        kernel.split("_")[1], x.dtype)


QMM_INPUT_FAULTS = ("scale_neighbour_column", "last_k_chunk_skipped", "rank_dropped",
                    "rank_doubled")


def qmm_fault_inputs(fault: str, x, scale, k: int, plan):
    """(x, scale) on which the sound kernel computes what a kernel with
    `fault` computes, for the faults that live in the inputs (under the
    launch's plan): the scale of the neighbouring column, the last stage of
    the last rank skipped, a rank's partial dropped or added twice (x zero
    or doubled over that rank's K range: exact). None where the plan has no
    such rank (one rank: no reduction)."""
    if fault == "scale_neighbour_column":
        return x, scale.roll(1, dims=-1).contiguous()
    ranges = plan.rank_ranges(k)
    if fault == "last_k_chunk_skipped":
        lo, hi = ranges[-1]
        lo = plan.stage_starts(lo, hi)[-1]
    elif fault in ("rank_dropped", "rank_doubled"):
        if plan.cluster == 1:
            return None
        lo, hi = ranges[1] if fault == "rank_dropped" else ranges[-1]
    else:
        raise ValueError(f"unknown fault {fault}")
    x = x.clone()
    x[:, lo:hi] *= 2 if fault == "rank_doubled" else 0
    return x, scale


def qmm_fault(fault: str, kernel: str, x, q8, q4):
    """What a GEMV kernel with `fault` computes on the case (QMM_FAULTS),
    or None where the fault cannot apply."""
    import torch

    from inferd_tpu_torch.ops import quant

    int4 = kernel != "w8a16"
    k = x.shape[1]
    plan = qmm_plan(kernel, x, q8, q4)
    if fault in QMM_INPUT_FAULTS:
        inputs = qmm_fault_inputs(fault, x, q4.scale if int4 else q8.scale, k, plan)
        if inputs is None:
            return None
        xf, sf = inputs
        if int4:
            return qmm_call(kernel, xf, q8, dataclasses.replace(q4, scale=sf))
        return qmm_call(kernel, xf, quant.QuantWeight(q8.q, sf), q4)
    if fault == "nibbles_swapped":
        if not (int4 and q4.packed):
            return None
        b = q4.q.view(torch.uint8)
        return qmm_call(kernel, x, q8, dataclasses.replace(q4, q=((b << 4) | (b >> 4)).view(torch.int8)))
    if fault == "zero_extended":  # each byte read as 0..255, each nibble as 0..15
        if not int4:
            return qmm_plain(kernel, x, quant.QuantWeight(q8.q.view(torch.uint8).float(), q8.scale), q4)
        b = q4.q.view(torch.uint8).int()
        if q4.packed:
            vals = torch.stack([b & 0xF, b >> 4], dim=1).reshape(-1, b.shape[1])
        else:
            vals = b
        return qmm_plain(kernel, x, q8, quant.Int4Weight(vals.float(), q4.scale, packed=False))
    if fault == "n_tail_skipped":
        out = qmm_call(kernel, x, q8, q4).clone()
        out[:, (out.shape[1] - 1) // plan.block_n * plan.block_n:] = 0
        return out
    if fault == "group_off_by_one":
        if not int4 or q4.scale.shape[0] < 2:
            return None
        return qmm_call(kernel, x, q8,
                        dataclasses.replace(q4, scale=q4.scale.roll(-1, dims=0).contiguous()))
    raise ValueError(f"unknown fault {fault}")


def qmm_library(kernel: str, x, q8, q4):
    """One PyTorch call that computes the case's product from the same
    quantized weight, its repacking done here, outside any timing: for
    w8a16 torch._weight_int8pack_mm (int8 [N, K], scales in x's dtype), for
    w4a16 torch._weight_int4pack_mm (bf16 only, groups of 32-256; the
    values biased to 0..15, two per byte with the even K index in the high
    nibble, repacked by torch._convert_weight_to_int4pack; scale and a zero
    point of 0 per group). Returns (call, None), or (None, why) where this
    torch has no such call for the case. Timed beside the kernel only: the
    port never calls either."""
    import torch

    try:
        if kernel == "w8a16":
            wt, s = q8.q.t().contiguous(), q8.scale.to(x.dtype)
            call = lambda: torch._weight_int8pack_mm(x, wt, s)  # noqa: E731
        else:
            k, n = q4.shape
            gs = k // q4.scale.shape[0]
            if x.dtype != torch.bfloat16 or gs not in (32, 64, 128, 256) or n % 8 or k % 128:
                return None, f"_weight_int4pack_mm takes bf16, groups of 32-256, N % 8 == 0 " \
                             f"and K % 128 == 0 (here {x.dtype}, group {gs}, N {n}, K {k})"
            u = (q4.unpacked().int() + 8).t()  # [N, K] in 0..15
            wp = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
            sz = torch.stack([q4.scale, torch.zeros_like(q4.scale)], dim=-1).to(
                torch.bfloat16).contiguous()  # [G, N, 2]
            call = lambda: torch._weight_int4pack_mm(x, wp, gs, sz)  # noqa: E731
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def qmm_work(m: int, k: int, n: int, x_item: int, q_bytes: int, groups: int) -> Dict[str, float]:
    """Bytes and flops of one GEMV: the weight as stored and its f32 scales
    read once, x read once, the output written once; 2*M*K*N flops."""
    return {"bytes": q_bytes + 4 * n * groups + (m * k + m * n) * x_item,
            "flops": 2.0 * m * k * n}


def qmm_wrapper(kernel: str):
    from inferd_tpu_torch.ops import qmatmul as Q

    return Q.w8a16_matmul if kernel == "w8a16" else Q.w4a16_matvec


def qmm_stage_sums(rows: List[Dict[str, Any]], kernel: str, m: int) -> Dict[str, Any]:
    """Device ms of one stage step's GEMVs at m rows (QMM_STAGE_LAYERS x the
    seven projections, k_v and gate_up twice) by the kernel, the bf16
    yardstick and the library call, summed from the cases; None where a
    case has no time."""
    by = {r["case"]: r for r in rows if r["kernel"] == kernel}

    def total(key):
        vals = [by[f"{s}_m{m}"][key] for s in QMM_PER_LAYER]
        if any(v is None for v in vals):
            return None
        return QMM_STAGE_LAYERS * sum(n * v for n, v in zip(QMM_PER_LAYER.values(), vals))

    return {"kernel": kernel, "M": m, "ms": total("ms"),
            "dequant_matmul_yardstick_ms": total("dequant_matmul_yardstick_ms"),
            "library_ms": total("library_ms"), "bound_ms": total("bound_ms")}


def run_qmm_cases() -> List[Dict[str, Any]]:
    import torch

    from inferd_tpu_torch.ops import quant

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    results, failures = [], []
    for c in QMM_CASES:
        k, n = QMM_SHAPES[c["shape"]] if "shape" in c else (c["k"], c["n"])
        dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
        # N(0, 0.02) weights as the seeded init draws them, quantized as a
        # node quantizes at load
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(dt)
        q8, q4 = quant.quantize(w), quant.quantize_int4(w)
        del w
        x = torch.randn((c["m"], k), generator=gen, device=dev).to(dt)
        tol = QMM_TOL["float32" if dt == torch.float32 else "bfloat16"]
        for kernel in QMM_KERNELS:
            plan = qmm_plan(kernel, x, q8, q4)
            wrapper = qmm_wrapper(kernel)
            before = {r: getattr(wrapper, f"{r}_launches") for r in ("mma", "simt")}
            got, ref = qmm_call(kernel, x, q8, q4), qmm_plain(kernel, x, q8, q4)
            again = qmm_call(kernel, x, q8, q4)
            torch.cuda.synchronize()
            name = f"{c['name']}/{kernel}"
            moved = {r: getattr(wrapper, f"{r}_launches") - v for r, v in before.items()}
            if moved != {r: 2 if r == plan.route else 0 for r in moved}:
                raise AssertionError(f"{name}: route counters moved {moved}, want 2 on "
                                     f"{plan.route} ({plan})")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls on the same inputs differ")
            if not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"{name}: kernel output is not finite")
            err = (got.float() - ref.float()).abs().max().item()
            rel = row_rel_err(got, ref, n)
            faults = {}
            for f in QMM_FAULTS:
                out = qmm_fault(f, kernel, x, q8, q4)
                faults[f] = None if out is None else row_rel_err(out, ref, n)
            if not rel <= tol:
                failures.append(f"{name}: row error {rel} > tol {tol}")
            for f, reading in faults.items():
                if reading is not None and not reading > tol:
                    failures.append(f"{name}: planted fault {f} reads {reading} <= tol {tol}")
            wq = q8 if kernel == "w8a16" else q4
            w_deq = wq.dequantize(dt)  # what --quant none reads: a yardstick
            yardstick_ms = time_ms(lambda: torch.matmul(x, w_deq), cold=True)
            del w_deq
            lib, lib_note = qmm_library(kernel, x, q8, q4)
            library_ms = library_err = None
            if lib is not None:
                library_ms = time_ms(lib, cold=True)
                library_err = row_rel_err(lib(), ref, n)
            del lib
            ms = time_ms(lambda: qmm_call(kernel, x, q8, q4), cold=True)
            plain_ms = time_ms(lambda: qmm_plain(kernel, x, q8, q4), iters=10, cold=True)
            groups = 1 if kernel == "w8a16" else q4.scale.shape[0]
            w_ = qmm_work(c["m"], k, n, x.element_size(), wq.q.numel(), groups)
            t_bytes = w_["bytes"] / HBM_BYTES_PER_S
            t_ops = w_["flops"] / PEAK_FLOPS["float32" if dt == torch.float32 else "bfloat16"]
            row = {
                "case": c["name"], "kernel": kernel, "M": c["m"], "K": k, "N": n,
                "route": plan.route, "cluster": plan.cluster, "k_per_rank": plan.k_per_rank,
                "stage_k": plan.stage_k, "depth": plan.depth, "ctas": plan.ctas,
                "bitwise_repeat": True,
                "dtype": str(dt).replace("torch.", ""),
                "int4_layout": None if kernel == "w8a16" else ("packed" if q4.packed else "bytes"),
                "max_abs_err": err, "row_err": rel, "tol": tol, "faults": faults,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library_call": "torch._weight_int8pack_mm" if kernel == "w8a16"
                else "torch._weight_int4pack_mm",
                "library_row_err": library_err, "library_note": lib_note,
                "dequant_matmul_yardstick_ms": yardstick_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": w_["bytes"], "flops": w_["flops"],
            }
            say("qmatmul", json.dumps(row))
            results.append(row)
        del q8, q4, x
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("qmatmul cases failed:\n  " + "\n  ".join(failures))
    for kernel in QMM_KERNELS:
        for m in (1, 8):
            say("qmatmul", "stage step " + json.dumps(qmm_stage_sums(results, kernel, m)))
    return results


# -- LoRA lane-delta cases ---------------------------------------------------------


def lora_inputs(c: Dict[str, Any], gen, dev):
    """One LoRA case's inputs: x [B, S, in], pools [LORA_SLOTS, LORA_LAYERS,
    in, r] / [.., r, out] (slot 0 zero), scales, ids int32 [B]."""
    import torch

    din, dout = LORA_SHAPES[c["target"]]
    dt = torch.float32 if c.get("dtype") == "float32" else torch.bfloat16
    r, b = c["r"], len(c["ids"])
    a_pool = torch.randn((LORA_SLOTS, LORA_LAYERS, din, r), generator=gen, device=dev) * 0.05
    b_pool = torch.randn((LORA_SLOTS, LORA_LAYERS, r, dout), generator=gen, device=dev) * 0.05
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    x = torch.randn((b, c["s"], din), generator=gen, device=dev).to(dt)
    scale = torch.tensor(LORA_SCALES[:LORA_SLOTS], device=dev)
    ids = torch.tensor(c["ids"], dtype=torch.int32, device=dev)
    return x, a_pool.to(dt), b_pool.to(dt), scale, ids


def lora_fault_inputs(fault: str, x, a_pool, b_pool, scale_pool, ids, layer):
    """Inputs on which the sound kernel computes what a kernel with `fault`
    computes on the given ones (LORA_FAULTS)."""
    import torch

    if fault == "neighbour_slot":
        ids = ((ids + 1) % a_pool.shape[0]).to(torch.int32)
    elif fault == "layer_off_by_one":
        layer = (layer + 1) % a_pool.shape[1]
    elif fault == "scale_skipped":
        scale_pool = torch.ones_like(scale_pool)
    elif fault == "last_rank_column_skipped":
        a_pool = a_pool.clone()
        a_pool[..., -1] = 0
    elif fault == "last_s_tile_skipped":
        x = x.clone()
        x[:, (x.shape[1] - 1) // LORA_S_TILE * LORA_S_TILE:] = 0
    else:
        raise ValueError(f"unknown fault {fault}")
    return x, a_pool, b_pool, scale_pool, ids, layer


def lora_work(x, a_pool, b_pool, ids) -> Dict[str, float]:
    """Bytes and flops one lane-delta launch needs: each distinct tenant
    slot's A and B slices read once (base-slot lanes need none: slot 0 is
    zero by contract), x read once, the f32 output written once;
    2 * S * r * (in + out) flops per tenant lane."""
    b, s, din = x.shape
    r, dout = a_pool.shape[-1], b_pool.shape[-1]
    tenants = [i for i in ids.tolist() if i]
    slices = len(set(tenants)) * r * (din + dout) * a_pool.element_size()
    return {"bytes": slices + x.numel() * x.element_size() + 4 * b * s * dout,
            "flops": 2.0 * len(tenants) * s * r * (din + dout)}


def run_lora_cases() -> List[Dict[str, Any]]:
    import torch

    from inferd_tpu_torch.ops import lora as L

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    results, failures = [], []
    for c in LORA_CASES:
        x, a_pool, b_pool, scale, ids = lora_inputs(c, gen, dev)
        layer, dout = LORA_LAYER, b_pool.shape[-1]

        def kernel(args=(x, a_pool, b_pool, scale, ids, layer)):
            return L.fused_lane_delta(*args)

        def plain():
            return L.fused_lane_delta_reference(x, a_pool, b_pool, scale, ids, layer)

        plan = L.lora_plan(len(c["ids"]), c["s"], x.shape[-1], dout, c["r"], x.dtype,
                           a_pool.dtype)
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{c['name']}: kernel output is not finite")
        if not torch.equal(got, again):
            failures.append(f"{c['name']}: two calls gave different bits")
        err = (got - ref).abs().max().item()
        rel = row_rel_err(got, ref, dout)
        faults = {f: row_rel_err(kernel(lora_fault_inputs(f, x, a_pool, b_pool, scale, ids,
                                                          layer)), ref, dout)
                  for f in LORA_FAULTS}
        if not rel <= LORA_TOL:
            failures.append(f"{c['name']}: row error {rel} > tol {LORA_TOL}")
        if not any(c["ids"]) and not torch.equal(got, torch.zeros_like(got)):
            failures.append(f"{c['name']}: base-slot lanes are not exactly zero")
        for f, reading in faults.items():
            if f not in c.get("blind", ()) and not reading > LORA_TOL:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {LORA_TOL}")
        il = ids.long()

        def yardstick():
            # gather, then two bmm in the pools' dtype: a yardstick only, no
            # single PyTorch call computes the per-lane delta
            xa = torch.bmm(x, a_pool[il, layer])
            return torch.bmm(xa, b_pool[il, layer]).float() * scale[il][:, None, None]

        yardstick_ms = time_ms(yardstick, cold=True)
        ms = time_ms(kernel, cold=True)
        plain_ms = time_ms(plain, iters=10, cold=True)
        w = lora_work(x, a_pool, b_pool, ids)
        t_bytes = w["bytes"] / HBM_BYTES_PER_S
        t_ops = w["flops"] / PEAK_FLOPS[str(a_pool.dtype).replace("torch.", "")]
        row = {
            "case": c["name"], "target": c["target"], "B": len(c["ids"]), "S": c["s"],
            "in": x.shape[-1], "out": dout, "r": c["r"], "ids": c["ids"],
            "dtype": str(x.dtype).replace("torch.", ""), "plan": dataclasses.asdict(plan),
            "max_abs_err": err, "row_err": rel, "tol": LORA_TOL, "faults": faults,
            "blind": list(c.get("blind", ())), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "gather_bmm_yardstick_ms": yardstick_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        say("lora", json.dumps(row))
        results.append(row)
        del x, a_pool, b_pool
    results += run_lora_y_cases(gen, failures)
    if failures:
        raise AssertionError("lora cases failed:\n  " + "\n  ".join(failures))
    return results


def run_lora_y_cases(gen, failures: List[str]) -> List[Dict[str, Any]]:
    """LORA_Y_CASES: fused_lane_delta(..., y=y) against the unfused add of
    its own delta (bit for bit) and of the plain version's (row rule)."""
    import torch

    from inferd_tpu_torch.ops import lora as L

    dev = torch.device(DEVICE)
    results = []
    for c in LORA_Y_CASES:
        x, a_pool, b_pool, scale, ids = lora_inputs(c, gen, dev)
        layer, dout = LORA_LAYER, b_pool.shape[-1]
        y = torch.randn((x.shape[0], x.shape[1], dout), generator=gen, device=dev).to(x.dtype)

        def fused(args=(x, a_pool, b_pool, scale, ids, layer), y=y):
            return L.fused_lane_delta(*args, y=y)

        def unfused():
            return (y.float() + L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer)
                    ).to(y.dtype)

        plan = L.lora_plan(len(c["ids"]), c["s"], x.shape[-1], dout, c["r"], x.dtype,
                           a_pool.dtype)
        before = L.fused_lane_delta.launches
        got = fused()
        launched = L.fused_lane_delta.launches - before
        again, sep = fused(), unfused()
        y_in = y.clone()
        in_place = L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer, y=y_in, inplace=True)
        ref = (y.float() + L.fused_lane_delta_reference(x, a_pool, b_pool, scale, ids, layer)
               ).to(y.dtype)
        torch.cuda.synchronize()
        base = (ids == 0).nonzero().flatten()
        checks = {
            "one launch": launched == 1,
            "equal to the unfused add": torch.equal(got, sep),
            "the same bits on two calls": torch.equal(got, again),
            "in place into y": in_place is y_in and torch.equal(y_in, got),
            "base lanes equal y": torch.equal(got[base], y[base]),
        }
        for what, ok in checks.items():
            if not ok:
                failures.append(f"{c['name']}: not {what}")
        tol = ATTN_TOL["bfloat16"]
        rel = row_rel_err(got, ref, dout)
        faults = {f: row_rel_err(fused(lora_fault_inputs(f, x, a_pool, b_pool, scale, ids,
                                                         layer)), ref, dout)
                  for f in LORA_FAULTS}
        if not rel <= tol:
            failures.append(f"{c['name']}: row error {rel} > tol {tol}")
        for f, reading in faults.items():
            if not reading > tol:
                failures.append(f"{c['name']}: planted fault {f} reads {reading} <= tol {tol}")
        scratch = y.clone()
        ms = time_ms(lambda: L.fused_lane_delta(x, a_pool, b_pool, scale, ids, layer,
                                                y=scratch, inplace=True), cold=True)
        unfused_ms = time_ms(unfused, cold=True)
        plain_ms = time_ms(lambda: (y.float() + L.fused_lane_delta_reference(
            x, a_pool, b_pool, scale, ids, layer)).to(y.dtype), iters=10, cold=True)
        w = lora_work(x, a_pool, b_pool, ids)
        # y read once and written once in place of the f32 delta's write
        nbytes = w["bytes"] - 4 * y.numel() + 2 * y.numel() * y.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = w["flops"] / PEAK_FLOPS[str(a_pool.dtype).replace("torch.", "")]
        row = {
            "case": c["name"], "target": c["target"], "B": len(c["ids"]), "S": c["s"],
            "in": x.shape[-1], "out": dout, "r": c["r"], "ids": c["ids"],
            "dtype": str(x.dtype).replace("torch.", ""), "plan": dataclasses.asdict(plan),
            "checks": {k: bool(v) for k, v in checks.items()},
            "max_abs_err": (got.float() - ref.float()).abs().max().item(), "row_err": rel,
            "tol": tol, "faults": faults, "blind": [], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "unfused_ms": unfused_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": w["flops"],
        }
        say("lora", json.dumps(row))
        results.append(row)
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


def start_node(parts: str, stage: int, log_dir: str, extra=(), tag: str = "") -> Dict[str, Any]:
    port = free_port()
    log = open(os.path.join(log_dir, f"node{stage}{tag or '_'.join(extra)}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "inferd_tpu_torch.tools.run_node", "--parts", parts,
         "--stage", str(stage), "--port", str(port), "--device", DEVICE,
         "--max-len", str(MAX_LEN), *extra],
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


def make_local_client(executors, sampling, adapter=None):
    """A GenerationClient whose transport is the stage executors in this
    process: the same generation loop and chunking as the ChainClient, and
    its `adapter` stamp on every stage of a session's first chunk."""
    from inferd_tpu_torch.client.base import GenerationClient

    class LocalChain(GenerationClient):
        def _step_sync(self, session_id, tokens, start_pos):
            import numpy as np

            stamp = {"adapter": self.adapter} if self.adapter and start_pos == 0 else {}
            payload = {"tokens": np.asarray([tokens], np.int32), "start_pos": start_pos,
                       "real_len": len(tokens), **stamp}
            for ex in executors:
                out = ex.process(session_id, payload)
                if "logits" in out:
                    return out["logits"].numpy()[0]
                payload = {"hidden": out["hidden"], "start_pos": out["start_pos"],
                           "real_len": out["real_len"], **stamp}
            raise RuntimeError("no logits")

        async def _step(self, session_id, tokens, start_pos):
            return await asyncio.to_thread(self._step_sync, session_id, tokens, start_pos)

        async def _end_session(self, session_id):
            for ex in executors:
                ex.end_session(session_id)

    return LocalChain(sampling=sampling, prefill_chunk=512, adapter=adapter)


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


def paged_splits(phase: str, st: Dict[str, Any], cfg) -> tuple:
    """(paged_decode_gqa.split_launches of a lane node, the count its decode
    dispatches want): every dispatch of table width MB launches one paged
    call per layer, split when ops.attention.paged_plan(LANES, Nkv, MB, ...)
    cuts the chain."""
    from inferd_tpu_torch.ops.attention import paged_plan

    layers = st["end_layer"] - st["start_layer"] + 1
    widths = {int(w): n for w, n in st["executor"]["decode_widths"].items()}
    plans = {w: paged_plan(LANES, cfg.num_kv_heads, w, PAGED_BS, cfg.torch_dtype).splits
             for w in widths}
    want = layers * sum(n for w, n in widths.items() if plans[w] > 1)
    got = st["kernels"]["paged_decode_gqa"]["split_launches"]
    say(phase, f"node stage {st['stage']}: decode dispatches by table width {widths}, splits "
               f"{plans}; paged split launches {got} (want {want}: {got == want})")
    return got, want


def flash_routes(stats: Dict[str, Any]) -> Dict[str, int]:
    """A node's flash_gqa launches by route, from its /stats."""
    fl = stats["kernels"]["flash_gqa"]
    return {"split": fl["split_launches"], "mma": fl["mma_launches"]}


def split_parts(work: str) -> str:
    """Qwen3-0.6B at full width from a seeded random init, split into two
    14-layer stage files by tools/split_model; returns the parts directory."""
    import torch

    from inferd_tpu_torch.tools import split_model

    parts = os.path.join(work, "parts")
    t0 = time.perf_counter()
    split_model.main(["--model", MODEL, "--stages", "2", "--random-init", "--seed", "0",
                      "--out", parts, "--device", DEVICE])
    torch.cuda.empty_cache()
    say("serve", f"split {MODEL} into 2 stages (seeded random init) in "
                 f"{time.perf_counter() - t0:.1f}s")
    return parts


@contextlib.contextmanager
def plain_gemvs():
    """Every decode-GEMV wrapper call runs its plain version, until the
    block ends: the plain-GEMV path the quantized phases hold the kernel
    path to."""
    from inferd_tpu_torch.ops import qmatmul as Q

    saved = Q.w8a16_matmul, Q.w4a16_matvec
    Q.w8a16_matmul, Q.w4a16_matvec = Q.w8a16_matmul_reference, Q.w4a16_matvec_reference
    try:
        yield
    finally:
        Q.w8a16_matmul, Q.w4a16_matvec = saved


@contextlib.contextmanager
def planted_gemv_fault(fault: str):
    """Every decode-GEMV kernel launch runs on inputs that reproduce `fault`
    (see qmm_fault_inputs), until the block ends."""
    from inferd_tpu_torch.ops import qmatmul as Q

    launch = Q._launch

    def faulty(x, q, scale, k, n, kind, groups, scheme, name):
        plan = Q.qgemv_plan(x.shape[0], k, n, groups, kind, scheme, x.dtype)
        x, scale = qmm_fault_inputs(fault, x, scale, k, plan)
        return launch(x, q, scale, k, n, kind, groups, scheme, name)

    Q._launch = faulty
    try:
        yield
    finally:
        Q._launch = launch


@contextlib.contextmanager
def plain_lora():
    """Every lane-delta wrapper call runs its plain version, until the block
    ends: the plain-delta path the LoRA phase holds the kernel path to."""
    from inferd_tpu_torch.ops import lora as L

    saved = L.fused_lane_delta
    L.fused_lane_delta = L.fused_lane_delta_reference
    try:
        yield
    finally:
        L.fused_lane_delta = saved


@contextlib.contextmanager
def planted_lora_fault(fault: str):
    """Every lane-delta kernel launch runs on inputs that reproduce `fault`
    (see lora_fault_inputs), until the block ends."""
    from inferd_tpu_torch.ops import lora as L

    launch = L._launch

    def faulty(*args):  # (x, pools, scale, ids, layer) and y, inplace as they come
        return launch(*lora_fault_inputs(fault, *args[:6]), *args[6:])

    L._launch = faulty
    try:
        yield
    finally:
        L._launch = launch


QMM_KERNEL_OF = {"int8": "w8a16_matmul", "int4": "w4a16_matvec"}  # --quant -> its kernel
GEMVS_PER_LAYER = 7  # q, k, v, o, gate, up, down


def gemv_launches(layers: int, last: bool, small_dispatches: int, dispatches: int) -> int:
    """GEMV kernel launches of one quantized stage: 7 per layer on every
    dispatch of at most MAX_KERNEL_ROWS rows, and on the last stage one for
    the head on every dispatch (its logits are one row per lane)."""
    return GEMVS_PER_LAYER * layers * small_dispatches + (dispatches if last else 0)


def gemv_projections(cfg) -> List[tuple]:
    """[K, N] of the seven per-layer projections, and the head's [K, N]."""
    h, q, kv = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    return [(h, q), (h, kv), (h, kv), (q, h), (h, i), (h, i), (i, h)], (h, cfg.vocab_size)


def gemv_route_launches(cfg, quant_flag, layers: int, last: bool, small_rows: List[int],
                        head_rows: List[int]) -> Dict[str, int]:
    """Launches per route (qgemv_plan's) of --quant quant_flag's GEMV wrapper
    on one stage: the seven projections of each layer on every dispatch
    whose row count is in small_rows (those of at most MAX_KERNEL_ROWS), and
    on the last stage the head on every dispatch (head_rows: its rows per
    dispatch), each weight quantized as the node quantizes it."""
    import torch

    from inferd_tpu_torch.ops import qmatmul as Q
    from inferd_tpu_torch.ops import quant

    def route(m, k, n):
        if quant_flag == "int8":
            return Q.qgemv_plan(m, k, n, 1, "int8", "grouped", torch.bfloat16).route
        return Q.qgemv_plan(m, k, n, k // quant._group_size(k, 128),
                            "int4" if k % 2 == 0 else "int4_bytes", quant.INT4_MODE,
                            torch.bfloat16).route

    counts = {"mma": 0, "simt": 0}
    projections, head = gemv_projections(cfg)
    for m in small_rows:
        for k, n in projections:
            counts[route(m, k, n)] += layers
    for m in head_rows if last else ():
        counts[route(m, *head)] += 1
    return counts


def gemv_routes(stats: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """A node's GEMV launches by wrapper and route, from its /stats."""
    return {name: {r: stats["kernels"][name][f"{r}_launches"] for r in ("mma", "simt")}
            for name in ("w8a16_matmul", "w4a16_matvec")}


def quantize_loaded(loaded, quant_flag):
    """The stage checkpoints as a --quant node holds them."""
    if quant_flag is None:
        return loaded
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import quant

    cfg = get_config(MODEL)
    return [(quant.apply_quant_mode(quant_flag, params, cfg.tie_word_embeddings, spec.is_last),
             spec, name) for params, spec, name in loaded]


def run_serve(card: str, parts: str, work: str, quant_flag=None, baseline=None) -> Dict[str, Any]:
    """The `serve` phase, or with quant_flag its `serve_quant` run on
    --quant nodes (the GEMV kernel path then held to the plain-GEMV path,
    and `baseline`'s bf16 rates printed beside its own)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    LastStageProbe = _last_stage_probe_class()

    phase = "serve" if quant_flag is None else f"serve_quant_{quant_flag}"
    extra = [] if quant_flag is None else ["--quant", quant_flag]
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts, s, work, extra) for s in range(2)]
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(extra)} processes ready in "
                   f"{time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            if any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]:
                raise AssertionError(f"nodes did work before the main path: {before}")
            if st["quant"] != (quant_flag or "none"):
                raise AssertionError(f"node serves quant {st['quant']}, want {quant_flag}")
        prompts = serve_prompts(cfg.vocab_size)
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
        rates = []
        for i, (p, ids, (t_req, stamps)) in enumerate(zip(prompts, streams, timing)):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            rates.append((ttft, tps))
            beside = ""
            if baseline is not None:
                b_ttft, b_tps = baseline["rates"][i]
                beside = f"; bf16 serve in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s"
            say(phase, f"prompt {len(p)} tokens: TTFT {ttft:.1f} ms, decode "
                       f"{tps:.1f} tok/s over {len(stamps) - 1} steps ({card}){beside}")

        # every forward pass of a prompt chunk pads to its bucket; decode is 1 row
        rows = [bucket_len(len(p[c:c + 512])) for p in prompts for c in range(0, len(p), 512)]
        decode_passes = len(prompts) * (NEW_TOKENS - 1)
        rows += [1] * decode_passes
        expected_passes = len(rows)
        route_launches = {"split": 0, "mma": 0}
        small = sum(r <= MAX_KERNEL_ROWS for r in rows)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        gemv_total = {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()}
        for a_ in after:
            passes = a_["forward_passes"]
            kern = {name: k["launches"] for name, k in a_["kernels"].items()}
            layers = a_["end_layer"] - a_["start_layer"] + 1
            last = a_["stage"] == a_["num_stages"] - 1
            want = {"flash_gqa": layers * passes, "paged_decode_gqa": 0,
                    "w8a16_matmul": 0, "w4a16_matvec": 0, "fused_lane_delta": 0}
            if quant_flag is not None:
                want[QMM_KERNEL_OF[quant_flag]] = gemv_launches(layers, last, small, passes)
            say(phase, f"node stage {a_['stage']} on {a_['device']} (quant {a_['quant']}, "
                       f"{a_['quantized_bytes']} parameter bytes): {passes} forward passes "
                       f"({small} of at most {MAX_KERNEL_ROWS} rows); launches {kern} "
                       f"(want {want}: {kern == want})")
            # decode steps take the split-KV route, prompt chunks the tensor cores
            routes = flash_routes(a_)
            want_routes = {"split": layers * decode_passes,
                           "mma": layers * (expected_passes - decode_passes)}
            say(phase, f"node stage {a_['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            # the GEMVs by route: every dispatch of at most 64 rows, the head on 1 row
            g_routes = gemv_routes(a_)
            want_g = {name: {"mma": 0, "simt": 0} for name in g_routes}
            if quant_flag is not None:
                want_g[QMM_KERNEL_OF[quant_flag]] = gemv_route_launches(
                    cfg, quant_flag, layers, last, [r for r in rows if r <= MAX_KERNEL_ROWS],
                    [1] * passes)
                say(phase, f"node stage {a_['stage']}: GEMV routes {g_routes} (want {want_g}: "
                           f"{g_routes == want_g})")
            if (passes != expected_passes or kern != want or kern["flash_gqa"] == 0
                    or routes != want_routes or g_routes != want_g):
                raise AssertionError(f"stage {a_['stage']}: {passes} passes (want "
                                     f"{expected_passes}), launches {kern} (want {want}), "
                                     f"flash_gqa routes {routes} (want {want_routes}), "
                                     f"GEMV routes {g_routes} (want {want_g})")
            for name, per in g_routes.items():
                for r, v in per.items():
                    gemv_total[name][r] += v
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        stop_nodes(nodes)
        nodes = []

        # the same stage executors in this process, over the same parts
        loaded = quantize_loaded([load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                        device=DEVICE) for s in range(2)],
                                 quant_flag)
        kernel_ex = [Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
                     for params, spec, _ in loaded]

        async def local(executors):
            client = make_local_client(executors, greedy)
            return [await client.generate_ids(p, max_new_tokens=NEW_TOKENS) for p in prompts]

        local_streams = asyncio.run(local(kernel_ex))
        for p, a_, b_ in zip(prompts, streams, local_streams):
            if a_ != b_:
                raise AssertionError(f"prompt {len(p)}: served stream != in-process stream")
        say(phase, "served streams equal the in-process executors' streams, token for token "
                   f"({len(prompts)} requests x {NEW_TOKENS} tokens)")

        probe = [kernel_ex[0], LastStageProbe(cfg, loaded[1][1], loaded[1][0], max_len=MAX_LEN)]
        if quant_flag is None:  # the kernel path against plain attention
            plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
            plain_probe = [Qwen3StageExecutor(plain_cfg, loaded[0][1], loaded[0][0],
                                              max_len=MAX_LEN),
                           LastStageProbe(plain_cfg, loaded[1][1], loaded[1][0], max_len=MAX_LEN)]
            plain_ctx, plant, faults, what = contextlib.nullcontext, planted_attention_fault, \
                E2E_FAULTS, "plain attention"
        else:  # the GEMV kernels against their plain versions
            plain_probe, plain_ctx, plant, faults, what = probe, plain_gemvs, planted_gemv_fault, \
                QUANT_E2E_FAULTS, "plain GEMVs"
        with plain_ctx():
            plain_steps = teacher_forced(plain_probe, prompts, streams)
        readings = {"sound": compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                           cfg.hidden_size)}
        for f in faults:
            with plant(f):
                readings[f] = compare_steps(teacher_forced(probe, prompts, streams), plain_steps,
                                            cfg.hidden_size)
        for name, (h_err, l_err) in readings.items():
            say(phase, f"kernel path {'' if name == 'sound' else 'with fault ' + name + ' '}vs "
                       f"{what} over {len(plain_steps)} teacher-forced steps: hidden "
                       f"row error {h_err:.4g} (tol {HIDDEN_TOL}), logits {l_err:.4%} of max "
                       f"|logit| (tol {LOGIT_TOL:.0%})")
        h_err, l_err = readings.pop("sound")
        if not (h_err <= HIDDEN_TOL and l_err <= LOGIT_TOL):
            raise AssertionError(f"kernel path vs {what}: hidden {h_err}, logits {l_err}")
        for f, (h_f, l_f) in readings.items():
            if not (h_f > HIDDEN_TOL or l_f > LOGIT_TOL):
                raise AssertionError(f"planted fault {f} passes the checks: hidden {h_f}, "
                                     f"logits {l_f}")
        del kernel_ex, probe, plain_probe, loaded
        torch.cuda.empty_cache()
        return {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
                "passes": expected_passes,
                "rates": rates, "streams": streams}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


@contextlib.contextmanager
def planted_paged_fault(fault: str):
    """Every paged_decode_gqa kernel launch runs on inputs that reproduce
    `fault` (see plant_paged_fault), until the block ends."""
    from inferd_tpu_torch.ops import attention as A

    launch = A._paged_launch

    def faulty(q, k_pool, v_pool, table, q_positions, kv_len, *rest):
        return launch(q, *plant_paged_fault(fault, k_pool, v_pool, table, q_positions, kv_len),
                      *rest)

    A._paged_launch = faulty
    try:
        yield
    finally:
        A._paged_launch = launch


class LaneProbe:
    """The last stage's lane executor, run as an inner stage so that it
    returns its hidden state on every real row; the last real token's
    logits are computed beside it from the same stage params."""

    def __init__(self, cfg, spec, params, **kw):
        from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

        inner = dataclasses.replace(spec, num_stages=spec.num_stages + 1)
        self.ex = BatchedStageExecutor(cfg, inner, params, **kw)
        self.cfg, self.params = cfg, params

    def process(self, session_id, payload):
        import torch

        from inferd_tpu_torch.models import qwen3

        out = self.ex.process(session_id, payload)
        last = out["hidden"][:, -1:].to(self.ex.device)
        with torch.no_grad():
            out["logits"] = qwen3.unembed(self.params, self.cfg, last)[:, 0].cpu()
        return out

    def process_batch(self, items):
        import torch

        from inferd_tpu_torch.models import qwen3

        outs = self.ex.process_batch(items)
        for out in outs:
            if isinstance(out, Exception):
                raise out
            with torch.no_grad():
                out["logits"] = qwen3.unembed(self.params, self.cfg,
                                              out["hidden"][:, -1:].to(self.ex.device))[:, 0].cpu()
        return outs

    def end_session(self, session_id):
        self.ex.end_session(session_id)


def teacher_forced_lanes(executors, prompts, streams, names=None) -> List[List[Any]]:
    """Per prompt, (last-stage hidden of the real rows, last logits) per
    step through the lane executors in this process: each prompt's
    512-token chunks one session at a time (prefill), then the first
    DECODE_CHECKED decode steps of EVERY stream co-batched, one
    process_batch per stage per step, so each step runs all sessions'
    lanes live at their ragged lengths. `names` binds session i to adapter
    names[i] (None: the base model), stamped on every stage of its first
    chunk as the chain client stamps it."""
    import numpy as np

    steps: List[List[Any]] = [[] for _ in prompts]
    sids = [f"forced-{i}" for i in range(len(prompts))]
    for i, p in enumerate(prompts):
        for c in range(0, len(p), 512):
            stamp = {"adapter": names[i]} if names and names[i] and c == 0 else {}
            out = {"tokens": np.asarray([p[c:c + 512]], np.int32), "start_pos": c,
                   "real_len": len(p[c:c + 512])}
            for ex in executors:
                out = ex.process(sids[i], {**out, **stamp})
            steps[i].append((out["hidden"].float(), out["logits"].float()))
    for j in range(DECODE_CHECKED):
        items = [(sid, {"tokens": [[ids[j]]], "start_pos": len(p) + j, "real_len": 1})
                 for sid, p, ids in zip(sids, prompts, streams)]
        for ex in executors:
            outs = ex.process_batch(items)
            for o in outs:
                if isinstance(o, Exception):
                    raise o
            items = [(sid, {"hidden": o["hidden"], "start_pos": o["start_pos"],
                            "real_len": o["real_len"]}) for (sid, _), o in zip(items, outs)]
        for i, o in enumerate(outs):
            steps[i].append((o["hidden"].float(), o["logits"].float()))
    for ex in executors:
        for sid in sids:
            ex.end_session(sid)
    return steps


def lane_executors(cfg, loaded, block_size: int, probe: bool, adapters=None):
    """The two stages' lane executors as the serve_lanes nodes build them;
    with `probe` the last one is a LaneProbe; with `adapters` (a list of
    adapter directories) each serves its stage's slice of that catalog, as
    a run_node --adapters node does."""
    from inferd_tpu_torch.runtime.adapters import AdapterRegistry
    from inferd_tpu_torch.runtime.stage_batch import BatchedStageExecutor

    kw = dict(lanes=LANES, max_len=MAX_LEN, block_size=block_size,
              prefill_chunk=LANE_PREFILL_CHUNK)

    def reg(spec):
        if adapters is None:
            return None
        return AdapterRegistry(cfg, adapters, start_layer=spec.start_layer,
                               end_layer=spec.end_layer + 1, device=DEVICE)

    (p0, s0, _), (p1, s1, _) = loaded
    last = (LaneProbe(cfg, s1, p1, adapters=reg(s1), **kw) if probe
            else BatchedStageExecutor(cfg, s1, p1, adapters=reg(s1), **kw))
    return [BatchedStageExecutor(cfg, s0, p0, adapters=reg(s0), **kw), last]


def check_teacher_forced(phase: str, tag: str, cfg, loaded, block_size: int, prompts, streams,
                         faults=(), gemv: bool = False, lora=None) -> Dict[str, Any]:
    """The lane executors' kernel path against their plain path, teacher-
    forced over every prompt chunk and the first DECODE_CHECKED co-batched
    decode steps of the streams, held to HIDDEN_TOL and LOGIT_TOL on every
    prompt. The plain path is plain attention (attn_impl="xla"), with
    `gemv` the plain GEMVs, or with `lora` = (adapter directories, the
    sessions' adapter names) the plain lane delta, on executors serving
    that catalog. Each planted fault (paged-attention, GEMV or lane-delta
    faults) must break one of the limits on some lane; a paged fault only
    on lanes whose chain spans more than one block (a one-block lane under
    either fault reads only the zeroed scratch block or nothing, so its
    attention is exactly zero and shows nothing of a multi-block walk), a
    lane-delta fault only on tenant lanes. With `lora`, the base sessions'
    steps must also be bit-identical to those of executors without a
    registry. The per-prompt readings are printed."""
    import torch

    dirs, names = lora if lora is not None else (None, None)
    if lora is not None:
        plain_cfg, plain_ctx, plant, what = cfg, plain_lora, planted_lora_fault, "plain lane delta"
    elif gemv:
        plain_cfg, plain_ctx, plant, what = cfg, plain_gemvs, planted_gemv_fault, "plain GEMVs"
    else:
        plain_cfg, plain_ctx, plant, what = (dataclasses.replace(cfg, attn_impl="xla"),
                                             contextlib.nullcontext, planted_paged_fault,
                                             "plain attention")
    with plain_ctx():
        plain = teacher_forced_lanes(lane_executors(plain_cfg, loaded, block_size, True, dirs),
                                     prompts, streams, names)
    torch.cuda.empty_cache()
    kernel_ex = lane_executors(cfg, loaded, block_size, True, dirs)

    def per_prompt():
        got = teacher_forced_lanes(kernel_ex, prompts, streams, names)
        return got, [compare_steps(g, r, cfg.hidden_size) for g, r in zip(got, plain)]

    t0 = time.perf_counter()
    sound, readings = per_prompt()
    torch.cuda.synchronize()
    sound_s = time.perf_counter() - t0
    readings = {"sound": readings}
    for f in faults:
        with plant(f):
            readings[f] = per_prompt()[1]
    del kernel_ex
    torch.cuda.empty_cache()
    if lora is not None:
        bare_ex = lane_executors(cfg, loaded, block_size, True)
        t0 = time.perf_counter()
        bare = teacher_forced_lanes(bare_ex, prompts, streams)
        torch.cuda.synchronize()
        say(phase, f"{tag}: one teacher-forced pass (every prompt chunk, then {DECODE_CHECKED} "
                   f"co-batched decode windows) took {sound_s:.3f} s on the host clock with the "
                   f"registry, {time.perf_counter() - t0:.3f} s on executors without one")
        del bare_ex
        base = [i for i, n in enumerate(names) if n is None]
        same = all(torch.equal(g[0], b[0]) and torch.equal(g[1], b[1])
                   for i in base for g, b in zip(sound[i], bare[i]))
        say(phase, f"{tag}: base sessions' hidden rows and logits over {len(sound[base[0]])} "
                   f"steps each ({DECODE_CHECKED} in windows mixed with tenants) bit-identical to "
                   f"executors without a registry: {same}")
        if not same:
            raise AssertionError(f"{tag}: base lanes differ from executors without a registry")
        del bare
        torch.cuda.empty_cache()
    bs = block_size or PAGED_BS
    if lora is not None:
        trip_lanes, kind = [i for i, n in enumerate(names) if n is not None], "tenant "
    else:
        trip_lanes = [i for i, p in enumerate(prompts) if gemv or len(p) + DECODE_CHECKED > bs]
        kind = "" if gemv else "multi-block "
    n_steps = sum(len(r) for r in plain)
    for name, per in readings.items():
        rows = ", ".join(f"{len(p)}: {h:.4g} / {l:.3%}" for p, (h, l) in zip(prompts, per))
        say(phase, f"{tag}: kernel path {'' if name == 'sound' else 'with fault ' + name + ' '}"
                   f"vs {what} over {n_steps} teacher-forced steps "
                   f"({DECODE_CHECKED} co-batched decode steps of {len(prompts)} lanes); "
                   f"per prompt, hidden row error / logits share of max |logit| (tol "
                   f"{HIDDEN_TOL} / {LOGIT_TOL:.0%}): {rows}")
    h_err = max(h for h, _ in readings["sound"])
    l_err = max(l for _, l in readings["sound"])
    if not (h_err <= HIDDEN_TOL and l_err <= LOGIT_TOL):
        raise AssertionError(f"{tag}: kernel path vs {what}: hidden {h_err}, logits {l_err}")
    for f in faults:
        tripped = [i for i in trip_lanes
                   if readings[f][i][0] > HIDDEN_TOL or readings[f][i][1] > LOGIT_TOL]
        say(phase, f"{tag}: fault {f} exceeds the limits on {len(tripped)} of "
                   f"{len(trip_lanes)} {kind}lanes")
        if not tripped:
            raise AssertionError(f"{tag}: planted fault {f} passes the checks on every lane it "
                                 f"can reach: {readings[f]}")
    return {name: [list(r) for r in per] for name, per in readings.items()}


def run_serve_lanes(card: str, parts: str, work: str, quant_flag=None,
                    baseline=None) -> Dict[str, Any]:
    """The `serve_lanes` phase, or with quant_flag `serve_lanes_quant` on
    --quant lane nodes (every decode GEMV then runs at M = LANES rows;
    `baseline`'s bf16 rates are printed beside its own)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import bucket_len
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    phase = "serve_lanes" if quant_flag is None else "serve_lanes_quant"
    node_args = LANE_NODE_ARGS + ([] if quant_flag is None else ["--quant", quant_flag])
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts, s, work, node_args) for s in range(2)]
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(node_args)} processes "
                   f"ready in {time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            ex = st["executor"]
            if (any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]
                    or ex["batched_steps"] or ex["prefill_steps"]):
                raise AssertionError(f"nodes did work before the main path: {before}")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LANE_PROMPT_LENS]

        async def drive():
            async with ChainClient([("127.0.0.1", n["port"]) for n in nodes],
                                   sampling=greedy, prefill_chunk=512) as client:
                async def one(p):
                    stamps: List[float] = []
                    t_req = time.perf_counter()
                    ids = await client.generate_ids(
                        p, max_new_tokens=NEW_TOKENS,
                        on_token=lambda _tok: stamps.append(time.perf_counter()))
                    return ids, t_req, stamps

                return await asyncio.gather(*(one(p) for p in prompts))

        t_all = time.perf_counter()
        served = asyncio.run(drive())
        wall = time.perf_counter() - t_all
        after = stats()
        streams = [ids for ids, _, _ in served]
        rates = []
        for i, (p, (ids, t_req, stamps)) in enumerate(zip(prompts, served)):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            rates.append((ttft, tps))
            beside = ""
            if baseline is not None:
                b_ttft, b_tps = baseline["rates"][i]
                beside = f"; bf16 serve_lanes in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s"
            say(phase, f"session, prompt {len(p)} tokens: TTFT {ttft:.1f} ms, decode "
                       f"{tps:.1f} tok/s over {len(stamps) - 1} steps ({card}){beside}")
        total = sum(len(ids) for ids in streams)
        beside = ("" if baseline is None else
                  f"; bf16 serve_lanes in this run: {baseline['tokens_per_s']:.1f} tok/s")
        say(phase, f"aggregate: {total} tokens from {len(prompts)} concurrent sessions in "
                   f"{wall:.2f} s = {total / wall:.1f} tok/s ({card}){beside}")

        # prefill dispatches: the client's 512-token chunks, each split into
        # LANE_PREFILL_CHUNK-token dispatches on the node, padded to a bucket
        pieces = [len(c[j:j + LANE_PREFILL_CHUNK]) for p in prompts
                  for c in (p[i:i + 512] for i in range(0, len(p), 512))
                  for j in range(0, len(c), LANE_PREFILL_CHUNK)]
        want_prefill = len(pieces)
        small_prefill = sum(bucket_len(n) <= MAX_KERNEL_ROWS for n in pieces)
        want_decode_tokens = len(prompts) * (NEW_TOKENS - 1)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        route_launches = {"split": 0, "mma": 0}
        gemv_total = {name: {"mma": 0, "simt": 0} for name in QMM_KERNEL_OF.values()}
        mean_batches = []
        paged_split = 0
        for st in after:
            ex = st["executor"]
            layers = st["end_layer"] - st["start_layer"] + 1
            last = st["stage"] == st["num_stages"] - 1
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            mean = toks / steps if steps else 0.0
            mean_batches.append(mean)
            want = {"flash_gqa": layers * ex["prefill_steps"], "paged_decode_gqa": layers * steps,
                    "w8a16_matmul": 0, "w4a16_matvec": 0, "fused_lane_delta": 0}
            if quant_flag is not None:
                # decode dispatches run LANES rows: every one takes the kernels
                want[QMM_KERNEL_OF[quant_flag]] = gemv_launches(
                    layers, last, steps + small_prefill, steps + ex["prefill_steps"])
            say(phase, f"node stage {st['stage']} on {st['device']} (quant {st['quant']}, "
                       f"{st['quantized_bytes']} parameter bytes): {steps} decode dispatches "
                       f"serving {toks} session steps (mean co-batch {mean:.3f}), "
                       f"{ex['prefill_steps']} prefill dispatches ({small_prefill} of at most "
                       f"{MAX_KERNEL_ROWS} rows); launches {kern} (want {want}: {kern == want}); "
                       f"blocks {ex['paged']['blocks_used']} used after the run")
            routes = flash_routes(st)  # prefill chunks only, on the tensor cores
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            say(phase, f"node stage {st['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            split, want_split = paged_splits(phase, st, cfg)
            paged_split += split
            # the GEMVs by route: decode at LANES rows (the head too), prefill
            # pieces at their bucket (the head on their last row)
            g_routes = gemv_routes(st)
            want_g = {name: {"mma": 0, "simt": 0} for name in g_routes}
            if quant_flag is not None:
                want_g[QMM_KERNEL_OF[quant_flag]] = gemv_route_launches(
                    cfg, quant_flag, layers, last,
                    [LANES] * steps + [bucket_len(n) for n in pieces
                                       if bucket_len(n) <= MAX_KERNEL_ROWS],
                    [LANES] * steps + [1] * ex["prefill_steps"])
                say(phase, f"node stage {st['stage']}: GEMV routes {g_routes} (want {want_g}: "
                           f"{g_routes == want_g})")
            for name, per in g_routes.items():
                for r, v in per.items():
                    gemv_total[name][r] += v
            if (kern != want or kern["paged_decode_gqa"] == 0 or toks != want_decode_tokens
                    or ex["prefill_steps"] != want_prefill or not mean > 1.0 or st["errors"]
                    or routes != want_routes or g_routes != want_g or split != want_split):
                raise AssertionError(
                    f"stage {st['stage']}: launches {kern} (want {want}), flash_gqa routes "
                    f"{routes} (want {want_routes}), GEMV routes {g_routes} (want {want_g}), "
                    f"paged split launches {split} (want {want_split}), "
                    f"{steps} decode "
                    f"dispatches for {toks} steps (want {want_decode_tokens}), "
                    f"{ex['prefill_steps']} prefill dispatches (want {want_prefill}), "
                    f"mean co-batch {mean}, {st['errors']} errors")
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        stop_nodes(nodes)
        nodes = []

        loaded = quantize_loaded([load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                        device=DEVICE) for s in range(2)],
                                 quant_flag)

        async def local(executors):
            client = make_local_client(executors, greedy)
            return [await client.generate_ids(p, max_new_tokens=NEW_TOKENS) for p in prompts]

        local_streams = asyncio.run(local(lane_executors(cfg, loaded, PAGED_BS, False)))
        torch.cuda.empty_cache()
        for p, a_, b_ in zip(prompts, streams, local_streams):
            if a_ != b_:
                diverge = next(i for i, (x, y) in enumerate(zip(a_, b_)) if x != y)
                raise AssertionError(f"prompt {len(p)}: served stream != in-process lane "
                                     f"executors' stream from token {diverge}")
        say(phase, "served streams equal the in-process lane executors' streams "
                   f"(sessions one at a time), token for token ({len(prompts)} x "
                   f"{NEW_TOKENS} tokens)")

        out = {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
               "paged_split": paged_split, "mean_batch": mean_batches,
               "rates": rates, "tokens_per_s": total / wall, "prompts": prompts,
               "streams": streams}
        if quant_flag is not None:
            out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                    prompts, streams, QUANT_E2E_FAULTS, gemv=True)
            return out
        out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                prompts, streams, LANE_E2E_FAULTS)
        pick = [LANE_PROMPT_LENS.index(n) for n in DENSE_LANE_PROMPTS]
        out["dense_e2e"] = check_teacher_forced(
            phase, "dense lanes", cfg, loaded, 0, [prompts[i] for i in pick],
            [streams[i] for i in pick])
        return out
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def write_tenants(work: str) -> List[str]:
    """LORA_TENANTS as peft adapter directories at Qwen3-0.6B's full width
    over all its layers, written from a seed by ops.lora.save_adapter: A
    N(0, 1/in), B N(0, LORA_TENANT_B_SD^2/r), alpha = 2r, so each delta's
    RMS is about a quarter of its input's, some 40% of the base
    projection's (N(0, 0.02^2) weights over 1024 inputs), and the tenants'
    greedy streams leave the base's."""
    import numpy as np

    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.ops import lora as L

    cfg = get_config(MODEL)
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim), "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim), "o_proj": (cfg.q_dim, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}
    rng = np.random.default_rng(4)
    dirs = []
    for name, r, targets in LORA_TENANTS:
        layers = {}
        for t in targets:
            din, dout = dims[t]
            a = rng.standard_normal((cfg.num_layers, din, r), dtype=np.float32) / np.sqrt(din)
            b = rng.standard_normal((cfg.num_layers, r, dout), dtype=np.float32) * (
                LORA_TENANT_B_SD / np.sqrt(r))
            layers[t] = (a, b)
        dirs.append(L.save_adapter(os.path.join(work, "adapters", name), layers, alpha=2 * r, r=r))
    return dirs


def run_serve_lanes_lora(card: str, parts: str, work: str, baseline) -> Dict[str, Any]:
    """The `serve_lanes_lora` phase: serve_lanes' prompts on --adapters lane
    nodes, session i bound to t0, t1, t2 or the base model in turn;
    `baseline` is serve_lanes' result from this run (its streams are the
    base model's on the same prompts, its rates printed beside these)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.client.chain_client import ChainClient
    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    phase = "serve_lanes_lora"
    cfg = get_config(MODEL)
    greedy = SamplingConfig(temperature=0.0)
    t0 = time.perf_counter()
    dirs = write_tenants(work)
    kinds = ", ".join(f"{n}: r {r}, {len(t)} targets" for n, r, t in LORA_TENANTS)
    say(phase, f"wrote {len(dirs)} peft tenants ({kinds}) over {cfg.num_layers} layers in "
               f"{time.perf_counter() - t0:.1f}s")
    names = [LORA_TENANTS[i % 4][0] if i % 4 < 3 else None for i in range(LANES)]
    prompts, base_streams = baseline["prompts"], baseline["streams"]
    n_targets = len(set().union(*(t for _, _, t in LORA_TENANTS)))
    node_args = LANE_NODE_ARGS + ["--adapters", ",".join(dirs)]
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts, s, work, node_args, tag="_lora") for s in range(2)]
        t0 = time.perf_counter()
        for n in nodes:
            wait_ready(n)
        say(phase, f"2 run_node --device {DEVICE} {' '.join(LANE_NODE_ARGS)} --adapters "
                   f"t0,t1,t2 processes ready in {time.perf_counter() - t0:.1f}s")

        def stats():
            return [http_get_json(f"http://127.0.0.1:{n['port']}/stats") for n in nodes]

        before = stats()  # fresh processes: every count starts at 0
        for st in before:
            ex = st["executor"]
            if (any(k["launches"] for k in st["kernels"].values()) or st["forward_passes"]
                    or ex["batched_steps"] or ex["prefill_steps"] or ex["adapters"]["loads"]):
                raise AssertionError(f"nodes did work before the main path: {before}")

        async def drive():
            addrs = [("127.0.0.1", n["port"]) for n in nodes]
            clients = {nm: ChainClient(addrs, sampling=greedy, prefill_chunk=512, adapter=nm)
                       for nm in set(names)}

            async def one(p, nm):
                stamps: List[float] = []
                t_req = time.perf_counter()
                ids = await clients[nm].generate_ids(
                    p, max_new_tokens=NEW_TOKENS,
                    on_token=lambda _tok: stamps.append(time.perf_counter()))
                return ids, t_req, stamps

            return await asyncio.gather(*(one(p, nm) for p, nm in zip(prompts, names)))

        t_all = time.perf_counter()
        served = asyncio.run(drive())
        wall = time.perf_counter() - t_all
        after = stats()
        streams = [ids for ids, _, _ in served]
        for i, (p, nm, (ids, t_req, stamps)) in enumerate(zip(prompts, names, served)):
            if len(ids) != NEW_TOKENS:
                raise AssertionError(f"prompt {len(p)}: {len(ids)} tokens, want {NEW_TOKENS}")
            ttft = (stamps[0] - t_req) * 1e3
            tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            b_ttft, b_tps = baseline["rates"][i]
            say(phase, f"session {i} ({nm or 'base'}), prompt {len(p)} tokens: TTFT {ttft:.1f} ms, "
                       f"decode {tps:.1f} tok/s over {len(stamps) - 1} steps ({card}); "
                       f"serve_lanes in this run: TTFT {b_ttft:.1f} ms, {b_tps:.1f} tok/s")
        total = sum(len(ids) for ids in streams)
        say(phase, f"aggregate: {total} tokens from {len(prompts)} concurrent sessions in "
                   f"{wall:.2f} s = {total / wall:.1f} tok/s ({card}); serve_lanes in this run: "
                   f"{baseline['tokens_per_s']:.1f} tok/s")
        for i, (nm, a_, b_) in enumerate(zip(names, streams, base_streams)):
            if (nm is None) != (a_ == b_):
                how = "differs from" if nm is None else "equals"
                raise AssertionError(f"session {i} ({nm or 'base'}): stream {how} the base "
                                     "model's on the same prompt (serve_lanes)")
        say(phase, "tenant streams differ from the base model's on the same prompts, and the "
                   "base sessions' equal serve_lanes', token for token")

        def pieces(idx):
            return [len(c[j:j + LANE_PREFILL_CHUNK]) for i in idx
                    for c in (prompts[i][k:k + 512] for k in range(0, len(prompts[i]), 512))
                    for j in range(0, len(c), LANE_PREFILL_CHUNK)]

        want_prefill = len(pieces(range(len(prompts))))
        want_tenant_prefill = len(pieces([i for i, nm in enumerate(names) if nm]))
        want_decode_tokens = len(prompts) * (NEW_TOKENS - 1)
        launches = dict.fromkeys(after[0]["kernels"], 0)
        route_launches = {"split": 0, "mma": 0}
        mean_batches = []
        paged_split = 0
        for st in after:
            ex = st["executor"]
            layers = st["end_layer"] - st["start_layer"] + 1
            kern = {name: k["launches"] for name, k in st["kernels"].items()}
            steps, toks = ex["batched_steps"], ex["batched_tokens"]
            a_dec, a_pre = ex["adapter_steps"], ex["adapter_prefill_steps"]
            mean = toks / steps if steps else 0.0
            mean_batches.append(mean)
            want = {"flash_gqa": layers * ex["prefill_steps"], "paged_decode_gqa": layers * steps,
                    "w8a16_matmul": 0, "w4a16_matvec": 0,
                    "fused_lane_delta": layers * n_targets * (a_dec + a_pre)}
            say(phase, f"node stage {st['stage']} on {st['device']}: {steps} decode dispatches "
                       f"({a_dec} with a tenant lane, {steps - a_dec} all-base) serving {toks} "
                       f"session steps (mean co-batch {mean:.3f}; serve_lanes in this run "
                       f"{baseline['mean_batch'][st['stage']]:.3f}), {ex['prefill_steps']} prefill "
                       f"dispatches ({a_pre} of tenant sessions); launches {kern} (want {want}: "
                       f"{kern == want}); registry {ex['adapters']}")
            routes = flash_routes(st)
            want_routes = {"split": 0, "mma": layers * ex["prefill_steps"]}
            say(phase, f"node stage {st['stage']}: flash_gqa routes {routes} (want "
                       f"{want_routes}: {routes == want_routes})")
            split, want_split = paged_splits(phase, st, cfg)
            paged_split += split
            if (kern != want or kern["fused_lane_delta"] == 0 or a_pre != want_tenant_prefill
                    or routes != want_routes or split != want_split
                    or not 0 < a_dec <= steps or toks != want_decode_tokens
                    or ex["prefill_steps"] != want_prefill or ex["adapters"]["loads"] != 3
                    or st["errors"]):
                raise AssertionError(
                    f"stage {st['stage']}: launches {kern} (want {want}), {a_pre} tenant prefill "
                    f"dispatches (want {want_tenant_prefill}), {a_dec} of {steps} decode "
                    f"dispatches with a tenant, {toks} steps (want {want_decode_tokens}), "
                    f"{ex['prefill_steps']} prefill dispatches (want {want_prefill}), registry "
                    f"{ex['adapters']} (want 3 loads), {st['errors']} errors, flash_gqa "
                    f"routes {routes} (want {want_routes}), paged split launches {split} "
                    f"(want {want_split})")
            for name, v in kern.items():
                launches[name] += v
            for r, v in routes.items():
                route_launches[r] += v
        stop_nodes(nodes)
        nodes = []

        loaded = [load_stage_checkpoint(stage_checkpoint_path(parts, s), device=DEVICE)
                  for s in range(2)]
        local_ex = lane_executors(cfg, loaded, PAGED_BS, False, dirs)

        async def local():
            out = []
            for p, nm in zip(prompts, names):
                client = make_local_client(local_ex, greedy, adapter=nm)
                out.append(await client.generate_ids(p, max_new_tokens=NEW_TOKENS))
            return out

        local_streams = asyncio.run(local())
        del local_ex
        torch.cuda.empty_cache()
        for p, nm, a_, b_ in zip(prompts, names, streams, local_streams):
            if a_ != b_:
                diverge = next(i for i, (x, y) in enumerate(zip(a_, b_)) if x != y)
                raise AssertionError(f"prompt {len(p)} ({nm or 'base'}): served stream != "
                                     f"in-process lane executors' stream from token {diverge}")
        say(phase, "served streams equal the in-process lane executors' with the same "
                   f"registries (sessions one at a time), token for token ({len(prompts)} x "
                   f"{NEW_TOKENS} tokens)")
        gemv_total = {name: {r: sum(gemv_routes(st)[name][r] for st in after)
                             for r in ("mma", "simt")} for name in QMM_KERNEL_OF.values()}
        out = {"launches": launches, "flash_routes": route_launches, "gemv_routes": gemv_total,
               "paged_split": paged_split, "mean_batch": mean_batches,
               "tokens_per_s": total / wall}
        out["paged_e2e"] = check_teacher_forced(phase, "paged lanes", cfg, loaded, PAGED_BS,
                                                prompts, streams, LORA_E2E_FAULTS,
                                                lora=(dirs, names))
        return out
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


# -- generate, generate_quant, serve_kstep, cli: the whole model in one process --

GEN_CHUNK = 8  # fused decode steps per host read in the chunked runs (generate(chunk=8))
GEN_SEED = 11  # the sampler's seed in the sampled runs
# bench.py's headline regime: a 64-token prompt, generate_scan at 50 and 150
# steps under the default SamplingConfig, differenced in interleaved pairs
HEADLINE_PROMPT = 64
HEADLINE_STEPS = (50, 150)
HEADLINE_PAIRS = 3
KSTEP_WINDOW = 8  # serve_kstep: decode_steps per /forward


def serve_prompts(vocab: int) -> List[List[int]]:
    """The serve phase's prompts (PROMPT_LENS tokens each, from seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _wrappers():
    from inferd_tpu_torch.ops import attention as A
    from inferd_tpu_torch.ops import lora
    from inferd_tpu_torch.ops import qmatmul as Q

    return {"flash_gqa": A.flash_gqa, "paged_decode_gqa": A.paged_decode_gqa,
            "w8a16_matmul": Q.w8a16_matmul, "w4a16_matvec": Q.w4a16_matvec,
            "fused_lane_delta": lora.fused_lane_delta}


def reset_kernel_counts() -> None:
    """Every wrapper's launch and route counters in this process to 0."""
    for w in _wrappers().values():
        for attr in ("launches", "split_launches", "mma_launches", "simt_launches"):
            if hasattr(w, attr):
                setattr(w, attr, 0)


def kernel_counts() -> Dict[str, Any]:
    """This process's counters, in the shape a phase result carries them."""
    w = _wrappers()
    return {"launches": {name: f.launches for name, f in w.items()},
            "flash_routes": {r: getattr(w["flash_gqa"], f"{r}_launches") for r in ("split", "mma")},
            "gemv_routes": {name: {r: getattr(w[name], f"{r}_launches") for r in ("mma", "simt")}
                            for name in ("w8a16_matmul", "w4a16_matvec")}}


def whole_model(parts: str):
    """The serve phase's two stage checkpoints joined into the whole model's
    params on the card: the same seeded weights, initialised once."""
    import torch

    from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path

    (p0, s0, _), (p1, s1, _) = [load_stage_checkpoint(stage_checkpoint_path(parts, s),
                                                      device=DEVICE) for s in range(2)]
    if s0.end_layer + 1 != s1.start_layer:
        raise AssertionError(f"stage layers {s0} {s1} do not join")
    return {"embed": p0["embed"], "final_norm": p1["final_norm"],
            "layers": {k: torch.cat([p0["layers"][k], p1["layers"][k]]) for k in p0["layers"]}}


def generate_three_ways(eng, prompt, seed: int) -> List[List[int]]:
    """NEW_TOKENS tokens by Engine.generate at chunk 1 and at GEN_CHUNK, and
    by generate_scan, from one seed."""
    import numpy as np

    from inferd_tpu_torch.core.generate import bucket_len

    padded = [prompt + [0] * (bucket_len(len(prompt)) - len(prompt))]
    return [eng.generate(prompt, NEW_TOKENS, seed=seed),
            eng.generate(prompt, NEW_TOKENS, seed=seed, chunk=GEN_CHUNK),
            eng.generate_scan(np.asarray(padded), len(prompt), NEW_TOKENS, seed=seed)[0].tolist()]


def first_divergence(a: List[int], b: List[int]) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def check_flash_routes(phase: str, counts, runs: int, layers: int) -> None:
    """One prefill chunk per run on the tensor cores, NEW_TOKENS - 1 decode
    steps on the split-KV route, `layers` launches each, as flash_plan
    routes them: exact."""
    want = {"split": layers * (NEW_TOKENS - 1) * runs, "mma": layers * runs}
    got = counts["flash_routes"]
    say(phase, f"flash_gqa routes {got} over {runs} generations (want {want}: {got == want})")
    if got != want or counts["launches"]["flash_gqa"] != sum(want.values()):
        raise AssertionError(f"{phase}: flash_gqa launches {counts}, want routes {want}")


@contextlib.contextmanager
def planted_kstep_slot_fault():
    """Until the block ends, decode_k writes each step's K/V one slot early,
    over the previous token's (its positions and masks stay right): the
    fault the chunked stream's equality with the per-step one must catch."""
    import torch

    from inferd_tpu_torch.models import qwen3 as Q

    real = Q.forward_layers

    def faulty(layers, cfg, hidden, positions, k_cache=None, v_cache=None,
               cache_write_pos=None, *rest, **kw):
        if isinstance(cache_write_pos, torch.Tensor):  # decode_k's per-row write
            cache_write_pos = cache_write_pos - 1
        return real(layers, cfg, hidden, positions, k_cache, v_cache, cache_write_pos, *rest, **kw)

    Q.forward_layers = faulty
    try:
        yield
    finally:
        Q.forward_layers = real


def forced_logits(eng, prompts, streams) -> List[Any]:
    """Last-token logits of each prompt's prefill and of its stream's first
    DECODE_CHECKED tokens fed one at a time, through the engine."""
    import torch

    out = []
    with torch.no_grad():
        for p, ids in zip(prompts, streams):
            logits, cache = eng.prefill(p, eng.new_cache(1))
            out.append(logits.float())
            for tok in ids[:DECODE_CHECKED]:
                tok_t = torch.tensor([[tok]], device=DEVICE)
                out.append(eng._forward(tok_t, cache.length, cache, 1).float())
                cache.length += 1
    return out


def headline(phase: str, card: str, methods) -> Dict[str, Dict[str, float]]:
    """bench.py's headline regime for each (name, run(n_steps, seed))
    method: one warm-up run, then HEADLINE_PAIRS interleaved pairs of
    50- and 150-step runs (host clock, each ending in a read of its
    tokens), differenced by utils.profiling.paired_delta_stats."""
    import torch

    from inferd_tpu_torch.utils.profiling import interleaved_pair_times, paired_delta_stats

    short, long_ = HEADLINE_STEPS
    out = {}
    for name, run in methods:
        seeds = iter(range(1, 1000))
        run(short, 0)  # nothing compiles: one run warms the allocator and the caches

        def timed(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n, next(seeds))
            return time.perf_counter() - t0

        ts, tl = interleaved_pair_times(lambda: timed(short), lambda: timed(long_), HEADLINE_PAIRS)
        per, n_valid, spread, ts_valid = paired_delta_stats(ts, tl, short, long_)
        e2e_t = statistics.median(ts_valid)
        overhead = max(e2e_t - short * per, 0.0) * 1e3 if n_valid else 0.0
        out[name] = {"steady_ms_per_token": per * 1e3, "e2e_tok_s": short / e2e_t,
                     "overhead_ms": overhead, "valid_pairs": n_valid, "spread_pt": spread}
        say(phase, f"headline {name}: steady {per * 1e3:.3f} ms/token ({1 / per:.1f} tok/s), "
                   f"e2e {short / e2e_t:.1f} tok/s over {short} tokens, fixed overhead "
                   f"{overhead:.1f} ms; {n_valid}/{HEADLINE_PAIRS} valid pairs, spread "
                   f"{spread}% ({card})")
    return out


def device_share(phase: str, card: str, name: str, fn, per: int, reps: int = 4):
    """Where one decode step's time goes: the host clock per step (no
    profiler), and from a torch.profiler trace (CUPTI) of `reps` more calls
    the device's busy time per step (the sum of its kernels' durations) and
    the kernels launched per step; `fn` runs `per` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / (reps * per) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / (reps * per) / 1e3
    by_name: Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / (reps * per)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host_top = sorted(((e.key, e.self_cpu_time_total / (reps * per)) for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), key=lambda kv: -kv[1])[:8]
    say(phase, f"{name}: most host time under the profiler, ms per step: "
               + ", ".join(f"{k[:40]} {v / 1e3:.3f}" for k, v in host_top))
    out = {"host_ms": host_ms, "device_busy_ms": busy_ms if kernels else None,
           "kernels_per_step": len(kernels) / (reps * per)}
    if not kernels:
        say(phase, f"{name}: {host_ms:.3f} ms per step on the host clock; device time not "
                   f"measured (the profiler traced no kernel) ({card})")
        return out
    say(phase, f"{name}: {host_ms:.3f} ms per step on the host clock; the device is busy "
               f"{busy_ms:.3f} ms of it ({max(0.0, 1 - busy_ms / host_ms):.0%} idle) over "
               f"{out['kernels_per_step']:.0f} kernel launches per step (torch.profiler); "
               "most device time: " + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top)
               + f" ({card})")
    return out


def headline_methods(eng, prompt, scan_only: bool = False):
    """(name, run) pairs over one engine for `headline`: generate_scan, and
    unless scan_only, generate at chunk 1 and at GEN_CHUNK."""
    import numpy as np

    toks = np.asarray([prompt])
    methods = [("generate_scan", lambda n, seed: eng.generate_scan(
        toks, len(prompt), n, seed=seed).cpu())]
    if not scan_only:
        methods += [(f"generate(chunk={c})", lambda n, seed, c=c: eng.generate(
            prompt, n, seed=seed, chunk=c)) for c in (1, GEN_CHUNK)]
    return methods


def run_generate(card: str, params, serve: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The `generate` phase: the engine in this process, the whole model
    (with `serve`'s streams, the shared prefixes are printed)."""
    import numpy as np
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core import sampling as samplib
    from inferd_tpu_torch.core.generate import Engine, bucket_len
    from inferd_tpu_torch.ops.attention import flash_plan

    phase = "generate"
    cfg = get_config(MODEL)
    prompts = serve_prompts(cfg.vocab_size)
    greedy_cfg = SamplingConfig(temperature=0.0)
    engines = {"greedy": Engine(cfg, params, sampling_cfg=greedy_cfg),
               "sampled (0.6/20/0.95)": Engine(cfg, params)}
    for p in prompts:
        b = bucket_len(len(p))
        plans = [flash_plan(1, b, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.torch_dtype, 0, b),
                 flash_plan(1, 1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.torch_dtype,
                            len(p), len(p) + 1)]
        say(phase, f"prompt {len(p)}: prefill bucket {b} -> {plans[0].route}, decode at "
                   f"{len(p)} -> {plans[1].route} ({plans[1].splits} splits)")
    reset_kernel_counts()
    t0 = time.perf_counter()
    streams = {name: [generate_three_ways(eng, p, GEN_SEED) for p in prompts]
               for name, eng in engines.items()}
    counts = kernel_counts()
    wall = time.perf_counter() - t0
    for name, per_prompt in streams.items():
        for p, (a, b, c) in zip(prompts, per_prompt):
            if not a == b == c:
                raise AssertionError(
                    f"{name}, prompt {len(p)}: chunk 1 / chunk {GEN_CHUNK} / generate_scan "
                    f"differ from token {min(first_divergence(a, b), first_divergence(a, c))}")
        say(phase, f"{name}: generate(chunk=1), generate(chunk={GEN_CHUNK}) and generate_scan "
                   f"give the same tokens on all {len(prompts)} prompts ({NEW_TOKENS} each, "
                   f"seed {GEN_SEED}); distinct tokens per stream "
                   f"{[len(set(s[0])) for s in per_prompt]}")
    runs = 3 * len(prompts) * len(engines)
    say(phase, f"{runs} generations of {NEW_TOKENS} tokens in {wall:.1f}s; launches "
               f"{counts['launches']}")
    check_flash_routes(phase, counts, runs, cfg.num_layers)
    others = {k: v for k, v in counts["launches"].items() if k != "flash_gqa"}
    if any(others.values()):
        raise AssertionError(f"{phase}: bf16 generation launched {others}")
    greedy = [s[0] for s in streams["greedy"]]

    # the planted fault: decode_k's KV one slot early must break the equality
    # of the chunked streams with the per-step ones (greedy or sampled)
    caught = {}
    with planted_kstep_slot_fault():
        for name, eng in engines.items():
            caught[name] = [len(p) for p, s in zip(prompts, streams[name])
                            if eng.generate(p, NEW_TOKENS, seed=GEN_SEED, chunk=GEN_CHUNK) != s[0]]
    say(phase, f"planted fault kv_slot_early (decode_k writes each step's K/V one slot early): "
               f"chunk {GEN_CHUNK} differs from chunk 1 on prompts {caught} of "
               f"{list(PROMPT_LENS)}")
    if not any(caught.values()):
        raise AssertionError("planted fault kv_slot_early passes the chunk equality")

    # teacher-forced: the kernel path against plain attention, logits only
    plain = Engine(dataclasses.replace(cfg, attn_impl="xla"), params, sampling_cfg=greedy_cfg)
    got = forced_logits(engines["greedy"], prompts, greedy)
    ref = forced_logits(plain, prompts, greedy)
    l_err = max((g - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, ref))
    say(phase, f"kernel path vs plain attention over {len(ref)} teacher-forced steps (prefill + "
               f"{DECODE_CHECKED} decode steps per prompt): logits {l_err:.4%} of max |logit| "
               f"(tol {LOGIT_TOL:.0%})")
    if not l_err <= LOGIT_TOL:
        raise AssertionError(f"{phase}: kernel path vs plain attention, logits {l_err}")
    del plain, got, ref
    for p, a, s in zip(prompts, greedy, serve["streams"] if serve else ()):
        say(phase, f"prompt {len(p)}: the engine's greedy stream shares its first "
                   f"{first_divergence(a, s)} of {NEW_TOKENS} tokens with the serve phase's "
                   "chain stream (printed, not gated: other buffers, other split plans)")

    # bench.py's headline regime, and what a step and the sampler cost
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, HEADLINE_PROMPT).tolist()
    eng = Engine(cfg, params, max_len=512)
    rates = headline(phase, card, headline_methods(eng, prompt))
    logits, cache = eng.prefill(prompt, eng.new_cache(1, 512))
    sub = samplib.split_key(samplib.prng_key(0))[1]
    key = samplib.prng_key(0)
    tok = samplib.sample(logits, sub)
    steps = {"decode (one step)": (lambda: eng.decode(tok, cache, sub), 1),
             f"decode_chunk ({GEN_CHUNK} steps)": (
                 lambda: eng.decode_chunk(tok, cache, key, GEN_CHUNK), GEN_CHUNK)}
    step_share = {name: device_share(phase, card, name, fn, per) for name, (fn, per)
                  in steps.items()}
    row = torch.randn(1, cfg.vocab_size, device=DEVICE) * 3
    sampler = {}
    for label, args in (("0.6/20/0.95 (topk 20 of V)", (0.6, 20, 0.95, 0.0)),
                        ("0.6/0/0.95 (sort of V)", (0.6, 0, 0.95, 0.0)),
                        ("greedy (argmax)", (0.0, 0, 1.0, 0.0))):
        sampler[label] = time_ms(lambda a=args: samplib.sample(row, sub, *a))
    say(phase, f"sampler on [1, {cfg.vocab_size}] float32 logits, device ms per call: "
               + ", ".join(f"{k} {v:.4f}" for k, v in sampler.items()) + f" ({card})")
    del eng, cache, engines
    torch.cuda.empty_cache()
    return dict(counts, rates=rates, step_share=step_share, sampler_ms=sampler)


def run_generate_quant(card: str, params) -> Dict[str, Any]:
    """The `generate_quant` phase: the engine on --quant int8 weights."""
    import numpy as np
    import torch

    from inferd_tpu_torch.config import SamplingConfig, get_config
    from inferd_tpu_torch.core.generate import Engine, bucket_len
    from inferd_tpu_torch.ops import quant
    from inferd_tpu_torch.ops.qmatmul import MAX_KERNEL_ROWS

    phase = "generate_quant"
    cfg = get_config(MODEL)
    prompts = serve_prompts(cfg.vocab_size)
    qparams = quant.apply_quant_mode("int8", params, tie_word_embeddings=cfg.tie_word_embeddings)
    eng = Engine(cfg, qparams, sampling_cfg=SamplingConfig(temperature=0.0))
    reset_kernel_counts()
    small_rows, head_rows = [], []
    for p in prompts:
        a = eng.generate(p, NEW_TOKENS)
        b = eng.generate(p, NEW_TOKENS, chunk=GEN_CHUNK)
        if a != b:
            raise AssertionError(f"{phase}, prompt {len(p)}: chunk {GEN_CHUNK} != chunk 1 from "
                                 f"token {first_divergence(a, b)}")
        bucket = bucket_len(len(p))
        for _ in range(2):  # a prefill (its head on the last row), then decode steps
            small_rows += ([bucket] if bucket <= MAX_KERNEL_ROWS else []) + [1] * (NEW_TOKENS - 1)
            head_rows += [1] * NEW_TOKENS
    counts = kernel_counts()
    say(phase, f"int8 greedy: generate(chunk={GEN_CHUNK}) equals generate(chunk=1) on all "
               f"{len(prompts)} prompts")
    check_flash_routes(phase, counts, 2 * len(prompts), cfg.num_layers)
    per_step = gemv_route_launches(cfg, "int8", cfg.num_layers, True, [1], [1])
    want = gemv_route_launches(cfg, "int8", cfg.num_layers, True, small_rows, head_rows)
    got = counts["gemv_routes"]["w8a16_matmul"]
    say(phase, f"w8a16_matmul routes {got} (want {want}: {got == want}); a decode step "
               f"launches {per_step} = {GEMVS_PER_LAYER} x {cfg.num_layers} + 1")
    if (per_step != {"mma": 0, "simt": GEMVS_PER_LAYER * cfg.num_layers + 1} or got != want
            or counts["launches"]["w8a16_matmul"] != sum(want.values())
            or counts["launches"]["w4a16_matvec"]):
        raise AssertionError(f"{phase}: GEMV launches {counts}, want {want}")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, HEADLINE_PROMPT).tolist()
    rates = headline(phase, card, headline_methods(Engine(cfg, qparams, max_len=512), prompt,
                                                   scan_only=True))
    del eng, qparams
    torch.cuda.empty_cache()
    return dict(counts, rates=rates)


def kstep_session(process, sid: str, prompt: List[int], eos=None, sampling=None):
    """A raw /forward session: the prompt's prefill (its first token the
    logits' argmax), then windows of KSTEP_WINDOW decode_steps up to
    NEW_TOKENS tokens or eos, the key chained. Returns (stream, the
    windows' results)."""
    import numpy as np

    r = process(sid, {"tokens": np.asarray([prompt], np.int32), "start_pos": 0,
                      "real_len": len(prompt)})
    out = [int(np.argmax(np.asarray(r["logits"], np.float32)[0]))]
    windows, key = [], None
    while len(out) < NEW_TOKENS and (eos is None or out[-1] != eos):
        pl = {"tokens": [[out[-1]]], "start_pos": len(prompt) + len(out) - 1,
              "decode_steps": min(KSTEP_WINDOW, NEW_TOKENS - len(out)), "seed": GEN_SEED}
        if eos is not None:
            pl["eos"] = eos
        if sampling is not None:
            pl["sampling"] = sampling
        if key is not None:
            pl["key"] = key
        w = process(sid, pl)
        windows.append({k: w[k] for k in ("tokens", "real_len", "decode_steps", "key")})
        out += [int(t) for t in w["tokens"][0]]
        key = w["key"]
    return out, windows


def node_process(node: Dict[str, Any], stage: int = 0):
    """A session-step callable over a node's /forward (raw payloads)."""
    from inferd_tpu_torch.client.base import ServerError, http_post
    from inferd_tpu_torch.runtime import wire

    def process(sid, payload):
        status, raw = http_post(f"http://127.0.0.1:{node['port']}/forward", wire.pack(
            {"session_id": sid, "stage": stage, "relay": False, "payload": payload}), 300.0)
        body = wire.unpack(raw)
        if status != 200:
            raise ServerError(str(body.get("error")), status, body.get("code"))
        return body["result"]

    return process


def run_serve_kstep(card: str, params, parts: str, work: str) -> Dict[str, Any]:
    """The `serve_kstep` phase: decode_steps through /forward on a one-stage
    node, against the same executor in this process."""
    import torch

    from inferd_tpu_torch.client.base import ServerError
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.parallel.stages import (
        StageSpec, save_stage_checkpoint, stage_checkpoint_path)
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor

    phase = "serve_kstep"
    cfg = get_config(MODEL)
    spec = StageSpec(0, 1, 0, cfg.num_layers - 1)
    parts1 = os.path.join(work, "parts1")
    save_stage_checkpoint(stage_checkpoint_path(parts1, 0), params, spec, MODEL)
    prompts = serve_prompts(cfg.vocab_size)
    modes = (("greedy", None), ("sampled", {"temperature": 0.6, "top_k": 20, "top_p": 0.95}))
    nodes: List[Dict[str, Any]] = []
    try:
        nodes = [start_node(parts1, 0, work, tag="_kstep"), start_node(parts, 0, work,
                                                                        tag="_chain0")]
        for n in nodes:
            wait_ready(n)
        before = http_get_json(f"http://127.0.0.1:{nodes[0]['port']}/stats")
        if any(k["launches"] for k in before["kernels"].values()) or before["forward_passes"]:
            raise AssertionError(f"the node did work before the main path: {before}")
        local = Qwen3StageExecutor(cfg, spec, params, max_len=MAX_LEN)
        served, prefills, steps, stops = {}, 0, 0, 0
        for mode, sampling in modes:
            for i, p in enumerate(prompts):
                free, _ = kstep_session(local.process, f"free-{mode}-{i}", p, sampling=sampling)
                # eos: the free run's token 5, or the first that is not its token 0
                eos = next((t for t in free[5:] + free[1:] if free.index(t) > 0), None)
                want = kstep_session(local.process, f"local-{mode}-{i}", p, eos, sampling)
                got = kstep_session(node_process(nodes[0]), f"node-{mode}-{i}", p, eos, sampling)
                if got != want:
                    raise AssertionError(f"{phase} {mode}, prompt {len(p)}: the node's windows "
                                         f"{got[1]} != in-process {want[1]}")
                cut = len(free) if eos is None else free.index(eos) + 1
                if got[0] != free[:cut]:
                    raise AssertionError(f"{phase} {mode}, prompt {len(p)}: the eos run is not "
                                         "the free run cut at eos")
                stops += sum(w["real_len"] < w["decode_steps"] for w in got[1])
                served[(mode, len(p))] = got
                prefills += 1
                steps += sum(w["decode_steps"] for w in got[1])
                for ex_sid in (f"free-{mode}-{i}", f"local-{mode}-{i}"):
                    local.end_session(ex_sid)
            say(phase, f"{mode}: {len(prompts)} sessions of decode_steps {KSTEP_WINDOW} windows: "
                       "tokens, real_len, decode_steps and key equal the in-process executor's, "
                       "and each stream is its free run's cut at eos (the free run's token 5); "
                       "real_len per window "
                       + str([[w['real_len'] for w in served[(mode, len(p))][1]] for p in prompts]))
        if not stops:
            raise AssertionError(f"{phase}: no eos stopped a window mid-way")
        st = http_get_json(f"http://127.0.0.1:{nodes[0]['port']}/stats")
        kern = {name: k["launches"] for name, k in st["kernels"].items()}
        routes = flash_routes(st)
        want_routes = {"split": cfg.num_layers * steps, "mma": cfg.num_layers * prefills}
        windows = sum(len(v[1]) for v in served.values())
        say(phase, f"node: {st['forward_passes']} forward passes ({prefills} prefills, {windows} "
                   f"windows of {steps} decode steps in all); launches {kern}; flash_gqa routes "
                   f"{routes} (want {want_routes}: {routes == want_routes})")
        if (routes != want_routes or st["forward_passes"] != prefills + windows
                or kern["flash_gqa"] != sum(want_routes.values())
                or any(v for name, v in kern.items() if name != "flash_gqa")):
            raise AssertionError(f"{phase}: node stats {st}")
        chain0 = node_process(nodes[1])
        chain0("chain", {"tokens": [prompts[0]], "start_pos": 0, "real_len": len(prompts[0])})
        try:
            chain0("chain", {"tokens": [[1]], "start_pos": len(prompts[0]), "decode_steps": 4})
            raise AssertionError("stage 0 of the two-stage chain served decode_steps")
        except ServerError as e:
            say(phase, f"stage 0 of the two-stage chain answers decode_steps with HTTP "
                       f"{e.status} {e.code}: {e}")
            if e.status != 409 or e.code != "session_state" or "single-stage" not in str(e):
                raise
        del local
        torch.cuda.empty_cache()
        return {"launches": kern, "flash_routes": routes, "gemv_routes": gemv_routes(st)}
    except BaseException:
        stop_nodes(nodes, show_logs=True)
        nodes = []
        raise
    finally:
        stop_nodes(nodes)


def run_cli(card: str) -> None:
    """The `cli` phase: tools/generate as a user runs it, on the card by
    default."""
    phase = "cli"
    cmd = [sys.executable, "-m", "inferd_tpu_torch.tools.generate", "--model", MODEL,
           "--random-init", "--prompt-ids", ",".join(str(t) for t in range(100, 132)),
           "--max-new-tokens", "16", "--chunk", "8"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    ids = json.loads(r.stdout.split("generated ids:", 1)[1].strip().splitlines()[0])
    rate = r.stderr.strip().splitlines()[-1]
    say(phase, f"{' '.join(cmd[1:4])} ... exit 0 in {time.perf_counter() - t0:.1f}s with "
               f"{len(ids)} ids; {rate} ({card})")
    if len(ids) != 16 or "on cuda" not in rate:
        raise AssertionError(f"{phase}: {r.stdout!r} {r.stderr[-2000:]!r}")


# -- main -----------------------------------------------------------------------


def ptxas_report(log: str) -> List[str]:
    """One line per kernel of nvcc's -Xptxas -v log: its (demangled, where
    c++filt is found) name, registers, static shared memory and spills."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True, text=True
                                      ).stdout.strip() or name
            name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


CASE_PHASES = {"flash": run_kernel_cases, "paged": run_paged_cases, "qmm": run_qmm_cases,
               "lora": run_lora_cases}


def main(argv: List[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port end to end on one CUDA card.")
    ap.add_argument("--only", default="", help="comma-separated phases to run alone "
                    f"({', '.join(CASE_PHASES)}, generate: the generate and generate_quant "
                    "phases on a fresh split), after the build; the default runs every phase")
    only = [x for x in ap.parse_args(argv).only.split(",") if x]
    if any(x not in CASE_PHASES and x != "generate" for x in only):
        ap.error(f"--only takes {sorted(CASE_PHASES) + ['generate']}, got {only}")

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

    from concurrent.futures import ThreadPoolExecutor

    from inferd_tpu_torch.ops import build

    with ThreadPoolExecutor(len(build.KERNELS)) as pool:  # one nvcc per source, all at once
        infos = dict(zip(build.KERNELS, pool.map(build.build, build.KERNELS)))
    for name, info in infos.items():
        regs = ptxas_report(info["log"])
        say("build", f"{name}: {os.path.relpath(info['path'], REPO)} "
                     f"({'built' if info['built'] else 'cached'} in {info['seconds']:.1f}s); "
                     f"ptxas ({len(regs)} kernels): {regs}")

    if only:  # a partial run: the named phases, no serve phases and no result lines
        for name in only:
            if name != "generate":
                CASE_PHASES[name]()
                continue
            work = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                whole = whole_model(split_parts(work))
                run_generate(card, whole, None)
                run_generate_quant(card, whole)
                del whole
            finally:
                shutil.rmtree(work, ignore_errors=True)
        say("done", f"case phases {only} passed in {time.perf_counter() - t_start:.1f}s")
        return 0
    cases = run_kernel_cases()
    paged_cases = run_paged_cases()
    qmm_cases = run_qmm_cases()
    lora_cases = run_lora_cases()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        parts = split_parts(work)
        serve = run_serve(card, parts, work)
        serve_q = {q: run_serve(card, parts, work, quant_flag=q, baseline=serve)
                   for q in ("int8", "int4")}
        lanes = run_serve_lanes(card, parts, work)
        lanes_q = run_serve_lanes(card, parts, work, quant_flag="int8", baseline=lanes)
        lanes_lora = run_serve_lanes_lora(card, parts, work, baseline=lanes)
        whole = whole_model(parts)
        gen = run_generate(card, whole, serve)
        gen_q = run_generate_quant(card, whole)
        kstep = run_serve_kstep(card, whole, parts, work)
        del whole
        torch.cuda.empty_cache()
        run_cli(card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths = {"serve": serve, "serve_quant_int8": serve_q["int8"],
             "serve_quant_int4": serve_q["int4"], "serve_lanes": lanes,
             "serve_lanes_quant": lanes_q, "serve_lanes_lora": lanes_lora,
             "generate": gen, "generate_quant": gen_q, "serve_kstep": kstep}

    def by_path(name):
        return {path: r["launches"][name] for path, r in paths.items() if r["launches"][name]}

    def timed(row):
        return {"ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    def qmm_timed(row):
        return dict(timed(row), library_call=row["library_call"],
                    library_note=row["library_note"],
                    dequant_matmul_yardstick_ms=row["dequant_matmul_yardstick_ms"],
                    plan={k: row[k] for k in ("route", "cluster", "k_per_rank", "ctas")})

    def qmm_entry(name, kernel, replaces):
        rows = [r for r in qmm_cases if r["kernel"] == kernel]
        main_row = next(r for r in rows if r["case"] == QMM_MAIN_CASE)
        lane_row = next(r for r in rows if r["case"] == QMM_LANE_CASE)
        launches = by_path(name)
        return dict({
            "name": name, "route": "cuda", "source": "inferd_tpu_torch/csrc/qmatmul.cu",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_row_err": max(r["row_err"] for r in rows if r["dtype"] == "bfloat16"),
        }, **qmm_timed(main_row), **{
            "shape": f"{QMM_MAIN_CASE}: M 1, K 1024, N 151936 (the tied head), bf16, {kernel}",
            QMM_LANE_CASE: dict(qmm_timed(lane_row), shape="M 8, K 1024, N 3072, bf16"),
            "launches_by_route": {r: sum(res["gemv_routes"][name][r] for res in paths.values())
                                  for r in ("mma", "simt")},
            "stage_step": [qmm_stage_sums(qmm_cases, kernel, m) for m in (1, 8)],
        })

    def lora_timed(row):
        return dict(timed(row), gather_bmm_yardstick_ms=row["gather_bmm_yardstick_ms"])

    lora_main = next(r for r in lora_cases if r["case"] == LORA_MAIN_CASE)
    lora_prefill = next(r for r in lora_cases if r["case"] == LORA_PREFILL_CASE)
    lora_y = next(r for r in lora_cases if r["case"] == LORA_Y_MAIN_CASE)
    lora_delta_rows = [r for r in lora_cases if "checks" not in r]  # f32 deltas, LORA_TOL
    lora_launches = by_path("fused_lane_delta")
    main_case = next(c for c in cases if c["case"] == MAIN_CASE)
    paged_main = next(c for c in paged_cases if c["case"] == PAGED_MAIN_CASE)
    paged_launches = by_path("paged_decode_gqa")
    flash_routes_all = {r: sum(res["flash_routes"][r] for res in paths.values())
                        for r in ("split", "mma")}
    lanes_chunk = next(c for c in cases if c["case"] == LANES_CHUNK_CASE)
    def flash_entry(route, replaces, row, shape):
        """One entry per flash_gqa kernel: its Pallas kernel, the launches of
        its route, the errors of the cases that ran on it, its main case."""
        on_route = [c for c in cases if c["route"] == route]
        return dict({
            "name": f"flash_gqa.{route}",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/flash_gqa.cu",
            "replaces": replaces,
            "launches": flash_routes_all[route],
            "launches_by_path": {path: r["flash_routes"][route] for path, r in paths.items()
                                 if r["flash_routes"][route]},
            "max_abs_err": max(c["max_abs_err"] for c in on_route),
            "max_row_err": max(c["row_err"] for c in on_route
                               if c["dtype"].startswith("bfloat16")),
        }, **timed(row), shape=shape)

    kernels = {"kernels": [
        # the one wrapper's two kernels: split-KV (with its combine) for
        # decode, the tensor cores for prompt chunks, as flash_plan routes
        flash_entry("split", "inferd_tpu/ops/attention.py:131", main_case,
                    f"{MAIN_CASE}: B 1, S 1, T 1024, Nq 16, Nkv 8, D 128, bf16"),
        flash_entry("mma", "inferd_tpu/ops/attention.py:218", lanes_chunk,
                    f"{LANES_CHUNK_CASE}: B 1, S 256, T 1024, kv_len 700 (device meta), bf16"),
        dict({
            "name": "paged_decode_gqa",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/paged_decode.cu",
            "replaces": "inferd_tpu/ops/attention.py:460",
            "launches": sum(paged_launches.values()),
            "launches_by_path": paged_launches,
            "max_abs_err": max(c["max_abs_err"] for c in paged_cases),
            "max_row_err": max(c["row_err"] for c in paged_cases
                               if c["dtype"].startswith("bfloat16")),
            "launches_split": sum(res["paged_split"] for res in paths.values()
                                  if "paged_split" in res),
        }, **timed(paged_main),  # library_ms None: no single PyTorch call computes it
            plan=paged_main["plan"],
            shape=f"{PAGED_MAIN_CASE}: B 8, bs 32, MB 32, kv_len {paged_main['kv_len']}, "
                  "Nq 16, Nkv 8, D 128, bf16"),
        # library_ms: torch's own weight-only quantized product on the same
        # weight (library_call); dequant_matmul_yardstick_ms is torch.matmul
        # against the weight dequantized beforehand, what --quant none pays
        qmm_entry("w8a16_matmul", "w8a16", "inferd_tpu/ops/qmatmul.py:34"),
        qmm_entry("w4a16_matvec", "w4a16_grouped", "inferd_tpu/ops/qmatmul.py:94"),
        dict({
            "name": "fused_lane_delta",
            "route": "cuda",
            "source": "inferd_tpu_torch/csrc/lora_delta.cu",
            "replaces": "inferd_tpu/ops/lora.py:313",
            "launches": sum(lora_launches.values()),
            "launches_by_path": lora_launches,
            "max_abs_err": max(r["max_abs_err"] for r in lora_delta_rows),
            "max_row_err": max(r["row_err"] for r in lora_delta_rows),
        }, **lora_timed(lora_main),  # library_ms None: no single PyTorch call computes it
            plan=lora_main["plan"],
            shape=f"{LORA_MAIN_CASE}: B 8, S 1, in 1024, out 3072, r 16, ids {LORA_DECODE_IDS}, "
                  "bf16 pools 4 x 14 layers",
            **{LORA_PREFILL_CASE: dict(lora_timed(lora_prefill), plan=lora_prefill["plan"],
                                       shape="B 1, S 256, in 1024, out 3072, r 16, bf16"),
               LORA_Y_MAIN_CASE: dict(timed(lora_y), unfused_ms=lora_y["unfused_ms"],
                                      plan=lora_y["plan"],
                                      shape="the main case with y= (bf16), in place")}),
    ]}
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception as e:  # report the failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
