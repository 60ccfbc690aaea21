"""Local generation CLI: run a model end to end in this process, on the card
by default (port of inferd_tpu/tools/generate.py, its plain and batched
engines).

Loads a preset's checkpoint from the local HF cache (models/loader: the
preset's repo under $HF_HOME, safetensors, no download), or with
`--random-init` draws seeded random weights; optionally merges a peft LoRA
adapter and quantizes, then generates with `--engine plain`
(core.generate.Engine: prefill, on-device sampling, and `--chunk` fused
decode steps per host read) or `--engine batched` (core.batch.
BatchedEngine with `--lanes` lanes: the prompt through generate_all, the
batched engine's loop, `--chunk` steps per window). Prints the new ids (or
the decoded text with `--prompt`) on stdout and the rate on stderr.

Usage:
  python -m inferd_tpu_torch.tools.generate --model llama3.2-1b [--random-init] \\
      [--num-layers N] --prompt-ids 3,7,11 --max-new-tokens 16 [--chunk 8] [--device cuda|cpu] \\
      [--engine plain|batched [--lanes 4]] \\
      [--quant none|int8|int8-kernel|int4] [--kv-dtype model|float8_e4m3fn] \\
      [--attn auto|flash|xla] [--lora DIR] [--pin-prefix-ids 3,7 --max-pins 4] \\
      [--temperature 0.6 --top-k 20 --top-p 0.95 --min-p 0 --seed 0] [--max-len 2048]

`--num-layers N` keeps the preset's first N layers, for a checkpoint cut to
that depth at the preset's width.

Not ported yet, and refused with the ROADMAP item that brings them:
`--engine speculative` (A7) and `--quant w8a8` (A6). Without a local
checkpoint (and without `--random-init`) the tool stops with exit 2 and
names where it looked: it never falls back to random weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import torch

from inferd_tpu_torch.config import HF_REPOS, SamplingConfig, get_config
from inferd_tpu_torch.ops import lora as loralib
from inferd_tpu_torch.ops import quant
from inferd_tpu_torch.utils.platform import DEVICE_CHOICES, resolve_device

_NOT_PORTED = {
    ("engine", "speculative"): "--engine speculative is not ported yet: ROADMAP A7",
    ("quant", "w8a8"): "--quant w8a8 is not ported yet: ROADMAP A6",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="generate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="the preset's first N layers only (a checkpoint cut to that depth; "
                    "default: all)")
    ap.add_argument("--random-init", action="store_true",
                    help="seeded random weights instead of the preset's local checkpoint")
    ap.add_argument("--prompt", default="", help="text prompt (needs a tokenizer)")
    ap.add_argument("--prompt-ids", default="", help="comma-separated token ids")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--engine", default="plain", choices=["plain", "batched", "speculative"])
    ap.add_argument("--lanes", type=int, default=4, help="batched: lanes")
    ap.add_argument("--chunk", type=int, default=1,
                    help="fused decode steps per host read (powers of two)")
    ap.add_argument("--lora", default="", help="peft LoRA adapter dir merged into the weights")
    ap.add_argument("--quant", default="none", choices=quant.QUANT_CHOICES)
    ap.add_argument("--kv-dtype", default="model", choices=["model", "float8_e4m3fn"])
    ap.add_argument("--attn", default="auto", choices=["auto", "flash", "xla"])
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p filtering: drop tokens below min_p * max-prob")
    ap.add_argument("--seed", type=int, default=0, help="the sampler's seed")
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that runs the model (default cuda)")
    ap.add_argument("--pin-prefix-ids", default="",
                    help="comma-separated token ids pinned as a prefix snapshot before "
                    "generating (prompts starting with them skip re-prefilling them)")
    ap.add_argument("--max-pins", type=int, default=4,
                    help="LRU cap on pinned prefix snapshots (each holds a KV snapshot)")
    return ap


def _ids(text: str) -> List[int]:
    return [int(t) for t in text.split(",")]


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for (flag, value), msg in _NOT_PORTED.items():
        if getattr(args, flag) == value:
            ap.error(msg)
    if not (args.prompt_ids or args.prompt):
        ap.error("need --prompt or --prompt-ids")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: say so, never fall back to the CPU
        ap.error(str(e))

    from inferd_tpu_torch.core.batch import BatchedEngine
    from inferd_tpu_torch.core.generate import Engine
    from inferd_tpu_torch.models import loader, qwen3

    cfg = get_config(args.model)
    if args.num_layers:
        cfg = cfg.with_layers(args.num_layers)
    if args.kv_dtype != "model":
        cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype)
    if args.attn != "auto":
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, min_p=args.min_p)
    if args.random_init:
        # the weights' seed is fixed, as the reference's --random-init; --seed samples
        params = qwen3.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
    else:
        try:
            params = loader.load_params(cfg, device=device)
        except FileNotFoundError:  # no checkpoint: stop, never random weights in its place
            ap.error(f"no checkpoint for {cfg.name}: {loader.searched(cfg.name)}; "
                     "pass --random-init for seeded random weights")
    if args.lora:
        params = loralib.merge_adapter(params, loralib.load_adapter(cfg, args.lora))
    params = quant.apply_quant_mode(args.quant, params,
                                    tie_word_embeddings=cfg.tie_word_embeddings)
    if device.type == "cuda":
        from inferd_tpu_torch.ops import build

        build.load("flash_gqa")  # a kernel that cannot build fails now
        if args.quant != "none":
            build.load("qmatmul")

    tokenizer = None
    if args.prompt_ids:
        prompt_ids, eos = _ids(args.prompt_ids), None
    else:
        from inferd_tpu_torch.core.tokenizer import Tokenizer

        tokenizer = Tokenizer(HF_REPOS.get(cfg.name, cfg.name))
        prompt_ids = tokenizer.apply_chat_template(
            [{"role": "user", "content": args.prompt}], add_generation_prompt=True)
        eos = tokenizer.eos_token_id

    t0 = time.perf_counter()
    if args.engine == "batched":
        if args.pin_prefix_ids:
            ap.error("--pin-prefix-ids pins into the plain engine only")
        beng = BatchedEngine(cfg, params, lanes=args.lanes, max_len=args.max_len,
                             sampling_cfg=sampling, device=device)
        out = beng.generate_all([prompt_ids], args.max_new_tokens, eos_token_id=eos,
                                seed=args.seed, chunk=args.chunk)[0]
    else:
        eng = Engine(cfg, params, max_len=args.max_len, sampling_cfg=sampling,
                     max_pins=args.max_pins)
        if args.pin_prefix_ids:
            eng.pin_prefix(_ids(args.pin_prefix_ids))
        out = eng.generate(prompt_ids, args.max_new_tokens, eos_token_id=eos, seed=args.seed,
                           chunk=args.chunk)
    dt = time.perf_counter() - t0

    if tokenizer is not None:
        print(tokenizer.decode(out))
    else:
        print("generated ids:", out)
    rate = len(out) / dt if dt > 0 else 0.0
    print(f"[{len(out)} tokens in {dt:.2f}s = {rate:.1f} tok/s on {device}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
