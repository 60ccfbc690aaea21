"""Model splitter: full params -> per-stage checkpoints (port of
inferd_tpu/tools/split_model.py).

Loads a preset's weights from a local safetensors checkpoint (`--weights`:
a directory, an HF repo id, or by default the preset's repo in the local HF
cache; models/loader), or draws them from a seed with `--random-init`, on
the chosen device; splits the layer stack evenly into N stages and writes
`stage_NNN.msgpack` files in the JAX package's format (the same bytes its
tool writes from the same weights).

`--num-layers N` keeps the preset's first N layers: a checkpoint cut to
that depth at the preset's width (the stage files name the preset, and a
node serves their layer ranges).

Usage:
  python -m inferd_tpu_torch.tools.split_model --model llama3.2-1b --stages 2 \\
      [--weights DIR_OR_REPO] [--num-layers N] --out parts/ [--device cuda|cpu]
  python -m inferd_tpu_torch.tools.split_model --model qwen3-0.6b --stages 2 \\
      --random-init --seed 0 --out parts/
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from inferd_tpu_torch.config import get_config
from inferd_tpu_torch.models import loader, qwen3
from inferd_tpu_torch.parallel.stages import Manifest, split_and_save
from inferd_tpu_torch.utils.platform import DEVICE_CHOICES, resolve_device


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="model preset name")
    ap.add_argument("--stages", type=int, default=2, help="even split into N stages")
    ap.add_argument("--out", required=True, help="output directory for stage checkpoints")
    ap.add_argument("--weights",
                    help="safetensors dir / HF repo id (default: the preset's repo in the "
                         "local HF cache)")
    ap.add_argument("--random-init", action="store_true",
                    help="seeded random weights instead of a checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=0,
                    help="the preset's first N layers only (a depth cut; default: all)")
    ap.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that holds the weights while they are split (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.num_layers:
        cfg = cfg.with_layers(args.num_layers)
    manifest = Manifest.even_split(cfg.name, args.stages, num_layers=cfg.num_layers)
    if args.random_init:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = qwen3.init_params(cfg, gen, device=device)
    else:
        try:
            params = loader.load_params(cfg, args.weights, device=device)
        except FileNotFoundError:  # no checkpoint: stop, never split random weights
            ap.error(f"no checkpoint to split: {loader.searched(args.weights or cfg.name)}")
    paths = split_and_save(params, cfg, manifest, args.out)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
