"""Model splitter: full params -> per-stage checkpoints (port of
inferd_tpu/tools/split_model.py).

Initializes a preset's weights from a seed on the chosen device, splits
the layer stack evenly into N stages and writes `stage_NNN.msgpack` files in
the JAX package's format. Loading real weights (the port of
models/loader.py) waits until the weight files are in the repository, so
`--random-init` is required.

Usage:
  python -m inferd_tpu_torch.tools.split_model --model qwen3-0.6b --stages 2 \\
      --random-init --seed 0 --out parts/ [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from inferd_tpu_torch.config import get_config
from inferd_tpu_torch.models import qwen3
from inferd_tpu_torch.parallel.stages import Manifest, split_and_save
from inferd_tpu_torch.utils.platform import DEVICE_CHOICES, resolve_device


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="model preset name")
    ap.add_argument("--stages", type=int, default=2, help="even split into N stages")
    ap.add_argument("--out", required=True, help="output directory for stage checkpoints")
    ap.add_argument("--random-init", action="store_true",
                    help="seeded random weights (required: weight loading is not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that draws the weights (default cuda)")
    args = ap.parse_args(argv)
    if not args.random_init:
        ap.error("loading checkpoint weights is not ported yet: pass --random-init")
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    manifest = Manifest.even_split(cfg.name, args.stages)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = qwen3.init_params(cfg, gen, device=device)
    paths = split_and_save(params, cfg, manifest, args.out)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
