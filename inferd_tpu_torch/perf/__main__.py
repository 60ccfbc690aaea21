"""perf CLI (port of inferd_tpu/perf/__main__.py).

    python -m inferd_tpu_torch.perf report --preset qwen3-0.6b [--chip h100]
        [--ctx N] [--batch B]
    python -m inferd_tpu_torch.perf anatomy --preset qwen3-0.6b [--quant int8]
        [--ctx N] [--batch B] [--pairs K] [--paged-block-size BS]
        [--phases embed,dispatch] [--device cuda|cpu]

`report` is host arithmetic (perf/roofline) and touches no device.
`anatomy` runs the step's phases on the device (default the card; `--device
cpu` runs the plain loops on the host) and prints ONE JSON line last.
`check` and `report --artifact` wait for perf/gate.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from inferd_tpu_torch.utils.platform import DEVICE_CHOICES


def cmd_report(args) -> int:
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.perf import roofline as rl

    print(rl.format_report(get_config(args.preset), rl.get_chip(args.chip), ctx=args.ctx,
                           batch=args.batch))
    return 0


def cmd_anatomy(args) -> int:
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.perf import anatomy
    from inferd_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    phases = tuple(p.strip() for p in args.phases.split(",") if p.strip()) or None
    out = anatomy.profile_step(
        get_config(args.preset), quant=args.quant, ctx=args.ctx, batch=args.batch,
        pairs=args.pairs, phases=phases, paged_block_size=args.paged_block_size, device=device,
    )
    print(json.dumps(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m inferd_tpu_torch.perf")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="analytic roofline table for a preset")
    rp.add_argument("--preset", required=True)
    rp.add_argument("--chip", default="h100")
    rp.add_argument("--ctx", type=int, default=0)
    rp.add_argument("--batch", type=int, default=1)
    rp.set_defaults(fn=cmd_report)

    an = sub.add_parser("anatomy", help="step-anatomy profile on the device (one JSON line)")
    an.add_argument("--preset", required=True)
    an.add_argument("--quant", default="none")
    an.add_argument("--ctx", type=int, default=256)
    an.add_argument("--batch", type=int, default=1)
    an.add_argument("--pairs", type=int, default=3)
    an.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that runs the phases (default cuda)")
    an.add_argument("--phases", default="",
                    help="comma-separated subset of the phases to time (default all)")
    an.add_argument("--paged-block-size", type=int, default=0,
                    help="time the attention phase through the paged read (paged_decode_gqa "
                    "over a block table) with this block size in tokens (0 = dense)")
    an.set_defaults(fn=cmd_anatomy)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
