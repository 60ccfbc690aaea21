"""Start one chain-mode stage node (port of inferd_tpu/tools/run_node.py,
chain topology only).

Loads `stage_NNN.msgpack` from the parts directory (its `meta_json` gives
the model and the stage's layer range), places it on the device, builds the
CUDA kernels there if needed, and serves /forward, /end_session, /health
and /stats until SIGINT or SIGTERM. Prints one JSON line
{"ready": true, ...} when it accepts requests.

Usage:
  python -m inferd_tpu_torch.tools.run_node --parts parts/ --stage 0 \\
      --port 6050 [--device cuda|cpu] [--max-len 4096]
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
from typing import List, Optional

from inferd_tpu_torch.config import get_config
from inferd_tpu_torch.parallel.stages import load_stage_checkpoint, stage_checkpoint_path
from inferd_tpu_torch.runtime.executor import make_executor
from inferd_tpu_torch.runtime.node import ChainNode
from inferd_tpu_torch.utils.platform import DEVICE_CHOICES, resolve_device

DEFAULT_HTTP_PORT = 6050


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="run_node", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parts", required=True, help="directory of stage_NNN.msgpack files")
    ap.add_argument("--stage", type=int, required=True, help="stage this node serves")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_HTTP_PORT)
    ap.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that runs the stage (default cuda)")
    ap.add_argument("--max-len", type=int, default=4096, help="per-session KV budget (tokens)")
    return ap


def make_node(args: argparse.Namespace) -> ChainNode:
    device = resolve_device(args.device)
    params, spec, model_name = load_stage_checkpoint(
        stage_checkpoint_path(args.parts, args.stage), device=device
    )
    if spec.stage != args.stage:
        raise ValueError(f"{args.parts}: checkpoint holds stage {spec.stage}, not {args.stage}")
    executor = make_executor(get_config(model_name), spec, params, max_len=args.max_len)
    if device.type == "cuda":
        from inferd_tpu_torch.ops import build

        build.load("flash_gqa")  # a kernel that cannot build fails the node now
    return ChainNode(executor, host=args.host, port=args.port)


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    node = make_node(args)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    node.start()
    print(json.dumps({
        "ready": True, "host": node.host, "port": node.port, "stage": node.spec.stage,
        "layers": [node.spec.start_layer, node.spec.end_layer], "device": node.device,
    }), flush=True)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        node.stop()


if __name__ == "__main__":
    main()
