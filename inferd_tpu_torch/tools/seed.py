"""Standalone swarm seed: a bare gossip peer to bootstrap against (port of
inferd_tpu/tools/seed.py).

A seed holds no stage, announces no record and serves no traffic: it answers
HELLO with the swarm's state and relays gossip, giving nodes that start
later a rendezvous address that outlives any of them. It prints one JSON
line {"ready": true, "host", "port"} once its socket is bound (port 0 picks
an ephemeral one), then a line {"view": {stage: [node ids]}} whenever the
set of live records it holds changes, and runs until SIGINT or SIGTERM.

Usage:
  python -m inferd_tpu_torch.tools.seed --port 7050 [--host 0.0.0.0] \\
      [--bootstrap host:port[,host:port...]]
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import uuid
from typing import Dict, List, Optional

from inferd_tpu_torch.control.dht import SwarmDHT
from inferd_tpu_torch.tools.run_node import DEFAULT_GOSSIP_PORT, parse_bootstrap

VIEW_POLL_S = 0.5  # how often the seed looks for a change in its live view


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="seed", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=DEFAULT_GOSSIP_PORT,
                    help="UDP port of the gossip (0 = ephemeral)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--bootstrap", default="", help="optional peer seeds host:port,...")
    ap.add_argument("--log-level", default="INFO")
    return ap


def view(dht: SwarmDHT) -> Dict[str, List[str]]:
    """{stage: sorted node ids} of the live records the seed holds."""
    return {str(stage): sorted(recs) for stage, recs in sorted(dht.get_all().items())}


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(), force=True)
    # an ephemeral port is not known yet: a random id keeps two seeds apart
    seed_id = f"seed:{args.port}" if args.port else f"seed-{uuid.uuid4().hex[:8]}"
    dht = SwarmDHT(seed_id, args.port, bootstrap=parse_bootstrap(args.bootstrap), host=args.host)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    dht.start()
    print(json.dumps({"ready": True, "host": args.host, "port": dht.port}), flush=True)
    last = None
    try:
        while not stop.wait(VIEW_POLL_S):
            now = view(dht)
            if now != last:
                print(json.dumps({"view": now}), flush=True)
                last = now
    finally:
        dht.stop()


if __name__ == "__main__":
    main()
