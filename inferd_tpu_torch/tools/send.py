"""Network generation CLI: drive a running swarm (or a fixed chain) from the
command line (port of inferd_tpu/tools/send.py, its --entry, --chain and
--routed topologies).

The tool sends bytes only: the nodes compute, the client here samples on
the host, so there is no --device. `--entry` enters at stage-0 nodes and
lets the swarm relay (client/swarm_client.SwarmClient); `--chain` drives
each stage's server in order itself (client/chain_client.ChainClient);
`--routed` joins the swarm's gossip at the given UDP addresses as an
observer, waits up to 10 s for every stage of --num-stages to show, and
drives a chain that D*-Lite plans per session over the live view
(client/routed_client.RoutedChainClient). The new ids print as
`generated ids: [...]` (the decoded text with --prompt), or one by one as
they are sampled with --stream.

`--pin-prefix-ids` pins those ids as a shared prefix first (the prompt
must start with them): the generation forks the pinned session's KV on
every stage instead of prefilling it. `--server-side` (with --entry only)
POSTs /generate and lets the entry node run the token loop (one round
trip; with --stream, chunked ndjson lines as the node samples them), the
pin then held by the node.

  python -m inferd_tpu_torch.tools.send --entry 127.0.0.1:6050 --prompt-ids 3,7,11
  python -m inferd_tpu_torch.tools.send --chain 127.0.0.1:6050,127.0.0.1:6051 \\
      --prompt-ids 3,7,11 --temperature 0 --max-new-tokens 16
  python -m inferd_tpu_torch.tools.send --routed 127.0.0.1:7050 --num-stages 2 \\
      --prompt-ids 3,7,11
  python -m inferd_tpu_torch.tools.send --entry 127.0.0.1:6050 --prompt-ids 3,7,11,5 \\
      --pin-prefix-ids 3,7,11 --server-side
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time
import uuid
from typing import List, Optional, Tuple

ROUTED_WAIT_S = 10.0  # how long --routed waits for every stage to show in its view


def parse_addrs(value: str) -> List[Tuple[str, int]]:
    out = []
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host:
            raise ValueError(f"{part!r} is not host:port")
        out.append((host, int(port)))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="send", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--entry", default="",
                   help="comma-separated stage-0 entry nodes (swarm relay topology)")
    g.add_argument("--chain", default="",
                   help="comma-separated per-stage servers in order (fixed chain)")
    g.add_argument("--routed", default="",
                   help="comma-separated gossip (UDP) bootstrap addresses: the chain is "
                   "planned per session by D*-Lite over the live swarm view (needs "
                   "--num-stages)")
    ap.add_argument("--num-stages", type=int, default=0, help="pipeline depth for --routed")
    ap.add_argument("--prompt", default="", help="text prompt (needs a tokenizer)")
    ap.add_argument("--prompt-ids", default="", help="comma-separated token ids")
    ap.add_argument("--tokenizer", default="", help="HF tokenizer name or path for --prompt")
    ap.add_argument("--max-new-tokens", type=int, default=50)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p filtering: drop tokens below min_p * max-prob")
    ap.add_argument("--logprobs", action="store_true",
                    help="also print each token's model log-probability (without --stream)")
    ap.add_argument("--top-logprobs", type=int, default=0,
                    help="also print the top-N alternatives and their logprobs per step "
                    "(without --stream)")
    ap.add_argument("--seed", type=int, default=0, help="the sampler's seed")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--session-retries", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--pin-prefix-ids", default="",
                    help="comma-separated token ids to pin as a shared prefix before "
                    "generating: each stage forks the pinned KV instead of prefilling it "
                    "(the prompt must start with these ids)")
    ap.add_argument("--server-side", action="store_true",
                    help="--entry only: POST /generate and let the node run the token loop "
                    "(one round trip)")
    ap.add_argument("--stream", action="store_true",
                    help="print each token as it is sampled (with --server-side: as the "
                    "node's chunked ndjson lines arrive)")
    return ap


def _pin_ids(args) -> List[int]:
    return [int(t) for t in args.pin_prefix_ids.split(",")] if args.pin_prefix_ids else []


async def _drive(args, client, ids: List[int], eos: Optional[int], tokenizer) -> int:
    pin_ids = _pin_ids(args)

    def show(tok):
        if tok is None:
            print("\n[restart]", flush=True)
        elif tokenizer is not None:
            print(tokenizer.decode([tok]), end="", flush=True)
        else:
            print(tok, end=" ", flush=True)

    # a streamed run never prints the sinks: no per-token log-softmax for them
    lps = [] if (args.logprobs and not args.stream) else None
    tops = [] if (args.top_logprobs and not args.stream) else None
    async with client as c:
        if args.server_side and args.stream:
            out = await c.generate_server_side_stream(
                ids, show, max_new_tokens=args.max_new_tokens, eos_token_id=eos,
                seed=args.seed, pin_prefix_len=len(pin_ids))
        elif args.server_side:
            out = await c.generate_server_side(
                ids, max_new_tokens=args.max_new_tokens, eos_token_id=eos, seed=args.seed,
                pin_prefix_len=len(pin_ids), logprob_sink=lps,
                top_logprobs=args.top_logprobs if tops is not None else 0, top_sink=tops)
        else:
            if pin_ids:
                await c.pin_prefix(pin_ids)
            out = await c.generate_ids(
                ids, max_new_tokens=args.max_new_tokens, eos_token_id=eos, seed=args.seed,
                session_retries=args.session_retries, on_token=show if args.stream else None,
                logprob_sink=lps, top_n=args.top_logprobs, top_sink=tops)
    if args.stream:
        print()
        return 0
    if tokenizer is not None:
        print(tokenizer.decode(out))
    else:
        print("generated ids:", out)
    if lps is not None:
        print("logprobs:", [round(x, 4) for x in lps])
    if tops is not None:
        for step, (ti, tl) in enumerate(tops):
            print(f"top[{step}]:", list(zip(ti, [round(x, 4) for x in tl])))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from inferd_tpu_torch.config import SamplingConfig

    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, min_p=args.min_p)
    tokenizer = None
    if args.prompt_ids:
        ids, eos = [int(t) for t in args.prompt_ids.split(",")], None
    elif args.prompt:
        from inferd_tpu_torch.core.tokenizer import Tokenizer

        tokenizer = Tokenizer(args.tokenizer or None)
        ids = tokenizer.apply_chat_template([{"role": "user", "content": args.prompt}],
                                            add_generation_prompt=True)
        eos = tokenizer.eos_token_id
    else:
        ap.error("need --prompt or --prompt-ids")
    # the reference's checks, before any topology is joined
    if args.server_side and not args.entry:
        print("--server-side needs --entry (swarm topology)", file=sys.stderr)
        return 2
    pin_ids = _pin_ids(args)
    if pin_ids and ids[:len(pin_ids)] != pin_ids:
        print("prompt does not start with --pin-prefix-ids", file=sys.stderr)
        return 2
    kw = dict(sampling=sampling, timeout_s=args.timeout, prefill_chunk=args.prefill_chunk)
    if args.routed:
        return _routed(ap, args, kw, ids, eos, tokenizer)
    if args.entry:
        from inferd_tpu_torch.client.swarm_client import SwarmClient

        client = SwarmClient(parse_addrs(args.entry), **kw)
    else:
        from inferd_tpu_torch.client.chain_client import ChainClient

        client = ChainClient(parse_addrs(args.chain), **kw)
    return asyncio.run(_drive(args, client, ids, eos, tokenizer))


def _routed(ap, args, kw, ids: List[int], eos: Optional[int], tokenizer) -> int:
    """--routed: a records-less gossip observer bootstrapped to the given
    addresses (an ephemeral UDP port), a RoutedChainClient over it once
    every stage shows; 1 when the view does not fill within ROUTED_WAIT_S."""
    from inferd_tpu_torch.client.routed_client import RoutedChainClient
    from inferd_tpu_torch.control.dht import SwarmDHT

    if args.num_stages < 1:
        ap.error("--routed needs --num-stages")
    dht = SwarmDHT(f"send-{uuid.uuid4().hex[:8]}", 0, bootstrap=parse_addrs(args.routed))
    dht.start()
    try:
        deadline = time.monotonic() + ROUTED_WAIT_S
        while not all(dht.get_all(args.num_stages)[s] for s in range(args.num_stages)):
            if time.monotonic() >= deadline:
                print("swarm view never converged via --routed bootstrap", file=sys.stderr)
                return 1
            time.sleep(0.1)
        client = RoutedChainClient(dht, args.num_stages, **kw)
        return asyncio.run(_drive(args, client, ids, eos, tokenizer))
    finally:
        dht.stop()


if __name__ == "__main__":
    sys.exit(main())
