"""Start one stage node (port of inferd_tpu/tools/run_node.py, the chain and
relay topologies).

Loads `stage_NNN.msgpack` from the parts directory (its `meta_json` gives
the model and the stage's layer range), places it on the device, builds the
CUDA kernels there if needed, joins the swarm's gossip (its UDP port
--gossip-port, seeds --bootstrap) and serves /forward, /end_session,
/health and /stats until SIGINT or SIGTERM. Prints one JSON line
{"ready": true, ...} when it accepts requests. With --backend counter the
stage is the weightless counter model (no --parts; --num-stages gives the
pipeline's depth).

Usage:
  python -m inferd_tpu_torch.tools.run_node --parts parts/ --stage 0 \\
      --port 6050 [--device cuda|cpu] [--max-len 4096] [--kv-dtype model|float8_e4m3fn] \\
      [--manifest cluster.yaml --name node0] [--model PRESET] [--log-level INFO] \\
      [--gossip-port 7050] [--bootstrap host:port[,host:port...]] \\
      [--capacity 4] [--rebalance-period 10] \\
      [--stage-lanes N | --batch-lanes N] [--window-ms W] \\
      [--paged-kv BS [--kv-blocks K]] [--prefill-chunk C] \\
      [--adapters DIR[,DIR...] [--adapter-slots N]] \\
      [--quant none|int8|int8-kernel|int4] [--lora DIR] \\
      [--enable-profiling [--profile-dir DIR]] \\
      [--hop-timeout S] [--hedge-delay-ms D] [--hedge-mode advertised|any|off] \\
      [--admission-reserve F] [--rescue-bounces N] [--chaos SPEC] \\
      [--standby-repl [--repl-interval S]]

With --stage-lanes the stage serves its sessions from lanes of one shared
KV cache, and co-arriving decode steps of concurrent sessions run as one
device step (stage-level continuous batching); --batch-lanes does the same
for the whole model from a 1-stage checkpoint (runtime/batch_executor,
whole-model continuous batching; the two are exclusive); --paged-kv pages
the lanes' cache. Either lane node also serves `decode_steps` windows when
it holds the whole model.
With --quant the stage's linear weights are quantized at load (the
checkpoint stays bf16 on disk) and its decode GEMVs run the kernels of
csrc/qmatmul.cu, on either executor. --lora merges one peft adapter into the
stage's weights at load, before --quant, on either executor; --adapters
serves many on either lane node, each session's own adapter added per lane by the
kernel of csrc/lora_delta.cu (the two are exclusive). --enable-profiling
opens POST /profile: torch.profiler traces of the node on demand, under
--profile-dir.
The overload plane's knobs (runtime/node.py): --hop-timeout bounds each
relay hop (a request's deadline bounds it further), --hedge-delay-ms and
--hedge-mode shape hedged decode relays, --admission-reserve is the free
share of a paged pool under which new sessions are shed (503 busy with
Retry-After), --rescue-bounces caps a failed-over chunk's relays to the
replica advertising its session, and --chaos injects faults
(utils/chaos.py; resilience testing only). --standby-repl replicates each
resident session's KV to a standby of the same stage every --repl-interval
seconds (runtime/repl): when the holder crashes, the standby promotes the
copy and the client re-sends only the tokens past it. A node whose executor
exports nothing (the stage lanes, the counter) keeps and promotes its
peers' shadows but replicates none of its own sessions, and logs so.

Elasticity: every --rebalance-period seconds (jittered) the node's balancer
may migrate it to a stage that has no live replica or carries much more
load than its own (control/balance.py); POST /reassign {"stage": N} migrates
it at once and POST /drain stops it admitting new sessions. A migration
loads the target stage's checkpoint from the same --parts with the same
flags (load_executor), builds its kernels and warms it up before it serves.

A swarm: start the stage-0 seed with --gossip-port P, every other node
with --bootstrap <seed host>:P (each with a gossip port of its own, or 0
for an ephemeral one), and send requests to any stage-0 node with
client/swarm_client.SwarmClient or tools/send. The defaults of
--gossip-port and --bootstrap come from GOSSIP_PORT and BOOTSTRAP_NODES. A
standalone gossip seed (tools/seed) gives the nodes a bootstrap address
that outlives any of them.

A node's identity, each with the reference's precedence, flag > environment
> manifest > default: --name (NODE_NAME) is its name in the --manifest
(the cluster's YAML topology, parallel/stages.Manifest) and in its gossip
record (default: its host:port); --stage (INITIAL_STAGE), else the
manifest entry's stage, else 0. With a manifest the checkpoint must hold
the manifest's model, stage count and layer range for that stage. Without
one, --model (when given) must name the checkpoint's model. --kv-dtype
(INFERD_KV_DTYPE) stores the KV cache as float8_e4m3fn; the counter
backend keeps no KV and refuses it.

  python -m inferd_tpu_torch.tools.seed --port 7050
  python -m inferd_tpu_torch.tools.run_node --manifest examples/cluster.yaml \\
      --name node1 --parts parts/ --port 6051 --gossip-port 0 \\
      --bootstrap 127.0.0.1:7050

  python -m inferd_tpu_torch.tools.run_node --backend counter --num-stages 3 \\
      --stage 0 --port 6050 --gossip-port 7050 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import threading
from typing import Any, List, NamedTuple, Optional, Tuple

from inferd_tpu_torch.config import get_config
from inferd_tpu_torch.ops import lora as loralib
from inferd_tpu_torch.ops import quant
from inferd_tpu_torch.parallel.stages import (
    Manifest, StageSpec, load_stage_checkpoint, stage_checkpoint_path,
)
from inferd_tpu_torch.runtime.adapters import AdapterRegistry
from inferd_tpu_torch.runtime.executor import make_executor
from inferd_tpu_torch.runtime.node import Node
from inferd_tpu_torch.utils.chaos import Chaos
from inferd_tpu_torch.utils.platform import DEVICE_CHOICES, resolve_device

DEFAULT_HTTP_PORT = 6050
DEFAULT_GOSSIP_PORT = 7050


def parse_bootstrap(value: Optional[str]) -> List[Tuple[str, int]]:
    """Parse `host:port,host:port` gossip seeds."""
    if not value:
        return []
    out = []
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host:
            raise ValueError(f"bootstrap entry {part!r} is not host:port")
        out.append((host, int(port)))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="run_node", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parts", default="", help="directory of stage_NNN.msgpack files "
                    "(required but with --backend counter)")
    ap.add_argument("--manifest", default="", help="cluster topology YAML (the stage table "
                    "this node's --name looks up)")
    ap.add_argument("--name", default=os.environ.get("NODE_NAME"),
                    help="this node's name in the manifest and its gossip record (env "
                    "NODE_NAME; default: its host:port)")
    ap.add_argument("--model", default="",
                    help="model preset without a manifest: the checkpoint must hold it")
    ap.add_argument("--stage", type=int, default=None,
                    help="stage this node serves (env INITIAL_STAGE; default: the manifest "
                    "entry's, else 0)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_HTTP_PORT)
    ap.add_argument("--backend", default="qwen3", choices=["qwen3", "counter"],
                    help="'counter' = the weightless distribution-test backend")
    ap.add_argument("--num-stages", type=int, default=2,
                    help="pipeline depth with --backend counter (a checkpoint names its own)")
    ap.add_argument("--gossip-port", type=int,
                    default=int(os.environ.get("GOSSIP_PORT", DEFAULT_GOSSIP_PORT)),
                    help="UDP port of the swarm's gossip (env GOSSIP_PORT; 0 = ephemeral)")
    ap.add_argument("--bootstrap", default=os.environ.get("BOOTSTRAP_NODES", ""),
                    help="comma-separated host:port gossip seeds (env BOOTSTRAP_NODES)")
    ap.add_argument("--capacity", type=int, default=4, help="advertised task capacity")
    ap.add_argument("--rebalance-period", type=float, default=10.0,
                    help="seconds between the balancer's passes (jittered): each may migrate "
                    "this node to a starved or hot stage (control/balance.py)")
    ap.add_argument("--device", default="cuda", choices=DEVICE_CHOICES,
                    help="device that runs the stage (default cuda)")
    ap.add_argument("--max-len", type=int, default=4096, help="per-session KV budget (tokens)")
    ap.add_argument(
        "--kv-dtype", default=os.environ.get("INFERD_KV_DTYPE", "model"),
        choices=["model", "float8_e4m3fn"],
        help="KV cache storage dtype (env INFERD_KV_DTYPE): float8_e4m3fn halves the "
        "per-token KV read that dominates long-context decode",
    )
    ap.add_argument(
        "--stage-lanes", type=int, default=0,
        help="stage-level continuous batching: serve this node's pipeline stage "
        "with this many session lanes; co-arriving decode steps of concurrent "
        "sessions run as ONE device step per arrival window (0 = off)",
    )
    ap.add_argument(
        "--batch-lanes", type=int, default=0,
        help="whole-model continuous batching: serve a 1-stage checkpoint with this "
        "many session lanes; concurrent decode steps coalesce into one device step "
        "(0 = off; exclusive with --stage-lanes)",
    )
    ap.add_argument(
        "--window-ms", type=float, default=2.0,
        help="arrival-window length for --stage-lanes / --batch-lanes decode "
        "co-batching; a solo session never pays it",
    )
    ap.add_argument(
        "--paged-kv", type=int, default=0,
        help="paged KV block size in tokens (0 = dense lane slab). Lanes map to "
        "chains of fixed-size pool blocks through a block table: allocation and "
        "eviction become per-block, and sessions sharing a cached prompt prefix "
        "map its blocks read-only (copy-on-write). Needs --stage-lanes or --batch-lanes",
    )
    ap.add_argument(
        "--kv-blocks", type=int, default=0,
        help="paged KV pool size in blocks (0 = full provisioning: lanes x "
        "ceil(max_len/block)). Lower overcommits device memory on mixed-length "
        "traffic; overflow surfaces as per-session KV errors, not OOM",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="server-side chunked prefill: ingest prompts in dispatches of at "
        "most this many tokens, releasing the device between chunks so "
        "co-batched decode windows interleave (0 = whole-prompt dispatches)",
    )
    ap.add_argument(
        "--quant", default="none", choices=quant.QUANT_CHOICES,
        help="serving quantization, applied at load: int8 (weight-only, per output "
        "channel) and int8-kernel route the same way here: decode-shaped products "
        "(<= 64 rows) run the w8a16 CUDA kernel, longer ones a plain product; int4 "
        "(group-wise w4a16, quarter the weight bytes) runs the w4a16 kernel. w8a8 is "
        "not ported yet and fails at start",
    )
    ap.add_argument(
        "--lora", default=os.environ.get("INFERD_LORA", ""),
        help="peft LoRA adapter directory merged into this node's stage weights at "
        "load time, before quantization (env INFERD_LORA); mutually exclusive with "
        "--adapters",
    )
    ap.add_argument(
        "--adapters", default=os.environ.get("INFERD_ADAPTERS", ""),
        help="multi-tenant LoRA: comma-separated peft adapter directories forming "
        "this node's adapter CATALOG (env INFERD_ADAPTERS). Sessions admitted with "
        "an `adapter` envelope key decode with that adapter's weights via the "
        "batched unmerged apply — heterogeneous-adapter sessions co-batch in ONE "
        "device step; adapters hot-load/evict through a refcounted slot registry "
        "and replicas gossip residency (`ada`) for affinity routing. Needs "
        "--stage-lanes or --batch-lanes; mutually exclusive with --lora",
    )
    ap.add_argument(
        "--adapter-slots", type=int, default=0,
        help="device-resident adapter slots incl. the permanent base slot 0 (0 = "
        "catalog size + 1). Fewer slots than tenants => idle adapters LRU-evict "
        "and cache-miss admissions hot-load",
    )
    ap.add_argument(
        "--enable-profiling", action="store_true",
        help="expose the POST /profile torch.profiler endpoint (off by default: any "
        "peer could otherwise start traces and fill the disk)",
    )
    ap.add_argument("--profile-dir", default="profiles",
                    help="directory the /profile traces land under (default profiles/)")
    ap.add_argument(
        "--hop-timeout", type=float,
        default=float(os.environ.get("INFERD_HOP_TIMEOUT", "120")),
        help="per-hop relay timeout in seconds (env INFERD_HOP_TIMEOUT); with a "
        "deadline-carrying request the hop waits at most what is left of it",
    )
    ap.add_argument(
        "--hedge-delay-ms", type=float,
        default=float(os.environ.get("INFERD_HEDGE_DELAY_MS", "0")),
        help="hedged decode relays: wait this long on the primary before sending "
        "the same envelope to a second replica (env INFERD_HEDGE_DELAY_MS; 0 = "
        "adaptive, the trailing 60 s p95 of this node's hop times); hedges stay "
        "within 5%% extra load",
    )
    ap.add_argument(
        "--hedge-mode", default=os.environ.get("INFERD_HEDGE_MODE", "advertised"),
        choices=["advertised", "any", "off"],
        help="where a hedge may go: 'advertised' (default) = only a replica whose "
        "gossip record advertises the session's KV; 'any' = the best-ranked other "
        "replica (stateless backends); 'off' = never hedge",
    )
    ap.add_argument(
        "--admission-reserve", type=float,
        default=float(os.environ.get("INFERD_ADMISSION_RESERVE", "0.05")),
        help="shed NEW sessions (503 'busy' + Retry-After) while the --paged-kv "
        "block pool has fewer than this fraction of its blocks free (env "
        "INFERD_ADMISSION_RESERVE)",
    )
    ap.add_argument(
        "--standby-repl", action="store_true",
        default=os.environ.get("INFERD_STANDBY_REPL", "") == "1",
        help="crash-tolerant sessions: replicate each resident session's completed KV "
        "to a gossip-chosen standby of the same stage (env INFERD_STANDBY_REPL=1); when "
        "the holder dies the standby promotes its copy and the client re-sends only the "
        "tokens past the replicated frontier. Off by default: the wire, the gossip "
        "records and the metrics are then what they are without it",
    )
    ap.add_argument(
        "--repl-interval", type=float,
        default=float(os.environ.get("INFERD_REPL_INTERVAL", "0.5")),
        help="seconds between standby replication ticks (env INFERD_REPL_INTERVAL): the "
        "tokens committed since the last ship are what a promotion re-prefills",
    )
    ap.add_argument(
        "--rescue-bounces", type=int,
        default=int(os.environ.get("INFERD_RESCUE_BOUNCES", "6")),
        help="how many times a mid-session chunk that lands on a replica without "
        "its KV is relayed to the replica advertising it before the client's "
        "409 and restart (env INFERD_RESCUE_BOUNCES)",
    )
    ap.add_argument(
        "--chaos", default=os.environ.get("INFERD_CHAOS", ""),
        help="fault injection spec, e.g. 'drop=0.2,delay_ms=50' or 'stall_p=1' "
        "(env INFERD_CHAOS; utils/chaos.py) — resilience testing only",
    )
    ap.add_argument("--log-level", default="INFO", help="logging level (default INFO)")
    return ap


class Identity(NamedTuple):
    """Who a node is: its record's name (None: its host:port), its stage, and
    the manifest it was resolved from (None without one)."""

    name: Optional[str]
    stage: int
    manifest: Optional[Manifest]

    def stage_spec(self) -> Optional[StageSpec]:
        """The manifest's spec of this node's stage (None without one)."""
        return None if self.manifest is None else self.manifest.stage_spec(self.stage)


def resolve_identity(args: argparse.Namespace) -> Identity:
    """The node's name and stage with the reference's precedence: --name >
    NODE_NAME; --stage > INITIAL_STAGE > the manifest entry > 0."""
    manifest = None
    if args.manifest:
        manifest = Manifest.from_yaml(args.manifest)
        manifest.validate()
        if not args.name:
            raise ValueError("--name (or NODE_NAME) is required with --manifest")
    stage = args.stage
    if stage is None:
        env_stage = os.environ.get("INITIAL_STAGE")
        if env_stage is not None:
            stage = int(env_stage)
        elif manifest is not None:
            stage = manifest.node(args.name).stage
        else:
            stage = 0
    if manifest is not None and not 0 <= stage < manifest.num_stages:
        raise ValueError(f"stage {stage} outside the manifest's {manifest.num_stages} stages")
    return Identity(args.name or None, stage, manifest)


def load_executor(args: argparse.Namespace, ident: Identity, stage: int,
                  model: Optional[str] = None) -> Tuple[Any, str]:
    """(executor, model name) serving `stage` behind the node's flags: the
    weightless counter model with --backend counter, else the stage's
    checkpoint from --parts with --lora merged, --quant applied, the
    --adapters registry bound, --kv-dtype, the lane, paged, prefill and
    --max-len flags, and on a card the kernels it runs built (a kernel that
    cannot build fails the load). The one load of a node's start and of its
    stage migrations (`Node.load_stage`). At start (`model` None) the
    checkpoint must hold the manifest's model and layer range for the
    node's stage, else the --model when given; a migration passes the
    node's model, which the target's checkpoint must hold (the manifest's
    stage is the node's first, and a migration leaves it on purpose)."""
    if args.backend == "counter":
        if args.parts:
            raise ValueError("--backend counter takes no --parts (it has no weights)")
        if args.kv_dtype != "model":
            raise ValueError("--kv-dtype: the counter backend keeps no KV cache")
        num_stages = args.num_stages if ident.manifest is None else ident.manifest.num_stages
        if not 0 <= stage < num_stages:
            raise ValueError(f"--stage {stage} outside --num-stages {num_stages}")
        resolve_device(args.device)  # the same refusal without a card as every node
        return make_executor(None, StageSpec(stage, num_stages, 0, 0), backend="counter"), "counter"
    if not args.parts:
        raise ValueError("--parts is required with --backend qwen3")
    device = resolve_device(args.device)
    params, spec, model_name = load_stage_checkpoint(
        stage_checkpoint_path(args.parts, stage), device=device
    )
    if spec.stage != stage:
        raise ValueError(f"{args.parts}: checkpoint holds stage {spec.stage}, not {stage}")
    if model is not None:
        if model_name != model:
            raise ValueError(f"{args.parts}: stage {stage}'s checkpoint holds {model_name}, not "
                             f"this node's {model}")
    else:
        want = ident.stage_spec()
        if want is not None and (want != spec or ident.manifest.model_name != model_name):
            raise ValueError(f"{args.parts}: checkpoint holds {model_name} {spec}, the manifest "
                             f"{args.manifest} says {ident.manifest.model_name} {want}")
        if want is None and args.model and args.model != model_name:
            raise ValueError(f"{args.parts}: checkpoint holds {model_name}, not --model "
                             f"{args.model}")
    cfg = get_config(model_name)
    if args.kv_dtype != "model":
        cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype)
    owner = f"{args.host}:{args.port} stage {spec.stage}"
    loralib.check_exclusive_modes(args.lora, args.adapters, owner=owner)
    if args.lora:
        # the stage's slice of the adapter, merged BEFORE quantization so the
        # adapted weights quantize like a base checkpoint
        sliced = loralib.slice_adapter(loralib.load_adapter(cfg, args.lora),
                                       spec.start_layer, spec.end_layer + 1, owner=owner)
        params = loralib.merge_adapter(params, sliced)
    # a non-last stage holds embed for the token gather only: no head shadow
    params = quant.apply_quant_mode(args.quant, params,
                                    tie_word_embeddings=cfg.tie_word_embeddings,
                                    needs_head=spec.is_last)
    registry = None
    if args.adapters:
        if args.stage_lanes <= 0 and args.batch_lanes <= 0:  # before reading the catalog
            raise ValueError("--adapters (multi-tenant batched LoRA) runs on the lane "
                             "executors — pair it with --stage-lanes or --batch-lanes")
        registry = AdapterRegistry(cfg, args.adapters, slots=args.adapter_slots,
                                   start_layer=spec.start_layer, end_layer=spec.end_layer + 1,
                                   owner=owner, device=device)
    executor = make_executor(
        cfg, spec, params, max_len=args.max_len,
        stage_lanes=args.stage_lanes, block_size=args.paged_kv, kv_blocks=args.kv_blocks,
        prefill_chunk=args.prefill_chunk, adapters=registry, batch_lanes=args.batch_lanes,
        window_ms=args.window_ms,
    )
    if device.type == "cuda":
        from inferd_tpu_torch.ops import build

        # a kernel that cannot build fails the load now
        build.load("flash_gqa")
        if args.paged_kv > 0:
            build.load("paged_decode")
        if args.quant != "none":
            build.load("qmatmul")
        if registry is not None:
            build.load("lora_delta")
    return executor, model_name


def make_node(args: argparse.Namespace) -> Node:
    ident = resolve_identity(args)
    executor, model_name = load_executor(args, ident, ident.stage)

    def load_stage(stage: int):
        return load_executor(args, ident, stage, model=model_name)[0]

    return Node(executor, host=args.host, port=args.port, window_ms=args.window_ms,
                quant=args.quant, enable_profiling=args.enable_profiling,
                profile_dir=args.profile_dir, model_name=model_name,
                gossip_port=args.gossip_port, bootstrap=parse_bootstrap(args.bootstrap),
                capacity=args.capacity, hop_timeout_s=args.hop_timeout,
                hedge_delay_ms=args.hedge_delay_ms, hedge_mode=args.hedge_mode,
                admission_reserve=args.admission_reserve,
                rescue_bounces=args.rescue_bounces, chaos=Chaos.parse(args.chaos),
                name=ident.name, load_stage=load_stage,
                rebalance_period_s=args.rebalance_period, standby_repl=args.standby_repl,
                repl_interval_s=args.repl_interval)


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    # force: an import may have configured the root logger already
    logging.basicConfig(level=args.log_level.upper(), force=True,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    node = make_node(args)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    node.start()
    print(json.dumps({
        "ready": True, "name": node.name, "host": node.host, "port": node.port,
        "stage": node.spec.stage,
        "layers": [node.spec.start_layer, node.spec.end_layer], "device": node.device,
        "gossip_port": node.dht.port,
    }), flush=True)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        node.stop()


if __name__ == "__main__":
    main()
