"""What a one-session executor's token-step graphs cost on one CUDA card:
per graph, the host time of its first step (warm-up, capture,
instantiation) and of a replay, and the device memory each capture leaves
allocated, under three ways of capturing.

  committed          utils/cuda_graph.CudaBackend: one memory pool for all
                     of a cache's graphs, every warm-up on one side stream
  stream_per_warmup  the same with a new side stream for every warm-up
  pool_per_graph     the same with a private memory pool for every graph

Each way runs in a process of its own (the allocator's state would carry
over): stage 0 of Qwen3-0.6B (14 layers, seeded random weights) behind a
Qwen3StageExecutor; `--graphs` sessions, each prefilled with the same
300-token prompt into a buffer of its own and then stepped twice at fill
300 and 301 (a capture, then a replay of the same kv bound).
torch.cuda.memory_allocated is read around each first step (reserved
memory also moves with the allocator's cache, so it does not count a
graph). One JSON line per way goes to stdout after the card's line.

Usage (on the card):
  python -m inferd_tpu_torch.tools.graph_memory [--graphs 40]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from inferd_tpu_torch.utils.cuda_graph import CudaBackend

WAYS = ("committed", "stream_per_warmup", "pool_per_graph")
FILL = 300


class StreamPerWarmup(CudaBackend):
    def warmup(self, fn):
        self.side = torch.cuda.Stream()  # a new side stream for this warm-up
        return super().warmup(fn)


class PoolPerGraph(CudaBackend):
    def capture(self, fn):
        self.pool = torch.cuda.graph_pool_handle()  # a new pool for this graph
        return super().capture(fn)


def measure(way: str, graphs: int) -> dict:
    from inferd_tpu_torch.config import get_config
    from inferd_tpu_torch.models import qwen3
    from inferd_tpu_torch.parallel.stages import StageSpec, extract_stage_params
    from inferd_tpu_torch.runtime.executor import Qwen3StageExecutor
    from inferd_tpu_torch.utils.cuda_graph import GraphCache

    cfg = get_config("qwen3-0.6b")
    full = qwen3.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    spec = StageSpec(0, 2, 0, cfg.num_layers // 2 - 1)
    ex = Qwen3StageExecutor(cfg, spec, extract_stage_params(full, cfg, spec), max_len=4096)
    del full
    backend = {"committed": CudaBackend, "stream_per_warmup": StreamPerWarmup,
               "pool_per_graph": PoolPerGraph}[way]()
    ex.graphs = GraphCache(max_graphs=graphs, backend=backend, device=ex.device)
    prompt = np.arange(1, FILL + 1)[None]
    first, second, mib = [], [], []
    for i in range(graphs):
        ex.process(f"s{i}", {"tokens": prompt, "start_pos": 0, "real_len": FILL})
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        for times, pos in ((first, FILL), (second, FILL + 1)):
            t0 = time.perf_counter()
            ex.process(f"s{i}", {"tokens": [[5]], "start_pos": pos, "real_len": 1})
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        mib.append((torch.cuda.memory_allocated() - before) / 2**20)
    return {"way": way, "graphs": ex.stats()["graphs"]["captures"],
            "first_step_ms_median": statistics.median(first),
            "replay_ms_median": statistics.median(second),
            "allocated_mib_first": mib[0], "allocated_mib_later_mean":
            statistics.mean(mib[1:]) if graphs > 1 else None,
            "allocated_mib_total": sum(mib)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graphs", type=int, default=40)
    ap.add_argument("--way", choices=WAYS, help="measure one way in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_memory: no CUDA device", file=sys.stderr)
        return 2
    if args.way:
        print(json.dumps(measure(args.way, args.graphs)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    for way in WAYS:
        out = subprocess.run([sys.executable, "-m", "inferd_tpu_torch.tools.graph_memory",
                              "--way", way, "--graphs", str(args.graphs)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
