"""Time the fused LoRA lane delta (csrc/lora_delta.cu) under every cluster
size it takes, at Qwen3-0.6B's projections, on one CUDA card.

ops/lora.lora_plan picks the ranks that split the shrink's K and the output
columns (`cluster`) by a fixed rule; this tool is how the rule was chosen:
for each case it times the plan the rule picks beside every cluster of 1,
2, 4 and 8 ranks,
each call timed by CUDA events with its inputs cold in L2 (a 128 MB read
before each call), the median of 20. One JSON line per case goes to
stdout: the rule's plan and time, and every plan's; the first line is the
time of a one-element kernel under the same timing, the floor beneath them.

Cases: decode (8 lanes on slots 1, 2, 3, 0, 1, 2, 3, 0, S 1) at ranks 1,
8, 16, 32 and 64 on the q, k, o, gate and down projections, and prefill (1
lane, S 256) at rank 16 on gate and down; bf16 x and pools.

Usage (on the card):
  python -m inferd_tpu_torch.tools.lora_sweep [--ranks 1,8,16,32,64]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Callable, List, Optional

import torch

from inferd_tpu_torch.ops import lora as L

SHAPES = {"q_proj": (1024, 2048), "k_proj": (1024, 1024), "o_proj": (2048, 1024),
          "gate_proj": (1024, 3072), "down_proj": (3072, 1024)}
DECODE_IDS = [1, 2, 3, 0, 1, 2, 3, 0]
SLOTS, LAYERS, LAYER = 4, 14, 5
FLUSH_BYTES = 128 << 20


def time_ms(fn: Callable[[], None], flush: torch.Tensor, iters: int = 20) -> float:
    """Median device ms of one call, each after a read of `flush`, outside
    its events, so the call finds none of its inputs in L2."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e8))  # the host enqueues every call before the device starts
    for a, b in zip(starts, ends):
        flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,8,16,32,64")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    one = torch.zeros(1, device=dev)
    print(json.dumps({"floor_one_element_kernel_ms": time_ms(lambda: one.add_(1), flush),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    cases = [(f"decode_{t}_r{r}", t, r, 1, DECODE_IDS)
             for r in (int(x) for x in args.ranks.split(",")) for t in SHAPES]
    cases += [(f"prefill_s256_{t}_r16", t, 16, 256, [1]) for t in ("gate_proj", "down_proj")]
    dt = torch.bfloat16
    for name, target, r, s, ids in cases:
        din, dout = SHAPES[target]
        a = torch.randn((SLOTS, LAYERS, din, r), generator=gen, device=dev) * 0.05
        b = torch.randn((SLOTS, LAYERS, r, dout), generator=gen, device=dev) * 0.05
        a[0] = b[0] = 0.0
        a, b = a.to(dt), b.to(dt)
        x = torch.randn((len(ids), s, din), generator=gen, device=dev).to(dt)
        scale = torch.tensor([0.0, 2.0, 0.5, 1.25], device=dev)
        idt = torch.tensor(ids, dtype=torch.int32, device=dev)
        ref = L.fused_lane_delta_reference(x, a, b, scale, idt, LAYER)
        rule = L.lora_plan(len(ids), s, din, dout, r, dt, dt)
        plans = [rule] + [p for c in (1, 2, 4, 8)
                          if (p := L.plan_for(s, din, dout, r, dt, dt, c)) not in (None, rule)]
        rows = []
        for p in plans:
            got = L._launch(x, a, b, scale, idt, LAYER, plan=p)
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            ms = time_ms(lambda p=p: L._launch(x, a, b, scale, idt, LAYER, plan=p), flush)
            rows.append(dict(dataclasses.asdict(p), ms=ms, rel_err=err))
        best = min(rows, key=lambda row: row["ms"])
        print(json.dumps({"case": name, "rule": rows[0], "best": best, "plans": rows}),
              flush=True)


if __name__ == "__main__":
    main()
