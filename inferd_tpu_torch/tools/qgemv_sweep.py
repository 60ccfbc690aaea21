"""Time the decode GEMV kernel (csrc/qmatmul.cu) under every plan it takes,
at Qwen3-0.6B's projection and head shapes, on one CUDA card.

ops/qmatmul.qgemv_plan picks a launch plan by a fixed shape rule; this tool
is how the rule's numbers were chosen: for each shape, row count and weight
format it times the plan the rule picks beside every other plan the kernel
accepts (route, column tile, cluster size, stage depth in K, ring stages),
each call timed by CUDA events with its inputs cold in L2 (a 128 MB read before each
call), the median of 20. One JSON line per (shape, rows, format) goes to
stdout: the rule's plan and time, and the fastest plans; the first line is
the time of a one-element kernel under the same timing, the floor beneath
them all.

Usage (on the card):
  python -m inferd_tpu_torch.tools.qgemv_sweep [--rows 1,8] [--kinds int8,int4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Callable, List, Optional

import torch

from inferd_tpu_torch.ops import qmatmul as Q
from inferd_tpu_torch.ops import quant

SHAPES = {  # Qwen3-0.6B [K, N]: q, k/v, o, gate/up, down, the tied head
    "q_proj": (1024, 2048), "k_v_proj": (1024, 1024), "o_proj": (2048, 1024),
    "gate_up_proj": (1024, 3072), "down_proj": (3072, 1024), "lm_head_q": (1024, 151936),
}
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


def candidate_plans(m: int, k: int, n: int, groups: int, kind: str, scheme: str,
                    dtype: torch.dtype) -> List[Q.QgemvPlan]:
    """The rule's plan first, then every plan the kernel takes for the call."""
    rule = Q.qgemv_plan(m, k, n, groups, kind, scheme, dtype)
    gs = k // groups
    plans = [rule]
    # the tensor cores take the shape at any row count if they take it at 2
    mma_ok = Q.qgemv_plan(max(m, 2), k, n, groups, kind, scheme, dtype).route == "mma"
    for route in ("mma", "simt"):
        if route == "mma" and not mma_ok:
            continue
        scaled_after = kind == "int8" or (scheme == "grouped" and groups == 1)
        align = gs if route == "mma" and not scaled_after else 16
        for cluster in (1, 2, 4, 8):
            per = -(-k // cluster)
            kr = -(-per // align) * align
            if cluster > 1 and (cluster - 1) * kr >= k:
                continue
            for stage_k in (128, 256, 512, 1024):
                if stage_k % align or stage_k > kr:
                    continue
                stages = -(-kr // stage_k)
                for depth in (1, 2, 4):
                    if depth > max(stages, 1) or (stages > 1 and depth < 2):
                        continue
                    for block_n in (Q.BLOCK_N, Q.WIDE_BLOCK_N):
                        if block_n != Q.BLOCK_N and (
                                cluster > 1 or Q.kernel_rows(m, route) > (16 if route == "mma" else 8)):
                            continue
                        p = Q.QgemvPlan(route, block_n, cluster, kr, stage_k, depth,
                                        -(-n // block_n) * cluster)
                        if p != rule:
                            plans.append(p)
    return plans


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", default="1,8", help="comma-separated row counts")
    ap.add_argument("--kinds", default="int8,int4", help="int8 (w8a16), int4 (grouped w4a16)")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated shape names")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qgemv_sweep times the CUDA kernel: it needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    card = torch.cuda.get_device_name(0)
    time_ms(lambda: flush[:1].add_(0), flush)  # the first timing of a process runs slow: discard it
    # the floor under every time below: one tiny kernel, timed the same way
    print(json.dumps({"empty_kernel_ms": time_ms(lambda: flush[:1].add_(0), flush), "card": card}),
          flush=True)
    for name in args.shapes.split(","):
        k, n = SHAPES[name]
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        weights = {"int8": quant.quantize(w), "int4": quant.quantize_int4(w)}
        del w
        for m in (int(r) for r in args.rows.split(",")):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            for kind in args.kinds.split(","):
                wq = weights[kind]
                groups = 1 if kind == "int8" else wq.scale.shape[0]
                times, refused = [], 0
                for p in candidate_plans(m, k, n, groups, kind, "grouped", x.dtype):
                    def call(p=p):
                        Q.launch_plan(x, wq.q, wq.scale, out, groups, kind, "grouped", p)
                    try:
                        call()
                    except RuntimeError:  # e.g. more shared memory than an SM has
                        refused += 1
                        continue
                    times.append((time_ms(call, flush), p))
                rule_ms, rule = times[0]
                best = sorted(times, key=lambda t: t[0])[:5]
                print(json.dumps({
                    "shape": name, "K": k, "N": n, "M": m, "kind": kind, "card": card,
                    "rule": dataclasses.asdict(rule), "rule_ms": rule_ms,
                    "best": [dict(dataclasses.asdict(p), ms=t) for t, p in best],
                    "plans_timed": len(times), "plans_refused": refused}), flush=True)


if __name__ == "__main__":
    main()
