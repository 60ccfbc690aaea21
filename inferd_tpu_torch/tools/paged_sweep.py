"""Time the paged decode kernels (csrc/paged_decode.cu) under every chain
split they take, at Qwen3-0.6B's attention shape, on one CUDA card.

ops/attention.paged_plan cuts each lane's block chain into uniform ranges by
a fixed rule (PAGED_MIN_SPLIT_SLOTS, PAGED_TARGET_CTAS); this tool is how
the rule's numbers were chosen: for each case it times the plan the rule
picks beside every split into a power-of-two number of blocks per range,
each call timed by CUDA events with its inputs cold in L2 (a 128 MB read
before each call), the median of 20. One JSON line per case goes to
stdout: the rule's plan and time, and every plan's; the first line is the
time of a one-element kernel under the same timing, the floor beneath them.

Cases: chip_smoke's paged cases at the lanes' 8 sessions (kv_len 17-1000,
MB 32), one long session (4096, MB 128), one long among short ones, and the
lanes' decode step at each table width their serving reaches (MB 16, 64).

Usage (on the card):
  python -m inferd_tpu_torch.tools.paged_sweep
"""

from __future__ import annotations

import json
import statistics
from typing import Callable, List, Optional

import torch

from inferd_tpu_torch.ops import attention as A

NQ, NKV, D, BS = 16, 8, 128, 32  # Qwen3-0.6B, the lanes' block size
CASES = {
    "main_b8_mb32": [17, 60, 101, 230, 301, 480, 701, 1000],
    "long_b1_mb128": [4096],
    "b8_one_long_mb128": [4096, 17, 60, 101, 150, 230, 260, 300],
    "b8_mb16": [17, 60, 101, 230, 301, 480, 400, 500],
    "b8_mb64": [48, 92, 133, 262, 333, 512, 733, 1032],
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


def inputs(kv_len: List[int], gen: torch.Generator, dev: torch.device):
    """Pools holding each lane's chain, shuffled, the table at the
    chain_clamp width (power-of-two bucket of the longest chain), each
    lane's query at kv_len - 1."""
    chains = [-(-n // BS) for n in kv_len]
    mb = 1
    while mb < max(chains):
        mb <<= 1
    nb = sum(chains) + 1
    perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table = torch.zeros((len(kv_len), mb), dtype=torch.int32, device=dev)
    used = 0
    for lane, n in enumerate(chains):
        table[lane, :n] = perm[used:used + n]
        used += n
    k = torch.randn((nb, BS, NKV, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((nb, BS, NKV, D), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((len(kv_len), 1, NQ, D), generator=gen, device=dev).to(torch.bfloat16)
    kl = torch.tensor(kv_len, device=dev)
    return q, k, v, table, (kl - 1).clamp(min=0)[:, None], kl


def plans(b: int, mb: int) -> List[A.PagedPlan]:
    """The rule's plan first, then every power-of-two range of blocks."""
    out = [A.paged_plan(b, NKV, mb, BS, torch.bfloat16)]
    bps = 1
    while bps <= mb:
        p = A.PagedPlan(-(-mb // bps), bps)
        if p.splits <= A.MAX_SPLITS and p not in out:
            out.append(p)
        bps <<= 1
    return out


def main(argv: Optional[List[str]] = None) -> None:
    del argv
    dev = torch.device("cuda")
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    one = torch.zeros(1, device=dev)
    print(json.dumps({"floor_one_element_kernel_ms": time_ms(lambda: one.add_(1), flush),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for name, kv_len in CASES.items():
        q, k, v, table, qpos, kl = inputs(kv_len, gen, dev)
        ref = A.paged_decode_gqa_reference(q, k, v, table, qpos, kl)
        rows = []
        for p in plans(len(kv_len), table.shape[1]):
            out, _ = A._paged_launch(q, k, v, table, qpos, kl, None, 0.0, None, None, plan=p)
            err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            ms = time_ms(lambda p=p: A._paged_launch(q, k, v, table, qpos, kl, None, 0.0, None,
                                                     None, plan=p), flush)
            rows.append({"splits": p.splits, "blocks_per_split": p.blocks_per_split,
                         "ctas": p.splits * NKV * len(kv_len), "ms": ms, "rel_err": err})
        best = min(rows, key=lambda r: r["ms"])
        print(json.dumps({"case": name, "B": len(kv_len), "MB": table.shape[1],
                          "rule": rows[0], "best": best, "plans": rows}), flush=True)


if __name__ == "__main__":
    main()
