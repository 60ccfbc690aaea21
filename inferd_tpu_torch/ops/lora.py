"""LoRA adapters: peft-format I/O, merged weights, and the batched unmerged
apply with its hand-written CUDA kernel (port of inferd_tpu/ops/lora.py).

Two serving modes, exclusive per node (`check_exclusive_modes`):

  * MERGED (`run_node --lora DIR`): W' = W + scale * A @ B, applied to the
    stage's weights at load, before quantization; either executor serves it
    with no runtime cost.
  * BATCHED UNMERGED (`run_node --adapters DIR[,DIR...]`): the base weights
    stay as they are and every projection of every layer adds each lane's
    own delta, y += scale[id] * (x @ A[id]) @ B[id], from the stacked pools
    of runtime/adapters.AdapterRegistry, so a decode window that mixes
    tenants is still one dispatch.

File format: HF peft `adapter_config.json` (lora_alpha, r, use_rslora) and
`adapter_model.safetensors` with keys like
`base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight`, read
and written by utils/safetensors_io (the port's own reader and writer).

The delta's dispatch rule, in place of the reference's autotune verdict
(`FORCE_LORA_KERNEL` / `fused_delta_enabled` have no counterpart): a CUDA
activation with adapters goes to `fused_lane_delta`, which launches the
kernel of csrc/lora_delta.cu or raises; a CPU activation takes the
reference's XLA path, `gather_lanes` once per dispatch and `lane_delta` per
projection. Nothing falls back from one to the other.

Pool contract (AdapterRegistry.device_adapters plus the executor's
per-dispatch ids), as in the reference:

  {"a":     {target: [slots, L, in, r]},   # slot 0 = the all-zero base adapter
   "b":     {target: [slots, L, r, out]},
   "scale": [slots] float32,               # alpha / r (or alpha / sqrt(r))
   "ids":   [B] int32}                     # per-lane slot, on the pools' device
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from inferd_tpu_torch.config import ModelConfig
from inferd_tpu_torch.ops import build
from inferd_tpu_torch.utils import safetensors_io
from inferd_tpu_torch.utils.profiling import span

Params = Dict[str, Any]

# decoder-layer leaves an adapter may target (stacked [L, in, out] weights)
TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

_KEY_RE = re.compile(
    r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.(?:\w+\.)?weight$"
)

# the kernel's largest rank (kMaxRank in csrc/lora_delta.cu)
MAX_KERNEL_RANK = 128


def _to_np(t) -> np.ndarray:
    """A torch tensor or array-like -> float32 numpy (lossless for bf16)
    (a copy of inferd_tpu/models/loader._to_np)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def adapter_from_state_dict(
    cfg: ModelConfig, sd, alpha: float, r: int, rslora: bool = False
) -> Dict[str, Any]:
    """Parse a peft state dict into {"layers": {name: (A, B)}, "scale"}.

    A is stacked [L, in, r] and B [L, r, out], float32 CPU tensors (peft
    stores lora_A [r, in] and lora_B [out, r]; they are transposed into the
    x @ W convention). Every targeted projection must be present for ALL
    layers, and a lora_A/lora_B key outside the supported decoder-layer
    targets (lm_head, embeddings, MoE experts) is an error: dropping it
    would serve a partially adapted model."""
    found: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    matched = 0
    for key, val in sd.items():
        m = _KEY_RE.search(key)
        if m is None:
            if "lora_A" in key or "lora_B" in key:
                raise ValueError(
                    f"LoRA adapter parameter {key!r} targets a module "
                    f"outside the supported decoder-layer projections "
                    f"{TARGETS} — refusing to serve a partially-adapted model"
                )
            continue
        i, name, ab = int(m.group(1)), m.group(2), m.group(3)
        if name not in TARGETS:
            raise ValueError(
                f"LoRA adapter targets unsupported module {name!r} "
                f"(supported: {TARGETS})"
            )
        found.setdefault(name, {}).setdefault(i, {})[ab] = _to_np(val)
        matched += 1
    if not matched:
        raise ValueError("no LoRA parameters found in adapter state dict")

    layers: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for name, per_layer in found.items():
        beyond = [i for i in per_layer if i >= cfg.num_layers]
        if beyond:
            raise ValueError(
                f"LoRA adapter has layers {sorted(beyond)} for {name!r} but "
                f"the model has only {cfg.num_layers} layers — wrong adapter "
                f"for this model"
            )
        missing = [i for i in range(cfg.num_layers) if i not in per_layer]
        if missing:
            raise ValueError(
                f"LoRA adapter misses layers {missing} for {name!r} "
                f"(model has {cfg.num_layers} layers)"
            )
        halves = [
            (i, ab)
            for i in range(cfg.num_layers)
            for ab in ("A", "B")
            if ab not in per_layer[i]
        ]
        if halves:
            raise ValueError(
                f"LoRA adapter is missing matrices for {name!r}: "
                + ", ".join(f"layer {i} lora_{ab}" for i, ab in halves)
            )
        a = np.stack([per_layer[i]["A"].T for i in range(cfg.num_layers)])
        b = np.stack([per_layer[i]["B"].T for i in range(cfg.num_layers)])
        if a.shape[-1] != r or b.shape[1] != r:
            raise ValueError(
                f"LoRA rank mismatch for {name!r}: A{a.shape} B{b.shape} vs r={r}"
            )
        layers[name] = (torch.from_numpy(a), torch.from_numpy(b))
    # rsLoRA (arXiv:2312.03732) scales alpha/sqrt(r) instead of alpha/r
    scale = float(alpha) / (float(r) ** 0.5 if rslora else float(r))
    return {"layers": layers, "scale": scale}


def load_adapter(cfg: ModelConfig, path: str) -> Dict[str, Any]:
    """Load a peft adapter directory (adapter_config.json + safetensors)."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    alpha, r = float(acfg["lora_alpha"]), int(acfg["r"])
    sd = safetensors_io.load_file(os.path.join(path, "adapter_model.safetensors"))
    return adapter_from_state_dict(
        cfg, sd, alpha, r, rslora=bool(acfg.get("use_rslora", False))
    )


def check_exclusive_modes(lora: Any, adapters: Any, owner: str = "node") -> None:
    """Refuse `--lora` together with `--adapters`: merged weights already
    contain one adapter, so per-lane deltas on top would serve every tenant
    the sum of two adapters."""
    if lora and adapters:
        raise ValueError(
            f"{owner}: --lora (merge ONE adapter into the weights) and "
            f"--adapters (multi-tenant batched registry) are mutually "
            f"exclusive — merged weights plus per-lane deltas would serve "
            f"every tenant two adapters; pick one mode"
        )


def save_adapter(
    path: str,
    layers: Dict[str, Tuple[Any, Any]],
    alpha: float,
    r: int,
    rslora: bool = False,
) -> str:
    """Write stacked {name: (A [L, in, r], B [L, r, out])} matrices (numpy
    or torch) as a peft-format adapter directory, in float32: the inverse
    of load_adapter (peft stores lora_A [r, in] and lora_B [out, r] per
    layer). Synthetic tenant catalogs are built with it."""
    sd: Dict[str, np.ndarray] = {}
    for name, (a, b) in layers.items():
        mod = "self_attn" if name in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
        a, b = _to_np(a), _to_np(b)
        for i in range(a.shape[0]):
            pre = f"base_model.model.model.layers.{i}.{mod}.{name}"
            sd[f"{pre}.lora_A.weight"] = np.ascontiguousarray(a[i].T)
            sd[f"{pre}.lora_B.weight"] = np.ascontiguousarray(b[i].T)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"lora_alpha": alpha, "r": int(r), "use_rslora": bool(rslora)}, f)
    safetensors_io.save_file(sd, os.path.join(path, "adapter_model.safetensors"))
    return path


def slice_adapter(
    adapter: Dict[str, Any], start: int, end: int, owner: str = "",
) -> Dict[str, Any]:
    """The adapter restricted to layers [start, end), as a stage's slice of
    the stacked weights. An empty or out-of-range slice would merge as a
    silent no-op (the base model served to a tenant), so it raises, naming
    `owner` (the stage)."""
    who = f"{owner}: " if owner else ""
    if start < 0 or start >= end:
        raise ValueError(
            f"{who}adapter slice [{start}, {end}) is empty or inverted — "
            f"an empty-layer adapter would merge as a silent no-op"
        )
    n_layers = min(
        a.shape[0] for a, _b in adapter["layers"].values()
    ) if adapter["layers"] else 0
    if end > n_layers:
        raise ValueError(
            f"{who}adapter slice [{start}, {end}) runs past the adapter's "
            f"{n_layers} stacked layers — wrong stage spec for this adapter"
        )
    return {
        "layers": {
            name: (a[start:end], b[start:end])
            for name, (a, b) in adapter["layers"].items()
        },
        "scale": adapter["scale"],
    }


def merge_adapter(params: Params, adapter: Dict[str, Any]) -> Params:
    """W' = W + scale * A @ B per targeted leaf, summed in float32 and cast
    back to the weight's dtype, on the weight's device. Leaves the adapter
    does not touch pass through."""
    layers = dict(params["layers"])
    scale = adapter["scale"]
    for name, (a, b) in adapter["layers"].items():
        if name not in layers:
            raise ValueError(f"adapter targets {name!r} absent from params")
        w = layers[name]
        if not isinstance(w, torch.Tensor) or w.ndim != 3:
            raise ValueError(
                f"adapter target {name!r} is not a stacked [L, in, out] "
                f"weight (MoE expert adapters are unsupported)"
            )
        delta = scale * torch.einsum(
            "lir,lro->lio",
            torch.as_tensor(a).to(w.device, torch.float32),
            torch.as_tensor(b).to(w.device, torch.float32),
        )
        layers[name] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Batched unmerged apply
# ---------------------------------------------------------------------------


def gather_lanes(adapters: Dict[str, Any]):
    """The plain path's per-lane gather of the stacked pools, done once per
    dispatch: ({target: (a [L, B, in, r], b [L, B, r, out])}, scale [B] f32),
    layer-leading so the layer loop indexes one layer's slices."""
    ids = adapters["ids"].long()
    per = {
        name: (
            adapters["a"][name][ids].transpose(0, 1),
            adapters["b"][name][ids].transpose(0, 1),
        )
        for name in adapters["a"]
    }
    return per, adapters["scale"].float()[ids]


def lane_delta(
    x: torch.Tensor,  # [B, S, in] projection input
    a: torch.Tensor,  # [B, in, r] this layer's per-lane A
    b: torch.Tensor,  # [B, r, out] this layer's per-lane B
    scale: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """scale[lane] * (x @ A[lane]) @ B[lane] -> [B, S, out] float32: two thin
    products through the rank, never an [in, out] delta; f32 throughout, so
    slot 0's zero A/B give base lanes an exact zero."""
    xa = torch.einsum("bsi,bir->bsr", x.float(), a.float())
    d = torch.einsum("bsr,bro->bso", xa, b.float())
    return d * scale[:, None, None]


def fused_lane_delta_reference(
    x: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor,
    scale_pool: torch.Tensor, ids: torch.Tensor, layer: int,
    y: Optional[torch.Tensor] = None, *, inplace: bool = False,
) -> torch.Tensor:
    """The plain version of fused_lane_delta: lane_delta on the gathered
    slices, in f32; with `y`, (y.float() + delta).to(y.dtype), into y when
    `inplace`."""
    il = ids.long()
    d = lane_delta(x, a_pool[il, layer], b_pool[il, layer], scale_pool.float()[il])
    if y is None:
        return d
    res = (y.float() + d).to(y.dtype)
    return y.copy_(res) if inplace else res


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# -- the kernel's launch plan ------------------------------------------------------

# Constants shared with csrc/lora_delta.cu
ROW_TILE = 16  # kRows: rows of S per row tile (one mma m16 tile); decode (S 1) takes 1
THREADS, WARPS = 256, 8  # kThreads, kWarps
MAX_CLUSTER = 8  # kMaxCluster: ranks that split the shrink's K (portable cluster size)
# A rank takes about RANK_K values of K (one round trip of 16-byte loads),
# the tensor cores take the shrink from MMA_MIN_ROWS rows of S (bf16 x and
# pools, K a multiple of their 16), and a rank stages at most SMEM_BUDGET
# bytes of shared memory: its x and A chunks and, where they fit beside
# whole chunks, its B columns; past that B is read from device memory after
# an L2 prefetch, and then past that K is walked in chunks (only ranks of
# 64-128 at Qwen3-0.6B's widths need either).
RANK_K = 128
MMA_MIN_ROWS = 16
SMEM_BUDGET = 160 * 1024


def smem_parts(route: str, rows: int, kc: int, rp: int, r: int, cluster: int, sx: int,
               sw: int, bcols: int) -> Tuple[int, ...]:
    """The byte sizes of the kernel's shared-memory parts, in order (smem_bytes
    of csrc/lora_delta.cu): x chunk, A chunk, K-split partials, the
    cluster's inbox, xa, and B's columns when staged (bcols > 0). Each is a
    multiple of 16 bytes, so every part starts aligned for cp.async."""
    red = WARPS * ROW_TILE * rp if route == "mma" else THREADS
    inbox, xa = (-(-n // 4) * 4 for n in (cluster * rows * r, rows * r))  # f32, to 16 bytes
    xst = -(-kc // 8) * 8 + 8  # x_stride: rows 16-byte aligned
    return (rows * xst * sx, kc * (rp + 8) * sw, 4 * red, 4 * inbox, 4 * xa, r * bcols * sw)


@dataclasses.dataclass(frozen=True)
class LoraPlan:
    """How one fused_lane_delta call is launched: a cluster of `cluster` CTAs
    per (lane, tile of `rows` rows of S); rank c shrinks K [c * k_per_rank,
    (c+1) * k_per_rank) in chunks of k_chunk and expands the output columns
    [c * cols_per_rank, (c+1) * cols_per_rank), from shared memory when
    b_stage. Grid (cluster, row_tiles, B)."""

    route: str  # "mma" (the shrink on the tensor cores) or "simt" (FMAs)
    rows: int  # rows of S per row tile: 1 at S 1 (decode), else ROW_TILE
    row_tiles: int
    cluster: int
    k_per_rank: int
    k_chunk: int
    r_pad: int  # r rounded up to the mma's 8 columns (shared-memory layout)
    cols_per_rank: int  # a multiple of 8: each rank's first column is 16-byte aligned
    b_stage: bool
    smem_bytes: int


def plan_for(s: int, din: int, dout: int, r: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
             cluster: int) -> Optional[LoraPlan]:
    """The plan with `cluster` ranks, None when the kernel cannot split K so
    (a rank would get nothing). The route, the row tile, K per rank (a
    multiple of 16), the chunk and B's staging follow from the shapes;
    lora_plan picks the cluster, tools/lora_sweep times the others."""
    route = ("mma" if x_dtype == w_dtype == torch.bfloat16 and s >= MMA_MIN_ROWS
             and din % 16 == 0 else "simt")
    rows = 1 if s == 1 else ROW_TILE
    kr = din if cluster == 1 else -(-(-(-din // cluster)) // 16) * 16
    if (cluster - 1) * kr >= din:
        return None
    rp = -(-r // 8) * 8
    cols = -(-(-(-dout // cluster)) // 8) * 8
    sx, sw = (4 if t == torch.float32 else 2 for t in (x_dtype, w_dtype))
    b_stage = sum(smem_parts(route, rows, kr, rp, r, cluster, sx, sw, cols)) <= SMEM_BUDGET
    bcols = cols if b_stage else 0
    kc = kr
    while kc > 16 and sum(smem_parts(route, rows, kc, rp, r, cluster, sx, sw, bcols)) > SMEM_BUDGET:
        kc = (kc - 1) // 16 * 16
    return LoraPlan(route, rows, -(-s // rows), cluster, kr, kc, rp, cols, b_stage,
                    sum(smem_parts(route, rows, kc, rp, r, cluster, sx, sw, bcols)))


@functools.lru_cache(maxsize=4096)
def lora_plan(b: int, s: int, din: int, dout: int, r: int, x_dtype: torch.dtype,
              w_dtype: torch.dtype) -> LoraPlan:
    """The lane delta's launch plan, a pure function of shapes and dtypes.
    The route: bf16 x and pools with at least MMA_MIN_ROWS rows of S and K a
    multiple of 16 take the tensor cores for the shrink; decode, f32 (never
    TF32) and odd K take FMAs. The cluster: the largest power of two up to
    MAX_CLUSTER that leaves each rank RANK_K values of K or more, and every
    rank a non-empty range. The row tile: 1 at S 1 (decode), else
    ROW_TILE. B's columns are staged in shared memory whenever they fit
    beside whole chunks."""
    del b  # every lane is its own cluster: the batch sets the grid, not the plan
    cluster = MAX_CLUSTER
    while cluster > 1 and din < cluster * RANK_K:
        cluster //= 2
    while True:
        plan = plan_for(s, din, dout, r, x_dtype, w_dtype, cluster)
        if plan is not None:
            return plan
        cluster //= 2


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("lora_delta")
    fn = lib.lora_delta_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 21 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor,
            scale_pool: torch.Tensor, ids: torch.Tensor, layer: int,
            y: Optional[torch.Tensor] = None, inplace: bool = False,
            plan: Optional[LoraPlan] = None) -> torch.Tensor:
    """Check everything the kernel relies on, then launch it on `plan`
    (lora_plan's unless given: the sweep tool times others); returns the
    f32 delta [B, S, out], or with `y` y + delta in y's dtype (into y itself
    when `inplace`); empty and with no launch when B, S or out is 0."""
    dev = x.device
    if x.ndim != 3 or a_pool.ndim != 4 or b_pool.ndim != 4:
        raise ValueError(f"fused_lane_delta: want x [B, S, in] and pools [slots, L, in, r] / "
                         f"[slots, L, r, out], got {tuple(x.shape)} {tuple(a_pool.shape)} "
                         f"{tuple(b_pool.shape)}")
    bsz, s, d_in = x.shape
    slots, n_layers, _, r = a_pool.shape
    d_out = b_pool.shape[-1]
    if a_pool.shape[2] != d_in or b_pool.shape[:3] != (slots, n_layers, r):
        raise ValueError(f"fused_lane_delta: pools {tuple(a_pool.shape)} / {tuple(b_pool.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if scale_pool.shape != (slots,) or ids.shape != (bsz,):
        raise ValueError(f"fused_lane_delta: want scale [{slots}] and ids [{bsz}], got "
                         f"{tuple(scale_pool.shape)} {tuple(ids.shape)}")
    if not 1 <= r <= MAX_KERNEL_RANK:
        raise ValueError(f"fused_lane_delta: rank {r} outside the kernel's 1..{MAX_KERNEL_RANK}")
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"fused_lane_delta: layer {layer} outside the pools' {n_layers}")
    for label, t in (("a_pool", a_pool), ("b_pool", b_pool), ("scale", scale_pool), ("ids", ids)):
        if t.device != dev:
            raise ValueError(f"fused_lane_delta: {label} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODES or a_pool.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_lane_delta kernel takes f32 or bf16 x and pools, got "
                        f"{x.dtype}, {a_pool.dtype}")
    if (b_pool.dtype != a_pool.dtype or scale_pool.dtype != torch.float32
            or ids.dtype != torch.int32):
        raise TypeError(f"fused_lane_delta kernel: want pools of one dtype, f32 scale and int32 "
                        f"ids, got {a_pool.dtype}/{b_pool.dtype}, {scale_pool.dtype}, {ids.dtype}")
    for label, t in (("x", x), ("a_pool", a_pool), ("b_pool", b_pool), ("scale", scale_pool),
                     ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"fused_lane_delta kernel: {label} must be contiguous")
    if y is not None:
        if y.shape != (bsz, s, d_out) or y.device != dev:
            raise ValueError(f"fused_lane_delta: y {tuple(y.shape)} on {y.device}, want "
                             f"{(bsz, s, d_out)} on {dev}")
        if y.dtype not in _DTYPE_CODES:
            raise TypeError(f"fused_lane_delta kernel takes f32 or bf16 y, got {y.dtype}")
        if not y.is_contiguous():
            raise ValueError("fused_lane_delta kernel: y must be contiguous")
        out = y if inplace else torch.empty_like(y)
    else:
        out = torch.empty((bsz, s, d_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = plan or lora_plan(bsz, s, d_in, d_out, r, x.dtype, a_pool.dtype)
    # 16-byte copies of x's, A's and B's rows where they are aligned (the main path)
    x_vec = d_in % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    a_vec = r % (16 // a_pool.element_size()) == 0 and a_pool.data_ptr() % 16 == 0
    b_vec = d_out % (16 // b_pool.element_size()) == 0 and b_pool.data_ptr() % 16 == 0
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.lora_delta_launch(
            x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(), scale_pool.data_ptr(),
            ids.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(), bsz, s, d_in,
            d_out, r, slots, n_layers, layer, _DTYPE_CODES[x.dtype], _DTYPE_CODES[a_pool.dtype],
            _DTYPE_CODES[out.dtype], int(plan.route == "mma"), plan.rows, plan.cluster,
            plan.k_per_rank, plan.k_chunk, plan.cols_per_rank, int(plan.b_stage), int(x_vec),
            int(a_vec), int(b_vec), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_lane_delta kernel launch failed: cudaError_t {rc}")
    return out


def fused_lane_delta(
    x: torch.Tensor,  # [B, S, in] projection input
    a_pool: torch.Tensor,  # [slots, L, in, r] stacked A pool (one target)
    b_pool: torch.Tensor,  # [slots, L, r, out]
    scale_pool: torch.Tensor,  # [slots] f32
    ids: torch.Tensor,  # [B] int32 per-lane slot ids
    layer: int,  # stacked-layer index (a host int: the layer loop is Python)
    y: Optional[torch.Tensor] = None,  # [B, S, out] f32 or bf16: the projection output
    *,
    inplace: bool = False,
) -> torch.Tensor:
    """The delta of ONE projection of ONE layer for every lane, the slots
    indexed in the pools by the kernel, so no per-lane copy of the pools
    exists. Returns [B, S, out] f32; slot 0 lanes get an exact zero.

    With `y`, returns (y.float() + delta).to(y.dtype) with exactly those
    bits, the add done in the kernel's epilogue: one launch where the
    unfused form takes four. With `inplace` the result is written into y
    itself and y is returned, so only a caller that owns y (a fresh
    projection output) may pass it; base-slot lanes then leave y untouched.
    Without `inplace` y is only read.

    CUDA tensors launch the kernel of csrc/lora_delta.cu (which replaces the
    Pallas `_fused_delta_kernel`) on the plan `lora_plan` makes, or raise on
    anything it does not take; CPU tensors run fused_lane_delta_reference
    (and the same add). The Pallas-only `interpret` knob has no counterpart.
    Each kernel launch adds one to `fused_lane_delta.launches`.
    Inside a captured CUDA graph (utils/cuda_graph) the checks, the plan
    and the count run once, at capture: a replay launches what was captured
    and re-runs none of them."""
    if x.device.type == "cpu":
        return fused_lane_delta_reference(x, a_pool, b_pool, scale_pool, ids, layer, y,
                                          inplace=inplace)
    if x.device.type != "cuda":
        raise ValueError(f"fused_lane_delta: unsupported device {x.device}")
    with span("kernel.fused_lane_delta"):
        out = _launch(x, a_pool, b_pool, scale_pool, ids, layer, y, inplace)
    if out.numel():  # an empty product launches nothing
        fused_lane_delta.launches += 1
    return out


fused_lane_delta.launches = 0


def layer_adapters(adapters: Optional[Dict[str, Any]], device: torch.device):
    """Per-layer `lane_adapters` for one dispatch's pool operand, as a
    function of the layer index (None when the dispatch carries none): on
    CUDA the pools and the layer index (fused_lane_delta gathers in the
    kernel); elsewhere the slices of one gather_lanes, done here once."""
    if adapters is None:
        return lambda i: None
    if device.type == "cuda":
        return lambda i: {"pools": adapters, "layer": i}
    per, scale = gather_lanes(adapters)
    return lambda i: {"layers": {n: (a[i], b[i]) for n, (a, b) in per.items()}, "scale": scale}


def apply_lane_delta(y: torch.Tensor, x: torch.Tensor, name: str,
                     lane_adapters: Optional[Dict[str, Any]]) -> torch.Tensor:
    """y (the base projection output for `name`) plus this layer's per-lane
    LoRA delta; y unchanged when the dispatch carries no adapters or the
    pools do not cover this target. The one application site shared by
    every projection of models/qwen3.decoder_layer.

    `lane_adapters` is {"pools": <pool operand>, "layer": int} (the kernel
    path) or {"layers": {name: (a [B, in, r], b [B, r, out])}, "scale": [B]}
    (this layer's gathered slices, the plain path), as layer_adapters makes
    them."""
    if lane_adapters is None:
        return y
    if "pools" in lane_adapters:
        pools = lane_adapters["pools"]
        if name not in pools["a"]:
            return y
        # y is this projection's fresh output, owned here: the kernel adds
        # the delta into it in place, one launch for the whole projection
        return fused_lane_delta(
            x.contiguous(), pools["a"][name], pools["b"][name], pools["scale"],
            pools["ids"], lane_adapters["layer"], y.contiguous(), inplace=True,
        )
    ab = lane_adapters["layers"].get(name)
    if ab is None:
        return y
    d = lane_delta(x, ab[0], ab[1], lane_adapters["scale"])
    return (y.float() + d).to(y.dtype)
