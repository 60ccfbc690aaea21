"""Decode GEMVs against quantized weights: wrappers of the hand-written
CUDA kernels and their plain versions (port of inferd_tpu/ops/qmatmul.py).

  * `w8a16_matmul(x, q, scale)`: x [M, K] (bf16/f32) @ int8 q [K, N], the
    product summed in f32 and times the per-output-channel scale [N] on the
    f32 sum, cast to x.dtype.
  * `w4a16_matvec(x, w, scheme)`: x [M, K] @ an ops.quant.Int4Weight [K, N]
    (nibble-packed or one value per byte, scales [G, N]) under the
    "grouped" scheme (a per-group f32 partial times its scale, summed) or
    the "dequant" one (q * scale rounded to x.dtype, then one f32-summed
    product).

Both take at most MAX_KERNEL_ROWS rows: the decode shapes, a few rows
against a large weight, where the weight's bytes set the time. On a CUDA
tensor each launches its kernel in csrc/qmatmul.cu on the route and K
split that `qgemv_plan` picks, or raises on anything the kernel does not
take; on a CPU tensor each runs its plain version
(`w8a16_matmul_reference`, `w4a16_matvec_reference`), which computes the
same function in f32 PyTorch. Each kernel launch adds one to the wrapper's
`launches` and one to its route's count, `mma_launches` or
`simt_launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from inferd_tpu_torch.ops import build
from inferd_tpu_torch.utils.profiling import span

# Past this many rows (prefill chunks) ops.quant.qdot takes the plain
# product: the GEMV shape, and its bound by bytes, is gone.
MAX_KERNEL_ROWS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the weight formats and contraction schemes of csrc/qmatmul.cu
_SCHEMES = {"grouped": 0, "dequant": 1}
KINDS = {"int8": 0, "int4": 1, "int4_bytes": 2}  # int4: nibble-packed; int4_bytes: a value per byte
_ROUTE_CODES = {"simt": 0, "mma": 1}  # Route in csrc/qmatmul.cu

# The plan's fixed rule (csrc/qmatmul.cu says what each number sizes).
BLOCK_N = 64  # columns per CTA
WIDE_BLOCK_N = 128  # ...for a weight wide enough to fill the card unsplit (the head),
WIDE_N = 16384  # from this many columns, and at most 16 rows (mma) or 8 (simt)
TARGET_CTAS = 128  # split K until a launch has this many CTAs (of 132 SMs)...
MAX_CLUSTER = 8  # ...over at most this many ranks (the portable cluster size)
MIN_RANK_K = 64  # and no rank takes fewer K values than this
STAGE_BYTES = 16384  # weight bytes per ring stage
MAX_DEPTH = 4  # ring stages
MMA_MAX_GROUP = 256  # larger groups (and G == 1 aside) take the simt route
RING_BYTES = 48 * 1024  # the ring's shared memory, so a few CTAs share an SM (the head)


@dataclasses.dataclass(frozen=True)
class QgemvPlan:
    """How one GEMV is launched: `ctas` = column tiles x `cluster`, rank r
    of a cluster summing K values [r * k_per_rank, min(K, (r+1) *
    k_per_rank)) of its tile of `block_n` columns, streamed through `depth`
    ring stages of `stage_k` values."""

    route: str  # "mma" (bf16 x on the tensor cores) or "simt" (FP32 FMAs)
    block_n: int
    cluster: int
    k_per_rank: int
    stage_k: int
    depth: int
    ctas: int

    def rank_ranges(self, k: int):
        """Each rank's [lo, hi) of K, in rank order."""
        return [(r * self.k_per_rank, min(k, (r + 1) * self.k_per_rank))
                for r in range(self.cluster)]

    def stage_starts(self, lo: int, hi: int):
        """The first K value of each ring stage of the rank range [lo, hi)."""
        return list(range(lo, hi, self.stage_k))


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


@functools.lru_cache(maxsize=4096)  # a pure function of shapes, called per launch
def qgemv_plan(m: int, k: int, n: int, groups: int, kind: str, scheme: str,
               dtype: torch.dtype) -> QgemvPlan:
    """The route and the K split of a GEMV launch: a pure function of the
    shapes. `kind` is "int8" (w8a16), "int4" (nibble-packed) or
    "int4_bytes" (one value per byte, odd K); `scheme` the w4a16 scheme
    ("grouped" for w8a16, which scales after the sum).

    The route: bf16 x of 2 rows or more with K % 16 == 0 takes the tensor
    cores for int8 and packed int4 when no group scale changes inside an
    mma step (one group, or groups of a multiple of 16 up to
    MMA_MAX_GROUP); one row (where the mma's n8 tile is 1/8 used and the
    simt kernel measured faster), f32 (TF32 would break f32's accuracy), the
    one-value-per-byte layout and other group sizes take the simt route. The split: the fewest ranks (a
    power of two, at most MAX_CLUSTER) that bring the launch to
    TARGET_CTAS, with every rank's range a multiple of 16 and, on the mma
    route with group scales, of the group size, and no rank below
    MIN_RANK_K or empty. The column tile: BLOCK_N, or WIDE_BLOCK_N for an
    unsplit weight of WIDE_N columns or more at few rows (each CTA then
    reads 128 contiguous bytes of int8 per weight row, and the head
    measured faster so). tools/qgemv_sweep.py times these choices against
    every other plan; PERF.md has the numbers."""
    if kind not in KINDS:
        raise ValueError(f"qgemv_plan: kind must be one of {tuple(KINDS)}, got {kind!r}")
    if scheme not in _SCHEMES:
        raise ValueError(f"w4a16 scheme must be one of {tuple(_SCHEMES)}, got {scheme!r}")
    if groups < 1 or k < 1 or k % groups:
        raise ValueError(f"qgemv_plan: {groups} groups do not split K = {k}")
    gs = k // groups
    scaled_after = kind == "int8" or (scheme == "grouped" and groups == 1)
    mma = (m > 1 and dtype == torch.bfloat16 and kind != "int4_bytes" and k % 16 == 0
           and (scaled_after or (gs % 16 == 0 and gs <= MMA_MAX_GROUP)))
    route = "mma" if mma else "simt"
    align = gs if mma and not scaled_after else 16
    tiles = -(-n // BLOCK_N)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < TARGET_CTAS
           and k // (2 * cluster) >= MIN_RANK_K):
        cluster *= 2
    while True:  # every rank holds some of K
        kr = _round_up(-(-k // cluster), align)
        if cluster == 1 or (cluster - 1) * kr < k:
            break
        cluster //= 2
    rows = kernel_rows(m, route)
    block_n = BLOCK_N
    if cluster == 1 and n >= WIDE_N and rows <= (16 if mma else 8):
        block_n = WIDE_BLOCK_N
    k_bytes = BLOCK_N // (2 if kind == "int4" else 1)  # weight bytes per K value of 64 columns
    stage_k = max(align, STAGE_BYTES // k_bytes // align * align)
    stage_k = min(stage_k, _round_up(kr, align))
    stages = -(-kr // stage_k)
    # a ring slot, as csrc/qmatmul.cu lays it out (weight rows padded by at
    # most 32 bytes, x's rows padded by 16, the group scales)
    item = 4 if dtype == torch.float32 else 2
    slot = (stage_k * k_bytes * (block_n + 32) // BLOCK_N + rows * (stage_k * item + 16)
            + (stage_k // gs + 1) * block_n * 4)
    depth = min(MAX_DEPTH, stages, max(2, RING_BYTES // slot))  # >= 2 once a rank has 2 stages
    return QgemvPlan(route, block_n, cluster, kr, stage_k, depth, -(-n // block_n) * cluster)


def kernel_rows(m: int, route: str) -> int:
    """The row capacity of the kernel a route launches for m rows: n8 tiles
    of the mma (8, 16, 32, 64), or 1, 8 or 64 rows on simt."""
    if route == "mma":
        return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64
    return 1 if m == 1 else 8 if m <= 8 else 64


def w8a16_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version of w8a16_matmul: (x @ q) in f32, times the scale,
    cast to x.dtype. Products of bf16 values and int8 values are exact in
    f32, so this is the Pallas kernel's function up to the order of the
    sum."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def w4a16_matvec_reference(x: torch.Tensor, w, scheme: str = "dequant") -> torch.Tensor:
    """The plain version of w4a16_matvec, in f32: "dequant" rounds q * scale
    to x.dtype and sums x times it; "grouped" sums each group's x times q,
    times the group's scale, then sums the groups."""
    if scheme not in _SCHEMES:
        raise ValueError(f"w4a16 scheme must be one of {tuple(_SCHEMES)}, got {scheme!r}")
    k, n = w.shape
    g = w.scale.shape[-2]
    vals = w.unpacked().float().reshape(g, k // g, n)
    s = w.scale.float()
    if scheme == "dequant":
        wd = (vals * s[:, None, :]).reshape(k, n).to(x.dtype).float()
        return (x.float() @ wd).to(x.dtype)
    xg = x.float().reshape(x.shape[0], g, k // g)
    y = torch.einsum("mgk,gkn->mgn", xg, vals)
    return (y * s).sum(dim=1).to(x.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("qmatmul")
    fn = lib.qmatmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 13 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, k: int, n: int,
            kind: str, groups: int, scheme: str, name: str):
    """Check everything the kernel relies on, then launch it on the route
    qgemv_plan picks; returns ([M, N] in x.dtype, the plan), the output
    empty and the plan None, with no launch, when M or N is 0."""
    dev = x.device
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: want x [M, {k}], got {tuple(x.shape)}")
    m = x.shape[0]
    if m > MAX_KERNEL_ROWS:
        raise ValueError(f"{name}: {m} rows > MAX_KERNEL_ROWS ({MAX_KERNEL_ROWS}); "
                         "ops.quant.qdot takes the plain product there")
    if q.device != dev or scale.device != dev:
        raise ValueError(f"{name}: x, q and scale must be on one device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes f32 or bf16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel: want int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if groups < 1 or k % groups:
        raise ValueError(f"{name}: {groups} groups do not split K = {k}")
    for label, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError(f"{name} kernel: q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out, None
    plan = qgemv_plan(m, k, n, groups, kind, scheme, x.dtype)
    launch_plan(x, q, scale, out, groups, kind, scheme, plan, name)
    return out, plan


def launch_plan(x, q, scale, out, groups: int, kind: str, scheme: str, plan: QgemvPlan,
                name: str = "qgemv") -> None:
    """Launch the kernel on inputs _launch has checked, under `plan` (the
    one qgemv_plan picks, or another that tools/qgemv_sweep.py times);
    raises on the kernel's refusal of the plan or a launch error."""
    m, k = x.shape
    n = out.shape[1]
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = lib.qmatmul_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, groups, KINDS[kind], _SCHEMES[scheme], _DTYPE_CODES[x.dtype],
            _ROUTE_CODES[plan.route], plan.block_n, plan.cluster, plan.k_per_rank, plan.stage_k,
            plan.depth,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({plan}): cudaError_t {rc}")


def _count(wrapper, plan) -> None:
    """One launch on the plan's route (none for an empty product)."""
    if plan is None:
        return
    wrapper.launches += 1
    if plan.route == "mma":
        wrapper.mma_launches += 1
    else:
        wrapper.simt_launches += 1


def _launch_w8a16(x, q, scale):
    if q.ndim != 2 or scale.shape != (q.shape[1],):
        raise ValueError(f"w8a16_matmul: want q [K, N] and scale [N], got "
                         f"{tuple(q.shape)} {tuple(scale.shape)}")
    return _launch(x, q, scale, q.shape[0], q.shape[1], "int8", 1, "grouped", "w8a16_matmul")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ int8 q [K, N] times scale [N] -> [M, N] in x.dtype, with
    int8 as the only weight bytes read.

    CUDA tensors launch the w8a16 kernel of csrc/qmatmul.cu (which replaces
    the Pallas `_w8a16_kernel`); CPU tensors run w8a16_matmul_reference.
    The Pallas-only `block_n`/`interpret` knobs have no counterpart. Each
    kernel launch adds one to `w8a16_matmul.launches` and one to its
    route's count (`mma_launches`, `simt_launches`). Inside a captured CUDA
    graph (utils/cuda_graph) the checks, the plan and the count run once,
    at capture: a replay launches what was captured and re-runs none of
    them."""
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x.device}")
    with span("kernel.qgemv"):
        out, plan = _launch_w8a16(x, q, scale)
    _count(w8a16_matmul, plan)
    return out


w8a16_matmul.launches = 0
w8a16_matmul.mma_launches = 0
w8a16_matmul.simt_launches = 0


def _launch_w4a16(x, w, scheme):
    if scheme not in _SCHEMES:
        raise ValueError(f"w4a16 scheme must be one of {tuple(_SCHEMES)}, got {scheme!r}")
    if w.ndim != 2 or w.scale.ndim != 2 or w.scale.shape[1] != w.shape[1]:
        raise ValueError(f"w4a16_matvec: want a 2-D Int4Weight with scale [G, N], got q "
                         f"{tuple(w.q.shape)} scale {tuple(w.scale.shape)}")
    k, n = w.shape
    kind = "int4" if w.packed else "int4_bytes"
    return _launch(x, w.q, w.scale, k, n, kind, w.scale.shape[0], scheme, "w4a16_matvec")


def w4a16_matvec(x: torch.Tensor, w, scheme: str = "dequant") -> torch.Tensor:
    """x [M, K] @ an Int4Weight [K, N] -> [M, N] in x.dtype, with the int4
    bytes as the only weight bytes read and the unpack and the group scales
    applied in registers.

    CUDA tensors launch the w4a16 kernel of csrc/qmatmul.cu (which replaces
    the Pallas `_w4a16_kernel`); CPU tensors run w4a16_matvec_reference.
    `scheme` is "dequant" or "grouped", the Pallas kernel's two; a
    --quant int4 node serves "grouped" (ops.quant.INT4_MODE). Each kernel
    launch adds one to `w4a16_matvec.launches` and one to its route's count
    (`mma_launches`, `simt_launches`). Inside a captured CUDA graph
    (utils/cuda_graph) the checks, the plan and the count run once, at
    capture: a replay launches what was captured and re-runs none of
    them."""
    if x.device.type == "cpu":
        return w4a16_matvec_reference(x, w, scheme)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_matvec: unsupported device {x.device}")
    with span("kernel.qgemv"):
        out, plan = _launch_w4a16(x, w, scheme)
    _count(w4a16_matvec, plan)
    return out


w4a16_matvec.launches = 0
w4a16_matvec.mma_launches = 0
w4a16_matvec.simt_launches = 0
