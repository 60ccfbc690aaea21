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
tensor each launches its kernel in csrc/qmatmul.cu, or raises on anything
the kernel does not take; on a CPU tensor each runs its plain version
(`w8a16_matmul_reference`, `w4a16_matvec_reference`), which computes the
same function in f32 PyTorch. Each kernel launch adds one to the wrapper's
`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from inferd_tpu_torch.ops import build

# Past this many rows (prefill chunks) ops.quant.qdot takes the plain
# product: the GEMV shape, and its bound by bytes, is gone.
MAX_KERNEL_ROWS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the weight formats and contraction schemes of csrc/qmatmul.cu
_KIND_INT8, _KIND_INT4_PACKED, _KIND_INT4_BYTES = 0, 1, 2
_SCHEMES = {"grouped": 0, "dequant": 1}


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
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, k: int, n: int,
            kind: int, groups: int, scheme: str, name: str) -> torch.Tensor:
    """Check everything the kernel relies on, then launch it; returns
    [M, N] in x.dtype, empty and with no launch when M or N is 0."""
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
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.qmatmul_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, groups, kind, _SCHEMES[scheme], _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    return out


def _launch_w8a16(x, q, scale):
    if q.ndim != 2 or scale.shape != (q.shape[1],):
        raise ValueError(f"w8a16_matmul: want q [K, N] and scale [N], got "
                         f"{tuple(q.shape)} {tuple(scale.shape)}")
    return _launch(x, q, scale, q.shape[0], q.shape[1], _KIND_INT8, 1, "grouped",
                   "w8a16_matmul")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ int8 q [K, N] times scale [N] -> [M, N] in x.dtype, with
    int8 as the only weight bytes read.

    CUDA tensors launch the w8a16 kernel of csrc/qmatmul.cu (which replaces
    the Pallas `_w8a16_kernel`); CPU tensors run w8a16_matmul_reference.
    The Pallas-only `block_n`/`interpret` knobs have no counterpart. Each
    kernel launch adds one to `w8a16_matmul.launches`."""
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x.device}")
    out = _launch_w8a16(x, q, scale)
    if out.numel():  # an empty product launches nothing
        w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0


def _launch_w4a16(x, w, scheme):
    if scheme not in _SCHEMES:
        raise ValueError(f"w4a16 scheme must be one of {tuple(_SCHEMES)}, got {scheme!r}")
    if w.ndim != 2 or w.scale.ndim != 2 or w.scale.shape[1] != w.shape[1]:
        raise ValueError(f"w4a16_matvec: want a 2-D Int4Weight with scale [G, N], got q "
                         f"{tuple(w.q.shape)} scale {tuple(w.scale.shape)}")
    k, n = w.shape
    kind = _KIND_INT4_PACKED if w.packed else _KIND_INT4_BYTES
    return _launch(x, w.q, w.scale, k, n, kind, w.scale.shape[0], scheme, "w4a16_matvec")


def w4a16_matvec(x: torch.Tensor, w, scheme: str = "dequant") -> torch.Tensor:
    """x [M, K] @ an Int4Weight [K, N] -> [M, N] in x.dtype, with the int4
    bytes as the only weight bytes read and the unpack and the group scales
    applied in registers.

    CUDA tensors launch the w4a16 kernel of csrc/qmatmul.cu (which replaces
    the Pallas `_w4a16_kernel`); CPU tensors run w4a16_matvec_reference.
    `scheme` is "dequant" or "grouped", the Pallas kernel's two; a
    --quant int4 node serves "grouped" (ops.quant.INT4_MODE). Each kernel
    launch adds one to `w4a16_matvec.launches`."""
    if x.device.type == "cpu":
        return w4a16_matvec_reference(x, w, scheme)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_matvec: unsupported device {x.device}")
    out = _launch_w4a16(x, w, scheme)
    if out.numel():  # an empty product launches nothing
        w4a16_matvec.launches += 1
    return out


w4a16_matvec.launches = 0
