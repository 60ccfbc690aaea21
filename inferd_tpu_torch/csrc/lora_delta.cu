// Fused multi-tenant LoRA lane delta for Hopper (sm_90a): for every lane b
// of a co-batched dispatch, scale[ids[b]] * (x[b] @ A[ids[b], layer]) @
// B[ids[b], layer], the slot gathered from the stacked adapter pools inside
// the kernel.
//
// Replaces the Pallas TPU kernel `_fused_delta_kernel` of
// inferd_tpu/ops/lora.py (line 313; entry `fused_lane_delta`, line 341):
//   x [B, S, in] (f32 or bf16), A pool [slots, L, in, r], B pool [slots, L,
//   r, out] (f32 or bf16, both alike), scale [slots] f32, ids [B] int32 on
//   the device, layer a host int -> out [B, S, out] f32. f32 end to end:
//   xa = x @ A stays f32 and is never rounded to 16 bits (Punica-style
//   kernels round it; the reference does not). Slot 0 is the all-zero base
//   adapter, and its lanes get an exact 0 (a base lane's y + 0.0 is y).
// On the TPU the gather lived in the BlockSpec index maps (scalar-prefetched
// ids picked which [in, r] / [r, out] blocks the pipeline fetched), one grid
// step per lane with its whole [S, in] x resident in VMEM. Here each CTA
// reads ids itself and indexes the pools with 64-bit offsets.
//
// What bounds it on the H100, and what this design does about it: the work
// is 2*S*r*(in + out) flops per lane against the lane's adapter slice (r *
// (in + out) values) and x; at decode (S = 1, r = 16, in/out 1024-3072)
// that is under 1 MB for 8 lanes, ~0.3 us of memory time, so one launch is
// set by launch latency and the serial dependency of the shrink's K loop,
// not by bytes or flops. The design, simply:
//   * one CTA of 256 threads per (lane, tile of kRows = 16 rows of S, tile
//     of kCols = 256 output columns); a lane on slot 0 writes zeros and
//     reads nothing; a slot outside [0, slots) writes NaN (loud, never a
//     silent other tenant);
//   * shrink: the CTA computes its rows' xa [rows, r] in f32 in shared
//     memory, walking K in chunks: each chunk's x rows and the matching
//     contiguous [kc, r] block of A are staged in shared memory as f32
//     (coalesced loads; kc as large as the buffers allow: 512 at decode
//     with r = 16), and each of the rows * r outputs is summed by a group
//     of threads that split the chunk's K (when rows * r < 256), their
//     partials added through shared memory at the end;
//   * expand: one thread per output column reads B's column (coalesced
//     across the warp) once per rank row and keeps an f32 accumulator per
//     S row; the scale multiplies the finished sum, as the reference does.
// xa is recomputed by every column tile of a row tile: nothing at decode,
// out/256 times the shrink's flops at prefill.
// Not done here, left for later work: tensor cores (mma/wgmma) for the
// prefill shapes, TMA or cp.async pipelining of the chunk loads, and
// grouping lanes that share a slot (Punica's SGMV) so a slice is read once.
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (lora_delta_launch), called through ctypes by
// inferd_tpu_torch/ops/lora.py (fused_lane_delta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                             // rows of S per CTA
constexpr int kCols = kThreads;                       // output columns per CTA: one per thread
constexpr int kMaxRank = 128;
constexpr int kABuf = 8192;                           // f32 values of A staged per chunk
constexpr int kXBuf = 1024;                           // f32 values of x staged per chunk
constexpr int kOut = kRows * kMaxRank / kThreads;     // xa outputs per thread, at most

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* x;       // [B, S, din], x's type
  const void* a;       // [slots, layers, din, r], the pools' type
  const void* b;       // [slots, layers, r, dout]
  const float* scale;  // [slots]
  const int* ids;      // [B]
  float* out;          // [B, S, dout]
  int S, din, dout, r, slots, layers, layer;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ceil(dout / kCols), ceil(S / kRows), B); blockDim kThreads
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) lora_delta_kernel(Params p) {
  __shared__ float a_tile[kABuf];         // [kc, r] block of A
  __shared__ float x_tile[kXBuf];         // [rows, kc] block of x
  __shared__ float xa[kRows * kMaxRank];  // [rows, r]
  __shared__ float red[kThreads];         // split-K partials of xa

  const int tid = threadIdx.x;
  const int lane = blockIdx.z;
  const int s0 = blockIdx.y * kRows;
  const int n = blockIdx.x * kCols + tid;
  const int rows = min(kRows, p.S - s0);
  const int r = p.r;
  const int slot = p.ids[lane];
  float* out = p.out + ((long)lane * p.S + s0) * p.dout;

  if (slot <= 0 || slot >= p.slots) {  // the base adapter, or an id out of range
    const float v = slot == 0 ? 0.f : __int_as_float(0x7fc00000);
    if (n < p.dout)
      for (int i = 0; i < rows; ++i) out[(long)i * p.dout + n] = v;
    return;
  }

  const long ab = (long)slot * p.layers + p.layer;
  const TW* A = static_cast<const TW*>(p.a) + ab * p.din * r;
  const TW* Bm = static_cast<const TW*>(p.b) + ab * r * p.dout;
  const TX* X = static_cast<const TX*>(p.x) + ((long)lane * p.S + s0) * p.din;

  // shrink: xa[row, j] = sum_k x[row, k] * A[k, j]
  const int no = rows * r;                              // xa outputs of this CTA
  const int groups = no >= kThreads ? 1 : kThreads / no;  // threads splitting K per output
  const int o1 = tid % no, g = tid / no;                // the output and K group (groups > 1)
  const int kc = min(kABuf / r, kXBuf / rows);          // K values per chunk
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.din; k0 += kc) {
    const int kn = min(kc, p.din - k0);
    __syncthreads();  // the previous chunk is done with x_tile and a_tile
    // the staging loops are unrolled so that each thread has several
    // independent loads in flight before the first store waits on one
#pragma unroll 4
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int row = i / kn, kk = i % kn;
      x_tile[i] = to_f32(X[(long)row * p.din + k0 + kk]);
    }
    const TW* Ac = A + (long)k0 * r;  // rows k0 .. k0 + kn of A: kn * r contiguous values
#pragma unroll 8
    for (int i = tid; i < kn * r; i += kThreads) a_tile[i] = to_f32(Ac[i]);
    __syncthreads();
    if (groups == 1) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int o = tid + i * kThreads;
        if (o < no) {
          const float* xr = x_tile + (o / r) * kn;
          const float* ac = a_tile + o % r;
          float s = acc[i];
          for (int kk = 0; kk < kn; ++kk) s = fmaf(xr[kk], ac[kk * r], s);
          acc[i] = s;
        }
      }
    } else if (g < groups) {
      const float* xr = x_tile + (o1 / r) * kn;
      const float* ac = a_tile + o1 % r;
      float s = acc[0];
      for (int kk = g; kk < kn; kk += groups) s = fmaf(xr[kk], ac[kk * r], s);
      acc[0] = s;
    }
  }
  if (groups == 1) {
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < no) xa[o] = acc[i];
    }
  } else {
    if (g < groups) red[tid] = acc[0];  // tid = g * no + o1
    __syncthreads();
    if (tid < no) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * no + tid];
      xa[tid] = s;
    }
  }
  __syncthreads();

  // expand: out[row, n] = scale * sum_j xa[row, j] * B[j, n]
  if (n >= p.dout) return;
  float y[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) y[i] = 0.f;
#pragma unroll 8
  for (int j = 0; j < r; ++j) {  // unrolled: eight B loads in flight, not one
    const float bj = to_f32(Bm[(long)j * p.dout + n]);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows) y[i] = fmaf(xa[i * r + j], bj, y[i]);
  }
  const float sc = p.scale[slot];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows) out[(long)i * p.dout + n] = y[i] * sc;
}

template <typename TX, typename TW>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  dim3 grid((p.dout + kCols - 1) / kCols, (p.S + kRows - 1) / kRows, batch);
  lora_delta_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (ops/lora.py) validates devices, dtypes, shapes, contiguity,
// the layer index and the rank. x_dtype / w_dtype: 0 f32, 1 bf16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int lora_delta_launch(const void* x, const void* a, const void* b, const float* scale,
                                 const int* ids, float* out, int batch, int S, int din, int dout,
                                 int r, int slots, int layers, int layer, int x_dtype, int w_dtype,
                                 void* stream) {
  if (batch <= 0 || S <= 0 || din <= 0 || dout <= 0 || r < 1 || r > kMaxRank || slots < 1 ||
      layer < 0 || layer >= layers || S > 65535 * kRows || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.scale = scale;
  p.ids = ids;
  p.out = out;
  p.S = S;
  p.din = din;
  p.dout = dout;
  p.r = r;
  p.slots = slots;
  p.layers = layers;
  p.layer = layer;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && w_dtype == kF32) return (int)launch<float, float>(p, batch, st);
  if (x_dtype == kF32 && w_dtype == kBF16) return (int)launch<float, __nv_bfloat16>(p, batch, st);
  if (x_dtype == kBF16 && w_dtype == kF32) return (int)launch<__nv_bfloat16, float>(p, batch, st);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, batch, st);
  return (int)cudaErrorInvalidValue;
}
