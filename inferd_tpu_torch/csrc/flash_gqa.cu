// Flash GQA attention for Hopper (sm_90a): online-softmax attention over a
// KV buffer whose slot j holds absolute position kv_start + j.
//
// Replaces the two Pallas TPU kernels of inferd_tpu/ops/attention.py:
// `_flash_kernel` (line 131, K/V resident in VMEM) and `_flash_kernel_stream`
// (line 218, K/V streamed through VMEM with the softmax state in scratch).
// That split exists only because of the TPU's VMEM budget. Here one kernel
// serves both: each block streams K/V tiles through shared memory and keeps
// its online-softmax state (running max m, denominator l, numerator acc) in
// registers and shared memory, so the buffer length is unbounded.
//
// What it computes (the TPU kernel's function, not its block structure):
//   * GQA sharing: a block owns one (batch row, kv head) and the G query
//     heads of that group over a tile of BQ query positions (rows r =
//     i * G + g). Each K/V tile is fetched once for the whole group.
//   * Per batch row (q_start, kv_start, kv_len, window), either as scalars
//     or as an int32 [B, 4] array. Masks: causal kpos <= qpos, validity
//     slot < kv_len, window (win <= 0) | (kpos > qpos - win).
//   * The kv-tile loop runs from the window floor to the causal frontier of
//     the block's query tile, as attention.py:169-180 bounds it.
//   * Scores accumulate in f32, times `scale`, then softcap, then the mask;
//     the masked value is the finite NEG_INF = -1e30 (exp(-inf - -inf) is
//     NaN). Masked entries contribute exactly zero probability, so a row with
//     no valid slot ends with l == 0 and writes zeros.
//   * p is rounded to the query dtype before p @ v, as attention.py:203-206
//     does; the denominator sums the unrounded f32 p. Accumulation is f32.
//   * Sinks (one logit per query head) fold into the denominator at the end
//     (_fold_sink, attention.py:109-123). out = acc / (l == 0 ? 1 : l).
//   * Q/K/V in f32 or bf16, or K/V in fp8-e4m3 upcast in-register (exact:
//     every e4m3 value is representable in bf16 and f32).
//
// What bounds it on the H100, and what this design does about it: attention
// at decode (S = 1) reads the whole valid KV span once and does ~2 flops per
// byte, so it is bound by device-memory bytes (3.35 TB/s); prefill at D = 128
// does ~S flops per byte and is bound by operations. This first kernel is
// the simple, right one: scalar FMA over shared-memory tiles, no tensor
// cores, no TMA, no split-KV. Known weaknesses, left for later work:
//   * decode with B = 1 launches only B * Nkv blocks (8 for Qwen3-0.6B) on
//     132 SMs, so it reaches a small share of the memory rate;
//   * prefill runs on the FP32 pipes (67 TFLOP/s peak) instead of the bf16
//     tensor cores (989 TFLOP/s), far from its bound.
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (flash_gqa_launch), called through ctypes by
// inferd_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRows = 32;  // query rows (G heads x BQ positions) per block
constexpr int kBlockK = 64;   // kv slots per shared-memory tile

enum DType { kF32 = 0, kBF16 = 1, kFP8E4M3 = 2 };

struct Params {
  const void* q;      // [B, S, Nq, D]
  const void* k;      // [B, T, Nkv, D]
  const void* v;      // [B, T, Nkv, D]
  void* out;          // [B, S, Nq, D], query dtype
  const int* meta;    // [B, 4] (q_start, kv_start, kv_len, window) or null
  const float* sinks; // [Nq] f32 or null
  int B, S, T, Nq, Nkv, G, BQ;
  int q_start, kv_start, kv_len, window;  // used when meta is null
  float scale, softcap;
};

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const __nv_fp8_e4m3* p, long i) {
  return static_cast<float>(p[i]);
}

// p.astype(query dtype): round-to-nearest-even, as XLA's convert does
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // qs [kMaxRows][D+1], ks [kBlockK][D+1], vs [kBlockK][D],
  // ps [kMaxRows][kBlockK], row_m/row_l/row_a [kMaxRows]
  return (size_t)kMaxRows * (D + 1) + (size_t)kBlockK * (D + 1) + (size_t)kBlockK * D +
         (size_t)kMaxRows * kBlockK + 3 * (size_t)kMaxRows;
}

// One block = one (query tile, kv head, batch row); blockDim.x == D, and
// thread t owns output column t of every row of the tile.
template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(D) flash_gqa_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;  // padded row stride: column reads of K are bank-conflict free
  float* qs = smem;
  float* ks = qs + kMaxRows * DP;
  float* vs = ks + kBlockK * DP;
  float* ps = vs + kBlockK * D;
  float* row_m = ps + kMaxRows * kBlockK;
  float* row_l = row_m + kMaxRows;
  float* row_a = row_l + kMaxRows;

  const TQ* q = static_cast<const TQ*>(p.q);
  const TKV* k = static_cast<const TKV*>(p.k);
  const TKV* v = static_cast<const TKV*>(p.v);
  TQ* out = static_cast<TQ*>(p.out);

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.G;
  const int s0 = blockIdx.x * p.BQ;            // first query index of the tile
  const int npos = min(p.BQ, p.S - s0);        // real query positions in the tile
  const int nrows = npos * G;                  // row r = i * G + g

  int q_start = p.q_start, kv_start = p.kv_start, kv_len = p.kv_len, win = p.window;
  if (p.meta != nullptr) {
    q_start = p.meta[b * 4 + 0];
    kv_start = p.meta[b * 4 + 1];
    kv_len = p.meta[b * 4 + 2];
    win = p.meta[b * 4 + 3];
  }

  // stage the tile's query rows (f32) and reset the softmax state
  for (int r = 0; r < nrows; ++r) {
    const int i = r / G, g = r - (r / G) * G;
    const long off = (((long)b * p.S + s0 + i) * p.Nq + (long)kvh * G + g) * D + tid;
    qs[r * DP + tid] = load_f(q, off);
  }
  for (int r = tid; r < kMaxRows; r += D) {
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }

  // kv-tile range: window floor of the tile's lowest position to the causal
  // frontier of its highest (and never past kv_len or the buffer)
  const int pos_lo = q_start + s0;
  const int pos_hi = q_start + s0 + npos - 1;
  const int ntiles = (p.T + kBlockK - 1) / kBlockK;
  const int last = min(min(kv_len, p.T), pos_hi + 1 - kv_start);  // exclusive slot bound
  const int hi = last <= 0 ? 0 : min((last + kBlockK - 1) / kBlockK, ntiles);
  int lo = 0;
  if (win > 0) {
    const int lo_slot = pos_lo - win + 1 - kv_start;
    lo = lo_slot > 0 ? min(lo_slot / kBlockK, ntiles) : 0;
  }

  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = D / 32;
  __syncthreads();

  for (int tile = lo; tile < hi; ++tile) {
    const int j0 = tile * kBlockK;
    // K/V tile -> shared f32 (in-register upcast of bf16 / fp8); slots past
    // the buffer read as zero and are masked below
#pragma unroll 16
    for (int j = 0; j < kBlockK; ++j) {
      const int slot = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (slot < p.T) {
        const long off = (((long)b * p.T + slot) * p.Nkv + kvh) * D + tid;
        kx = load_f(k, off);
        vx = load_f(v, off);
      }
      ks[j * DP + tid] = kx;
      vs[j * D + tid] = vx;
    }
    __syncthreads();

    // scores s[r, j] = scale * <q_r, k_j>, softcapped
    for (int idx = tid; idx < nrows * kBlockK; idx += D) {
      const int r = idx / kBlockK, j = idx - (idx / kBlockK) * kBlockK;
      const float* qr = qs + r * DP;
      const float* kr = ks + j * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * p.scale;
      if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
      ps[r * kBlockK + j] = s;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < nrows; r += kWarps) {
      const int qpos = q_start + s0 + r / G;
      float sv[kBlockK / 32];
      bool ok[kBlockK / 32];
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < kBlockK / 32; ++u) {
        const int j = lane + 32 * u;
        const int slot = j0 + j;
        const int kpos = kv_start + slot;
        const bool valid = slot < kv_len && slot < p.T && kpos <= qpos &&
                           (win <= 0 || kpos > qpos - win);
        sv[u] = ps[r * kBlockK + j];
        ok[u] = valid;
        if (valid) mt = fmaxf(mt, sv[u]);
      }
      mt = warp_max(mt);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mt);
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < kBlockK / 32; ++u) {
        const float pj = ok[u] ? expf(sv[u] - m_new) : 0.f;
        lsum += pj;
        ps[r * kBlockK + lane + 32 * u] = round_as(pj, q);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + lsum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r] = acc[r] * alpha[r] + sum_j p[r, j] * v[j, tid]
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < nrows) acc[r] *= row_a[r];
    for (int j = 0; j < kBlockK; ++j) {
      const float vj = vs[j * D + tid];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nrows) acc[r] = fmaf(ps[r * kBlockK + j], vj, acc[r]);
    }
    __syncthreads();
  }

  // sink fold, normalisation, store
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nrows) {
      const int i = r / G, g = r - (r / G) * G;
      const int h = kvh * G + g;
      float m = row_m[r], l = row_l[r], a = acc[r];
      if (p.sinks != nullptr) {
        const float sk = p.sinks[h];
        const float mf = fmaxf(m, sk);
        const float af = expf(m - mf);
        l = l * af + (sk > 0.5f * kNegInf ? expf(sk - mf) : 0.f);
        a *= af;
      }
      const float o = a / (l == 0.f ? 1.f : l);
      store_f(out, (((long)b * p.S + s0 + i) * p.Nq + h) * D + tid, o);
    }
  }
}

template <int D, typename TQ, typename TKV>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_gqa_kernel<D, TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + p.BQ - 1) / p.BQ, p.Nkv, p.B);
  flash_gqa_kernel<D, TQ, TKV><<<grid, D, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtypes(const Params& p, int q_dtype, int kv_dtype, cudaStream_t stream) {
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_typed<D, float, float>(p, stream);
  if (q_dtype == kF32 && kv_dtype == kFP8E4M3) return launch_typed<D, float, __nv_fp8_e4m3>(p, stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<D, __nv_bfloat16, __nv_bfloat16>(p, stream);
  if (q_dtype == kBF16 && kv_dtype == kFP8E4M3)
    return launch_typed<D, __nv_bfloat16, __nv_fp8_e4m3>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The wrapper (ops/attention.py) validates shapes, dtypes and grid limits;
// this returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_gqa_launch(const void* q, const void* k, const void* v, void* out,
                                const int* meta, const float* sinks, int B, int S, int T,
                                int Nq, int Nkv, int D, int q_start, int kv_start, int kv_len,
                                int window, float scale, float softcap, int q_dtype,
                                int kv_dtype, void* stream) {
  const int G = Nq / Nkv;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.meta = meta;
  p.sinks = sinks;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.G = G;
  p.BQ = S < kMaxRows / G ? S : kMaxRows / G;
  p.q_start = q_start;
  p.kv_start = kv_start;
  p.kv_len = kv_len;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dtypes<64>(p, q_dtype, kv_dtype, st);
  if (D == 128) return (int)launch_dtypes<128>(p, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
