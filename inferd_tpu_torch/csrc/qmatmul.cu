// Decode GEMVs against quantized weights for Hopper (sm_90a): a few rows of
// activations (M <= 64) times an int8 or int4 weight, the weight bytes read
// once, unpacked and scaled in registers.
//
// Replaces two Pallas TPU kernels of inferd_tpu/ops/qmatmul.py:
//   * `_w8a16_kernel` (line 34; entry `w8a16_matmul`, line 53): x [M, K]
//     (f32 or bf16) times int8 q [K, N], int8 converted to x's type, the
//     product summed in f32, the per-output-channel scale [N] applied to the
//     f32 sum, then cast to x's type.
//   * `_w4a16_kernel` (line 94; entry `w4a16_matvec`, line 144): x times a
//     group-wise int4 weight, q int8 [K/2, N] with two values per byte along
//     K (low nibble = even k) or [K, N] with one value per byte (odd K);
//     scale f32 [G, N], the group of element k being k / (K / G), never a
//     byte pair's (an odd group size splits pairs). Two schemes:
//       grouped: each group's f32 partial sum times its scale, summed;
//       dequant: q * scale rounded to x's type, then one f32-summed product.
// On the TPU each was a grid over 512-column blocks with the whole x and a
// [K, 512] weight block resident in VMEM, one MXU dot per block.
//
// What bounds it on the H100, and what this design does about it: at decode
// the product does 2*M flops per weight byte (M = 1 on the one-session path,
// 8 on the lanes), far below the ~590 flops per byte where the int8 or bf16
// tensor cores would limit, so it is bound by the weight's bytes at 3.35 TB/s.
// The design, simply:
//   * one CTA of 256 threads per tile of 64 columns and MT rows (MT = 1, 4 or
//     8, from M; more rows take more CTAs along y). Eight threads cover the
//     64 columns, each reading 8 weight bytes (one 8-byte load) per byte row,
//     so a warp reads four 64-byte row segments at once; the other factor of
//     32 (row slices) splits K inside the CTA, slice s taking byte rows
//     s, s + 32, ...;
//   * x is staged in shared memory as f32, 256 values of K at a time per row;
//   * a slice loads all its byte rows of a K chunk before using any, so 4-8
//     loads per thread are in flight;
//   * bytes become floats without the int-to-float unit: each byte (int8, or
//     a nibble xor 8) is biased to [0, 255], dropped into the mantissa of
//     2^23 with one byte permute, and the bias subtracted in one float add,
//     which is exact. No shift of a negative value (undefined before C++20);
//   * an f32 accumulator per (row, column) in registers, and for the grouped
//     scheme a second one for the running group's partial; at the end the
//     32 slices' sums combine by warp shuffles and through shared memory.
// Columns past N are never loaded (8-byte loads when N % 8 == 0, single
// bytes otherwise) and never stored.
// Not done here, left for later work: tensor cores (wgmma) for M >= 16, TMA
// or cp.async pipelining, split-K across CTAs for the narrow layers (N =
// 1024 gives 16 CTAs for 132 SMs).
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (qmatmul_launch), called through ctypes by
// inferd_tpu_torch/ops/qmatmul.py (w8a16_matmul, w4a16_matvec).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                           // weight columns per thread
constexpr int kColThreads = 8;                     // threads across a tile's columns
constexpr int kBlockN = kCols * kColThreads;       // 64 columns per CTA
constexpr int kSlices = kThreads / kColThreads;    // 32 slices of K per CTA
constexpr int kChunkK = 256;                       // K values of x staged at a time

enum DType { kF32 = 0, kBF16 = 1 };
enum Kind { kInt8 = 0, kInt4Packed = 1, kInt4Bytes = 2 };
// kScaleAfter: one scale per column, applied to the finished f32 sum (w8a16;
// w4a16 grouped with one group). kGrouped: a partial per group, times the
// group's scale. kDequant: q * scale rounded to x's type before the product.
enum Scheme { kScaleAfter = 0, kGrouped = 1, kDequant = 2 };

struct Params {
  const void* x;       // [M, K], x's type
  const uint8_t* q;    // [R, N] weight bytes: R = K, or K / 2 when packed
  const float* scale;  // [G, N]
  void* out;           // [M, N], x's type
  int M, K, N, G, gs;  // gs = K / G
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v.astype(x's type) and back: round-to-nearest-even, as XLA's convert does
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// byte i of a word holding biased values u in [0, 255] -> u - bias, exactly:
// 0x4B000000 is 2^23, whose mantissa's low byte takes u
__device__ __forceinline__ float biased_byte(uint32_t word, int i, float bias) {
  const uint32_t bits = __byte_perm(word, 0x4B000000u, 0x7440u + i);
  return __uint_as_float(bits) - bias;
}

// one byte row's kCols columns -> w[h][c], h the K values the row holds
// (1 for a byte per value, 2 for a packed row: low nibble first)
template <bool PACKED>
__device__ __forceinline__ void unpack(uint2 raw, float (*w)[kCols]) {
  const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (PACKED) {
      const uint32_t b = words[half] ^ 0x88888888u;  // each nibble n -> n ^ 8 = value + 8
      const uint32_t lo = b & 0x0F0F0F0Fu;
      const uint32_t hi = (b >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[0][half * 4 + i] = biased_byte(lo, i, 8388616.0f);  // 2^23 + 8
        w[1][half * 4 + i] = biased_byte(hi, i, 8388616.0f);
      }
    } else {
      const uint32_t b = words[half] ^ 0x80808080u;  // each int8 -> value + 128
#pragma unroll
      for (int i = 0; i < 4; ++i) w[0][half * 4 + i] = biased_byte(b, i, 8388736.0f);  // 2^23 + 128
    }
  }
}

// kCols bytes of byte row r from column n0; columns past N read as 0
__device__ __forceinline__ uint2 load_row(const uint8_t* q, int r, int n0, int N, bool vec) {
  const uint8_t* p = q + (long)r * N + n0;
  if (vec) return n0 < N ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < N) w[c / 4] |= (uint32_t)p[c] << (8 * (c % 4));
  return make_uint2(w[0], w[1]);
}

// grid (ceil(N / kBlockN), ceil(M / MT)); blockDim kThreads
template <typename T, int MT, bool PACKED, int SCHEME>
__global__ void __launch_bounds__(kThreads) qgemv_kernel(Params p) {
  constexpr int kRowK = PACKED ? 2 : 1;                   // K values per byte row
  constexpr int kRowsPerThread = kChunkK / kRowK / kSlices;  // byte rows per chunk per slice
  __shared__ float xs[MT][kChunkK];
  __shared__ float red[kWarps][MT][kBlockN];

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads, slice = tid / kColThreads;
  const int n0 = blockIdx.x * kBlockN + ct * kCols;
  const int m0 = blockIdx.y * MT;
  const bool vec = (p.N % kCols) == 0;
  const int rows_total = p.K / kRowK;

  float acc[MT][kCols];
  float part[MT][kCols];  // kGrouped: the running group's partial sum
  float sc[kCols];        // kGrouped / kDequant: the running group's scales
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = part[m][c] = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) sc[c] = 0.f;
  int cur_g = -1;

  auto load_scales = [&](int g) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      sc[c] = n0 + c < p.N ? p.scale[(long)g * p.N + n0 + c] : 0.f;
  };
  auto flush = [&]() {  // kGrouped: acc += partial * scale, partial = 0
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[m][c] = fmaf(part[m][c], sc[c], acc[m][c]);
        part[m][c] = 0.f;
      }
  };

  for (int kc = 0; kc < p.K; kc += kChunkK) {
    __syncthreads();  // the previous chunk is done with xs
    for (int i = tid; i < MT * kChunkK; i += kThreads) {
      const int m = i / kChunkK, kk = i % kChunkK;
      const int row = m0 + m, k = kc + kk;
      xs[m][kk] = (row < p.M && k < p.K) ? to_f32(x[(long)row * p.K + k]) : 0.f;
    }
    __syncthreads();

    const int r0 = kc / kRowK;
    uint2 raw[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = r0 + slice + j * kSlices;
      raw[j] = r < rows_total ? load_row(p.q, r, n0, p.N, vec) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = r0 + slice + j * kSlices;
      if (r >= rows_total) break;  // rows ascend with j
      float w[kRowK][kCols];
      unpack<PACKED>(raw[j], w);
#pragma unroll
      for (int h = 0; h < kRowK; ++h) {
        const int k = r * kRowK + h;
        const int kk = k - kc;
        if (SCHEME != kScaleAfter) {
          const int g = k / p.gs;
          if (g != cur_g) {  // a thread's k only grows: each group starts once
            if (SCHEME == kGrouped && cur_g >= 0) flush();
            load_scales(g);
            cur_g = g;
          }
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float wv = w[h][c];
          if (SCHEME == kDequant) wv = round_as(wv * sc[c], x);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (SCHEME == kGrouped)
              part[m][c] = fmaf(xs[m][kk], wv, part[m][c]);
            else
              acc[m][c] = fmaf(xs[m][kk], wv, acc[m][c]);
          }
        }
      }
    }
  }
  if (SCHEME == kGrouped && cur_g >= 0) flush();

  // sum the 32 slices: the 4 of a warp by shuffles (lanes 8 apart hold the
  // same columns), then the 8 warps through shared memory
#pragma unroll
  for (int off = kColThreads; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kColThreads) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][m][lane * kCols + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int row = m0 + m, n = blockIdx.x * kBlockN + col;
    if (row >= p.M || n >= p.N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][col];
    if (SCHEME == kScaleAfter) s *= p.scale[n];  // one group: row 0 of the scales
    store(out, (long)row * p.N + n, s);
  }
}

template <typename T, int MT, bool PACKED>
cudaError_t launch_scheme(const Params& p, int scheme, cudaStream_t stream) {
  dim3 grid((p.N + kBlockN - 1) / kBlockN, (p.M + MT - 1) / MT);
  if (scheme == kScaleAfter)
    qgemv_kernel<T, MT, PACKED, kScaleAfter><<<grid, kThreads, 0, stream>>>(p);
  else if (scheme == kGrouped)
    qgemv_kernel<T, MT, PACKED, kGrouped><<<grid, kThreads, 0, stream>>>(p);
  else
    qgemv_kernel<T, MT, PACKED, kDequant><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool PACKED>
cudaError_t launch_rows(const Params& p, int scheme, cudaStream_t stream) {
  if (p.M == 1) return launch_scheme<T, 1, PACKED>(p, scheme, stream);
  if (p.M <= 4) return launch_scheme<T, 4, PACKED>(p, scheme, stream);
  return launch_scheme<T, 8, PACKED>(p, scheme, stream);
}

template <typename T>
cudaError_t launch_kind(const Params& p, int kind, int scheme, cudaStream_t stream) {
  if (kind == kInt4Packed) return launch_rows<T, true>(p, scheme, stream);
  return launch_rows<T, false>(p, scheme, stream);
}

}  // namespace

// The wrapper (ops/qmatmul.py) validates devices, dtypes, shapes, contiguity
// and alignment. kind: 0 int8 (w8a16), 1 int4 packed, 2 int4 one value per
// byte; scheme: 0 grouped, 1 dequant (w8a16 passes 0 with one group). This
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int qmatmul_launch(const void* x, const void* q, const float* scale, void* out,
                              int M, int K, int N, int G, int kind, int scheme, int x_dtype,
                              void* stream) {
  if (G <= 0 || K % G != 0 || kind < kInt8 || kind > kInt4Bytes || scheme < 0 || scheme > 1)
    return (int)cudaErrorInvalidValue;
  if (kind == kInt4Packed && K % 2 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.q = static_cast<const uint8_t*>(q);
  p.scale = scale;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  p.gs = K / G;
  // w8a16, and grouped int4 with a single group, apply the scale to the sum
  const int s = kind == kInt8 ? kScaleAfter : scheme == 1 ? kDequant : G == 1 ? kScaleAfter : kGrouped;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return (int)launch_kind<float>(p, kind, s, st);
  if (x_dtype == kBF16) return (int)launch_kind<__nv_bfloat16>(p, kind, s, st);
  return (int)cudaErrorInvalidValue;
}
