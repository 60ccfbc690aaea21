// Fused multi-tenant LoRA lane delta for Hopper (sm_90a): for every lane b
// of a co-batched dispatch, scale[ids[b]] * (x[b] @ A[ids[b], layer]) @
// B[ids[b], layer], the slot gathered from the stacked adapter pools inside
// the kernel, and optionally added to the projection output y in the
// epilogue.
//
// Replaces the Pallas TPU kernel `_fused_delta_kernel` of
// inferd_tpu/ops/lora.py (line 313; entry `fused_lane_delta`, line 341):
//   x [B, S, in] (f32 or bf16), A pool [slots, L, in, r], B pool [slots, L,
//   r, out] (f32 or bf16, both alike), scale [slots] f32, ids [B] int32 on
//   the device, layer a host int -> out [B, S, out] f32. f32 end to end:
//   xa = x @ A stays f32 and is never rounded to 16 bits (Punica-style
//   kernels round it; the reference does not). Slot 0 is the all-zero base
//   adapter, and its lanes get an exact 0; a slot outside [0, slots) writes
//   NaN (loud, never a silent other tenant). With y [B, S, out] (f32 or
//   bf16), out = (y.float() + delta).to(y.dtype), the reference's own add
//   (inferd_tpu/ops/lora.py:433): an f32 add, then one rounding; out may be
//   y itself, and base-slot lanes then leave y untouched.
// On the TPU the gather lived in the BlockSpec index maps (scalar-prefetched
// ids picked which [in, r] / [r, out] blocks the pipeline fetched), one grid
// step per lane with its whole [S, in] x resident in VMEM. Here each CTA
// reads ids itself and indexes the pools with 64-bit offsets.
//
// What bounds it on the H100, and what this design does about it: the work
// is 2*S*r*(in + out) flops per lane against the lane's adapter slice (r *
// (in + out) values) and x; at decode (S = 1, r = 16, in/out 1024-3072)
// that is under 1 MB for 8 lanes, ~0.3 us of memory time, so a launch is
// set by launch latency and by how many dependent device-memory round trips
// it makes. The first version (one CTA per lane, 16 rows and 256 columns)
// walked the shrink's K in dependent chunks, recomputed the shrink in every
// column tile, ran the prefill shrink on the FP32 pipes, and left the
// residual add to three more launches. Here, with the launch plan from the
// host (ops/lora.lora_plan, a pure function of shapes):
//   * one thread-block cluster of `cluster` CTAs per (lane, row tile): the
//     shrink is computed once per row tile. A row tile is 16 rows of S (one
//     mma m16 tile), or 1 at decode, where the 16-row form's unrolled
//     expand held twice the registers and made the launch several
//     microseconds slower;
//   * rank c takes K values [c * kr, (c + 1) * kr) and the output columns
//     [c * cols, (c + 1) * cols). Once the lane's slot is read (ids[lane],
//     with the scale beside it), every load of the rank is issued at once:
//     its x rows, the lane's A rows and its B columns, by cp.async into
//     shared memory (16-byte pieces when rows are aligned, element loads
//     otherwise), so the rank makes one round trip after the ids'. A's
//     slice is read once per lane at decode. Where B's columns do not fit
//     beside the chunks (ranks of 64-128 at the wider projections), they
//     are prefetched into L2 instead and K is walked in chunks;
//   * the ranks' partial xa meet through distributed shared memory: each
//     rank stores its [rows, r] partial into every rank's inbox, one
//     cluster barrier, and each rank adds the partials in rank order 0, 1,
//     ... (no atomics: every rank holds the same bits, and so does every
//     call);
//   * the prefill shrink (bf16 x and pools, S >= 16: route mma) runs on the
//     tensor cores, mma.sync m16n8k16 with f32 accumulation, warps taking
//     alternate 16-value K steps and adding their tiles in warp order; every
//     bf16 product is exact in f32. r is padded to the mma's 8 columns in
//     shared memory and the pad columns are dropped. f32 x or pools, and
//     decode, take FMAs (route simt): groups of threads split each output's
//     K, their partials added in group order. No TF32;
//   * the expand stays on FMAs: xa is read in f32 from shared memory, a
//     thread takes two neighbouring columns of the rank's share with an f32
//     accumulator per row each; the scale multiplies the finished sum, as
//     the reference does;
//   * the epilogue adds y when given (__fmul_rn / __fadd_rn, so the compiler
//     cannot fuse the scale and the add into one rounding): a projection
//     with a delta is one launch instead of four. y's rows are prefetched
//     into L2 when the CTA starts.
// Not done here, left for later work: grouping lanes that share a slot
// (Punica's SGMV) so B's columns are read once per slot, TMA and wgmma.
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (lora_delta_launch), called through ctypes by
// inferd_tpu_torch/ops/lora.py (fused_lane_delta).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                          // rows of S per row tile (one mma m16 tile)
constexpr int kMaxRank = 128;
constexpr int kMaxCluster = 8;
constexpr int kMaxGroups = 32;  // simt: threads that split one xa output's K
constexpr int kMaxSmem = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1 };
enum Route { kSimt = 0, kMma = 1 };

struct Params {
  const void* x;       // [B, S, din], x's type
  const void* a;       // [slots, layers, din, r], the pools' type
  const void* b;       // [slots, layers, r, dout]
  const float* scale;  // [slots]
  const int* ids;      // [B]
  const void* y;       // [B, S, dout] in the output's type, or null
  void* out;           // [B, S, dout]: y's type with y (may be y), else f32
  int S, din, dout, r, slots, layers, layer;
  int cluster, kr, kc, rp, cols;  // the plan: ranks, K per rank, K per chunk, padded r, columns
  int b_stage;                    // the rank's B columns staged in shared memory
  int x_vec, a_vec, b_vec;        // rows of x / A / B in 16-byte pieces (cp.async)
};

// Shared memory, in this order (every part a multiple of 16 bytes: the f32
// parts are rounded up to 4 values):
//   xs  [rt][xst]         x chunk, x's type; xst = kc rounded up to 8, plus 8 (rows
//                         16-byte aligned, and ldmatrix rows on distinct banks)
//   as  [kc][rp + 8]      A chunk, the pools' type
//   red simt [kThreads] / mma [kWarps][kRows][rp] f32: the CTA's K-split partials
//   inbox [cluster][rt][r] f32: every rank's partial xa
//   xa  [rt][r] f32
//   bs  [r][cols]         the rank's B columns, the pools' type (b_stage only)
// lora_plan in ops/lora.py computes the same sizes to pick kc and b_stage.
// (rt: the row tile, kRows or 1)
__host__ __device__ inline long round4(long n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int x_stride(int kc) { return (kc + 7) / 8 * 8 + 8; }
__host__ __device__ inline long smem_bytes(int route, int rt, int kc, int rp, int r, int cluster,
                                           int sx, int sw, int bcols) {
  return (long)rt * x_stride(kc) * sx + (long)kc * (rp + 8) * sw +
         4L * (route == kMma ? kWarps * kRows * rp : kThreads) + 4L * round4(cluster * rt * r) +
         4L * round4(rt * r) + (long)r * bcols * sw;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// columns [c0, c1) of `rows` rows `stride` values apart, into L2: one
// prefetch per 128-byte line, the block's threads taking the lines in turn
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* base, long stride, int rows, int c0,
                                              int c1) {
  if (c1 <= c0) return;
  const int lines = (int)(((long)(c1 - c0) * sizeof(T) + 127) / 128) + 1;
  for (int i = threadIdx.x; i < rows * lines; i += blockDim.x) {
    const int row = i / lines, l = i - (i / lines) * lines;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(base + row * stride + c0);
    const uintptr_t at = (lo & ~uintptr_t(127)) + 128u * l;
    if (at < reinterpret_cast<uintptr_t>(base + row * stride + c1))
      prefetch_l2(reinterpret_cast<const void*>(at));
  }
}

// the cluster barrier in two halves: arrive (release, or relaxed where it
// only says "this CTA has started"), then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid (cluster, row tiles, B), cluster dims (cluster, 1, 1): blockIdx.x is
// the rank; blockDim kThreads. TO: the output's type (f32 without y).
template <int ROUTE, int RT, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads) lora_delta_kernel(Params p) {
  static_assert(ROUTE != kMma || RT == kRows, "the mma route takes whole m16 row tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int s0 = blockIdx.y * RT;
  const int lane = blockIdx.z;
  const int rows = min(RT, p.S - s0);
  const int r = p.r, C = p.cluster;
  const int c0 = rank * p.cols, c1 = min(c0 + p.cols, p.dout);
  const int slot = p.ids[lane];
  const long row0 = ((long)lane * p.S + s0) * p.dout;
  TO* out = static_cast<TO*>(p.out) + row0;
  const TO* yin = p.y == nullptr ? nullptr : static_cast<const TO*>(p.y) + row0;

  const int xst = x_stride(p.kc), ast = p.rp + 8;
  TX* xs = reinterpret_cast<TX*>(smem);
  TW* as = reinterpret_cast<TW*>(smem + (long)RT * xst * sizeof(TX));
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(as) +
                                        (long)p.kc * ast * sizeof(TW));
  float* inbox = red + (ROUTE == kMma ? kWarps * kRows * p.rp : kThreads);
  float* xa = inbox + round4(C * RT * r);
  TW* bs = reinterpret_cast<TW*>(xa + round4(RT * r));  // [r][cols]
  const TX* X = static_cast<const TX*>(p.x) + ((long)lane * p.S + s0) * p.din;
  const int k_lo = rank * p.kr, k_hi = min(k_lo + p.kr, p.din);

  // x's rows of the chunk [kb, kb + kn) into xs, all loads at once
  auto stage_x = [&](int kb, int kn) {
    if (p.x_vec) {
      constexpr int V = 16 / sizeof(TX);
      const int nv = kn / V;
      for (int v = tid; v < rows * nv; v += kThreads) {
        const int row = v / nv, c = v - (v / nv) * nv;
        cp_async16(xs + row * xst + c * V, X + (long)row * p.din + kb + c * V);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < rows * kn; i += kThreads) {
        const int row = i / kn, kk = i - (i / kn) * kn;
        xs[row * xst + kk] = X[(long)row * p.din + kb + kk];
      }
    }
  };

  // y's rows of this rank's columns into L2 while the slot arrives
  if (yin != nullptr) prefetch_rows(yin, p.dout, rows, c0, c1);

  // the base adapter (zero delta), or an id out of range (NaN); the whole
  // cluster sees the same slot and leaves before any cluster barrier
  if (slot <= 0 || slot >= p.slots) {
    if (slot == 0 && yin == out) return;  // in place: y + 0 is y
    for (int i = 0; i < rows; ++i)
      for (int n = c0 + tid; n < c1; n += kThreads) {
        const long o = (long)i * p.dout + n;
        if (slot != 0)
          put(out, o, __int_as_float(0x7fc00000));
        else if (yin != nullptr)
          out[o] = yin[o];
        else
          put(out, o, 0.f);
      }
    return;
  }

  const float sc = p.scale[slot];  // in flight with the loads below
  stage_x(k_lo, min(p.kc, k_hi - k_lo));
  const long ab = (long)slot * p.layers + p.layer;
  const TW* A = static_cast<const TW*>(p.a) + ab * p.din * r;
  const TW* Bm = static_cast<const TW*>(p.b) + ab * r * p.dout;

  // B's rows for this rank's columns: staged in shared memory with the
  // shrink's loads (one round trip for all three), or, when they do not
  // fit, prefetched into L2 while the shrink runs
  const int ncols = max(c1 - c0, 0);
  if (p.b_stage) {
    if (p.b_vec) {
      constexpr int V = 16 / sizeof(TW);
      const int nv = ncols / V;
      for (int v = tid; v < r * nv; v += kThreads) {
        const int j = v / nv, c = v - (v / nv) * nv;
        cp_async16(bs + j * p.cols + c * V, Bm + (long)j * p.dout + c0 + c * V);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < r * ncols; i += kThreads) {
        const int j = i / ncols, c = i - (i / ncols) * ncols;
        bs[j * p.cols + c] = Bm[(long)j * p.dout + c0 + c];
      }
    }
  } else {
    prefetch_rows(Bm, p.dout, r, c0, c1);
  }
  if (C > 1) cluster_arrive_relaxed();  // "started": waited before the first remote store

  // ---- shrink: this rank's partial xa[row, j] over K [k_lo, k_hi) ----
  const int no = rows * r;                                 // xa outputs
  // simt: threads per output, at most kMaxGroups: one thread then adds an
  // output's group sums in order, serially (256 at rank 1 cost microseconds)
  const int groups = no >= kThreads ? 1 : min(kThreads / no, kMaxGroups);
  const int o1 = tid % no, g = tid / no;
  constexpr int kOut = (RT * kMaxRank + kThreads - 1) / kThreads;  // simt xa outputs a thread
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float mc[kMaxRank / 8][4];  // mma: this warp's [16, rp] tile, 8 columns each
#pragma unroll
  for (int t = 0; t < kMaxRank / 8; ++t) mc[t][0] = mc[t][1] = mc[t][2] = mc[t][3] = 0.f;
  const int warp = tid >> 5, ln = tid & 31;

  for (int kb = k_lo; kb < k_hi; kb += p.kc) {
    const int kn = min(p.kc, k_hi - kb);
    if (kb != k_lo) {  // a later chunk: the previous one is consumed first
      __syncthreads();
      stage_x(kb, kn);
    }
    // every load of the chunk at once
    const TW* Ac = A + (long)kb * r;  // rows kb .. kb + kn of A: kn * r contiguous values
    if (p.a_vec) {
      constexpr int V = 16 / sizeof(TW);
      const int nv = r / V;
      for (int v = tid; v < kn * nv; v += kThreads) {
        const int kk = v / nv, c = v - (v / nv) * nv;
        cp_async16(as + kk * ast + c * V, Ac + (long)kk * r + c * V);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < kn * r; i += kThreads) {
        const int kk = i / r, j = i - (i / r) * r;
        as[kk * ast + j] = Ac[i];
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if constexpr (ROUTE == kMma) {
      // warp w takes the 16-value K steps w, w + kWarps, ... of the chunk
      const int nt = p.rp / 8;
      for (int ks = warp; ks < kn / 16; ks += kWarps) {
        uint32_t af[4];
        ldmatrix_x4(af, xs + (ln & 15) * xst + ks * 16 + (ln >> 4) * 8);
#pragma unroll
        for (int t = 0; t < kMaxRank / 8; ++t) {
          if (t < nt) {
            uint32_t bf[2];
            ldmatrix_x2_trans(bf, as + (ks * 16 + (ln & 15)) * ast + t * 8);
            mma_bf16(mc[t], af, bf);
          }
        }
      }
    } else if (groups == 1) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int o = tid + i * kThreads;
        if (o < no) {
          const TX* xr = xs + (o / r) * xst;
          const TW* ac = as + o % r;
          float s = acc[i];
          for (int kk = 0; kk < kn; ++kk) s = fmaf(to_f32(xr[kk]), to_f32(ac[kk * ast]), s);
          acc[i] = s;
        }
      }
    } else if (g < groups) {
      const TX* xr = xs + (o1 / r) * xst;
      const TW* ac = as + o1 % r;
      float s = acc[0];
      for (int kk = g; kk < kn; kk += groups) s = fmaf(to_f32(xr[kk]), to_f32(ac[kk * ast]), s);
      acc[0] = s;
    }
  }

  // the CTA's partial, its parts added in order, into every rank's inbox
  // (rank `rank`'s slot); the cluster's partials meet after one barrier
  cg::cluster_group cluster = cg::this_cluster();
  auto deliver = [&](int row, int j, float s) {
    for (int dst = 0; dst < C; ++dst) {
      float* box = C > 1 ? cluster.map_shared_rank(inbox, dst) : inbox;
      box[(rank * RT + row) * r + j] = s;
    }
  };
  if constexpr (ROUTE == kMma) {
    const int nt = p.rp / 8;
#pragma unroll
    for (int t = 0; t < kMaxRank / 8; ++t) {
      if (t < nt) {
        const int row = ln >> 2, col = t * 8 + (ln & 3) * 2;
        float* w = red + (warp * kRows + row) * p.rp + col;
        w[0] = mc[t][0];
        w[1] = mc[t][1];
        w[8 * p.rp] = mc[t][2];
        w[8 * p.rp + 1] = mc[t][3];
      }
    }
    __syncthreads();
    if (C > 1) cluster_wait();  // every CTA of the cluster has started
    for (int o = tid; o < no; o += kThreads) {
      const int row = o / r, j = o - (o / r) * r;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + row) * p.rp + j];
      deliver(row, j, s);
    }
  } else if (groups == 1) {
    if (C > 1) cluster_wait();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < no) deliver(o / r, o % r, acc[i]);
    }
  } else {
    if (g < groups) red[tid] = acc[0];  // tid = g * no + o1
    __syncthreads();
    if (C > 1) cluster_wait();
    if (tid < no) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * no + tid];
      deliver(tid / r, tid % r, s);
    }
  }
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  // every rank adds the ranks' partials in rank order: the same bits everywhere
  for (int o = tid; o < no; o += kThreads) {
    const int row = o / r, j = o - (o / r) * r;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += inbox[(c * RT + row) * r + j];
    xa[row * r + j] = s;
  }
  __syncthreads();

  // ---- expand: out[row, n] = scale * sum_j xa[row, j] * B[j, n] (+ y) ----
  // a thread takes two neighbouring columns c, c + 1 of the rank's share
  auto expand = [&](auto bval) {  // bval(j, c): B[j, c0 + c] in f32
    for (int c = 2 * tid; c < ncols; c += 2 * kThreads) {
      const bool two = c + 1 < ncols;
      float y0[RT], y1[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) y0[i] = y1[i] = 0.f;
#pragma unroll 8
      for (int j = 0; j < r; ++j) {
        const float b0 = bval(j, c), b1 = two ? bval(j, c + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          if (i < rows) {
            y0[i] = fmaf(xa[i * r + j], b0, y0[i]);
            y1[i] = fmaf(xa[i * r + j], b1, y1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (i < rows) {
          const long o = (long)i * p.dout + c0 + c;
          const float d0 = __fmul_rn(y0[i], sc), d1 = __fmul_rn(y1[i], sc);
          put(out, o, yin == nullptr ? d0 : __fadd_rn(to_f32(yin[o]), d0));
          if (two) put(out, o + 1, yin == nullptr ? d1 : __fadd_rn(to_f32(yin[o + 1]), d1));
        }
      }
    }
  };
  if (p.b_stage)
    expand([&](int j, int c) { return to_f32(bs[j * p.cols + c]); });
  else
    expand([&](int j, int c) { return to_f32(Bm[(long)j * p.dout + c0 + c]); });
}

template <int ROUTE, int RT, typename TX, typename TW, typename TO>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = lora_delta_kernel<ROUTE, RT, TX, TW, TO>;
  const int row_tiles = (p.S + RT - 1) / RT;
  const long smem = smem_bytes(ROUTE, RT, p.kc, p.rp, p.r, p.cluster, sizeof(TX), sizeof(TW),
                               p.b_stage ? p.cols : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cluster, (unsigned)row_tiles, (unsigned)batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int ROUTE, int RT, typename TX, typename TW>
cudaError_t launch_out(const Params& p, int o_dtype, int batch, cudaStream_t st) {
  if (o_dtype == kBF16) return launch<ROUTE, RT, TX, TW, __nv_bfloat16>(p, batch, st);
  return launch<ROUTE, RT, TX, TW, float>(p, batch, st);
}

template <typename TX, typename TW>
cudaError_t launch_simt(const Params& p, int rt, int o_dtype, int batch, cudaStream_t st) {
  if (rt == 1) return launch_out<kSimt, 1, TX, TW>(p, o_dtype, batch, st);
  return launch_out<kSimt, kRows, TX, TW>(p, o_dtype, batch, st);
}

}  // namespace

// The wrapper (ops/lora.py) validates devices, dtypes, shapes, contiguity,
// alignment, the layer index and the rank, and passes lora_plan's route,
// cluster, K per rank, K per chunk, columns per rank and whether B is
// staged. x_dtype / w_dtype / o_dtype: 0 f32, 1 bf16; o_dtype is y's (out's)
// dtype, f32 when y is null. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int lora_delta_launch(const void* x, const void* a, const void* b, const float* scale,
                                 const int* ids, const void* y, void* out, int batch, int S,
                                 int din, int dout, int r, int slots, int layers, int layer,
                                 int x_dtype, int w_dtype, int o_dtype, int route, int rt,
                                 int cluster, int kr, int kc, int cols, int b_stage,
                                 int x_vec,
                                 int a_vec, int b_vec, void* stream) {
  const int sx = x_dtype == kF32 ? 4 : 2, sw = w_dtype == kF32 ? 4 : 2;
  const int rp = (r + 7) / 8 * 8;
  const int row_tiles = (S + rt - 1) / (rt > 0 ? rt : 1);
  if (batch <= 0 || S <= 0 || din <= 0 || dout <= 0 || r < 1 || r > kMaxRank || slots < 1 ||
      layer < 0 || layer >= layers || row_tiles > 65535 || batch > 65535 ||
      (x_dtype != kF32 && x_dtype != kBF16) || (w_dtype != kF32 && w_dtype != kBF16) ||
      (o_dtype != kF32 && o_dtype != kBF16) || (y == nullptr && o_dtype != kF32) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || kr < 1 || kc < 1 ||
      kc > kr || (long)(cluster - 1) * kr >= din || (long)cluster * kr < din ||
      (x_vec && (din % (16 / sx) || kr % (16 / sx) || kc % (16 / sx))) ||
      (a_vec && r % (16 / sw)) || cols < 1 || cols % 8 || (long)cols * cluster < dout ||
      (b_vec && dout % (16 / sw)) ||
      (rt != 1 && rt != kRows) || (route == kMma && rt != kRows) ||
      smem_bytes(route, rt, kc, rp, r, cluster, sx, sw, b_stage ? cols : 0) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (route == kMma &&
      (x_dtype != kBF16 || w_dtype != kBF16 || din % 16 || kr % 16 || kc % 16))
    return (int)cudaErrorInvalidValue;
  if (route != kMma && route != kSimt) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.scale = scale;
  p.ids = ids;
  p.y = y;
  p.out = out;
  p.S = S;
  p.din = din;
  p.dout = dout;
  p.r = r;
  p.slots = slots;
  p.layers = layers;
  p.layer = layer;
  p.cluster = cluster;
  p.kr = kr;
  p.kc = kc;
  p.rp = rp;
  p.cols = cols;
  p.b_stage = b_stage;
  p.x_vec = x_vec;
  p.a_vec = a_vec;
  p.b_vec = b_vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kMma)
    return (int)launch_out<kMma, kRows, __nv_bfloat16, __nv_bfloat16>(p, o_dtype, batch, st);
  if (x_dtype == kF32 && w_dtype == kF32)
    return (int)launch_simt<float, float>(p, rt, o_dtype, batch, st);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return (int)launch_simt<float, __nv_bfloat16>(p, rt, o_dtype, batch, st);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return (int)launch_simt<__nv_bfloat16, float>(p, rt, o_dtype, batch, st);
  return (int)launch_simt<__nv_bfloat16, __nv_bfloat16>(p, rt, o_dtype, batch, st);
}
