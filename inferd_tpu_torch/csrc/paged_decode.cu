// Paged decode attention for Hopper (sm_90a): one query per lane (S = 1)
// attending over that lane's chain of KV blocks in a paged pool.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` of
// inferd_tpu/ops/attention.py (line 460; entry `paged_decode_gqa`, line 553).
// On the TPU the chain was the innermost, sequential grid axis, each block
// DMA'd from its pool slot through the scalar-prefetched table, with the
// online-softmax state carried in VMEM scratch from one grid step to the next.
// Blocks of a CUDA grid run in parallel and carry nothing, so here CTAs walk
// ranges of the chain themselves and a combine kernel merges their states.
//
// What it computes (the TPU kernel's function):
//   * pools k/v [NB, bs, Nkv, D]; table [B, MB] int32 (MB = the stamped
//     table width, a runtime argument: chain_clamp changes it step to step);
//     chain slot j of lane b covers absolute positions [j*bs, (j+1)*bs), so
//     slot index == absolute position. The row read is pool[tbl[b, j], i, h].
//   * per lane (qpos, kv_len, window), each a host int or a column read in
//     place (int32 or int64, any stride: no copy kernel). Only chain
//     blocks in [lo, hi) are read, hi = clamp(ceil(min(kv_len, qpos+1) / bs),
//     0, MB), lo = clamp((win > 0 ? qpos-win+1 : 0) / bs, 0, MB), so the
//     scratch block 0 (unallocated table entries) is never scored.
//   * masks: slot < kv_len, slot <= qpos, win <= 0 | slot > qpos - win;
//     masked slots are not even loaded and carry probability 0, so a lane
//     with nothing to attend (kv_len 0) writes zeros.
//   * scores in f32, times `scale`, then softcap; p rounded to the query
//     dtype before p*v (the Pallas kernel's p.astype(v.dtype)), f32 sums.
//   * sinks (one logit per query head) fold in at the end (_fold_sink);
//     out = acc / (l == 0 ? 1 : l), in the query dtype.
//   * q in f32 or bf16; pools in the query dtype or fp8-e4m3, upcast in
//     registers (exact: every e4m3 value is a bf16 and an f32 value).
//
// What bounds it on the H100, and what this design does about it: a decode
// step reads each attended K/V row once and does ~4*G flops per K/V element
// pair, far below the 295 flops per byte where the tensor cores would limit,
// so it is bound by device-memory bytes at 3.35 TB/s, and at the main path's
// sizes (a few MB) by how many loads are in flight across the SMs. The first
// version gave one CTA a lane's whole chain: 64 CTAs on 132 SMs at 8 lanes,
// 8 for a single long session, and the longest chain set the time. Here:
//   * the host (ops/attention.paged_plan, from B, Nkv and MB alone) cuts the
//     chain [0, MB) into `splits` uniform ranges of `bps` blocks, each at
//     least 256 slots, so that B * Nkv * splits lands near 4 waves of one
//     CTA per SM (the kernel holds ~180 registers a thread). Grid (splits,
//     Nkv, B): a CTA walks its range intersected with its lane's [lo, hi);
//     a range outside the span writes an empty partial (m = -inf, l = 0)
//     and reads nothing. With one split the CTA finishes the output itself;
//   * the spans are read in place (host ints or columns, no copy kernels),
//     and the range's table entries are loaded into shared memory in the
//     same round trip as the spans, so a warp's first K/V loads wait on one
//     dependent load, not two;
//   * a CTA holds the G = Nq/Nkv query rows of its kv head in registers, so
//     each K/V row is read once for the whole group;
//   * the range's (block, step) units are dealt round-robin to 8 warps, a
//     step being four slots per row group, so a short range still feeds
//     every warp; each warp keeps its own online-softmax state, the warps
//     merge through shared memory in warp order;
//   * a warp reads K/V rows with 16-byte vector loads (8 bf16 per lane, so a
//     256-byte bf16 row of D = 128 takes 16 lanes: two rows per warp
//     instruction; f32 rows take 4 floats per lane, fp8 rows 8 bytes), the
//     scores of a step's slots are computed together, the running max is
//     rescaled once per step, and the next step's loads are already in
//     flight while this one is scored;
//   * with splits > 1 each CTA writes (m, l, acc[G, D]) in f32 to scratch and
//     combine_kernel merges each (lane, kv head)'s partials in split order:
//     empty partials weigh 0 and are not read, the sinks fold once, l == 0
//     normalises by 1. No atomics, so two calls give the same bits. The
//     combine is a programmatic dependent launch: its launch overlaps the
//     split kernel's tail, and griddepcontrol.wait orders its reads.
// Not done here, left for later work: splits balanced per lane (the ranges
// are uniform over MB, so a short lane's CTAs past its chain idle), TMA block
// copies and wgmma.
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (paged_decode_launch), called through ctypes by
// inferd_tpu_torch/ops/attention.py (paged_decode_gqa).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;   // warps per CTA; chain blocks are dealt round-robin
constexpr int kMaxG = 8;    // query heads per kv head held in registers (GM <= kMaxG)
constexpr int kUnroll = 4;  // slots a row group loads before scoring them
constexpr int kCombineThreads = 256;
constexpr int kMaxSplits = 64;  // MAX_SPLITS in ops/attention.py
constexpr int kTableSmem = 256;  // table entries of a CTA's range staged in shared memory

enum DType { kF32 = 0, kBF16 = 1, kFP8E4M3 = 2 };

struct Params {
  const void* q;       // [B, 1, Nq, D]
  const void* k_pool;  // [NB, bs, Nkv, D]
  const void* v_pool;
  const int* table;    // [B, MB]
  // (qpos, kv_len, window) per lane: column i (int32 or int64 by span_wide,
  // element stride span_stride) or, when null, the host int span_scalar
  const void* span[3];
  long long span_scalar[3], span_stride[3];
  int span_wide[3];
  const float* sinks;  // [Nq] or null
  void* out;           // [B, 1, Nq, D], query dtype
  float* part_acc;     // [B, Nkv, splits, G, D] f32 partials (splits > 1)
  float* part_ml;      // [B, Nkv, splits, G, 2]: (m, l) of each partial
  int B, Nq, Nkv, G, bs, MB, splits, bps;
  float scale, softcap;
};

// VEC elements of one K/V row per lane, loaded raw (16 bytes of f32 or
// bf16, 8 bytes of fp8) and unpacked to f32 when scored
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void unpack(const Raw& u, float* x) {
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void unpack(const Raw& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 f = __bfloat1622float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 8;
  using Raw = uint2;
  __device__ static Raw load(const __nv_fp8_e4m3* p) { return *reinterpret_cast<const uint2*>(p); }
  __device__ static void unpack(const Raw& u, float* x) {
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_fp8_e4m3 b;
      b.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
      x[i] = static_cast<float>(b);
    }
  }
};

__device__ __forceinline__ float load_q(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_q(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// p.astype(query dtype): round-to-nearest-even, as XLA's convert does
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_out(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

// lane b's value of span i (0 qpos, 1 kv_len, 2 window)
__device__ __forceinline__ int span_of(const Params& p, int i, int b) {
  if (p.span[i] == nullptr) return (int)p.span_scalar[i];
  const long long at = (long long)b * p.span_stride[i];
  return p.span_wide[i] ? (int)static_cast<const long long*>(p.span[i])[at]
                        : static_cast<const int*>(p.span[i])[at];
}

// fold the sinks into (mx, lsum, a), normalise and store one output value
template <typename TQ>
__device__ __forceinline__ void finish(const Params& p, TQ* out, int b, int head, int d, int D,
                                       float mx, float lsum, float a) {
  if (p.sinks != nullptr) {
    const float sk = p.sinks[head];
    const float mf = fmaxf(mx, sk);
    const float af = expf(mx - mf);
    lsum = lsum * af + (sk > 0.5f * kNegInf ? expf(sk - mf) : 0.f);
    a *= af;
  }
  store_out(out, ((long)b * p.Nq + head) * D + d, a / (lsum == 0.f ? 1.f : lsum));
}

// grid (splits, Nkv, B); blockDim.x = 32 * kWarps. A row group of LPR = D / VEC
// lanes holds one K/V row; a warp holds RPW = 32 / LPR row groups.
// GM: the number of query rows the registers are sized for (G <= GM).
template <int D, int GM, typename TQ, typename TKV>
__global__ void __launch_bounds__(32 * kWarps) paged_decode_kernel(Params p) {
  constexpr int VEC = Vec<TKV>::N;
  constexpr int LPR = D / VEC;
  constexpr int RPW = 32 / LPR;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row must fit a warp");

  extern __shared__ float smem[];  // [kWarps][G][D] acc, then [kWarps][G] m and l
  float* s_acc = smem;
  float* s_m = s_acc + kWarps * p.G * D;
  float* s_l = s_m + kWarps * p.G;

  const TQ* q = static_cast<const TQ*>(p.q);
  const TKV* kp = static_cast<const TKV*>(p.k_pool);
  const TKV* vp = static_cast<const TKV*>(p.v_pool);
  TQ* out = static_cast<TQ*>(p.out);

  const int z = blockIdx.x;  // chain range
  const int h = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // lane
  const int G = p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / LPR;         // row group within the warp
  const int d0 = (lane % LPR) * VEC; // this lane's first column

  // the dependent combine may start launching now (it waits for this grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // this range's table entries into shared memory, in flight with the spans
  __shared__ int s_tbl[kTableSmem];
  const int t0 = z * p.bps, tn = max(0, min(p.bps, p.MB - t0));
  const bool tbl_smem = tn <= kTableSmem;
  if (tbl_smem)
    for (int i = threadIdx.x; i < tn; i += blockDim.x) s_tbl[i] = p.table[(long)b * p.MB + t0 + i];
  const int qpos = span_of(p, 0, b);
  const int kv_len = span_of(p, 1, b);
  const int win = span_of(p, 2, b);
  const int last = min(kv_len, qpos + 1);
  const int hi = last <= 0 ? 0 : min((last + p.bs - 1) / p.bs, p.MB);
  int lo = 0;
  if (win > 0) {
    const int lo_slot = qpos - win + 1;
    lo = lo_slot > 0 ? min(lo_slot / p.bs, p.MB) : 0;
  }
  // this CTA's range of the chain, within the lane's span
  const int blo = max(lo, z * p.bps), bhi = min(hi, (z + 1) * p.bps);
  const long part = (((long)b * p.Nkv + h) * p.splits + z) * G;  // its first partial row
  if (p.splits > 1 && blo >= bhi) {  // an empty partial: nothing read, acc not written
    if (threadIdx.x < G) {
      p.part_ml[(part + threadIdx.x) * 2] = kNegInf;
      p.part_ml[(part + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }

  // the group's query rows, this lane's VEC columns, in f32
  float qr[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = g < G ? load_q(q, ((long)b * p.Nq + (long)h * G + g) * D + d0 + e) : 0.f;
  }

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // The range's units, flattened: unit u covers chain block blo + u /
  // per_blk and, in it, kUnroll slots per row group from (u % per_blk) *
  // kStepSlots. Warp w takes units w, w + kWarps, ...: its step t is unit
  // w + t * kWarps. The loads of step t + 1 are issued before step t is scored.
  using Raw = typename Vec<TKV>::Raw;
  constexpr int kStepSlots = RPW * kUnroll;
  const int per_blk = (p.bs + kStepSlots - 1) / kStepSlots;
  const int units = max(bhi - blo, 0) * per_blk;
  const int steps = units > warp ? (units - warp + kWarps - 1) / kWarps : 0;
  const long row_stride = (long)p.Nkv * D;  // between slots of a block

  Raw kr[kUnroll], vr[kUnroll];
  bool ok[kUnroll];
  auto fetch = [&](int t, Raw* kd, Raw* vd, bool* okd) {
    const int u = warp + t * kWarps;
    const int j = blo + u / per_blk;
    const int i0 = (u % per_blk) * kStepSlots;
    const long blk = tbl_smem ? s_tbl[j - t0] : p.table[(long)b * p.MB + j];
    const long base = (blk * p.bs * p.Nkv + h) * (long)D + d0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * RPW + rg;
      const int slot = j * p.bs + i;  // == absolute position
      okd[u] = i < p.bs && slot < kv_len && slot <= qpos && (win <= 0 || slot > qpos - win);
      if (okd[u]) {  // masked slots are never loaded
        kd[u] = Vec<TKV>::load(kp + base + i * row_stride);
        vd[u] = Vec<TKV>::load(vp + base + i * row_stride);
      }
    }
  };
  __syncthreads();  // s_tbl is filled
  if (steps > 0) fetch(0, kr, vr, ok);

  for (int t = 0; t < steps; ++t) {
    Raw kn[kUnroll], vn[kUnroll];
    bool okn[kUnroll] = {};
    if (t + 1 < steps) fetch(t + 1, kn, vn, okn);

    // scores of the step's slots, all independent (every lane of a row
    // group takes part in the shuffles; a masked slot is dropped after)
    float sc[kUnroll][GM];
    float vx[kUnroll][VEC];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[VEC];
      if (ok[u]) {
        Vec<TKV>::unpack(kr[u], kx);
        Vec<TKV>::unpack(vr[u], vx[u]);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float s = 0.f;
        if (ok[u] && g < G) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(qr[g][e], kx[e], s);
        }
        sc[u][g] = s;
      }
      any |= ok[u];
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < GM; ++g) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
      }
    }

    // one online-softmax rescale per step: the running max takes the
    // step's max, then each slot's p (rounded to the query dtype) joins
    if (any) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float mt = kNegInf;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float s = sc[u][g] * p.scale;
          if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
          sc[u][g] = s;
          if (ok[u]) mt = fmaxf(mt, s);
        }
        const float m_new = fmaxf(m[g], mt);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;
          const float pj = expf(sc[u][g] - m_new);
          const float pr = round_as(pj, q);
          l[g] += pj;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vx[u][e], acc[g][e]);
        }
        m[g] = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
      ok[u] = okn[u];
    }
  }

  // combine the warp's row groups (lanes LPR apart hold the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), ao = expf(mo - mn);
      l[g] = l[g] * a + lo_ * ao;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float x = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + x * ao;
      }
      m[g] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_acc[(warp * G + g) * D + d0 + e] = acc[g][e];
      if (lane == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // combine the warps in warp order; with one split fold the sinks,
  // normalise and store, else write this range's partial
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w * G + g] - mx);
      lsum += s_l[w * G + g] * f;
      a += s_acc[(w * G + g) * D + d] * f;
    }
    if (p.splits > 1) {
      p.part_acc[(part + g) * D + d] = a;
      if (d == 0) {
        p.part_ml[(part + g) * 2] = mx;
        p.part_ml[(part + g) * 2 + 1] = lsum;
      }
      continue;
    }
    finish(p, out, b, h * G + g, d, D, mx, lsum, a);
  }
}

// Combine: merges the `splits` partials of each (lane, kv head), in split
// order. An empty partial (l == 0: nothing of its range attended) weighs 0
// and its acc, never written, is not read. grid (Nkv, B); a thread takes 4
// columns of one query row, so the partials' reads are 16-byte and coalesced.
template <int D, typename TQ>
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(Params p) {
  extern __shared__ float cw[];  // [splits][G] weights, then [splits][G] l
  __shared__ float mmax[kMaxG], lsum[kMaxG];
  const int h = blockIdx.x, b = blockIdx.y, G = p.G, Z = p.splits;
  // launched as a programmatic dependent of the split kernel: every
  // partial is written, and visible, once this returns
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long base = ((long)b * p.Nkv + h) * Z * G;  // partial row (z, g): base + z G + g
  float* w = cw;
  float* ls = cw + Z * G;
  for (int i = threadIdx.x; i < Z * G; i += blockDim.x) {
    const float2 ml = *reinterpret_cast<const float2*>(p.part_ml + (base + i) * 2);
    w[i] = ml.y > 0.f ? ml.x : kNegInf;
    ls[i] = ml.y;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int zz = 0; zz < Z; ++zz) mx = fmaxf(mx, w[zz * G + g]);
    float l = 0.f;
    for (int zz = 0; zz < Z; ++zz)
      if (ls[zz * G + g] > 0.f) l += ls[zz * G + g] * expf(w[zz * G + g] - mx);
    mmax[g] = mx;
    lsum[g] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Z * G; i += blockDim.x)
    w[i] = ls[i] > 0.f ? expf(w[i] - mmax[i % G]) : 0.f;
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out);
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < G * C4; idx += blockDim.x) {
    const int g = idx / C4, c4 = idx - (idx / C4) * C4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int zz = 0; zz < Z; ++zz) {
      const float f = w[zz * G + g];
      if (f == 0.f) continue;  // empty, or too small to count
      const float4 x = reinterpret_cast<const float4*>(p.part_acc + (base + (long)zz * G + g) * D)[c4];
      a.x = fmaf(x.x, f, a.x);
      a.y = fmaf(x.y, f, a.y);
      a.z = fmaf(x.z, f, a.z);
      a.w = fmaf(x.w, f, a.w);
    }
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) finish(p, out, b, h * G + g, 4 * c4 + e, D, mmax[g], lsum[g], av[e]);
  }
}

template <int D, typename TQ, typename TKV>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const size_t smem = ((size_t)kWarps * p.G * D + 2 * (size_t)kWarps * p.G) * sizeof(float);
  dim3 grid(p.splits, p.Nkv, p.B);
  if (p.G <= 2)
    paged_decode_kernel<D, 2, TQ, TKV><<<grid, 32 * kWarps, smem, stream>>>(p);
  else
    paged_decode_kernel<D, kMaxG, TQ, TKV><<<grid, 32 * kWarps, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  // programmatic dependent launch: the combine's launch overlaps the split
  // kernel's tail; griddepcontrol.wait in the combine orders the partials
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.Nkv, p.B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 2 * (size_t)p.splits * p.G * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<D, TQ>, p);
  if (err != cudaSuccess) return err;
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

// The wrapper (ops/attention.py) validates devices, dtypes, shapes,
// alignment and the grid limits, and passes paged_plan's cut of the chain
// (splits ranges of bps blocks; part_acc / part_ml scratch when splits > 1);
// this returns cudaGetLastError() after the launches (0 on success).
// The spans: span_cols[i] a column of B values (int32, or int64 when
// span_wide[i]; element stride span_strides[i]) or null for span_scalars[i].
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const int* table, const void* const* span_cols,
                                   const long long* span_scalars, const long long* span_strides,
                                   const int* span_wide, const float* sinks, void* out,
                                   float* part_acc, float* part_ml, int B, int Nq, int Nkv, int D,
                                   int bs, int MB, int splits, int bps, float scale,
                                   float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (Nkv <= 0 || Nq % Nkv != 0 || Nq / Nkv > kMaxG || B <= 0 || B > 65535 || MB < 0 ||
      bs < 1 || splits < 1 || splits > kMaxSplits || bps < 1 || (long)splits * bps < MB ||
      (splits > 1 && ((long)(splits - 1) * bps >= MB || part_acc == nullptr ||
                      part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.table = table;
  for (int i = 0; i < 3; ++i) {
    p.span[i] = span_cols[i];
    p.span_scalar[i] = span_scalars[i];
    p.span_stride[i] = span_strides[i];
    p.span_wide[i] = span_wide[i];
  }
  p.sinks = sinks;
  p.out = out;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.B = B;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.G = Nq / Nkv;
  p.bs = bs;
  p.MB = MB;
  p.splits = splits;
  p.bps = bps;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dtypes<64>(p, q_dtype, kv_dtype, st);
  if (D == 128) return (int)launch_dtypes<128>(p, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
