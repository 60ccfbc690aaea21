// Flash GQA attention for Hopper (sm_90a): online-softmax attention over a
// KV buffer whose slot j holds absolute position kv_start + j.
//
// Replaces the two Pallas TPU kernels of inferd_tpu/ops/attention.py:
// `_flash_kernel` (line 131, K/V resident in VMEM) and `_flash_kernel_stream`
// (line 218, K/V streamed through VMEM with the softmax state in scratch).
// That split exists only because of the TPU's VMEM budget. Here K/V always
// stream through a shared-memory ring, so the buffer length is unbounded.
//
// What it computes (the TPU kernel's function, not its block structure):
//   * GQA sharing: a CTA owns one (batch row, kv head) and a tile of packed
//     query rows r = i * G + g (position i, head g of the group), so each
//     K/V row is fetched once for the whole group.
//   * Per batch row (q_start, kv_start, kv_len, window), each a scalar or
//     an int64 [B] column read in place (e.g. the positions' first column). Masks: causal kpos <= qpos, validity
//     slot < kv_len, window (win <= 0) | (kpos > qpos - win).
//   * Scores in f32, times `scale`, then softcap, then the mask; masked
//     entries carry probability exactly 0 (the finite NEG_INF = -1e30 is the
//     running max's floor), so a row with no valid slot ends with l == 0 and
//     writes zeros.
//   * p is rounded to the query dtype before p @ v (attention.py:203-206);
//     the denominator sums the unrounded f32 p. Accumulation is f32.
//   * Sinks (one logit per query head) fold into the denominator once, after
//     every split has merged (_fold_sink, attention.py:109-123).
//   * Q/K/V in f32 or bf16, or K/V in fp8-e4m3 upcast exactly.
//
// Two kernels sit behind the one entry, chosen by the host's plan
// (ops/attention.flash_plan): a fixed rule on the packed rows G * S.
//
// 1. Split-KV route (decode, short multi-token steps, every f32 call):
//    flash-decoding on the CUDA cores. At decode a step reads the whole valid
//    KV span once and does ~2 flops per byte, so it is bound by device-memory
//    bytes (3.35 TB/s). B * Nkv CTAs (8 for Qwen3-0.6B) cannot pull that, so
//    the span is cut into `splits` ranges of whole 32-slot tiles, one CTA
//    each, grid (row tile, split, B * Nkv). A CTA holds its <= 16 rows'
//    accumulators in registers (templated on the row count; a warp takes
//    up to 4 rows and its share of each tile's slots), streams its tiles
//    through a 4-stage cp.async ring (16-byte chunks, three tiles in
//    flight), and scores each K row against every row of the group with an
//    8-wide per-lane FMA and a shuffle reduction over the row's lanes. Each
//    warp keeps its own online softmax; warps of the same rows merge
//    through shared memory and write (m, l, acc) in f32 to scratch, which
//    the combine kernel
//    merges (empty partials are m = NEG_INF, l = 0), folding sinks once.
//    With one split the CTA normalises and writes the output itself.
// 2. Tensor-core route (bf16 chunks with G * S > 16 rows: prefill):
//    flash-attention-2 with mma.sync m16n8k16 (bf16 in, f32 state). A CTA
//    owns 64 packed rows with 2 warpgroups of 4 warps; each warp keeps 16
//    rows of Q as A fragments (ldmatrix once), and the groups take alternate
//    kv tiles, merging their states at the end (a prefill chunk's CTAs are
//    few and walk short spans, so a CTA is bound by the latency of its tile
//    chain). K/V tiles of 64 slots are double-buffered per group in shared
//    memory by cp.async, rows padded by 16 bytes so ldmatrix (K) and
//    ldmatrix.trans (V) are free of bank conflicts. S = Q K^T, the masks, the
//    online softmax and O stay in registers; P is packed to bf16 in
//    registers (the reference's rounding of p) and reused as the A operand
//    of O += P V. fp8 K/V are converted to bf16 while staged. The kv loop
//    runs from the window floor of the CTA's lowest position to the causal
//    frontier of its highest. A very long span is cut into splits too, with
//    the same combine kernel. mma.sync rather than wgmma + TMA: at these
//    sizes the chunk is bound by latency and occupancy, not the tensor rate.
//
// Slots a CTA cannot attend (past T, past kv_len or the causal frontier of
// its rows, below the window floor) are zero-filled in shared memory
// (cp.async src-size 0), never read and never left stale: 0 * NaN is NaN
// inside an mma.
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
constexpr int kThreads = 128;  // 4 warps, both routes
constexpr int kWarps = kThreads / 32;
constexpr int kSplitTile = 32;  // kv slots per tile, split-KV route
constexpr int kStages = 4;      // its cp.async ring
constexpr int kMmaRows = 64;    // packed rows per CTA, tensor-core route
constexpr int kMmaTile = 64;    // kv slots per tile there

enum DType { kF32 = 0, kBF16 = 1, kFP8E4M3 = 2 };
enum Route { kSplit = 0, kMma = 1 };

struct Params {
  const void* q;       // [B, S, Nq, D]
  const void* k;       // [B, T, Nkv, D]
  const void* v;       // [B, T, Nkv, D]
  void* out;           // [B, S, Nq, D], query dtype
  // per batch row (q_start, kv_start, kv_len, window): field i is
  // span[i][b * span_stride[i]] (int64, e.g. a column of the positions), or
  // the scalar below where span[i] is null
  const long long* span[4];
  long long span_stride[4];
  const float* sinks;  // [Nq] f32 or null
  float* part_acc;     // [B*Nkv, row_tiles, splits, rows, D] when splits > 1
  float* part_ml;      // [B*Nkv, row_tiles, splits, rows, 2]
  int B, S, T, Nq, Nkv, G;
  int rows, row_tiles, tile_lo, splits, tps;  // the host's plan
  int q_start, kv_start, kv_len, window;      // the scalars
  float scale, softcap;
};

struct Span {
  int q_start, kv_start, kv_len, win;
};

__device__ __forceinline__ Span span_of(const Params& p, int b) {
  const int scalar[4] = {p.q_start, p.kv_start, p.kv_len, p.window};
  int f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = p.span[i] == nullptr ? scalar[i] : (int)p.span[i][b * p.span_stride[i]];
  return {f[0], f[1], f[2], f[3]};
}

// the slots [lo, hi) that a query at `qpos` may attend (empty when lo >= hi)
__device__ __forceinline__ void slot_bounds(const Span& m, int T, int qpos, int& lo, int& hi) {
  const long long h = min((long long)min(m.kv_len, T), (long long)qpos - m.kv_start + 1);
  const long long l = m.win > 0 ? (long long)qpos - m.win + 1 - m.kv_start : 0;
  hi = (int)max(h, 0LL);
  lo = (int)min(max(l, 0LL), (long long)hi);
}

// The CTA's rows [rt * rows, ...) attend slots [slot_lo, slot_hi): the window
// floor of its lowest position to the causal frontier of its highest. Its
// tiles are that range cut to split blockIdx.y of the plan: [t0, t1). Row
// tiles run fastest in the grid, so the CTAs that read the same K/V tiles
// run together and share them through L2.
__device__ __forceinline__ void cta_range(const Params& p, const Span& m, int tile, int& slot_lo,
                                          int& slot_hi, int& t0, int& t1) {
  const int r0 = blockIdx.x * p.rows;
  const int r1 = min(r0 + p.rows, p.S * p.G);
  int lo_a, hi_a, lo_b, hi_b;
  slot_bounds(m, p.T, m.q_start + r0 / p.G, lo_a, hi_a);
  slot_bounds(m, p.T, m.q_start + (r1 - 1) / p.G, lo_b, hi_b);
  slot_lo = lo_a;
  slot_hi = max(hi_b, lo_a);
  const int lo_t = slot_lo / tile;
  const int hi_t = slot_hi > slot_lo ? (slot_hi + tile - 1) / tile : lo_t;
  const int z0 = p.tile_lo + blockIdx.y * p.tps;
  t0 = max(lo_t, z0);
  t1 = max(t0, min(hi_t, z0 + p.tps));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
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

__device__ __forceinline__ float fp8_at(uint32_t w, int i) {
  __nv_fp8_e4m3 b;
  b.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xffu);
  return static_cast<float>(b);
}

// 8 consecutive elements of a K/V row in shared memory, as f32: lane `ln`
// of a row group reads elements [8 ln, 8 ln + 8)
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  __device__ static void load(const unsigned char* row, int ln, float* x) {
    const float4 a = reinterpret_cast<const float4*>(row)[2 * ln];
    const float4 b = reinterpret_cast<const float4*>(row)[2 * ln + 1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};
template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const unsigned char* row, int ln, float* x) {
    const uint4 u = reinterpret_cast<const uint4*>(row)[ln];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec8<__nv_fp8_e4m3> {
  __device__ static void load(const unsigned char* row, int ln, float* x) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[ln];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = fp8_at(i < 4 ? u.x : u.y, i % 4);
  }
};

// Sinks, normalisation and the store of one output element of row `rg`.
template <typename TQ>
__device__ __forceinline__ void finish(const Params& p, TQ* out, int b, int kvh, int rg, int d,
                                       int D, float m, float l, float a) {
  const int i = rg / p.G, g = rg - (rg / p.G) * p.G;
  const int h = kvh * p.G + g;
  if (p.sinks != nullptr) {
    const float sk = p.sinks[h];
    const float mf = fmaxf(m, sk);
    const float af = expf(m - mf);
    l = l * af + (sk > 0.5f * kNegInf ? expf(sk - mf) : 0.f);
    a *= af;
  }
  store_f(out, (((long)b * p.S + i) * p.Nq + h) * D + d, a / (l == 0.f ? 1.f : l));
}

// ---------------------------------------------------------------------------
// Split-KV route: one CTA per (split, row tile of RM rows, batch row x kv head)

// The 4 warps split a tile's work by rows and by slots: each warp holds RW =
// min(RM, 4) rows (so its registers stay few enough for the rows' chains to
// interleave) and reads the tile's slots of its slot group.
template <int RM>
struct SplitLayout {
  static constexpr int RW = RM < 4 ? RM : 4;  // rows per warp
  static constexpr int WR = RM / RW;          // row groups of warps
  static constexpr int WS = kWarps / WR;      // slot groups of warps
};

template <int D, int RM, typename TKV>
constexpr size_t split_smem_bytes() {
  constexpr int WS = SplitLayout<RM>::WS;
  constexpr size_t ring = (size_t)kStages * 2 * kSplitTile * D * sizeof(TKV);
  constexpr size_t merge = (size_t)WS * RM * D * 4 + 2 * (size_t)WS * RM * 4;
  return (size_t)RM * D * 4 + 2 * (size_t)RM * 4 + (ring > merge ? ring : merge);
}

template <int D, int RM, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) split_kernel(Params p) {
  using L = SplitLayout<RM>;
  constexpr int RW = L::RW, WS = L::WS;
  constexpr int LPR = D / 8;                // lanes per K/V row (8 elements each)
  constexpr int RPW = 32 / LPR;             // row groups per warp: slots read at once
  constexpr int WSLOTS = kSplitTile / WS;   // slots per warp per tile
  constexpr int NB0 = WSLOTS / RPW;
  constexpr int NB = NB0 < 4 ? NB0 : 4;     // slots per row group per pass
  constexpr int PASSES = WSLOTS / (RPW * NB);
  constexpr int ROW_BYTES = D * (int)sizeof(TKV);
  constexpr int TILE_BYTES = kSplitTile * ROW_BYTES;
  constexpr int CPR = ROW_BYTES / 16;  // 16-byte chunks per row
  static_assert(PASSES * RPW * NB == WSLOTS, "tile must divide among the warps");

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [RM][D], lane-permuted (see below)
  int* s_lo = reinterpret_cast<int*>(qs + RM * D);
  int* s_hi = s_lo + RM;
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_hi + RM);

  const TQ* q = static_cast<const TQ*>(p.q);
  const unsigned char* kb = static_cast<const unsigned char*>(p.k);
  const unsigned char* vb = static_cast<const unsigned char*>(p.v);
  TQ* out = static_cast<TQ*>(p.out);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sg = lane / LPR, ln = lane % LPR;
  const int ws = warp % WS, r0 = (warp / WS) * RW;  // slot group; first row
  const int grp = blockIdx.z, b = grp / p.Nkv, kvh = grp - (grp / p.Nkv) * p.Nkv;
  const int rt = blockIdx.x;
  const int nrows = p.S * p.G;
  const Span m = span_of(p, b);
  int slot_lo, slot_hi, t0, t1;
  cta_range(p, m, kSplitTile, slot_lo, slot_hi, t0, t1);
  const int nt = t1 - t0;

  auto load_tile = [&](int t, int stage) {
    unsigned char* kd = ring + stage * 2 * TILE_BYTES;
    unsigned char* vd = kd + TILE_BYTES;
    for (int c = tid; c < kSplitTile * CPR; c += kThreads) {
      const int j = c / CPR, cc = c - (c / CPR) * CPR;
      const int slot = t * kSplitTile + j;
      const bool ok = slot >= slot_lo && slot < slot_hi;
      const long off = ok ? (((long)b * p.T + slot) * p.Nkv + kvh) * ROW_BYTES + cc * 16 : 0;
      cp_async16(kd + j * ROW_BYTES + cc * 16, kb + off, ok);
      cp_async16(vd + j * ROW_BYTES + cc * 16, vb + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_tile(t0 + s, s);
    cp_async_commit();
  }

  // the rows' queries in f32, stored so that lane ln's elements [8 ln, 8 ln
  // + 4) and [8 ln + 4, 8 ln + 8) sit at [4 ln, ...) and [D/2 + 4 ln, ...):
  // each quarter-warp's 16-byte reads are then contiguous
  for (int idx = tid; idx < RM * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int rg = rt * RM + r;
    float x = 0.f;
    if (rg < nrows) {
      const int i = rg / p.G, g = rg - (rg / p.G) * p.G;
      x = load_f(q, (((long)b * p.S + i) * p.Nq + (long)kvh * p.G + g) * D + d);
    }
    qs[r * D + ((d % 8) / 4) * (D / 2) + (d / 8) * 4 + d % 4] = x;
  }
  if (tid < RM) {
    const int rg = rt * RM + tid;
    int lo = 0, hi = 0;
    if (rg < nrows) slot_bounds(m, p.T, m.q_start + rg / p.G, lo, hi);
    s_lo[tid] = lo;
    s_hi[tid] = hi;
  }

  float mrow[RW], lrow[RW], acc[RW][8];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    mrow[r] = kNegInf;
    lrow[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + kStages - 1 < nt) load_tile(t0 + it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* kt = ring + (it % kStages) * 2 * TILE_BYTES;
    const unsigned char* vt = kt + TILE_BYTES;
    const int tbase = (t0 + it) * kSplitTile;

#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      float sc[NB][RW], kx[NB][8], vx[NB][8];
      int slot[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int jl = ws * WSLOTS + (pass * NB + u) * RPW + sg;
        slot[u] = tbase + jl;
        Vec8<TKV>::load(kt + jl * ROW_BYTES, ln, kx[u]);
        Vec8<TKV>::load(vt + jl * ROW_BYTES, ln, vx[u]);
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qa = reinterpret_cast<const float4*>(qs + (r0 + r) * D)[ln];
        const float4 qb = reinterpret_cast<const float4*>(qs + (r0 + r) * D + D / 2)[ln];
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          float s = qa.x * kx[u][0];
          s = fmaf(qa.y, kx[u][1], s);
          s = fmaf(qa.z, kx[u][2], s);
          s = fmaf(qa.w, kx[u][3], s);
          s = fmaf(qb.x, kx[u][4], s);
          s = fmaf(qb.y, kx[u][5], s);
          s = fmaf(qb.z, kx[u][6], s);
          s = fmaf(qb.w, kx[u][7], s);
          sc[u][r] = s;
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < NB; ++u) {
#pragma unroll
          for (int r = 0; r < RW; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
        }
      }
      // one online-softmax rescale per pass, branch-free so that the rows'
      // chains interleave; the running max is warp-wide, so the row groups'
      // l and acc add up at the end without rescaling
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int lo = s_lo[r0 + r], hi = s_hi[r0 + r];
        float mt = kNegInf;
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          float s = sc[u][r] * p.scale;
          if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
          sc[u][r] = s;
          if (slot[u] >= lo && slot[u] < hi) mt = fmaxf(mt, s);
        }
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(mrow[r], mt);
        const float alpha = __expf(mrow[r] - mn);
        mrow[r] = mn;
        lrow[r] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const bool ok = slot[u] >= lo && slot[u] < hi;
          const float pj = ok ? __expf(sc[u][r] - mn) : 0.f;
          const float pr = round_as(pj, q);
          lrow[r] += pj;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vx[u][e], acc[r][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // row groups of a warp hold the same columns under one max: sum them
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], off);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
  }
  __syncthreads();  // the ring becomes the slot groups' merge area
  float* w_acc = reinterpret_cast<float*>(ring);  // [WS][RM][D]
  float* w_m = w_acc + WS * RM * D;               // [WS][RM]
  float* w_l = w_m + WS * RM;
  if (sg == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = ws * RM + r0 + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) w_acc[row * D + ln * 8 + e] = acc[r][e];
      if (ln == 0) {
        w_m[row] = mrow[r];
        w_l[row] = lrow[r];
      }
    }
  }
  __syncthreads();

  const long part = (((long)grp * p.row_tiles + rt) * p.splits + blockIdx.y) * RM;
  for (int idx = tid; idx < RM * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WS; ++w) mx = fmaxf(mx, w_m[w * RM + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WS; ++w) {
      const float f = __expf(w_m[w * RM + r] - mx);
      l += w_l[w * RM + r] * f;
      a += w_acc[(w * RM + r) * D + d] * f;
    }
    if (p.splits == 1) {
      if (rt * RM + r < nrows) finish(p, out, b, kvh, rt * RM + r, d, D, mx, l, a);
    } else {
      p.part_acc[(part + r) * D + d] = a;
      if (d == 0) {
        p.part_ml[(part + r) * 2] = mx;
        p.part_ml[(part + r) * 2 + 1] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: one CTA of 4 warps per (split, 64 packed rows, batch row
// x kv head); warp w owns rows [16 w, 16 w + 16)

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The CTA is 2 warpgroups of 4 warps. Both hold the same 64 rows (warp w
// of a group rows [16 w, 16 w + 16)); group g takes the kv tiles t0 + g,
// t0 + g + 2, ... through its own double buffer, so a CTA walks its span in
// half the steps with twice the loads in flight, and group 1's state merges
// into group 0's through shared memory at the end.
constexpr int kMmaGroups = 2;
constexpr int kMmaThreads = kMmaGroups * kThreads;

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaRows + kMmaGroups * 4 * kMmaTile) * (D + 8) * 2;
}

// named barrier of one warpgroup (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kThreads));
}

// one 8-element chunk of K/V row `slot` into a bf16 shared-memory row: bf16
// by cp.async, fp8 converted on the way
__device__ __forceinline__ void stage_kv(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void stage_kv(__nv_bfloat16* dst, const __nv_fp8_e4m3* src, bool ok) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    w.x = pack_bf16(fp8_at(u.x, 0), fp8_at(u.x, 1));
    w.y = pack_bf16(fp8_at(u.x, 2), fp8_at(u.x, 3));
    w.z = pack_bf16(fp8_at(u.y, 0), fp8_at(u.y, 1));
    w.w = pack_bf16(fp8_at(u.y, 2), fp8_at(u.y, 3));
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

template <int D, typename TKV>
__global__ void __launch_bounds__(kMmaThreads) mma_kernel(Params p) {
  constexpr int DP = D + 8;        // padded row: ldmatrix rows land on distinct banks
  constexpr int KSTEPS = D / 16;   // q.k depth steps
  constexpr int NT = kMmaTile / 8; // slot n-tiles of S
  constexpr int DT = D / 8;        // column n-tiles of O
  constexpr int CPR = D / 8;       // 8-element chunks per row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][DP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp_w = warp / 4, wr = warp % 4, gtid = tid % kThreads;  // warpgroup, row slice
  // this group's [2][64][DP] K and [2][64][DP] V
  __nv_bfloat16* ks = qs + kMmaRows * DP + grp_w * 4 * kMmaTile * DP;
  __nv_bfloat16* vs = ks + 2 * kMmaTile * DP;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const TKV* k = static_cast<const TKV*>(p.k);
  const TKV* v = static_cast<const TKV*>(p.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  const int grp = blockIdx.z, b = grp / p.Nkv, kvh = grp - (grp / p.Nkv) * p.Nkv;
  const int rt = blockIdx.x;
  const int nrows = p.S * p.G;
  const Span m = span_of(p, b);
  int slot_lo, slot_hi, t0, t1;
  cta_range(p, m, kMmaTile, slot_lo, slot_hi, t0, t1);
  const int nt = t1 > t0 + grp_w ? (t1 - t0 - grp_w + 1) / kMmaGroups : 0;  // this group's tiles

  auto load_tile = [&](int i, int buf) {  // the group's i-th tile
    const int t = t0 + grp_w + kMmaGroups * i;
    __nv_bfloat16* kd = ks + buf * kMmaTile * DP;
    __nv_bfloat16* vd = vs + buf * kMmaTile * DP;
    for (int c = gtid; c < kMmaTile * CPR; c += kThreads) {
      const int j = c / CPR, cc = c - (c / CPR) * CPR;
      const int slot = t * kMmaTile + j;
      const bool ok = slot >= slot_lo && slot < slot_hi;
      const long off = ok ? (((long)b * p.T + slot) * p.Nkv + kvh) * D + cc * 8 : 0;
      stage_kv(kd + j * DP + cc * 8, k + off, ok);
      stage_kv(vd + j * DP + cc * 8, v + off, ok);
    }
  };

  // Q rows (zero past S * G) and each group's first tile, one group of copies
  for (int c = tid; c < kMmaRows * CPR; c += kMmaThreads) {
    const int r = c / CPR, cc = c - (c / CPR) * CPR;
    const int rg = rt * kMmaRows + r;
    const bool ok = rg < nrows;
    long off = 0;
    if (ok) {
      const int i = rg / p.G, g = rg - (rg / p.G) * p.G;
      off = (((long)b * p.S + i) * p.Nq + (long)kvh * p.G + g) * D + cc * 8;
    }
    cp_async16(qs + r * DP + cc * 8, q + off, ok);
  }
  if (nt > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's two rows of the m16n8 accumulators: lane/4 and lane/4 + 8
  int lo[2], hi[2], rg2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rg2[h] = rt * kMmaRows + wr * 16 + lane / 4 + 8 * h;
    lo[h] = hi[h] = 0;
    if (rg2[h] < nrows) slot_bounds(m, p.T, m.q_start + rg2[h] / p.G, lo[h], hi[h]);
  }
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], qs + (wr * 16 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);

  for (int it = 0; it < nt; ++it) {
    if (it > 0) {
      cp_async_wait<0>();
      group_sync(grp_w);  // tile `it` landed; the group is done with tile it - 1
    }
    if (it + 1 < nt) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (it & 1) * kMmaTile * DP;
    const __nv_bfloat16* vt = vs + (it & 1) * kMmaTile * DP;

    // S = Q K^T over the tile's 64 slots
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * DP + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, softcap, masks; element (j, c) is row lane/4 + 8 (c / 2), slot
    // tbase + 8 j + 2 (lane % 4) + c % 2
    const int sbase = (t0 + grp_w + kMmaGroups * it) * kMmaTile + 2 * (lane & 3);
    uint32_t okbits = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const int slot = sbase + 8 * j + (c & 1);
        float x = s[j][c] * p.scale;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[j][c] = x;
        if (slot >= lo[h] && slot < hi[h]) {
          okbits |= 1u << (4 * j + c);
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(mrow[h], mx[h]);
      const float alpha = __expf(mrow[h] - mn);
      mrow[h] = mn;
      lrow[h] *= alpha;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pj = (okbits >> (4 * j + c)) & 1u ? __expf(s[j][c] - mrow[c >> 1]) : 0.f;
        lrow[c >> 1] += pj;
        s[j][c] = pj;
      }
    }

    // O += P V: P packed to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }

  // group 1 hands its state to the thread of group 0 that holds the same
  // (row, column) elements, through its own (now idle) K/V buffers
  float* xfer = reinterpret_cast<float*>(qs + kMmaRows * DP + 4 * kMmaTile * DP);
  const int slot_of = wr * 32 + lane;  // this thread's record, (DT * 4 + 4) floats
  constexpr int REC = DT * 4 + 4;
  if (grp_w == 1) {
    group_sync(1);  // every group-1 warp is done reading its buffers
    float* rec = xfer + slot_of * REC;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float4*>(rec + 4 * n) = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    *reinterpret_cast<float4*>(rec + 4 * DT) = make_float4(mrow[0], mrow[1], lrow[0], lrow[1]);
  }
  __syncthreads();
  if (grp_w == 1) return;
  {
    const float* rec = xfer + slot_of * REC;
    const float4 ml = *reinterpret_cast<const float4*>(rec + 4 * DT);
    const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
    float f0[2], f1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mrow[h], m1[h]);
      f0[h] = __expf(mrow[h] - mn);
      f1[h] = __expf(m1[h] - mn);
      mrow[h] = mn;
      lrow[h] = lrow[h] * f0[h] + l1[h] * f1[h];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(rec + 4 * n);
      o[n][0] = o[n][0] * f0[0] + x.x * f1[0];
      o[n][1] = o[n][1] * f0[0] + x.y * f1[0];
      o[n][2] = o[n][2] * f0[1] + x.z * f1[1];
      o[n][3] = o[n][3] * f0[1] + x.w * f1[1];
    }
  }

  const int col = 2 * (lane & 3);
  if (p.splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rg2[h] >= nrows) continue;
      const int i = rg2[h] / p.G, g = rg2[h] - (rg2[h] / p.G) * p.G;
      const int head = kvh * p.G + g;
      float l = lrow[h], af = 1.f;
      if (p.sinks != nullptr) {
        const float sk = p.sinks[head];
        const float mf = fmaxf(mrow[h], sk);
        af = expf(mrow[h] - mf);
        l = l * af + (sk > 0.5f * kNegInf ? expf(sk - mf) : 0.f);
      }
      const float f = af / (l == 0.f ? 1.f : l);
      __nv_bfloat16* dst = out + (((long)b * p.S + i) * p.Nq + head) * D + col;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * h] * f, o[n][2 * h + 1] * f);
    }
  } else {
    const long part = (((long)grp * p.row_tiles + rt) * p.splits + blockIdx.y) * kMmaRows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = part + wr * 16 + lane / 4 + 8 * h;
      float* dst = p.part_acc + row * D + col;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if ((lane & 3) == 0) {
        p.part_ml[row * 2] = mrow[h];
        p.part_ml[row * 2 + 1] = lrow[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Combine: merges the `splits` partials of each row; empty partials (m =
// NEG_INF, l = 0) weigh nothing. A CTA takes RPC rows of one (row tile,
// batch row x kv head), a thread 4 columns of one row, so the partials'
// reads are 16-byte, coalesced and all in flight together.

template <int D, typename TQ>
__global__ void __launch_bounds__(kThreads) combine_kernel(Params p) {
  constexpr int C4 = D / 4;           // float4 columns per row
  constexpr int RPC = kThreads / C4;  // rows per CTA
  extern __shared__ float cw[];       // [splits][RPC] max then weights; [splits][RPC] l
  __shared__ float mmax[RPC], lsum[RPC];
  TQ* out = static_cast<TQ*>(p.out);
  const int R = p.rows, nrows = p.S * p.G, Z = p.splits;
  const int chunks = (R + RPC - 1) / RPC;
  const int rt = blockIdx.x / chunks, rc = blockIdx.x - (blockIdx.x / chunks) * chunks;
  const int grp = blockIdx.y;
  const int b = grp / p.Nkv, kvh = grp - (grp / p.Nkv) * p.Nkv;
  const long base = ((long)grp * p.row_tiles + rt) * Z * R;  // partial row (z, r): base + z R + r
  float* w = cw;
  float* ls = cw + Z * RPC;
  for (int i = threadIdx.x; i < Z * RPC; i += kThreads) {
    const int z = i / RPC, r = rc * RPC + i % RPC;
    float2 ml = make_float2(kNegInf, 0.f);
    if (r < R) ml = *reinterpret_cast<const float2*>(p.part_ml + (base + (long)z * R + r) * 2);
    w[i] = ml.x;
    ls[i] = ml.y;
  }
  __syncthreads();
  if (threadIdx.x < RPC) {
    float mx = kNegInf;
    for (int z = 0; z < Z; ++z) mx = fmaxf(mx, w[z * RPC + threadIdx.x]);
    float l = 0.f;
    for (int z = 0; z < Z; ++z) l += ls[z * RPC + threadIdx.x] * expf(w[z * RPC + threadIdx.x] - mx);
    mmax[threadIdx.x] = mx;
    lsum[threadIdx.x] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Z * RPC; i += kThreads) w[i] = expf(w[i] - mmax[i % RPC]);
  __syncthreads();
  const int rl = threadIdx.x / C4, c4 = threadIdx.x - (threadIdx.x / C4) * C4;
  const int r = rc * RPC + rl, rg = rt * R + r;
  if (r >= R || rg >= nrows) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int z = 0; z < Z; ++z) {
    const float4 x = reinterpret_cast<const float4*>(p.part_acc + (base + (long)z * R + r) * D)[c4];
    const float f = w[z * RPC + rl];
    a.x = fmaf(x.x, f, a.x);
    a.y = fmaf(x.y, f, a.y);
    a.z = fmaf(x.z, f, a.z);
    a.w = fmaf(x.w, f, a.w);
  }
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) finish(p, out, b, kvh, rg, 4 * c4 + e, D, mmax[rl], lsum[rl], av[e]);
}

// ---------------------------------------------------------------------------
// launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, typename TQ>
cudaError_t launch_combine(const Params& p, cudaStream_t stream) {
  if (p.splits == 1) return cudaSuccess;
  constexpr int rpc = kThreads / (D / 4);
  const int chunks = (p.rows + rpc - 1) / rpc;
  const size_t smem = 2 * (size_t)p.splits * rpc * sizeof(float);
  combine_kernel<D, TQ><<<dim3(p.row_tiles * chunks, p.B * p.Nkv), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int RM, typename TQ, typename TKV>
cudaError_t launch_split_rows(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D, RM, TKV>();
  cudaError_t err = allow_smem(split_kernel<D, RM, TQ, TKV>, smem);
  if (err != cudaSuccess) return err;
  split_kernel<D, RM, TQ, TKV>
      <<<dim3(p.row_tiles, p.splits, p.B * p.Nkv), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<D, TQ>(p, stream);
}

template <int D, typename TQ, typename TKV>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  switch (p.rows) {
    case 2: return launch_split_rows<D, 2, TQ, TKV>(p, stream);
    case 4: return launch_split_rows<D, 4, TQ, TKV>(p, stream);
    case 8: return launch_split_rows<D, 8, TQ, TKV>(p, stream);
    case 16: return launch_split_rows<D, 16, TQ, TKV>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, typename TKV>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  if (p.rows != kMmaRows) return cudaErrorInvalidValue;
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(mma_kernel<D, TKV>, smem);
  if (err != cudaSuccess) return err;
  mma_kernel<D, TKV><<<dim3(p.row_tiles, p.splits, p.B * p.Nkv), kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<D, __nv_bfloat16>(p, stream);
}

template <int D>
cudaError_t launch_route(const Params& p, int route, int q_dtype, int kv_dtype,
                         cudaStream_t stream) {
  if (route == kMma) {
    if (q_dtype != kBF16) return cudaErrorInvalidValue;  // no TF32: f32 takes the split route
    if (kv_dtype == kBF16) return launch_mma<D, __nv_bfloat16>(p, stream);
    if (kv_dtype == kFP8E4M3) return launch_mma<D, __nv_fp8_e4m3>(p, stream);
    return cudaErrorInvalidValue;
  }
  if (route != kSplit) return cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_split<D, float, float>(p, stream);
  if (q_dtype == kF32 && kv_dtype == kFP8E4M3)
    return launch_split<D, float, __nv_fp8_e4m3>(p, stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_split<D, __nv_bfloat16, __nv_bfloat16>(p, stream);
  if (q_dtype == kBF16 && kv_dtype == kFP8E4M3)
    return launch_split<D, __nv_bfloat16, __nv_fp8_e4m3>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The wrapper (ops/attention.py) validates shapes, dtypes, alignment and grid
// limits and plans the launch (route, row tile, splits); this launches the
// route's kernel and, with splits > 1, the combine kernel, and returns
// cudaGetLastError() after them (0 on success).
extern "C" int flash_gqa_launch(const void* q, const void* k, const void* v, void* out,
                                const long long* q_start_rows, const long long* kv_start_rows,
                                const long long* kv_len_rows, const long long* window_rows,
                                const float* sinks, float* part_acc, float* part_ml, int B, int S,
                                int T, int Nq, int Nkv, int D, int q_start, int kv_start,
                                int kv_len, int window, long long q_start_stride,
                                long long kv_start_stride, long long kv_len_stride,
                                long long window_stride, float scale, float softcap, int q_dtype,
                                int kv_dtype, int route, int rows, int row_tiles, int tile_lo,
                                int splits, int tiles_per_split, void* stream) {
  if (Nkv <= 0 || Nq % Nkv != 0 || splits < 1 || row_tiles < 1 || tiles_per_split < 0 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.span[0] = q_start_rows;
  p.span[1] = kv_start_rows;
  p.span[2] = kv_len_rows;
  p.span[3] = window_rows;
  p.span_stride[0] = q_start_stride;
  p.span_stride[1] = kv_start_stride;
  p.span_stride[2] = kv_len_stride;
  p.span_stride[3] = window_stride;
  p.sinks = sinks;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.G = Nq / Nkv;
  p.rows = rows;
  p.row_tiles = row_tiles;
  p.tile_lo = tile_lo;
  p.splits = splits;
  p.tps = tiles_per_split;
  p.q_start = q_start;
  p.kv_start = kv_start;
  p.kv_len = kv_len;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_route<64>(p, route, q_dtype, kv_dtype, st);
  if (D == 128) return (int)launch_route<128>(p, route, q_dtype, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}
