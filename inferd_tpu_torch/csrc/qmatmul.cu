// Decode GEMVs against quantized weights for Hopper (sm_90a): a few rows of
// activations (M <= 64) times an int8 or int4 weight, each weight byte read
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
// What bounds it on the H100: at decode the product does 2*M flops per
// weight byte, far below the ~295 flops per byte where the bf16 tensor cores
// would limit, so the time is the weight's bytes at 3.35 TB/s, or, for the
// per-layer weights of Qwen3-0.6B (0.5-3 MB), the latency of one pass over
// them. What the design does about it:
//   * split K over a thread-block cluster. A column tile of 64 columns is
//     cut along K into `cluster` ranks (1, 2, 4 or 8 CTAs of one cluster),
//     so a 1024-column layer launches 16 x 8 = 128 CTAs instead of 16.
//     Each rank sums its K range (its warps or K slices added in order),
//     stores the partial of rank r's 64 / cluster columns into rank r's
//     shared memory (distributed shared memory), and after one cluster
//     barrier rank r adds the partials in rank order 0, 1, ... and stores
//     its columns: one launch, no workspace, no atomics, and the same bits
//     on every call. A weight as wide as the head fills the card unsplit
//     and takes a 128-column tile, so each CTA reads longer runs of a row;
//   * a cp.async ring. A rank's range streams through `depth` (<= 4)
//     shared-memory stages of ks K values each: the weight tile, x's rows
//     for those K values and, on the tensor-core route, the group scales,
//     all in 16-byte copies (byte copies where a row is not 16-byte
//     aligned: ragged N), so depth - 1 stages are in flight while one is
//     computed, with one barrier per stage;
//   * two routes, picked on the host (ops/qmatmul.qgemv_plan):
//     mma: bf16 x of 2 to 64 rows on the tensor cores, mma.sync m16n8k16
//       with the weight as the A operand (16 output columns) and x as B (8
//       rows per n8 tile), so every M up to 64 reads the weight once. A
//       thread's A pair is (k, k+1) of one column: one byte of packed int4
//       (low nibble first), two byte rows of int8. A warp's 8-byte shared
//       loads cover 8 columns (thread lane/4) of one packed row (lane%4)
//       and feed 4 mma tiles directly: the map from columns to mma rows is
//       chosen for that, and the epilogue writes through the same map.
//       Bytes become bf16 pairs by magic numbers, exactly, with no
//       int-to-float unit: a byte permute puts a pair in the two halves,
//       one lop3 drops the low bits into the mantissa of 128, one bf16x2
//       subtract takes the bias off (int4: 128 + (n ^ 8) - 136; int8, whose
//       128 + 255 is not exact in bf16: 128 + (q & 127) minus 128 or 256 by
//       the sign, a second lop3). grouped keeps a partial per group, folded
//       with the group's scale at each group change; dequant rounds
//       q * scale to bf16 in the fragment; w8a16 scales in the epilogue.
//       Products of bf16 values and small integers are exact in f32;
//     simt: one row (it measured faster than an n8 tile 1/8 used), f32 x,
//       group sizes that are not a multiple of 16, the one-value-per-byte
//       int4 layout and K % 16 != 0. FP32 FMAs on 8 columns per thread,
//       bytes biased and dropped into the mantissa of 2^23 (one byte
//       permute, one float add: exact); a thread's K only grows, so the
//       group changes by a compare, not a k / gs per value. Rows past 8 go
//       to other threads of the CTA (8 rows each), never to another CTA:
//       the weight is read once.
// Columns past N are zero-filled and never stored; K past a rank's range is
// zero-filled in both x and the weight.
// Not done here: wgmma and TMA (at M <= 64 the tensor cores are idle
// either way), a persistent grid for the head.
//
// Built by inferd_tpu_torch/ops/build.py with nvcc into a shared library with
// a plain C interface (qmatmul_launch), called through ctypes by
// inferd_tpu_torch/ops/qmatmul.py (w8a16_matmul, w4a16_matvec).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 4;

enum DType { kF32 = 0, kBF16 = 1 };
enum Kind { kInt8 = 0, kInt4Packed = 1, kInt4Bytes = 2 };
// kScaleAfter: one scale per column, applied to the finished f32 sum (w8a16;
// w4a16 grouped with one group). kGrouped: a partial per group, times the
// group's scale. kDequant: q * scale rounded to x's type before the product.
enum Scheme { kScaleAfter = 0, kGrouped = 1, kDequant = 2 };
enum Route { kSimt = 0, kMma = 1 };

struct Params {
  const void* x;       // [M, K], x's type
  const uint8_t* q;    // [R, N] weight bytes: R = K, or K / 2 when packed
  const float* scale;  // [G, N]
  void* out;           // [M, N], x's type
  int M, K, N, G, gs;  // gs = K / G
  int cluster;         // ranks per column tile: CTAs of one cluster
  int kr;              // K values per rank: rank r takes [r * kr, min(K, (r + 1) * kr))
  int ks;              // K values per ring stage (a multiple of 16)
  int depth;           // ring stages
};

// Shared-memory layout of one instantiation. Ring slot: weight rows (padded
// on the mma route so a warp's 8-byte loads of 4 rows hit distinct banks),
// x rows (MT of them, each ks values plus 16 bytes of padding), group scales
// (mma route, grouped or dequant). The per-thread partials (red) reuse the
// ring once it is drained. After both: the inbox, where every rank of the
// cluster stores its partial of this rank's columns, [rank][column][row],
// and this rank's column scales (the scale-after scheme).
template <typename T, bool MMA, bool PACKED, int SCHEME, int MT, int BN>
struct Layout {
  static_assert(BN == 64 || BN == 128, "the column tile is 64 or 128 columns");
  static constexpr int kBlockN = BN;  // columns per CTA
  static constexpr int kLogBlockN = BN == 128 ? 7 : 6;
  static constexpr int kColGroups = BN / 64;  // mma: warps side by side along the columns
  static constexpr int kColThreads = BN / 8;  // simt: threads side by side along the columns
  static constexpr int kRowK = PACKED ? 2 : 1;  // K values per weight byte row
  static constexpr int kWStride = kBlockN + (MMA ? (PACKED ? 32 : 16) : 0);
  static constexpr bool kScalesInRing = MMA && SCHEME != kScaleAfter;
  // threads' split of the K steps: warps on the mma route, slices on simt
  // (where a warp holds several slices of the same columns and rows, they
  // are summed by shuffles first and the warp is one part)
  static constexpr int kParts =
      MMA ? kWarps / kColGroups / (MT == 64 ? 4 : MT == 32 ? 2 : 1)
          : (MT <= 8 ? 1 : MT / 8) * kColThreads < 32 ? kWarps : kThreads / kColThreads / (MT / 8);
  __host__ __device__ static int x_stride(int ks) { return ks * (int)sizeof(T) + 16; }
  __host__ __device__ static int w_bytes(int ks) { return ks / kRowK * kWStride; }
  __host__ __device__ static int s_bytes(int ks, int gs) {
    return kScalesInRing ? ks / gs * kBlockN * 4 : 0;
  }
  __host__ __device__ static int slot_bytes(int ks, int gs) {
    return w_bytes(ks) + MT * x_stride(ks) + s_bytes(ks, gs);
  }
  __host__ __device__ static int inbox_offset(int ks, int gs, int depth) {
    const int ring = depth * slot_bytes(ks, gs);
    const int red = kParts * kBlockN * MT * 4;
    return ring > red ? ring : red;
  }
  __host__ __device__ static int smem_bytes(int ks, int gs, int depth) {
    return inbox_offset(ks, gs, depth) + kBlockN * MT * 4 + kBlockN * 4;
  }
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

// 16 bytes global -> shared, of which `valid` (0..16) are read and the rest
// zero-filled: one cp.async where the source row is 16-byte aligned, plain
// byte copies otherwise (they land before the ring's next barrier too).
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, int valid, bool vec,
                                       const void* any) {
  if (vec) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const void* g = valid > 0 ? static_cast<const void*>(src) : any;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(valid));
  } else {
#pragma unroll 1
    for (int b = 0; b < 16; ++b) dst[b] = b < valid ? src[b] : 0;
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n (0..2: depth - 2) of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
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

__device__ __forceinline__ int clamp16(int v) { return v < 0 ? 0 : v > 16 ? 16 : v; }

// byte i of a word holding biased values u in [0, 255] -> u - bias, exactly:
// 0x4B000000 is 2^23, whose mantissa's low byte takes u
__device__ __forceinline__ float biased_byte(uint32_t word, int i, float bias) {
  const uint32_t bits = __byte_perm(word, 0x4B000000u, 0x7440u + i);
  return __uint_as_float(bits) - bias;
}

// simt: one byte row's 8 columns -> w[h][c], h the K values the row holds
// (1 for a byte per value, 2 for a packed row: low nibble first)
template <bool PACKED>
__device__ __forceinline__ void unpack(uint2 raw, float (*w)[8]) {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// mma: x holds a nibble pair (k, k+1) of one column in bits 0-3 and 16-19
// -> bf16x2 {value(k), value(k+1)}: one lop3 makes 0x4300 | (n ^ 8), the
// bf16 of 128 + (n ^ 8) = 136 + value (n a two's-complement nibble), and one
// bf16x2 subtract takes 136 off: exact
__device__ __forceinline__ uint32_t nibble_pair(uint32_t x) {
  uint32_t bits = ((x ^ 0x43084308u) & 0x000F000Fu) | 0x43004300u;
  uint32_t bias = 0x43084308u;  // bf16x2 {136, 136}
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits),
                                   *reinterpret_cast<__nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mma: x holds two int8 q (k, k+1) of one column in bits 0-7 and 16-23 ->
// bf16x2 {q(k), q(k+1)}: 128 + (q & 127) is exact in bf16 (0x4300 | (q &
// 127)), and q = (q & 127) - 128 * sign, so one bf16x2 subtract of 128 or
// 256 (0x4300 | (q & 128)) gives it exactly
__device__ __forceinline__ uint32_t int8_pair(uint32_t x) {
  uint32_t low = (x & 0x007F007Fu) | 0x43004300u;
  uint32_t sub = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&low),
                                   *reinterpret_cast<__nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (column tiles * cluster); block kThreads; cluster (cluster, 1, 1).
// MT: row capacity (mma 8/16/32/64, simt 1/8/64); BN: the column tile.
template <typename T, bool MMA, bool PACKED, int SCHEME, int MT, int BN>
__global__ void __launch_bounds__(kThreads) qgemv_kernel(Params p) {
  using L = Layout<T, MMA, PACKED, SCHEME, MT, BN>;
  constexpr int kBlockN = L::kBlockN, kLogBlockN = L::kLogBlockN;
  constexpr int kColGroups = L::kColGroups, kColThreads = L::kColThreads;
  constexpr int kRowK = L::kRowK;
  extern __shared__ __align__(16) uint8_t smem[];

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int tid = threadIdx.x;
  const int lc = __ffs(p.cluster) - 1;  // log2 of the cluster size
  const int rank = blockIdx.x & (p.cluster - 1);
  const int n0 = (blockIdx.x >> lc) * kBlockN;
  const int k_lo = rank * p.kr;
  const int k_hi = min(p.K, k_lo + p.kr);
  const int ks = p.ks;
  const int nst = (k_hi - k_lo + ks - 1) / ks;  // stages of this rank
  const int slot = L::slot_bytes(ks, p.gs);
  const int xs = L::x_stride(ks);
  const int wb = L::w_bytes(ks);

  const bool wvec = p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  // x's chunks start at k_lo + multiples of ks (a multiple of 16)
  const bool xvec = (p.K * (int)sizeof(T)) % 16 == 0 && (k_lo * (int)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  const bool svec = p.N % 4 == 0 && reinterpret_cast<uintptr_t>(p.scale) % 16 == 0;
  // this rank's columns of the output: [col0, col0 + cols) of the tile
  const int lcols = kLogBlockN - lc;  // log2 of kBlockN / cluster
  const int cols = 1 << lcols, col0 = rank * cols;
  if (p.cluster > 1) cluster_arrive_relaxed();  // "started": waited before the first remote store
  // the scale-after scheme's column scales, loaded now and used at the end
  float col_scale = 0.f;
  if (SCHEME == kScaleAfter && tid < cols && n0 + col0 + tid < p.N) col_scale = p.scale[n0 + col0 + tid];

  // stage i of this rank -> ring slot `s`: every thread copies its share,
  // the same chunks of every stage (worked out once, here)
  constexpr int kE = 16 / (int)sizeof(T);  // x values per 16 bytes
  const int rows = ks / kRowK;             // weight byte rows per stage
  const uint8_t* q_rank = p.q + (long)(k_lo / kRowK) * p.N + n0;
  const int xchunks = ks / kE;             // 16-byte chunks of an x row per stage
  const int xm0 = tid / xchunks, xc0 = tid % xchunks;  // this thread's first x chunk
  const int xdm = kThreads / xchunks, xdc = kThreads % xchunks;
  const int s_groups = L::kScalesInRing ? ks / p.gs : 0;  // group scale rows per stage
  auto issue = [&](int i, int s) {
    uint8_t* base = smem + s * slot;
    const int k0 = k_lo + i * ks;
    const int kend = min(k0 + ks, k_hi);
    const int rows_valid = (kend - k0 + kRowK - 1) / kRowK;
    const uint8_t* q_stage = q_rank + (long)i * rows * p.N;
#pragma unroll 1
    for (int c = tid; c < rows * (kBlockN / 16); c += kThreads) {
      const int r = c / (kBlockN / 16), cc = c % (kBlockN / 16);
      const int valid = r < rows_valid ? clamp16(p.N - n0 - cc * 16) : 0;
      copy16(base + r * L::kWStride + cc * 16, q_stage + (long)r * p.N + cc * 16, valid, wvec, p.q);
    }
#pragma unroll 1
    for (int m = xm0, cc = xc0; m < p.M;) {
      const int k = k0 + cc * kE;
      copy16(base + wb + m * xs + cc * 16,
             reinterpret_cast<const uint8_t*>(x + (long)m * p.K + k),
             clamp16((kend - k) * (int)sizeof(T)), xvec, p.x);
      m += xdm;
      cc += xdc;
      if (cc >= xchunks) {
        cc -= xchunks;
        ++m;
      }
    }
    if (L::kScalesInRing) {
      uint8_t* sb = base + wb + MT * xs;
      const float* s_stage = p.scale + (long)(k0 / p.gs) * p.N + n0;
#pragma unroll 1
      for (int c = tid; c < s_groups * (kBlockN / 4); c += kThreads) {
        const int gi = c / (kBlockN / 4), cc = c % (kBlockN / 4);
        const int valid = k0 + gi * p.gs < kend ? clamp16((p.N - n0) * 4 - cc * 16) : 0;
        copy16(sb + gi * kBlockN * 4 + cc * 16,
               reinterpret_cast<const uint8_t*>(s_stage + (long)gi * p.N) + cc * 16, valid, svec,
               p.scale);
      }
    }
  };

  // this thread's partial sums; layout of `red`: [part][column][row]
  float* red = reinterpret_cast<float*>(smem);  // reuses the ring once it is drained
  float* inbox = reinterpret_cast<float*>(smem + L::inbox_offset(ks, p.gs, p.depth));
  float* scales = inbox + kBlockN * MT;

  // the ring: stage c lands in slot c % depth while up to depth - 1 later
  // stages are in flight; one barrier per stage both publishes stage c and
  // frees the slot that the next copy overwrites (the one stage c - 1 used).
  // A rank of one stage runs it as depth 2 with the second slot never used.
  const int depth = p.depth < 2 ? 2 : p.depth;
  auto ring = [&](auto&& compute) {
    for (int it = 0; it < nst + depth - 1; ++it) {
      const int c = it - (depth - 1);  // the stage computed in this step
      if (c >= 0) {
        cp_async_wait(depth - 2);
        __syncthreads();
      }
      if (it < nst) issue(it, it % depth);
      cp_async_commit();
      if (c >= 0) compute(c, smem + (c % depth) * slot);
    }
    __syncthreads();  // every thread is done with the ring before `red` reuses it
  };

  if constexpr (MMA) {
    constexpr int WM = MT == 64 ? 4 : MT == 32 ? 2 : 1;  // warps along M
    constexpr int WK = kWarps / kColGroups / WM;         // warps along K
    constexpr int N8W = MT == 8 ? 1 : 2;                 // n8 row tiles per warp
    static_assert(WK >= 1, "too few warps for the tile");
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wc = warp % kColGroups, wm = warp / kColGroups % WM, wk = warp / kColGroups / WM;
    const int gc = wc * 64 + g * 8;  // this thread's first column of the tile
    float acc[4][N8W][4];
    float part[4][N8W][4];  // kGrouped: the running group's partial
    float sc[8];            // kGrouped / kDequant: the running group's scales, columns g*8 + j
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < N8W; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] = part[a][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.f;
    int g_end = 0;  // grouped / dequant: the first K past the running group

    auto fold = [&]() {  // kGrouped: acc += partial * scale, partial = 0
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < N8W; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // c0, c1: column g*8 + 2a; c2, c3: column g*8 + 2a + 1
            acc[a][n][e] = fmaf(part[a][n][e], sc[2 * a + (e >> 1)], acc[a][n][e]);
            part[a][n][e] = 0.f;
          }
    };

    ring([&](int i, const uint8_t* base) {
      const uint8_t* W = base;
      const uint8_t* X = base + wb;
      const float* S = reinterpret_cast<const float*>(base + wb + MT * xs);
      const int k0 = k_lo + i * ks;
      const int steps = (min(k0 + ks, k_hi) - k0) / 16;
      for (int j = wk; j < steps; j += WK) {
        const int kk = j * 16;
        if (SCHEME != kScaleAfter && k0 + kk >= g_end) {  // a warp's K only grows
          if (SCHEME == kGrouped && g_end > 0) fold();
          const int gi = kk / p.gs;  // the group's row among the stage's scales
          g_end = k0 + (gi + 1) * p.gs;
          const float4* sp = reinterpret_cast<const float4*>(S + gi * kBlockN + gc);
          const float4 s0 = sp[0], s1 = sp[1];
          sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
          sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
        }
        // A fragments of 4 mma tiles: tile a's rows g and g + 8 are columns
        // g*8 + 2a and g*8 + 2a + 1; regs 0/1 take k pair t, regs 2/3 pair t + 4
        uint32_t af[4][4];
        if (PACKED) {
          const uint2 lo = *reinterpret_cast<const uint2*>(W + (kk / 2 + t) * L::kWStride + gc);
          const uint2 hi = *reinterpret_cast<const uint2*>(W + (kk / 2 + t + 4) * L::kWStride + gc);
          const uint32_t words[2][2] = {{lo.x, lo.y}, {hi.x, hi.y}};  // [pair t / t + 4][columns 0-3 / 4-7]
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint32_t w = words[h][half], w4 = w >> 4;
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const int col = half * 4 + b;  // column g*8 + col: tile col / 2, row half col % 2
                // byte b's low nibble to bits 0-3, its high nibble to bits 16-19
                const uint32_t x2 = __byte_perm(w, w4, b | ((b + 4) << 8));
                uint32_t v;
                if (SCHEME == kDequant) {
                  const uint32_t e = nibble_pair(x2);
                  const float s_ = sc[col];
                  v = pack_bf16(__uint_as_float(e << 16) * s_, __uint_as_float(e & 0xFFFF0000u) * s_);
                } else {
                  v = nibble_pair(x2);
                }
                af[col >> 1][(col & 1) + 2 * h] = v;
              }
            }
        } else {
          // int8: pair t is byte rows kk + 2t and kk + 2t + 1; pair t + 4 is 8 rows on
          const uint8_t* r = W + (kk + 2 * t) * L::kWStride + gc;
          const uint2 r0 = *reinterpret_cast<const uint2*>(r);
          const uint2 r1 = *reinterpret_cast<const uint2*>(r + L::kWStride);
          const uint2 r8 = *reinterpret_cast<const uint2*>(r + 8 * L::kWStride);
          const uint2 r9 = *reinterpret_cast<const uint2*>(r + 9 * L::kWStride);
          const uint32_t w[2][2][2] = {{{r0.x, r0.y}, {r1.x, r1.y}}, {{r8.x, r8.y}, {r9.x, r9.y}}};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const int col = half * 4 + b;
                // byte b of row k to bits 0-7, of row k + 1 to bits 16-23
                const uint32_t x2 = __byte_perm(w[h][0][half], w[h][1][half], b | ((b + 4) << 8));
                af[col >> 1][(col & 1) + 2 * h] = int8_pair(x2);
              }
        }
#pragma unroll
        for (int n = 0; n < N8W; ++n) {
          const uint8_t* xr = X + ((wm * N8W + n) * 8 + g) * xs + (kk + 2 * t) * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
          for (int a = 0; a < 4; ++a) mma_bf16(SCHEME == kGrouped ? part[a][n] : acc[a][n], af[a], b0, b1);
        }
      }
    });
    if (SCHEME == kGrouped && g_end > 0) fold();
    // C fragment: c0, c1 at mma row g (column g*8 + 2a), rows 2t and 2t + 1 of
    // the n8 tile; c2, c3 at mma row g + 8 (column g*8 + 2a + 1)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < N8W; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = gc + 2 * a + (e >> 1);
          const int m = (wm * N8W + n) * 8 + 2 * t + (e & 1);
          red[(wk * kBlockN + col) * MT + m] = acc[a][n][e];
        }
  } else {
    constexpr int RT = MT < 8 ? MT : 8;  // rows per thread
    constexpr int RG = MT / RT;          // row groups
    constexpr int SL = kThreads / (kColThreads * RG);  // K slices
    const int ct = tid % kColThreads, rg = (tid / kColThreads) % RG, sl = tid / (kColThreads * RG);
    const int nc = n0 + ct * 8;  // this thread's first column
    float acc[RT][8];
    float part[RT][8];
    float sc[8];
#pragma unroll
    for (int m = 0; m < RT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = part[m][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[c] = 0.f;
    int cur_g = -1, g_end = 0;  // the running group and the first K past it

    auto flush = [&]() {
#pragma unroll
      for (int m = 0; m < RT; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[m][c] = fmaf(part[m][c], sc[c], acc[m][c]);
          part[m][c] = 0.f;
        }
    };

    ring([&](int i, const uint8_t* base) {
      const T* X = reinterpret_cast<const T*>(base + wb);
      const int k0 = k_lo + i * ks;
      const int kend = min(k0 + ks, k_hi);
      const int rows_valid = (kend - k0 + kRowK - 1) / kRowK;
      for (int r = sl; r < rows_valid; r += SL) {
        float w[kRowK][8];
        unpack<PACKED>(*reinterpret_cast<const uint2*>(base + r * L::kWStride + ct * 8), w);
#pragma unroll
        for (int h = 0; h < kRowK; ++h) {
          const int kk = r * kRowK + h;
          const int k = k0 + kk;
          if (k >= kend) break;
          if (SCHEME != kScaleAfter && k >= g_end) {  // a thread's k only grows
            if (SCHEME == kGrouped && cur_g >= 0) flush();
            cur_g = k / p.gs;
            g_end = (cur_g + 1) * p.gs;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              sc[c] = nc + c < p.N ? p.scale[(long)cur_g * p.N + nc + c] : 0.f;
          }
          float xv[RT];
#pragma unroll
          for (int m = 0; m < RT; ++m)
            xv[m] = to_f32(*reinterpret_cast<const T*>(
                reinterpret_cast<const uint8_t*>(X) + (rg * RT + m) * xs + kk * (int)sizeof(T)));
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float wv = w[h][c];
            if (SCHEME == kDequant) wv = round_as(wv * sc[c], x);
#pragma unroll
            for (int m = 0; m < RT; ++m) {
              if (SCHEME == kGrouped)
                part[m][c] = fmaf(xv[m], wv, part[m][c]);
              else
                acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
            }
          }
        }
      }
    });
    if (SCHEME == kGrouped && cur_g >= 0) flush();
    // lanes kColThreads * RG apart hold the same columns and rows (other
    // slices): add them by shuffles, in a fixed order
    constexpr int kSame = kColThreads * RG;
    if (kSame < 32) {
#pragma unroll
      for (int off = kSame; off < 32; off <<= 1)
#pragma unroll
        for (int m = 0; m < RT; ++m)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    }
    const int pw = kSame < 32 ? tid / 32 : sl;  // this thread's part of `red`
    if (kSame >= 32 || tid % 32 < kSame) {
#pragma unroll
      for (int m = 0; m < RT; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) red[(pw * kBlockN + ct * 8 + c) * MT + rg * RT + m] = acc[m][c];
    }
  }
  if (tid < cols) scales[tid] = col_scale;
  __syncthreads();
  // the CTA's partial, the parts summed in order, stored into the inbox of
  // the rank that owns each column (rank r: columns [r * cols, (r+1) * cols))
  cg::cluster_group cluster = cg::this_cluster();
  if (p.cluster > 1) cluster_wait();  // every CTA of the cluster has started
  for (int i = tid; i < kBlockN * MT; i += kThreads) {
    const int col = i / MT, m = i % MT;
    if (m >= p.M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < L::kParts; ++w) s += red[w * kBlockN * MT + i];
    const int owner = col >> lcols;
    float* box = p.cluster > 1 ? cluster.map_shared_rank(inbox, owner) : inbox;
    box[(rank * cols + col - owner * cols) * MT + m] = s;
  }
  // every partial has landed: each rank sums its columns over the ranks, in
  // rank order, from its own inbox, and stores them; no CTA reads another's
  // shared memory past this point
  if (p.cluster > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = tid; i < cols * p.M; i += kThreads) {
    const int m = i >> lcols, c = i & (cols - 1), n = n0 + col0 + c;
    if (n >= p.N) continue;
    float s = 0.f;
    for (int r = 0; r < p.cluster; ++r) s += inbox[(r * cols + c) * MT + m];
    if (SCHEME == kScaleAfter) s *= scales[c];  // one group: row 0 of the scales
    store(out, (long)m * p.N + n, s);
  }
}

template <typename T, bool MMA, bool PACKED, int SCHEME, int MT, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, MMA, PACKED, SCHEME, MT, BN>;
  const int smem = L::smem_bytes(p.ks, p.gs, p.depth);
  auto kernel = qgemv_kernel<T, MMA, PACKED, SCHEME, MT, BN>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.N + BN - 1) / BN * p.cluster), 1, 1);
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

// the row capacity from M; a 128-column tile is built for few rows only
// (the head: mma up to 16 rows, simt 1 or 8), which qmatmul_launch checks
template <typename T, bool MMA, bool PACKED, int SCHEME>
cudaError_t launch_rows(const Params& p, int block_n, cudaStream_t stream) {
  if constexpr (MMA) {
    if (block_n == 128) {
      if (p.M <= 8) return launch<T, MMA, PACKED, SCHEME, 8, 128>(p, stream);
      return launch<T, MMA, PACKED, SCHEME, 16, 128>(p, stream);
    }
    if (p.M <= 8) return launch<T, MMA, PACKED, SCHEME, 8, 64>(p, stream);
    if (p.M <= 16) return launch<T, MMA, PACKED, SCHEME, 16, 64>(p, stream);
    if (p.M <= 32) return launch<T, MMA, PACKED, SCHEME, 32, 64>(p, stream);
    return launch<T, MMA, PACKED, SCHEME, 64, 64>(p, stream);
  } else {
    if (block_n == 128) {
      if (p.M == 1) return launch<T, MMA, PACKED, SCHEME, 1, 128>(p, stream);
      return launch<T, MMA, PACKED, SCHEME, 8, 128>(p, stream);
    }
    if (p.M == 1) return launch<T, MMA, PACKED, SCHEME, 1, 64>(p, stream);
    if (p.M <= 8) return launch<T, MMA, PACKED, SCHEME, 8, 64>(p, stream);
    return launch<T, MMA, PACKED, SCHEME, 64, 64>(p, stream);
  }
}

template <typename T, bool MMA>
cudaError_t launch_kind(const Params& p, bool packed, int scheme, int block_n, cudaStream_t stream) {
  if (MMA && !packed)  // the tensor-core route takes int8 (w8a16) and packed int4 only
    return launch_rows<T, MMA, false, kScaleAfter>(p, block_n, stream);
  if (packed) {
    if (scheme == kGrouped) return launch_rows<T, MMA, true, kGrouped>(p, block_n, stream);
    if (scheme == kDequant) return launch_rows<T, MMA, true, kDequant>(p, block_n, stream);
    return launch_rows<T, MMA, true, kScaleAfter>(p, block_n, stream);
  }
  if constexpr (!MMA) {
    if (scheme == kGrouped) return launch_rows<T, MMA, false, kGrouped>(p, block_n, stream);
    if (scheme == kDequant) return launch_rows<T, MMA, false, kDequant>(p, block_n, stream);
  }
  return launch_rows<T, MMA, false, kScaleAfter>(p, block_n, stream);
}

}  // namespace

// The wrapper (ops/qmatmul.py) validates devices, dtypes, shapes, contiguity
// and alignment, and passes the plan of ops/qmatmul.qgemv_plan: route (0
// simt, 1 mma), block_n (the column tile: 64, or 128 for at most 16 rows on
// mma and 8 on simt), cluster (ranks per column tile), kr (K values per
// rank), ks (K values per ring stage) and depth (ring stages). kind: 0 int8 (w8a16),
// 1 int4 packed, 2 int4 one value per byte; scheme: 0 grouped, 1 dequant
// (w8a16 passes 0 with one group). A plan the kernels cannot run is refused
// with cudaErrorInvalidValue; otherwise this returns the launch's error (0
// on success), cudaFuncSetAttribute's included.
extern "C" int qmatmul_launch(const void* x, const void* q, const float* scale, void* out,
                              int M, int K, int N, int G, int kind, int scheme, int x_dtype,
                              int route, int block_n, int cluster, int kr, int ks, int depth,
                              void* stream) {
  if (G <= 0 || K <= 0 || K % G != 0 || kind < kInt8 || kind > kInt4Bytes || scheme < 0 ||
      scheme > 1 || M < 1 || M > 64 || N < 1 || (x_dtype != kF32 && x_dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const bool packed = kind == kInt4Packed;
  if (packed && K % 2 != 0) return (int)cudaErrorInvalidValue;
  // w8a16, and grouped int4 with a single group, apply the scale to the sum
  const int s = kind == kInt8 ? kScaleAfter : scheme == 1 ? kDequant : G == 1 ? kScaleAfter : kGrouped;
  const int gs = K / G;
  // the split: 1, 2, 4 or 8 ranks, each non-empty, together covering K
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || kr < 1 ||
      (long)(cluster - 1) * kr >= K || (long)cluster * kr < K || (packed && kr % 2 != 0) ||
      ks < 16 || ks % 16 != 0 || depth < 1 || depth > kMaxDepth || (depth == 1 && kr > ks))
    return (int)cudaErrorInvalidValue;
  if (block_n != 64 && (block_n != 128 || M > (route == kMma ? 16 : 8)))
    return (int)cudaErrorInvalidValue;
  if (route == kMma) {
    if (x_dtype != kBF16 || kind == kInt4Bytes || K % 16 != 0 || kr % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (s != kScaleAfter && (gs % 16 != 0 || kr % gs != 0 || ks % gs != 0))
      return (int)cudaErrorInvalidValue;
  } else if (route != kSimt) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.q = static_cast<const uint8_t*>(q);
  p.scale = scale;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  p.gs = gs;
  p.cluster = cluster;
  p.kr = kr;
  p.ks = ks;
  p.depth = depth;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kMma) return (int)launch_kind<__nv_bfloat16, true>(p, packed, s, block_n, st);
  if (x_dtype == kF32) return (int)launch_kind<float, false>(p, packed, s, block_n, st);
  return (int)launch_kind<__nv_bfloat16, false>(p, packed, s, block_n, st);
}
