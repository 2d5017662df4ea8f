// FlashAssign for Hopper (sm_90a) on the tensor cores.
//
// Replaces: src/repro/kernels/flash_assign.py:flash_assign_raw (the Pallas TPU
// kernel of the fused distance + online-argmin assignment).
//
// Computes, for every point n and problem b, a[n] = argmin_k (||c_k||^2 - 2 x_n.c_k)
// and m[n] = that minimum (||x_n||^2 is added back by the Python wrapper). Ties go
// to the lower index, as jnp.argmin does. The N x K score matrix never leaves the
// registers: reads are O(N d + K d) from HBM, writes O(N).
//
// What bounds it on the H100: tensor-core operations. 2 N K d flops per call; the
// feature bytes are read once from HBM (the re-reads of a tile come from L2).
//
// - bfloat16 inputs: one wgmma.m64n128k16 bf16 product per 16 features. Every
//   product of two bf16 values is exact in fp32, so with fp32 accumulation the
//   scores are as exact as an fp32 FMA loop. Bound: 2 N K d / 989 TFLOP/s.
// - float32 inputs: 3xTF32. Plain TF32 keeps 11 significant bits (a relative
//   error of ~5e-4 per product), which flips argmins far outside the fp32
//   near-tie bound that the port holds the kernel to; the card has no faster
//   exact-fp32 rate. So each operand is split v = hi + lo with
//   hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (the subtraction is exact),
//   and x.c is taken as x_lo.c_hi + x_hi.c_lo + x_hi.c_hi, small terms first, into
//   one fp32 accumulator. The dropped x_lo.c_lo and the rounding of the two low
//   parts cost at most 3 * 2^-22 of |x_j c_j| per term. Bound: 3 * 2 N K d /
//   495 TFLOP/s (the CUDA-core fp32 rate, 2 N K d / 67 TFLOP/s, is 2.5x slower).
//   The centroids are split once per call by split_kernel into scratch (c_hi,
//   c_lo); the points are split in shared memory, after their TMA load, so x
//   is read from HBM once and never written back.
// The error bound of the scores, derived in kernels/flash_assign.py:score_tol, is
// what chip_smoke.py holds the kernel to against its plain version.
//
// Design: a CTA owns kBM = 128 points (two consumer warpgroups of 64 rows, one
// producer warp) and sweeps all K centroids in tiles of kBN = 128. The feature
// axis streams through a ring of shared-memory stages of 128 bytes per row (32
// f32 or 64 bf16 features; the TMA's and the wgmma's 128-byte swizzle). The
// producer loads each stage with TMA (cp.async.bulk.tensor, mbarrier
// completion); rows past N or K and features past d arrive as zeros. While x's
// CTA tile fits 4 such rows (d <= 128 f32, <= 256 bf16) it is loaded once, kept
// resident for the whole sweep, and the stages carry centroids only; else each
// stage carries its x chunk too. For f32 the consumers split each x chunk in
// place into x_hi and x_lo (element-wise, so the swizzle carries over), then
// fence.proxy.async so that the wgmma (the async proxy) sees the writes. The
// wgmma reads both operands from shared memory; a warpgroup issues the next
// chunk's products before waiting for the current one's (wait_group 1). After
// a tile's feature sweep the epilogue runs in registers:
// score = csq[k] - 2 acc, where the prologue pads csq with +inf past K (a
// zero-filled centroid would score 0 and win), each thread scanning its columns
// in ascending k with a strict '<' (four independent chains, merged by (value,
// index)), the running (min, argmin) of its two rows kept across tiles. The 4
// lanes of a row merge (value, index) lexicographically once at the end, and a
// row writes a and m once; rows n >= N are computed and not written.
//
// Layout: x (B, N, d), c (B, K, d) row-major, d a multiple of 4 (f32) or 8 (bf16)
// so that TMA sees 16-byte row strides (the wrapper zero-pads other d). Grid
// (ceil(N / 128), B), 288 threads, dynamic shared memory (fk_flash_assign_smem).
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W; PERF.md): N = 8,388,608,
// K = 1,024, d = 128 in 19.7 ms f32 (bound 13.3 ms) and 5.3 ms bf16 (bound
// 2.2 ms). Error: |score - exact| <= (6 d + 13) u mag for f32 and (2 d + 1) u mag
// for bf16 (u = 2^-24, mag = max ||c||^2 + 2 max ||x|| max ||c||), as derived in
// kernels/flash_assign.py:score_tol.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace fk {
namespace fa {

constexpr int kBM = 128;                 // points per CTA: two warpgroups of 64 rows
constexpr int kBN = 128;                 // centroids per tile (the wgmma N)
constexpr int kRowBytes = 128;           // feature bytes per stage row (128-byte swizzle)
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kBM * kRowBytes;  // 16 KB (kBN == kBM)
constexpr int kWgBytes = 64 * kRowBytes;     // one warpgroup's 64 rows of a tile
static_assert(kBN == kBM, "x and c tiles share kTileBytes");

constexpr int kResChunks = 4;           // x stays resident up to 4 stage rows

// Shared memory. The wgmma reads both operands from shared memory; for f32 the
// consumers first split each x chunk in place into x_hi and a second tile x_lo.
// kResX: the CTA's x tile (kBM rows x d, and for f32 its split) stays in shared
// memory for the whole centroid sweep, loaded and split once, during the first
// centroid tile (d * bytes <= kResChunks * 128: d <= 128 in f32, <= 256 in
// bf16); otherwise each ring stage carries its x chunk, re-read from L2 and
// re-split for every centroid tile.
template <bool kF32, bool kResX>
struct Cfg {
  static constexpr int kElem = kF32 ? 4 : 2;
  static constexpr int kChunk = kRowBytes / kElem;        // features per stage
  static constexpr int kSplit = kF32 ? 2 : 1;             // (hi, lo) | raw
  static constexpr int kStages = kF32 ? 3 : 4;            // depth of the TMA ring
  static constexpr int kXStage = kResX ? 0 : kSplit * kTileBytes;  // x in a stage
  static constexpr int kStageBytes = kXStage + kSplit * kTileBytes;  // + c (hi, lo)
  static constexpr int kXRes = kResX ? kSplit * kResChunks * kTileBytes : 0;
  // resident x, the ring, its 2 kStages mbarriers, and slack to align both to
  // 1024 B (the swizzle pattern's period); core/heuristics.assign_footprint
  static constexpr int kSmem = kXRes + kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;  // a tf32 value in an fp32 container
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle: leading
// byte offset unused (1), stride between 8-row groups 1024 B, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving reads of the accumulators above the wait (it
// sees a wgmma's outputs as ready when the instruction is issued).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FK_D8(i)                                                             \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FK_D64 \
  FK_D8(0), FK_D8(8), FK_D8(16), FK_D8(24), FK_D8(32), FK_D8(40), FK_D8(48), FK_D8(56)
#define FK_ACC_REGS                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1"

// d[64] += A (64 x 8 tf32) * B (8 x 128 tf32), both K-major in shared memory
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FK_ACC_REGS ";\n}\n"
      : FK_D64
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64] += A (64 x 16 bf16) * B (16 x 128 bf16), both K-major in shared memory
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FK_ACC_REGS ", 0, 0;\n}\n"
      : FK_D64
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Splits a warpgroup's 64 rows of an f32 x chunk (8 KB at xh) in place into
// tf32 hi and, at xl, lo: 16 bytes per thread and step. The split is element-
// wise, so the TMA's swizzled layout carries over. The async-proxy fence makes
// the writes visible to the wgmma, the named barrier to the whole warpgroup.
__device__ __forceinline__ void split_x(uint32_t xh, uint32_t xl, int wg, int tid) {
#pragma unroll
  for (int i = 0; i < kWgBytes / (16 * 128); ++i) {
    const uint32_t off = (uint32_t)(tid + 128 * i) * 16;
    uint32_t v[4], h[4], l[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(xh + off));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = tf32_rna(__uint_as_float(v[j]));
      l[j] = tf32_rna(__uint_as_float(v[j]) - __uint_as_float(h[j]));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(xh + off), "r"(h[0]),
                 "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(xl + off), "r"(l[0]),
                 "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_sync(1 + wg, 128);
}

// ||c||^2 of every centroid (from the unsplit values, in f32) into csq, whose
// rows are padded to Kp = a multiple of kBN with +inf (so the epilogue needs no
// mask: +inf - 2 acc stays +inf and never wins), and for f32 the 3xTF32 split
// of every centroid row into chi and clo. One warp per row of B * Kp.
template <typename T>
__global__ void prologue_kernel(const T* __restrict__ c, float* __restrict__ csq,
                                float* __restrict__ chi, float* __restrict__ clo,
                                long long rows, int K, int Kp, int d) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long bi = row / Kp;
  const int k = (int)(row % Kp);
  if (k >= K) {
    if (lane == 0) csq[row] = INFINITY;
    return;
  }
  const long long r = bi * K + k;  // the row in c (B, K, d)
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const long long i = r * d + j;
    const float v = to_f32(c[i]);
    s = fmaf(v, v, s);
    if constexpr (sizeof(T) == 4) {
      const float h = __uint_as_float(tf32_rna(v));
      chi[i] = h;
      clo[i] = __uint_as_float(tf32_rna(v - h));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) csq[row] = s;
}

// (v, i) <- (w, j) if w < v: keeps the first minimum of an ascending scan
__device__ __forceinline__ void take_min(float& v, int& i, float w, int j) {
  const bool lt = w < v;
  v = lt ? w : v;
  i = lt ? j : i;
}

template <bool kF32, bool kResX>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_assign_tc(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tc_hi,
                    const __grid_constant__ CUtensorMap tc_lo,
                    const float* __restrict__ csq, int* __restrict__ a,
                    float* __restrict__ m, int N, int K, int Kp, int d) {
  using C = Cfg<kF32, kResX>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = base + C::kXRes;
  const uint32_t bars = ring + S * C::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto stage = [&](int s) { return ring + s * C::kStageBytes; };
  // x chunk dc of stage s: its (hi, lo) tiles for f32, its one tile for bf16
  auto x_tile = [&](int s, int dc, int part) {
    return kResX ? base + (part * kResChunks + dc) * kTileBytes
                 : stage(s) + part * kTileBytes;
  };
  auto c_tile = [&](int s, int part) {
    return stage(s) + C::kXStage + part * kTileBytes;
  };

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kBM;
  const int nk = (K + kBN - 1) / kBN;
  const int nd = (d + C::kChunk - 1) / C::kChunk;
  const int steps = nk * nd;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp: one thread issues the TMA
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % S;
        const bool load_x = !kResX || t < nd;  // resident x: first tile only
        mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        mbar_expect_tx(full(s), (C::kSplit + (load_x ? 1 : 0)) * kTileBytes);
        const int dc = t % nd;
        const int col = dc * C::kChunk;
        const int k0 = (t / nd) * kBN;
        if (load_x) tma_load_3d(x_tile(s, dc, 0), &tx, full(s), col, n0, b);
        tma_load_3d(c_tile(s, 0), &tc_hi, full(s), col, k0, b);
        if (kF32) tma_load_3d(c_tile(s, 1), &tc_lo, full(s), col, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63; in the
  // accumulator a thread holds rows r0 and r0 + 8 and, per 8-column block j,
  // columns 8 j + 2 q and + 1
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const float* cq = csq + (long long)b * Kp;
  float best_v[2] = {INFINITY, INFINITY};
  int best_i[2] = {0x7fffffff, 0x7fffffff};
  float acc[64];
  // Waits for step t (tile kt, chunk dc), splits its x chunk where that is
  // still to do (f32), and issues its products into acc as one commit group:
  // x_lo c_hi, x_hi c_lo, x_hi c_hi per k-step of 32 bytes (small terms
  // first), or x c for bf16.
  auto issue = [&](int t, int kt, int dc) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const uint32_t xh = x_tile(s, dc, 0) + wg * kWgBytes;
    const uint64_t ahi = sw128_desc(xh);
    const uint64_t bhi = sw128_desc(c_tile(s, 0));
    if constexpr (kF32) {
      const uint32_t xl = x_tile(s, dc, 1) + wg * kWgBytes;
      if (!kResX || kt == 0) split_x(xh, xl, wg, threadIdx.x & 127);
      const uint64_t alo = sw128_desc(xl);
      const uint64_t blo = sw128_desc(c_tile(s, 1));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // +32 bytes per k-step: +2 in a desc
        mma_tf32(acc, alo + 2 * ks, bhi + 2 * ks);
        mma_tf32(acc, ahi + 2 * ks, blo + 2 * ks);
        mma_tf32(acc, ahi + 2 * ks, bhi + 2 * ks);
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) mma_bf16(acc, ahi + 2 * ks, bhi + 2 * ks);
    }
    wgmma_commit();
  };
  // step t's products have finished: hand its slot back to the producer
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(t % S));
  };
  // Within a tile, step t + 1 is issued before step t has finished, so the
  // tensor cores stay fed while the warpgroup waits for and splits the next
  // chunk; the epilogue needs the whole tile.
  int t = 0;
  for (int kt = 0; kt < nk; ++kt, t += nd) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    issue(t, kt, 0);
    for (int dc = 1; dc < nd; ++dc) {
      issue(t + dc, kt, dc);
      wgmma_wait<1>();  // all but the group just issued
      release(t + dc - 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(t + nd - 1);
    // Epilogue of tile kt. A thread's 32 columns of a row, in ascending k, are
    // i = 2 j + e -> k = kb + 8 j + 2 q + e; it scans them as four independent
    // chains of 8 (a strict '<' keeps a chain's first minimum), merges the
    // chains by (value, i), then the tile into the running (min, argmin).
    const int kb = kt * kBN;
    float2 cj[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      cj[j] = __ldg(reinterpret_cast<const float2*>(cq + kb + 8 * j + 2 * q));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cv[4];
      int ci[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        cv[ch] = INFINITY;
        ci[ch] = 0;
#pragma unroll
        for (int i = 8 * ch; i < 8 * ch + 8; ++i) {
          const int j = i >> 1, e = i & 1;
          const float ck = e ? cj[j].y : cj[j].x;
          take_min(cv[ch], ci[ch], ck - 2.f * acc[4 * j + 2 * r + e], i);
        }
      }
#pragma unroll
      for (int ch = 1; ch < 4; ++ch) take_min(cv[0], ci[0], cv[ch], ci[ch]);
      // ci[0] of the lowest chain wins ties: chains are merged in ascending i
      take_min(best_v[r], best_i[r], cv[0],
               kb + 8 * (ci[0] >> 1) + 2 * q + (ci[0] & 1));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = best_v[r];
    int idx = best_i[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (ov < v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    const int n = n0 + r0 + 8 * r;
    if (q == 0 && n < N) {
      a[(long long)b * N + n] = (idx == 0x7fffffff) ? 0 : idx;
      m[(long long)b * N + n] = v;
    }
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A (B, rows, d) row-major tensor as a 3-D map with boxes of 128 bytes of
// features x 128 rows x 1 problem, 128-byte swizzle, zeros past the edges.
bool encode(CUtensorMap* map, const void* ptr, bool f32, int d, int rows, int B) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {d * es, (cuuint64_t)rows * d * es};
  const cuuint32_t box[3] = {(cuuint32_t)(kRowBytes / es), (cuuint32_t)kBM, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kF32, bool kResX>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(flash_assign_tc<kF32, kResX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<kF32, kResX>::kSmem);
}

template <bool kF32, bool kResX>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& thi, const CUtensorMap& tlo,
                   const float* csq, int* a, float* m, int B, int N, int K, int Kp,
                   int d, cudaStream_t s) {
  cudaError_t e = set_smem<kF32, kResX>();
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBM - 1) / kBM, B);
  flash_assign_tc<kF32, kResX><<<grid, kThreadsTC, Cfg<kF32, kResX>::kSmem, s>>>(
      tx, thi, tlo, csq, a, m, N, K, Kp, d);
  return cudaGetLastError();
}

// x stays resident when its CTA tile fits kResChunks stage rows
inline bool resident_x(bool f32, int d) {
  return (long long)d * (f32 ? 4 : 2) <= (long long)kResChunks * kRowBytes;
}

}  // namespace fa
}  // namespace fk

// x (B, N, d), c (B, K, d); csq (B, Kp) with Kp = K rounded up to a multiple of
// 128 and, for f32, csplit (2, B, K, d) are scratch; a (B, N) int32 and m (B, N)
// f32 out. d must be a multiple of 4 (f32) or 8 (bf16); N >= 1.
extern "C" int fk_flash_assign(const void* x, const void* c, void* csq, void* csplit,
                               void* a, void* m, int B, int N, int K, int d, int is_bf16,
                               void* stream) {
  using namespace fk;
  using namespace fk::fa;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = !is_bf16;
  if (d % (f32 ? 4 : 8) != 0 || N < 1 || K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int Kp = (K + kBN - 1) / kBN * kBN;
  const long long rows = (long long)B * Kp;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  const void* c_hi = c;
  const void* c_lo = c;
  if (f32) {
    float* hi = (float*)csplit;
    float* lo = hi + (long long)B * K * d;
    prologue_kernel<float><<<blocks, 256, 0, s>>>((const float*)c, (float*)csq, hi, lo, rows,
                                                   K, Kp, d);
    c_hi = hi;
    c_lo = lo;
  } else {
    prologue_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)c, (float*)csq, nullptr, nullptr, rows, K, Kp, d);
  }
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  CUtensorMap tx, thi, tlo;
  if (!encode(&tx, x, f32, d, N, B) || !encode(&thi, c_hi, f32, d, K, B) ||
      !encode(&tlo, c_lo, f32, d, K, B))
    return (int)cudaErrorInvalidValue;
  const float* cq = (const float*)csq;
  const bool res = resident_x(f32, d);
  if (f32)
    e = res ? launch<true, true>(tx, thi, tlo, cq, (int*)a, (float*)m, B, N, K, Kp, d, s)
            : launch<true, false>(tx, thi, tlo, cq, (int*)a, (float*)m, B, N, K, Kp, d, s);
  else
    e = res ? launch<false, true>(tx, thi, tlo, cq, (int*)a, (float*)m, B, N, K, Kp, d, s)
            : launch<false, false>(tx, thi, tlo, cq, (int*)a, (float*)m, B, N, K, Kp, d, s);
  return (int)e;
}

// The dynamic shared memory the launch at width d sets, read back from the
// kernel's attributes (cudaFuncAttributes::maxDynamicSharedSizeBytes).
extern "C" int fk_flash_assign_smem(int is_bf16, int d, int* out) {
  using namespace fk::fa;
  cudaFuncAttributes attr;
  cudaError_t e;
  const bool res = resident_x(!is_bf16, d);
#define FK_SMEM_OF(F32, RES)                                                  \
  if ((e = set_smem<F32, RES>()) != cudaSuccess) return (int)e;               \
  e = cudaFuncGetAttributes(&attr, flash_assign_tc<F32, RES>);
  if (is_bf16) {
    if (res) { FK_SMEM_OF(false, true) } else { FK_SMEM_OF(false, false) }
  } else {
    if (res) { FK_SMEM_OF(true, true) } else { FK_SMEM_OF(true, false) }
  }
#undef FK_SMEM_OF
  if (e == cudaSuccess) *out = attr.maxDynamicSharedSizeBytes;
  return (int)e;
}

extern "C" int fk_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
