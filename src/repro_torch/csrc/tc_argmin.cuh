// The tensor-core argmin mainloop shared by FlashAssign (flash_assign.cu) and
// FlashLloyd (flash_lloyd.cu), for Hopper (sm_90a).
//
// For a tile of kBM = 128 points it computes, per point, the running minimum of
// score = ||c_k||^2 - 2 x.c_k over all K centroids and its index, with ties to the
// lower index. A CTA has two consumer warpgroups of 64 rows and one producer warp.
// The centroids are swept in tiles of kBN = 128 (the wgmma N); the feature axis
// streams through a ring of shared-memory stages of 128 bytes per row (32 f32 or 64
// bf16 features; the TMA's and the wgmma's 128-byte swizzle). The producer loads
// each stage with TMA (cp.async.bulk.tensor, mbarrier completion); rows past N or K
// and features past d arrive as zeros.
//
// - bfloat16 inputs: one wgmma.m64n128k16 bf16 product per 16 features. Every
//   product of two bf16 values is exact in fp32, so with fp32 accumulation the
//   scores are as exact as an fp32 FMA loop. Bound: 2 N K d / 989 TFLOP/s.
// - float32 inputs: 3xTF32. Plain TF32 keeps 11 significant bits (a relative error
//   of ~5e-4 per product), which flips argmins far outside the fp32 near-tie bound
//   that the port holds the kernels to; the card has no faster exact-fp32 rate. So
//   each operand is split v = hi + lo with hi = cvt.rna.tf32(v) and lo =
//   cvt.rna.tf32(v - hi) (the subtraction is exact), and x.c is taken as
//   x_lo.c_hi + x_hi.c_lo + x_hi.c_hi, small terms first, into one fp32
//   accumulator. Bound: 3 * 2 N K d / 495 TFLOP/s. The centroids are split once
//   per call by prologue_kernel into scratch (c_hi, c_lo); the points are split in
//   shared memory, after their TMA load, so x is read from HBM once and never
//   written back.
// The error bound of the scores is derived in kernels/flash_assign.py:score_tol.
//
// Layouts (Cfg): kResX keeps a CTA's x tile (and for f32 its split) in shared
// memory for the whole centroid sweep, loaded and split during the first centroid
// tile, while d fits kResChunks stage rows; the stages then carry centroids only.
// Otherwise each stage carries its x chunk too, re-read from L2 and re-split for
// every centroid tile. FlashAssign (one point tile a CTA) keeps x resident where it
// fits; FlashLloyd (persistent, its cluster statistics beside the ring) streams it.
// The wgmma reads both operands from shared memory; a warpgroup issues the next
// chunk's products before waiting for the current one's (wait_group 1). After a
// tile's feature sweep the epilogue runs in registers: score = csq[k] - 2 acc,
// where the prologue pads csq with +inf past K (a zero-filled centroid would score
// 0 and win), each thread scanning its columns in ascending k with a strict '<'
// (four independent chains, merged by (value, index)), the running (min, argmin)
// of its two rows kept across tiles. The 4 lanes of a row merge (value, index)
// lexicographically once at the end. Both kernels run the same instructions in
// the same order on the same chunks, so their scores and ids agree bit for bit.
// FlashLloyd also asks the consumers for each row's ||x||^2 (kSq), which they
// sum from the x chunks of the first centroid tile as they split them (f32) or
// with one more read of the chunk (bf16).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace fk {
namespace tc {

constexpr int kBM = 128;                 // points per CTA tile: two warpgroups of 64 rows
constexpr int kBN = 128;                 // centroids per tile (the wgmma N)
constexpr int kRowBytes = 128;           // feature bytes per stage row (128-byte swizzle)
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kBM * kRowBytes;  // 16 KB (kBN == kBM)
constexpr int kWgBytes = 64 * kRowBytes;     // one warpgroup's 64 rows of a tile
constexpr int kResChunks = 4;            // x stays resident up to 4 stage rows
static_assert(kBN == kBM, "x and c tiles share kTileBytes");

// Shared-memory layout from a 1024-byte-aligned base (the swizzle pattern's
// period): the resident x tile (kResX), then kStages ring stages, then their
// 2 kStages mbarriers (full, empty).
template <bool kF32, bool kResX, int kStages_>
struct Cfg {
  static constexpr bool kIsF32 = kF32;
  static constexpr bool kResident = kResX;
  static constexpr int kStages = kStages_;
  static constexpr int kElem = kF32 ? 4 : 2;
  static constexpr int kChunk = kRowBytes / kElem;        // features per stage
  static constexpr int kSplit = kF32 ? 2 : 1;             // (hi, lo) | raw
  static constexpr int kXStage = kResX ? 0 : kSplit * kTileBytes;  // x in a stage
  static constexpr int kStageBytes = kXStage + kSplit * kTileBytes;  // + c (hi, lo)
  static constexpr int kXRes = kResX ? kSplit * kResChunks * kTileBytes : 0;
  static constexpr int kBytes = kXRes + kStages * kStageBytes + 2 * kStages * 8;
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

#undef FK_ACC_REGS
#undef FK_D64
#undef FK_D8

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Splits a warpgroup's 64 rows of an f32 x chunk (8 KB at xh) in place into
// tf32 hi and, at xl, lo: 16 bytes per thread and step. The split is element-
// wise, so the TMA's swizzled layout carries over. With kSq and acc it also adds
// the squares of the values to sq[i], the thread's part of ||x||^2 of the
// warpgroup's row tid / 8 + 16 i (the swizzle permutes 16-byte pieces within a
// row). The async-proxy fence makes the writes visible to the wgmma, the named
// barrier to the whole warpgroup.
template <bool kSq>
__device__ __forceinline__ void split_x(uint32_t xh, uint32_t xl, int wg, int tid,
                                        float (&sq)[4], bool acc) {
#pragma unroll
  for (int i = 0; i < kWgBytes / (16 * 128); ++i) {
    const uint32_t off = (uint32_t)(tid + 128 * i) * 16;
    uint32_t v[4], h[4], l[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(xh + off));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = __uint_as_float(v[j]);
      if (kSq && acc) sq[i] = fmaf(f, f, sq[i]);
      h[j] = tf32_rna(f);
      l[j] = tf32_rna(f - __uint_as_float(h[j]));
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

// The squares of a warpgroup's 64 rows of a bf16 x chunk (8 KB at xh) into sq,
// in split_x's layout.
__device__ __forceinline__ void square_x(uint32_t xh, int tid, float (&sq)[4]) {
#pragma unroll
  for (int i = 0; i < kWgBytes / (16 * 128); ++i) {
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(xh + (uint32_t)(tid + 128 * i) * 16));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[j]));
      sq[i] = fmaf(f.x, f.x, fmaf(f.y, f.y, sq[i]));
    }
  }
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

// The ring of one CTA: its barriers, its stages and the two halves of the loop.
// Steps are numbered across the CTA's point tiles (t), so a persistent CTA keeps
// one ring phase over all of its tiles. Thread 0 calls init() before the CTA's
// first barrier.
template <class C>
struct Pipe {
  uint32_t base;  // 1024-byte aligned shared address

  __device__ __forceinline__ uint32_t ring() const { return base + C::kXRes; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return ring() + C::kStages * C::kStageBytes + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(C::kStages + s); }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return ring() + s * C::kStageBytes;
  }
  // x chunk dc of stage s: its (hi, lo) tiles for f32, its one tile for bf16
  __device__ __forceinline__ uint32_t x_tile(int s, int dc, int part) const {
    return C::kResident ? base + (part * kResChunks + dc) * kTileBytes
                        : stage(s) + part * kTileBytes;
  }
  __device__ __forceinline__ uint32_t c_tile(int s, int part) const {
    return stage(s) + C::kXStage + part * kTileBytes;
  }

  __device__ void init() const {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Producer (one thread): every stage of the point tile at n0 of problem b, from
  // step t on; nk centroid tiles of nd feature chunks. A resident x tile is
  // loaded with the first centroid tile's chunks (one point tile a CTA).
  __device__ void produce(const CUtensorMap* tx, const CUtensorMap* tc_hi,
                          const CUtensorMap* tc_lo, int& t, int n0, int b, int nk,
                          int nd) const {
    constexpr int S = C::kStages;
    for (int kt = 0; kt < nk; ++kt) {
      for (int dc = 0; dc < nd; ++dc, ++t) {
        const int s = t % S;
        const bool load_x = !C::kResident || kt == 0;
        mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        mbar_expect_tx(full(s), (C::kSplit + (load_x ? 1 : 0)) * kTileBytes);
        const int col = dc * C::kChunk;
        if (load_x) tma_load_3d(x_tile(s, dc, 0), tx, full(s), col, n0, b);
        tma_load_3d(c_tile(s, 0), tc_hi, full(s), col, kt * kBN, b);
        if (C::kIsF32) tma_load_3d(c_tile(s, 1), tc_lo, full(s), col, kt * kBN, b);
      }
    }
  }

  // Consumers (the two warpgroups): the (min, argmin) of the thread's two rows
  // r0 and r0 + 8 of the tile (r0 = row_of_thread()) over all nk centroid tiles,
  // from step t on; cq is the problem's +inf-padded ||c||^2. On return every lane
  // of a row holds the row's merged result (value, index). With kSq it also
  // sums ||x||^2 of every row of the tile from the x chunks of the first
  // centroid tile (the values the split reads, or a read of the bf16 chunk),
  // through row_sq (kBM floats of shared memory), into x_sq of the two rows.
  template <bool kSq = false>
  __device__ void argmin(const float* __restrict__ cq, int& t, int nk, int nd,
                         float (&best_v)[2], int (&best_i)[2],
                         float* row_sq = nullptr, float* x_sq = nullptr) const {
    constexpr int S = C::kStages;
    // in the accumulator a thread holds rows r0 and r0 + 8 and, per 8-column
    // block j, columns 8 j + 2 q and + 1
    const int wg = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    best_v[0] = best_v[1] = INFINITY;
    best_i[0] = best_i[1] = 0x7fffffff;
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
    float acc[64];
    // Waits for step u (tile kt, chunk dc), splits its x chunk where that is
    // still to do (f32), and issues its products into acc as one commit group:
    // x_lo c_hi, x_hi c_lo, x_hi c_hi per k-step of 32 bytes (small terms
    // first), or x c for bf16.
    auto issue = [&](int u, int kt, int dc) {
      const int s = u % S;
      mbar_wait(full(s), (u / S) & 1);
      const uint32_t xh = x_tile(s, dc, 0) + wg * kWgBytes;
      const uint64_t ahi = sw128_desc(xh);
      const uint64_t bhi = sw128_desc(c_tile(s, 0));
      if constexpr (C::kIsF32) {
        const uint32_t xl = x_tile(s, dc, 1) + wg * kWgBytes;
        if (!C::kResident || kt == 0)
          split_x<kSq>(xh, xl, wg, threadIdx.x & 127, sq, kt == 0);
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
        if (kSq && kt == 0) square_x(xh, threadIdx.x & 127, sq);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) mma_bf16(acc, ahi + 2 * ks, bhi + 2 * ks);
      }
      wgmma_commit();
    };
    // step u's products have finished: hand its slot back to the producer
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(u % S));
    };
    // Within a tile, step u + 1 is issued before step u has finished, so the
    // tensor cores stay fed while the warpgroup waits for and splits the next
    // chunk; the epilogue needs the whole tile.
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
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
        const float ov = __shfl_xor_sync(0xffffffffu, best_v[r], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
        if (ov < best_v[r] || (ov == best_v[r] && oi < best_i[r])) {
          best_v[r] = ov;
          best_i[r] = oi;
        }
      }
      if (best_i[r] == 0x7fffffff) best_i[r] = 0;
    }
    if constexpr (kSq) {
      // the 8 threads of a row hold its pieces: lanes that differ in bits 0-2
      const int tw = threadIdx.x & 127;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
        if ((tw & 7) == 0) row_sq[wg * 64 + (tw >> 3) + 16 * i] = sq[i];
      }
      bar_sync(1 + wg, 128);
      const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
      x_sq[0] = row_sq[r0];
      x_sq[1] = row_sq[r0 + 8];
      bar_sync(1 + wg, 128);  // read before the next tile writes
    }
  }
};

// The tile row (0 .. kBM - 1) of a consumer thread's first accumulator row; its
// second is 8 below.
__device__ __forceinline__ int row_of_thread() {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeFn encode_fn() {
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
inline bool encode(CUtensorMap* map, const void* ptr, bool f32, int d, int rows, int B) {
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

// The operands of one call: the prologue's csq (B, Kp) and, for f32, the split
// csplit (2, B, K, d), then the tensor maps of x and of the centroid operands.
struct Operands {
  CUtensorMap tx, thi, tlo;
  int Kp;
};

inline cudaError_t prepare(Operands& o, const void* x, const void* c, void* csq,
                           void* csplit, int B, int N, int K, int d, bool f32,
                           cudaStream_t s) {
  o.Kp = (K + kBN - 1) / kBN * kBN;
  const long long rows = (long long)B * o.Kp;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  const void* c_hi = c;
  const void* c_lo = c;
  if (f32) {
    float* hi = (float*)csplit;
    float* lo = hi + (long long)B * K * d;
    prologue_kernel<float><<<blocks, 256, 0, s>>>((const float*)c, (float*)csq, hi, lo,
                                                   rows, K, o.Kp, d);
    c_hi = hi;
    c_lo = lo;
  } else {
    prologue_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)c, (float*)csq, nullptr, nullptr, rows, K, o.Kp, d);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (!encode(&o.tx, x, f32, d, N, B) || !encode(&o.thi, c_hi, f32, d, K, B) ||
      !encode(&o.tlo, c_lo, f32, d, K, B))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tc
}  // namespace fk
