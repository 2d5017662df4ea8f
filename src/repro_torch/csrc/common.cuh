// Shared pieces of the flash-kmeans CUDA kernels (sm_90a, fp32 FMA on CUDA cores).
//
// tile_argmin is FlashLloyd's argmin loop (flash_lloyd.cu): one CTA of 256
// threads scores a tile of kTileN points against every centroid, kTileK
// centroids at a time, with the feature axis streamed through shared memory
// kTileD columns at a time. Each thread owns a 4 x 4 micro-tile (rows ty + 16 i,
// columns tx + 16 j), so a warp reads one shared x value per row (broadcast) and
// 16 consecutive centroid values (no bank conflicts). FlashAssign runs on the
// tensor cores instead (flash_assign.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fk {

constexpr int kTileN = 64;     // points per CTA tile
constexpr int kTileK = 64;     // centroids per sweep step
constexpr int kTileD = 16;     // feature columns per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = 4;        // row padding of the shared stages

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Shared-memory address of a generic pointer, and the mbarrier operations the TMA
// pipelines use (flash_assign.cu, flash_probe.cu).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

struct ArgminSmem {
  float xs[kTileD][kTileN + kPad];  // x tile, feature-major
  float cs[kTileD][kTileK + kPad];  // centroid tile, feature-major
};

// ||c||^2 for every centroid row, one warp per row.
template <typename T>
__global__ void csq_kernel(const T* __restrict__ c, float* __restrict__ csq,
                           long long rows, int d) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(c[row * d + j]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) csq[row] = s;
}

inline cudaError_t launch_csq_f32(const float* c, float* csq, long long rows, int d,
                                  cudaStream_t s) {
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  csq_kernel<float><<<(unsigned)blocks, warps * 32, 0, s>>>(c, csq, rows, d);
  return cudaGetLastError();
}

inline cudaError_t launch_csq_bf16(const __nv_bfloat16* c, float* csq, long long rows,
                                   int d, cudaStream_t s) {
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  csq_kernel<__nv_bfloat16><<<(unsigned)blocks, warps * 32, 0, s>>>(c, csq, rows, d);
  return cudaGetLastError();
}

// Online argmin of score = ||c||^2 - 2 x.c over all K centroids for the points
// n0 .. n0 + kTileN - 1. Writes the row minimum and its index into out_m/out_a
// (shared arrays of kTileN). Centroids k >= K are never scored; rows n >= N read
// zeros and their results are ignored by the caller. Ties go to the lower index:
// each thread scans its columns in ascending k with a strict '<', and the
// cross-thread merge compares (value, index) lexicographically.
template <typename T>
__device__ void tile_argmin(const T* __restrict__ x, const T* __restrict__ c,
                            const float* __restrict__ csq, int n0, int N, int K, int d,
                            ArgminSmem& sm, float* out_m, int* out_a) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0x7fffffff;
  }
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kTileD) {
      __syncthreads();  // the previous stage has been read by every thread
      for (int e = tid; e < kTileN * kTileD; e += kThreads) {
        const int r = e / kTileD;
        const int col = e % kTileD;
        const int dd = d0 + col;
        const int n = n0 + r;
        const int k = k0 + r;
        sm.xs[col][r] = (n < N && dd < d) ? to_f32(x[(size_t)n * d + dd]) : 0.f;
        sm.cs[col][r] = (k < K && dd < d) ? to_f32(c[(size_t)k * d + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kTileD; ++dd) {
        float xv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sm.xs[dd][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = sm.cs[dd][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) {
        const float cq = csq[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = cq - 2.f * acc[i][j];
          if (s < best_v[i]) {
            best_v[i] = s;
            best_i[i] = k;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best_v[i];
    int idx = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // the 16 lanes of one ty
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (ov < v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    if (tx == 0) {
      out_m[ty + 16 * i] = v;
      out_a[ty + 16 * i] = (idx == 0x7fffffff) ? 0 : idx;
    }
  }
  __syncthreads();
}

}  // namespace fk
