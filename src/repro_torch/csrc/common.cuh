// Shared pieces of the flash-kmeans CUDA kernels (sm_90a): type conversion, the
// mbarrier operations of the TMA pipelines (tc_argmin.cuh, flash_probe.cu), the
// cluster operations (flash_lloyd.cu, flash_probe.cu) and ||c||^2 by rows (the q8
// scan's query norms).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fk {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Shared-memory address of a generic pointer, and the mbarrier operations the TMA
// pipelines use (tc_argmin.cuh, flash_probe.cu).
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

// Thread-block clusters (flash_lloyd.cu, flash_probe.cu): this CTA's rank, the
// cluster-wide barrier, and reads of another CTA's shared memory.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders the shared-memory writes
// before it (release) against the reads after it (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// the address of the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// ||c||^2 for every row of c, one warp per row (a template, so that each source
// that includes this header may hold its own instance).
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

}  // namespace fk
