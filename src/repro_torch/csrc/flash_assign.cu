// FlashAssign for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_assign.py, flash_assign_raw / _flash_assign_kernel
// (the Pallas TPU kernel of the fused distance + online-argmin assignment).
//
// Computes, for every point n and problem b, a[n] = argmin_k (||c_k||^2 - 2 x_n.c_k)
// and m[n] = that minimum (||x_n||^2 is added back by the Python wrapper). Ties go
// to the lower index, as jnp.argmin does. The N x K score matrix never leaves the
// CTA: reads are O(N d + K d), writes O(N).
//
// What bounds it on the H100: operations. Each (point, centroid) pair costs d fp32
// FMAs, and at d = 128 a point is reused by every centroid, so 2 N K d flops over
// 67 TFLOP/s (fp32, CUDA cores) is far above (N d + K d) bytes over 3.35 TB/s.
// The design answers with register blocking: each thread keeps a 4 x 4 block of
// scores in registers, so one shared-memory value feeds four FMAs, and the running
// (min, argmin) never leaves registers until one shuffle merge per tile. It does
// not use the tensor cores (wgmma): a later change can, at the cost of an exact
// fp32 argmin, which TF32 would not give.
//
// Layout: x (B, N, d), c (B, K, d) row-major, float32 or bfloat16 (converted to
// float32 on load). Grid (ceil(N / 64), B), 256 threads. A prologue kernel writes
// ||c||^2 once per centroid set into csq (B * K floats, allocated by the caller).
#include "common.cuh"

namespace fk {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
                        const float* __restrict__ csq, int* __restrict__ a,
                        float* __restrict__ m, int N, int K, int d) {
  __shared__ ArgminSmem sm;
  __shared__ float s_m[kTileN];
  __shared__ int s_a[kTileN];
  const long long b = blockIdx.y;
  x += b * N * (long long)d;
  c += b * K * (long long)d;
  csq += b * K;
  a += b * N;
  m += b * N;
  const int n0 = blockIdx.x * kTileN;
  tile_argmin(x, c, csq, n0, N, K, d, sm, s_m, s_a);
  const int t = threadIdx.x;
  if (t < kTileN && n0 + t < N) {
    a[n0 + t] = s_a[t];
    m[n0 + t] = s_m[t];
  }
}

}  // namespace fk

extern "C" int fk_flash_assign(const void* x, const void* c, void* csq, void* a, void* m,
                               int B, int N, int K, int d, int is_bf16, void* stream) {
  using namespace fk;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kTileN - 1) / kTileN, B);
  cudaError_t e;
  if (is_bf16) {
    const __nv_bfloat16* cb = (const __nv_bfloat16*)c;
    e = launch_csq_bf16(cb, (float*)csq, (long long)B * K, d, s);
    if (e != cudaSuccess) return (int)e;
    flash_assign_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, cb, (const float*)csq, (int*)a, (float*)m, N, K, d);
  } else {
    const float* cf = (const float*)c;
    e = launch_csq_f32(cf, (float*)csq, (long long)B * K, d, s);
    if (e != cudaSuccess) return (int)e;
    flash_assign_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, cf, (const float*)csq, (int*)a, (float*)m, N, K, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int fk_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
