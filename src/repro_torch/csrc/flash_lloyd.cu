// FlashLloyd for Hopper (sm_90a): one Lloyd iteration's statistics in one pass.
//
// Replaces: src/repro/kernels/flash_lloyd.py, flash_lloyd_raw / _flash_lloyd_kernel
// (the Pallas TPU kernel that keeps the (K_pad, d) sums resident in VMEM across
// its sequential grid).
//
// Computes the assignments a (as FlashAssign), the per-cluster sums (K, d) and
// counts (K,), and the inertia sum_n max(m_n + ||x_n||^2, 0), reading x once. A
// GPU has no buffer that lives across CTAs, so the grid is persistent: a few CTAs
// (about one per SM) stride over the point tiles, and each holds its own (K, d)
// sums and (K,) counts in dynamic shared memory. Per tile: the FlashAssign argmin
// (tile_argmin, shared with flash_assign.cu), the assignments written out, then
// each row added into the shared sums with shared-memory atomics while its
// ||x||^2 is summed for the inertia. At the end every CTA flushes its non-zero
// sums and counts into the global outputs with one atomicAdd each and writes its
// inertia partial to inertia_part[b, blockIdx.x]; the wrapper sums the partials.
//
// What bounds it on the H100: operations, as FlashAssign (2 N K d fp32 flops over
// 67 TFLOP/s); the statistics add N d shared-memory atomics and G K d global ones
// (G CTAs). The constraint the two-pass path does not have is shared memory: the
// (K, d) f32 accumulator must fit one CTA's 227 KB (4 (K d + K) bytes plus the
// static stages), so the planner sends only small K d here (K <= ~430 at d = 128)
// and the wrapper refuses anything larger.
//
// Layout: x (B, N, d), c (B, K, d) float32 or bfloat16; a (B, N) int32; sums
// (B, K, d), counts (B, K), inertia_part (B, grid_x) float32, sums and counts
// zeroed by the caller. Grid (grid_x, B), 256 threads.
#include "common.cuh"

namespace fk {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_lloyd_kernel(const T* __restrict__ x, const T* __restrict__ c,
                       const float* __restrict__ csq, int* __restrict__ a,
                       float* __restrict__ sums, float* __restrict__ cnt,
                       float* __restrict__ inertia_part, int N, int K, int d) {
  extern __shared__ float s_acc[];  // K * d sums, then K counts
  __shared__ ArgminSmem sm;
  __shared__ float s_m[kTileN];
  __shared__ int s_a[kTileN];
  __shared__ float s_red[kThreads / 32];
  float* s_sums = s_acc;
  float* s_cnt = s_acc + (size_t)K * d;
  const long long b = blockIdx.y;
  x += b * N * (long long)d;
  c += b * K * (long long)d;
  csq += b * K;
  a += b * N;
  sums += b * K * (long long)d;
  cnt += b * K;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const long long acc_len = (long long)K * d + K;
  for (long long i = tid; i < acc_len; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  float inertia = 0.f;  // lane 0 of each warp accumulates its rows
  const int tiles = (N + kTileN - 1) / kTileN;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t * kTileN;
    tile_argmin(x, c, csq, n0, N, K, d, sm, s_m, s_a);  // ends with a barrier
    if (tid < kTileN && n0 + tid < N) a[n0 + tid] = s_a[tid];
    for (int r = warp; r < kTileN; r += kThreads / 32) {
      const int n = n0 + r;
      if (n >= N) break;  // uniform across the warp
      const int k = s_a[r];
      const T* row = x + (size_t)n * d;
      float* dst = s_sums + (size_t)k * d;
      float sq = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float v = to_f32(row[j]);
        atomicAdd(&dst[j], v);
        sq = fmaf(v, v, sq);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) {
        atomicAdd(&s_cnt[k], 1.f);
        inertia += fmaxf(s_m[r] + sq, 0.f);
      }
    }
    // The next tile_argmin starts with a barrier before it overwrites s_a / s_m.
  }
  if (lane == 0) s_red[warp] = inertia;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += s_red[w];
    inertia_part[b * gridDim.x + blockIdx.x] = total;
  }
  for (long long i = tid; i < (long long)K * d; i += kThreads) {
    const float v = s_sums[i];
    if (v != 0.f) atomicAdd(&sums[i], v);
  }
  for (int i = tid; i < K; i += kThreads) {
    const float v = s_cnt[i];
    if (v != 0.f) atomicAdd(&cnt[i], v);
  }
}

template <typename T>
cudaError_t launch_lloyd(const T* x, const T* c, float* csq, int* a, float* sums,
                         float* cnt, float* part, int B, int N, int K, int d, int grid_x,
                         cudaStream_t s) {
  const size_t dyn = ((size_t)K * d + K) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_lloyd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dyn);
  if (e != cudaSuccess) return e;
  flash_lloyd_kernel<T><<<dim3(grid_x, B), kThreads, dyn, s>>>(x, c, csq, a, sums, cnt,
                                                                part, N, K, d);
  return cudaGetLastError();
}

}  // namespace fk

extern "C" int fk_flash_lloyd(const void* x, const void* c, void* csq, void* a,
                              void* sums, void* cnt, void* inertia_part, int B, int N,
                              int K, int d, int grid_x, int is_bf16, void* stream) {
  using namespace fk;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    const __nv_bfloat16* cb = (const __nv_bfloat16*)c;
    e = launch_csq_bf16(cb, (float*)csq, (long long)B * K, d, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_lloyd<__nv_bfloat16>((const __nv_bfloat16*)x, cb, (float*)csq, (int*)a,
                                    (float*)sums, (float*)cnt, (float*)inertia_part, B,
                                    N, K, d, grid_x, s);
  } else {
    const float* cf = (const float*)c;
    e = launch_csq_f32(cf, (float*)csq, (long long)B * K, d, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_lloyd<float>((const float*)x, cf, (float*)csq, (int*)a, (float*)sums,
                            (float*)cnt, (float*)inertia_part, B, N, K, d, grid_x, s);
  }
  return (int)e;
}

// Static shared memory of the FlashLloyd kernel, for the caller's footprint audit.
extern "C" int fk_flash_lloyd_static_smem(int is_bf16, int* out) {
  using namespace fk;
  cudaFuncAttributes attr;
  cudaError_t e = is_bf16 ? cudaFuncGetAttributes(&attr, flash_lloyd_kernel<__nv_bfloat16>)
                          : cudaFuncGetAttributes(&attr, flash_lloyd_kernel<float>);
  if (e != cudaSuccess) return (int)e;
  *out = (int)attr.sharedSizeBytes;
  return 0;
}
