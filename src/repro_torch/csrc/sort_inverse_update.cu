// Sort-inverse centroid update for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sort_inverse_update.py, sort_inverse_update_raw /
// _sort_inverse_kernel, with its tile-pair prologue build_tile_pairs (the TPU's
// block-sparse onehot^T @ x_sorted). This is the paper's GPU form instead.
//
// Input: the stable sort of the assignment vector, as ids_sorted (cluster ids in
// ascending order) and sorted_idx (the point each id came from). Each CTA takes a
// contiguous chunk of the sorted order, gathers the rows x[sorted_idx[i]] itself
// (no x_sorted copy is written), and keeps one running segment sum per column in a
// register. It issues one global atomicAdd per (segment, column) when the cluster
// id changes or the chunk ends, plus one count atomic per segment. Clusters no
// point belongs to are never touched and stay exactly 0 (the caller zeroes sums
// and counts).
//
// What bounds it on the H100: bytes. Every row of x is read once (N d itemsize
// bytes) and there are no flops to speak of, so the floor is N d itemsize over
// 3.35 TB/s. The atomics are per segment, not per point: at most
// (N / chunk + K) d of them, against N d for a scatter. Each thread owns one
// column, so neighbouring threads read neighbouring addresses of the same row;
// the loop issues four row loads before it consumes them, to keep loads in flight.
//
// Layout: x (R, d) row-major float32 or bfloat16; sorted_idx, ids_sorted int32
// (R,); sums (S, d) and counts (S,) float32, S > max id. For a batch of problems
// the caller offsets ids by b * K and flattens the points, so one launch covers
// every problem. Grid ceil(R / chunk), blockDim threads (a multiple of 32) walk the
// columns, dynamic shared memory 2 * chunk int32.
#include "common.cuh"

namespace fk {

template <typename T>
__global__ void sort_inverse_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                    const int* __restrict__ ids, float* __restrict__ sums,
                                    float* __restrict__ cnt, long long R, int d,
                                    int chunk) {
  extern __shared__ int s_buf[];
  int* s_ids = s_buf;
  int* s_idx = s_buf + chunk;
  const long long start = (long long)blockIdx.x * chunk;
  const int len = (int)((R - start) < chunk ? (R - start) : chunk);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_ids[i] = ids[start + i];
    s_idx[i] = idx[start + i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    int cur = s_ids[0];
    float acc = 0.f;
    int run = 0;
    int i = 0;
    for (; i + 4 <= len; i += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = to_f32(x[(size_t)s_idx[i + u] * d + col]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int id = s_ids[i + u];
        if (id != cur) {
          atomicAdd(&sums[(size_t)cur * d + col], acc);
          if (col == 0) atomicAdd(&cnt[cur], (float)run);
          cur = id;
          acc = 0.f;
          run = 0;
        }
        acc += v[u];
        ++run;
      }
    }
    for (; i < len; ++i) {
      const float v = to_f32(x[(size_t)s_idx[i] * d + col]);
      const int id = s_ids[i];
      if (id != cur) {
        atomicAdd(&sums[(size_t)cur * d + col], acc);
        if (col == 0) atomicAdd(&cnt[cur], (float)run);
        cur = id;
        acc = 0.f;
        run = 0;
      }
      acc += v;
      ++run;
    }
    atomicAdd(&sums[(size_t)cur * d + col], acc);
    if (col == 0) atomicAdd(&cnt[cur], (float)run);
  }
}

}  // namespace fk

extern "C" int fk_sort_inverse_update(const void* x, const void* sorted_idx,
                                      const void* ids_sorted, void* sums, void* cnt,
                                      long long R, int d, int chunk, int threads,
                                      int is_bf16, void* stream) {
  using namespace fk;
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (R + chunk - 1) / chunk;
  const size_t smem = 2 * (size_t)chunk * sizeof(int);
  if (is_bf16) {
    sort_inverse_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, s>>>(
        (const __nv_bfloat16*)x, (const int*)sorted_idx, (const int*)ids_sorted,
        (float*)sums, (float*)cnt, R, d, chunk);
  } else {
    sort_inverse_kernel<float><<<(unsigned)blocks, threads, smem, s>>>(
        (const float*)x, (const int*)sorted_idx, (const int*)ids_sorted, (float*)sums,
        (float*)cnt, R, d, chunk);
  }
  return (int)cudaGetLastError();
}
