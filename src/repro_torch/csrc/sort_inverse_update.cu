// Sort-inverse centroid update for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sort_inverse_update.py, sort_inverse_update_raw /
// _sort_inverse_kernel, with its tile-pair prologue build_tile_pairs (the TPU's
// block-sparse onehot^T @ x_sorted). This is the paper's GPU form instead.
//
// Input: the stable sort of the assignment vector, as ids_sorted (cluster ids in
// ascending order) and sorted_idx (the point each id came from). Each CTA takes a
// contiguous chunk of the sorted order and gathers the rows x[sorted_idx[i]] itself
// (no x_sorted copy is written).
//
// What bounds it on the H100: bytes (N d itemsize read once, no flops to speak of) at
// large N; at small N (65,536 rows) the latency of the dependent gathers. The design:
//
// - A worker is a group of G lanes (G = the power of two covering the row's 16-byte
//   vectors, at most 32) that owns whole rows: each lane loads 16 bytes (4 f32 or 8
//   bf16 columns) of a row, VPL of them when the row is wider than 32 vectors, and the
//   feature axis is walked in slabs of G * VPL vectors. At d = 128 a warp covers one f32
//   row, or two bf16 rows with 16 lanes each. A d that is not a multiple of the vector,
//   or an unaligned x, takes the scalar path (one element a load).
// - Each worker walks its own contiguous share of the chunk and keeps kRows gathered
//   rows in flight before it adds them, so the SM holds many independent loads.
// - A segment (one cluster id) that starts and ends inside a worker's share is written
//   with plain stores. The first and last segment of each worker go to shared memory,
//   where the workers that share a segment add their partials. The combined segment is
//   written with plain stores, unless it is the chunk's first or last segment and its
//   id continues into the neighbouring chunk: only those use atomicAdd, so there are
//   at most 2 atomics per CTA per column.
// - The outputs are one allocation, sums (S, d) then counts (S,), zeroed by one
//   cudaMemsetAsync here; clusters no point belongs to stay exactly 0.
//
// Sums are fp32 in registers, in another order than the plain version's, so a check
// holds them to 2 n u sum|x|; counts are exact (float of an int run, below 2^24).
//
// Layout: x (R, d) row-major float32 or bfloat16; sorted_idx, ids_sorted int32 (R,);
// out = sums (S, d) then counts (S,) float32, S > max id. For a batch of problems the
// caller offsets ids by b * K and flattens the points, so one launch covers every
// problem. Grid ceil(R / chunk), `threads` threads (a multiple of 32).
#include "common.cuh"

namespace fk {
namespace siu {

constexpr int kRows = 8;  // gathered rows in flight per worker

template <typename T, int V> struct VecOf;
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<__nv_bfloat16, 8> { using type = uint4; };
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

__device__ __forceinline__ void widen(const float4& v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void widen(const uint4& v, float (&o)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {  // bf16 -> f32 is exact: the bf16 bits are the top half
    o[2 * h] = __uint_as_float(w[h] << 16);
    o[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(float v, float (&o)[1]) { o[0] = v; }
__device__ __forceinline__ void widen(__nv_bfloat16 v, float (&o)[1]) {
  o[0] = __bfloat162float(v);
}

// The worker's sums of one segment over this lane's columns, to `dst` (a row of S x d
// floats, or a shared slot of SC floats indexed by the slab-local column).
template <int V, int VPL>
__device__ __forceinline__ void put_row(float* dst, const int (&col)[VPL],
                                        const bool (&live)[VPL], const float (&acc)[VPL][V]) {
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    if (!live[v]) continue;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + col[v] + e) =
            make_float4(acc[v][e], acc[v][e + 1], acc[v][e + 2], acc[v][e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[col[v] + e] = acc[v][e];
    }
  }
}

// Minimum resident CTAs per SM that each layout's register cap allows (the planner's
// model, core/heuristics.py UPDATE_MIN_BLOCKS).
template <int VPL> struct MinBlocks { static constexpr int value = VPL == 1 ? 3 : (VPL == 2 ? 2 : 1); };

template <typename T, int V, int VPL>
__global__ void __launch_bounds__(256, MinBlocks<VPL>::value)
    sort_inverse_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                        const int* __restrict__ ids, float* __restrict__ sums,
                        float* __restrict__ cnt, long long R, int d, int chunk, int G) {
  using VT = typename VecOf<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nworkers = blockDim.x / G;
  const int E = 2 * nworkers;  // boundary slots: each worker's first and last segment
  const int SC = G * VPL * V;  // columns per slab
  float* s_bsum = reinterpret_cast<float*>(smem);  // E x SC partial sums
  int* s_ids = reinterpret_cast<int*>(s_bsum + (size_t)E * SC);
  int* s_idx = s_ids + chunk;
  int* s_bid = s_idx + chunk;  // E slot ids, -1 when empty
  int* s_bcnt = s_bid + E;     // E slot row counts
  int* s_edge = s_bcnt + E;    // [0]: the first segment continues in the previous chunk

  const long long start = (long long)blockIdx.x * chunk;
  const int len = (int)((R - start) < chunk ? (R - start) : chunk);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_ids[i] = ids[start + i];
    s_idx[i] = idx[start + i];
  }
  if (threadIdx.x == 0) {
    s_edge[0] = start > 0 && ids[start - 1] == ids[start];
    s_edge[1] = start + len < R && ids[start + len] == ids[start + len - 1];
  }
  __syncthreads();
  const int first_id = s_ids[0], last_id = s_ids[len - 1];
  const bool first_atomic = s_edge[0] != 0, last_atomic = s_edge[1] != 0;
  const int worker = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int share = (len + nworkers - 1) / nworkers;
  const int r0 = min(len, worker * share), r1 = min(len, r0 + share);

  for (int col0 = 0; col0 < d; col0 += SC) {
    int col[VPL], scol[VPL];  // global column, slab-local column of each vector
    bool live[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      scol[v] = (v * G + lane_g) * V;
      col[v] = col0 + scol[v];
      live[v] = col[v] < d;
    }
    float acc[VPL][V];
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[v][e] = 0.f;
    int cur = r0 < r1 ? s_ids[r0] : -1, run = 0;
    bool first = true;
    for (int i = r0; i < r1; i += kRows) {
      VT buf[kRows][VPL];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (i + u < r1) {
          const T* row = x + (size_t)s_idx[i + u] * d;
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            if (live[v]) buf[u][v] = *reinterpret_cast<const VT*>(row + col[v]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (i + u >= r1) break;
        const int id = s_ids[i + u];
        if (id != cur) {  // a segment ends inside this worker's share
          if (first) {
            put_row<V, VPL>(s_bsum + (size_t)(2 * worker) * SC, scol, live, acc);
            if (lane_g == 0) {
              s_bid[2 * worker] = cur;
              s_bcnt[2 * worker] = run;
            }
            first = false;
          } else {  // wholly inside the share: nobody else writes it
            put_row<V, VPL>(sums + (size_t)cur * d + col0, scol, live, acc);
            if (col0 == 0 && lane_g == 0) cnt[cur] = (float)run;
          }
          cur = id;
          run = 0;
#pragma unroll
          for (int v = 0; v < VPL; ++v)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[v][e] = 0.f;
        }
        ++run;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          if (!live[v]) continue;
          float f[V];
          widen(buf[u][v], f);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[v][e] += f[e];
        }
      }
    }
    // the share's last segment (its only one when `first` still holds)
    const int slot = 2 * worker + (first ? 0 : 1);
    if (r0 < r1) put_row<V, VPL>(s_bsum + (size_t)slot * SC, scol, live, acc);
    if (lane_g == 0) {
      s_bid[slot] = r0 < r1 ? cur : -1;
      s_bcnt[slot] = run;
      if (first) s_bid[2 * worker + 1] = -1;
    }
    __syncthreads();
    // Combine the slots: entries are in ascending id order; the first slot of each id
    // adds up the run of slots with that id, column by column.
    for (int t = threadIdx.x; t < E * SC; t += blockDim.x) {
      const int e = t / SC, c = t - e * SC;
      const int id = s_bid[e];
      if (id < 0) continue;
      int p = e - 1;
      while (p >= 0 && s_bid[p] < 0) --p;
      if (p >= 0 && s_bid[p] == id) continue;  // not the first slot of its id
      float s = 0.f;
      int n = 0;
      for (int q = e; q < E; ++q) {
        const int qid = s_bid[q];
        if (qid < 0) continue;
        if (qid != id) break;
        s += s_bsum[(size_t)q * SC + c];
        n += s_bcnt[q];
      }
      const bool atomic = (id == first_id && first_atomic) || (id == last_id && last_atomic);
      const int gc = col0 + c;
      if (gc < d) {
        float* dst = sums + (size_t)id * d + gc;
        if (atomic) atomicAdd(dst, s);
        else *dst = s;
      }
      if (col0 == 0 && c == 0) {
        if (atomic) atomicAdd(cnt + id, (float)n);
        else cnt[id] = (float)n;
      }
    }
    __syncthreads();  // the next slab reuses the slots
  }
}

// The launch's layout: V elements a load, G lanes a worker, VPL loads a lane per slab.
struct Layout {
  int V, G, VPL;
};

inline Layout layout_for(int d, bool is_bf16, bool aligned) {
  const int vw = is_bf16 ? 8 : 4;
  const int V = (d % vw == 0 && aligned) ? vw : 1;
  const int nvec = d / V;
  int G = 1;
  while (G < nvec && G < 32) G <<= 1;
  const int VPL = nvec <= 32 ? 1 : (nvec <= 64 ? 2 : 4);
  return {V, G, VPL};
}

inline size_t smem_bytes(const Layout& L, int chunk, int threads) {
  const size_t E = 2 * (size_t)(threads / L.G);
  return E * L.G * L.VPL * L.V * sizeof(float) + (2 * (size_t)chunk + 2 * E + 2) * sizeof(int);
}

template <typename T, int V, int VPL>
cudaError_t launch(const void* x, const void* idx, const void* ids, float* sums, float* cnt,
                   long long R, int d, int chunk, int threads, int G, size_t smem,
                   cudaStream_t s) {
  auto kernel = sort_inverse_kernel<T, V, VPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (R + chunk - 1) / chunk;
  kernel<<<(unsigned)blocks, threads, smem, s>>>((const T*)x, (const int*)idx, (const int*)ids,
                                                 sums, cnt, R, d, chunk, G);
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t dispatch(const Layout& L, const void* x, const void* idx, const void* ids,
                     float* sums, float* cnt, long long R, int d, int chunk, int threads,
                     size_t smem, cudaStream_t s) {
  if (L.V == VW) {
    switch (L.VPL) {
      case 1: return launch<T, VW, 1>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
      case 2: return launch<T, VW, 2>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
      default: return launch<T, VW, 4>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
    }
  }
  switch (L.VPL) {
    case 1: return launch<T, 1, 1>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
    case 2: return launch<T, 1, 2>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
    default: return launch<T, 1, 4>(x, idx, ids, sums, cnt, R, d, chunk, threads, L.G, smem, s);
  }
}

}  // namespace siu
}  // namespace fk

// out: S * d sums then S counts (float32), zeroed here. threads: a multiple of 32.
extern "C" int fk_sort_inverse_update(const void* x, const void* sorted_idx,
                                      const void* ids_sorted, void* out, long long R, int d,
                                      int S, int chunk, int threads, int is_bf16,
                                      void* stream) {
  using namespace fk::siu;
  cudaStream_t s = (cudaStream_t)stream;
  float* sums = (float*)out;
  float* cnt = sums + (size_t)S * d;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)S * (d + 1) * sizeof(float), s);
  if (e != cudaSuccess || R <= 0) return (int)e;
  const Layout L = layout_for(d, is_bf16 != 0, ((uintptr_t)x & 15) == 0);
  const size_t smem = smem_bytes(L, chunk, threads);
  e = is_bf16 ? dispatch<__nv_bfloat16, 8>(L, x, sorted_idx, ids_sorted, sums, cnt, R, d, chunk,
                                          threads, smem, s)
              : dispatch<float, 4>(L, x, sorted_idx, ids_sorted, sums, cnt, R, d, chunk,
                                   threads, smem, s);
  return (int)e;
}

// The dynamic shared memory and the layout (V, G, VPL) of a launch, for the planner's
// model (core/heuristics.py update_footprint) and chip_smoke.py.
extern "C" int fk_sort_inverse_layout(int d, int chunk, int threads, int is_bf16, int aligned,
                                      int* out) {
  using namespace fk::siu;
  const Layout L = layout_for(d, is_bf16 != 0, aligned != 0);
  out[0] = (int)smem_bytes(L, chunk, threads);
  out[1] = L.V;
  out[2] = L.G;
  out[3] = L.VPL;
  return 0;
}
