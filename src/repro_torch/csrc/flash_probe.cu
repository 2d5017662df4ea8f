// FlashProbe for Hopper (sm_90a): fused distance + online top-L selection.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/flash_probe.py:
//   flash_probe_raw            (_flash_probe_kernel, l.73)            -> flash_probe_kernel
//   flash_probe_grouped_raw    (_flash_probe_grouped_kernel, l.116)   -> flash_probe_grouped_kernel
//   flash_probe_grouped_q8_raw (_flash_probe_grouped_q8_kernel, l.157) -> flash_probe_grouped_q8_kernel
//
// Each returns, for every query b, the L candidates of smallest score in ascending
// (score, index) order, where index is the position on the candidate axis: a centroid
// k (probe), a row of the query's own gathered block (grouped), or p * W + w over the
// flattened probe-rank-major (nprobe, W) axis (q8). Equal scores go to the lower index,
// as lax.top_k. Scores keep the reference's expanded forms:
//   probe:   ||c||^2 - 2 q.c          (||c||^2 passed in as csq)
//   grouped: ||c||^2 - 2 q.c          (both sums taken here, in fp32)
//   q8:      ||q'||^2 - 2 q'.r + ||r||^2 with r = float(code) * s, +inf where s <= 0
// bf16 and int8 inputs widen to fp32 on load; every sum is fp32.
//
// Design. Grid (B, S): CTA (b, s) scans chunk s of query b's candidates. A group of G
// lanes (G = the power of two covering d / 16 bytes, at most 32) scores one candidate
// row with 16-byte loads along d, reduced by shuffles; any d works (rows whose d is not
// a multiple of the vector width, or unaligned pointers, take a scalar path). A row is
// kept only if its (score, index) is below the CTA's current L-th entry, by a strict
// lexicographic compare; survivors go to a shared buffer. Every kTile rows the buffer
// is bitonic-sorted and merged into the running list by ranks: an entry's place in the
// merged list is its own rank plus the count of smaller entries in the other list
// (binary search), so the merge is exact for any L and needs no sequential pass. The
// running list lives in shared memory while its length is at most kListSmemMax, and in
// a global scratch buffer the wrapper allocates beyond that. With S > 1 a second
// kernel, topl_merge_kernel, merges each query's S sorted partial lists the same way.
// Tiles are swept in index order, but order does not matter: (score, index) is a total
// order, so the top-L set and its order are those of a stable sort of all scores.
//
// What bounds it on the H100: bytes. The grouped kernels read a per-query candidate
// block that no other query shares (B * C * d * 4 bytes in fp32, C * (d + 4) per query
// in q8), once, with streaming 16-byte loads; scoring costs 2 d flops per row, far below
// the fp32 rate per byte. Selection touches only the few rows that beat the running
// L-th entry. The probe kernel at the IVF shape (B = 256 queries, K = 1024) moves about
// 0.6 MB and is bound by its launch, not tuned here.
#include "common.cuh"

namespace fk {
namespace probe {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;          // __launch_bounds__: at most 64 registers a thread
constexpr int kTile = 1024;            // candidate rows per selection round
constexpr int kListSmemMax = 2048;     // longest running list kept in shared memory
constexpr int kHead = 16 + kTile * 8;  // survivor counter + survivor buffer (v, i)
constexpr int kSentinel = 0x7fffffff;  // index of the empty list entry (+inf, kSentinel)

extern __shared__ __align__(16) unsigned char smem[];

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ bool key_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Entries of the sorted list (v, ix)[0, n) that come before the key: strictly smaller
// (kStrict) or not larger.
template <bool kStrict>
__device__ __forceinline__ int count_before(const float* v, const int* ix, int n, float kv,
                                            int ki) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = kStrict ? key_less(v[mid], ix[mid], kv, ki)
                                : !key_less(kv, ki, v[mid], ix[mid]);
    if (before) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// (ov, oi)[0, n_out) = the first n_out entries of the merge of two ascending lists; on
// equal keys a's entries come first. Needs na + nb >= n_out. All threads of the CTA
// call it; it holds no barrier.
__device__ void merge_lists(const float* av, const int* ai, int na, const float* bv,
                            const int* bi, int nb, float* ov, int* oi, int n_out) {
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    const float v = av[i];
    const int x = ai[i];
    const int r = i + count_before<true>(bv, bi, nb, v, x);
    if (r < n_out) {
      ov[r] = v;
      oi[r] = x;
    }
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const float v = bv[j];
    const int x = bi[j];
    const int r = j + count_before<false>(av, ai, na, v, x);
    if (r < n_out) {
      ov[r] = v;
      oi[r] = x;
    }
  }
}

// Ascending bitonic sort of n (a power of two) shared entries; ends with a barrier.
__device__ void bitonic_sort(float* v, int* ix, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int p = t ^ j;
        if (p > t) {
          const float tv = v[t], pv = v[p];
          const int ti = ix[t], pi = ix[p];
          const bool up = (t & k) == 0;
          if (up ? key_less(pv, pi, tv, ti) : key_less(tv, ti, pv, pi)) {
            v[t] = pv;
            v[p] = tv;
            ix[t] = pi;
            ix[p] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte vector loads, widened to fp32. kStream marks data read once (the per-query
// candidate blocks): it goes around L1 (__ldcs); data that other rows or queries read
// again (queries, shared centroids) goes through it (__ldg).
template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { using V = uint4; static constexpr int N = 8; };
template <> struct Vec16<int8_t> { using V = int4; static constexpr int N = 16; };

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&o)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {  // bf16 -> f32 is exact: the bf16 bits are the top half
    o[2 * h] = __uint_as_float(w[h] << 16);
    o[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const int4& v, float (&o)[16]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * h + e] = (float)(int8_t)(w[h] >> (8 * e));
}

template <typename T, bool kStream>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[Vec16<T>::N]) {
  using V = typename Vec16<T>::V;
  const V* vp = reinterpret_cast<const V*>(p);
  V v;
  if constexpr (kStream) v = __ldcs(vp);
  else v = __ldg(vp);
  unpack(v, o);
}

// ---- the three scorers: each returns the row's score on every lane of its group -----

template <typename T, bool kVec>
struct ProbeRow {  // kernel 4: centroids shared by every query
  const T* q;      // (N, d)
  const T* c;      // (K, d)
  const float* csq;  // (K,)
  int d;
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    float dot = 0.f;
    if (valid) {
      const T* qr = q + (size_t)b * d;
      const T* cr = c + (size_t)idx * d;
      if constexpr (kVec) {
        constexpr int V = Vec16<T>::N;
        for (int j = lane_g * V; j < d; j += g * V) {
          float cv[V], qv[V];
          load_vec<T, false>(cr + j, cv);
          load_vec<T, false>(qr + j, qv);
#pragma unroll
          for (int e = 0; e < V; ++e) dot = fmaf(qv[e], cv[e], dot);
        }
      } else {
        for (int j = lane_g; j < d; j += g) dot = fmaf(to_f32(qr[j]), to_f32(cr[j]), dot);
      }
    }
    dot = group_sum(dot, g);
    return valid ? csq[idx] - 2.f * dot : 0.f;
  }
};

template <typename T, bool kVec>
struct GroupedRow {  // kernel 5: each query against its own candidate block
  const T* q;        // (B, d)
  const T* c;        // (B, C, d)
  int C, d;
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    float dot = 0.f, sq = 0.f;
    if (valid) {
      const T* qr = q + (size_t)b * d;
      const T* cr = c + ((size_t)b * C + idx) * d;
      if constexpr (kVec) {
        constexpr int V = Vec16<T>::N;
        for (int j = lane_g * V; j < d; j += g * V) {
          float cv[V], qv[V];
          load_vec<T, true>(cr + j, cv);
          load_vec<T, false>(qr + j, qv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            sq = fmaf(cv[e], cv[e], sq);
            dot = fmaf(qv[e], cv[e], dot);
          }
        }
      } else {
        for (int j = lane_g; j < d; j += g) {
          const float cv = to_f32(cr[j]);
          sq = fmaf(cv, cv, sq);
          dot = fmaf(to_f32(qr[j]), cv, dot);
        }
      }
    }
    dot = group_sum(dot, g);
    sq = group_sum(sq, g);
    return sq - 2.f * dot;
  }
};

template <bool kVec>
struct Q8Row {          // kernel 6: int8 residual codes, dequantized in registers
  const float* qp;      // (B, P, d) per-probe shifted queries q - anchor[cell]
  const int8_t* codes;  // (B, P * W, d)
  const float* scales;  // (B, P * W), 0 on empty slots
  const float* qsq;     // (B, P) ||q'||^2
  int P, W, d;
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    const size_t row = (size_t)b * P * W + idx;
    const int p = idx / W;
    const float s = valid ? __ldcs(scales + row) : 0.f;  // one address for the group
    float cross = 0.f, rsq = 0.f;
    if (s > 0.f) {  // empty slots cost one 4-byte read
      const float* qr = qp + ((size_t)b * P + p) * d;
      const int8_t* cr = codes + row * d;
      if constexpr (kVec) {
        for (int j = lane_g * 16; j < d; j += g * 16) {
          float cv[16], qv[16];
          load_vec<int8_t, true>(cr + j, cv);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            float f[4];
            load_vec<float, false>(qr + j + 4 * h, f);
#pragma unroll
            for (int e = 0; e < 4; ++e) qv[4 * h + e] = f[e];
          }
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float r = cv[e] * s;
            cross = fmaf(qv[e], r, cross);
            rsq = fmaf(r, r, rsq);
          }
        }
      } else {
        for (int j = lane_g; j < d; j += g) {
          const float r = to_f32(cr[j]) * s;
          cross = fmaf(qr[j], r, cross);
          rsq = fmaf(r, r, rsq);
        }
      }
    }
    cross = group_sum(cross, g);
    rsq = group_sum(rsq, g);
    if (!(s > 0.f)) return INFINITY;
    return qsq[(size_t)b * P + p] - 2.f * cross + rsq;
  }
};

// ---- selection --------------------------------------------------------------------

// Top-lp of rows [c0, c1) of query b into out (lp entries, ascending). The running list
// is (lv0, li0) / (lv1, li1), double-buffered; rows past c1 never enter.
template <class Row>
__device__ void scan_topl(const Row& row, int b, int c0, int c1, int lp, int g, float* lv0,
                          int* li0, float* lv1, int* li1, float* out_v, int* out_i) {
  int* s_count = reinterpret_cast<int*>(smem);
  float* buf_v = reinterpret_cast<float*>(smem + 16);
  int* buf_i = reinterpret_cast<int*>(smem + 16 + kTile * 4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane_g = lane & (g - 1), grp = lane / g, rpw = 32 / g;
  for (int i = tid; i < lp; i += blockDim.x) {
    lv0[i] = INFINITY;
    li0[i] = kSentinel;
  }
  if (tid == 0) *s_count = 0;
  __syncthreads();
  float *av = lv0, *bv = lv1;
  int *ai = li0, *bi = li1;
  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int nt = min(kTile, c1 - t0);
    const float tv = av[lp - 1];  // the current L-th entry: rows must beat it
    const int ti = ai[lp - 1];
    for (int base = warp * rpw; base < nt; base += nwarps * rpw) {  // uniform per warp
      const int r = base + grp;
      const bool valid = r < nt;
      const int idx = t0 + r;
      const float s = row(b, idx, valid, lane_g, g);
      if (valid && lane_g == 0 && key_less(s, idx, tv, ti)) {
        const int pos = atomicAdd(s_count, 1);
        buf_v[pos] = s;
        buf_i[pos] = idx;
      }
    }
    __syncthreads();
    const int m = *s_count;
    __syncthreads();
    if (m > 0) {  // uniform: every thread read the same count
      int n2 = 1;
      while (n2 < m) n2 <<= 1;
      for (int i = m + tid; i < n2; i += blockDim.x) {
        buf_v[i] = INFINITY;
        buf_i[i] = kSentinel;
      }
      if (tid == 0) *s_count = 0;
      __syncthreads();
      bitonic_sort(buf_v, buf_i, n2);
      merge_lists(av, ai, lp, buf_v, buf_i, m, bv, bi, lp);
      __syncthreads();
      float* tf = av;
      av = bv;
      bv = tf;
      int* tx = ai;
      ai = bi;
      bi = tx;
    }
  }
  for (int i = tid; i < lp; i += blockDim.x) {
    out_v[i] = av[i];
    out_i[i] = ai[i];
  }
}

// CTA (b, s): rows [s * chunk, min(C, (s + 1) * chunk)) of query b, partial list of lp
// entries at part[(b * S + s) * lp]. lws == nullptr: the running list is in shared
// memory after the survivor buffer; else it is 2 * lp entries of lws per CTA.
template <class Row>
__device__ void run_stage1(const Row& row, int C, int lp, int chunk, int g, float* part_v,
                           int* part_i, float* lws_v, int* lws_i) {
  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int c0 = s * chunk;
  const int c1 = min(C, c0 + chunk);
  float *lv0, *lv1;
  int *li0, *li1;
  if (lws_v == nullptr) {
    unsigned char* p = smem + kHead;
    lv0 = reinterpret_cast<float*>(p);
    li0 = reinterpret_cast<int*>(p + 4 * (size_t)lp);
    lv1 = reinterpret_cast<float*>(p + 8 * (size_t)lp);
    li1 = reinterpret_cast<int*>(p + 12 * (size_t)lp);
  } else {
    const size_t off = ((size_t)b * S + s) * 2 * lp;
    lv0 = lws_v + off;
    lv1 = lv0 + lp;
    li0 = lws_i + off;
    li1 = li0 + lp;
  }
  const size_t o = ((size_t)b * S + s) * lp;
  scan_topl(row, b, c0, c1, lp, g, lv0, li0, lv1, li1, part_v + o, part_i + o);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_probe_kernel(const T* q, const T* c, const float* csq, int K, int d, int lp,
                       int chunk, int g, float* pv, int* pi, float* lv, int* li) {
  run_stage1(ProbeRow<T, kVec>{q, c, csq, d}, K, lp, chunk, g, pv, pi, lv, li);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_probe_grouped_kernel(const T* q, const T* c, int C, int d, int lp, int chunk,
                               int g, float* pv, int* pi, float* lv, int* li) {
  run_stage1(GroupedRow<T, kVec>{q, c, C, d}, C, lp, chunk, g, pv, pi, lv, li);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_probe_grouped_q8_kernel(const float* qp, const int8_t* codes, const float* scales,
                                  const float* qsq, int P, int W, int d, int lp, int chunk,
                                  int g, float* pv, int* pi, float* lv, int* li) {
  run_stage1(Q8Row<kVec>{qp, codes, scales, qsq, P, W, d}, P * W, lp, chunk, g, pv, pi, lv,
             li);
}

// Query b = blockIdx.x: merge its S partial lists of lp entries into the top L.
// mws == nullptr: the list is in shared memory (16 * L bytes); else 2 * L entries of mws.
__global__ void __launch_bounds__(kThreads)
    topl_merge_kernel(const float* pv, const int* pi, int S, int lp, int L, float* mws_v,
                      int* mws_i, float* out_v, int* out_i) {
  const int b = blockIdx.x;
  float *av, *bv;
  int *ai, *bi;
  if (mws_v == nullptr) {
    av = reinterpret_cast<float*>(smem);
    ai = reinterpret_cast<int*>(smem + 4 * (size_t)L);
    bv = reinterpret_cast<float*>(smem + 8 * (size_t)L);
    bi = reinterpret_cast<int*>(smem + 12 * (size_t)L);
  } else {
    av = mws_v + (size_t)b * 2 * L;
    bv = av + L;
    ai = mws_i + (size_t)b * 2 * L;
    bi = ai + L;
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    av[i] = INFINITY;
    ai[i] = kSentinel;
  }
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const float* sv = pv + ((size_t)b * S + s) * lp;
    const int* si = pi + ((size_t)b * S + s) * lp;
    if (key_less(sv[0], si[0], av[L - 1], ai[L - 1])) {  // same values on every thread
      merge_lists(av, ai, L, sv, si, lp, bv, bi, L);
      __syncthreads();
      float* tf = av;
      av = bv;
      bv = tf;
      int* tx = ai;
      ai = bi;
      bi = tx;
    }
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    out_v[(size_t)b * L + i] = av[i];
    out_i[(size_t)b * L + i] = ai[i];
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Lanes per row: the power of two covering the row's vectors (or scalars), at most 32.
inline int group_lanes(int units) {
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  return g;
}

inline size_t stage1_smem(int lp, const void* lws) {
  return kHead + (lws == nullptr ? (size_t)16 * lp : 0);
}

// The second pass, when the candidate axis was split.
inline cudaError_t merge_partials(int B, int S, int lp, int L, const void* pv, const void* pi,
                                  void* mws_v, void* mws_i, void* out_v, void* out_i,
                                  cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  const size_t sm = mws_v == nullptr ? (size_t)16 * L : 0;
  topl_merge_kernel<<<B, kThreads, sm, st>>>((const float*)pv, (const int*)pi, S, lp, L,
                                             (float*)mws_v, (int*)mws_i, (float*)out_v,
                                             (int*)out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe(const void* q, const void* c, const void* csq, int N, int K, int d,
                         int lp, int S, int chunk, void* pv, void* pi, void* lv, void* li,
                         cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  const bool vec = d % V == 0 && aligned16(q) && aligned16(c);
  const int g = group_lanes(vec ? d / V : d);
  const dim3 grid(N, S);
  const size_t sm = stage1_smem(lp, lv);
  auto kernel = vec ? flash_probe_kernel<T, true> : flash_probe_kernel<T, false>;
  kernel<<<grid, kThreads, sm, st>>>((const T*)q, (const T*)c, (const float*)csq, K, d, lp,
                                     chunk, g, (float*)pv, (int*)pi, (float*)lv, (int*)li);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grouped(const void* q, const void* c, int B, int C, int d, int lp, int S,
                           int chunk, void* pv, void* pi, void* lv, void* li,
                           cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  const bool vec = d % V == 0 && aligned16(q) && aligned16(c);
  const int g = group_lanes(vec ? d / V : d);
  const dim3 grid(B, S);
  const size_t sm = stage1_smem(lp, lv);
  auto kernel = vec ? flash_probe_grouped_kernel<T, true> : flash_probe_grouped_kernel<T, false>;
  kernel<<<grid, kThreads, sm, st>>>((const T*)q, (const T*)c, C, d, lp, chunk, g, (float*)pv,
                                     (int*)pi, (float*)lv, (int*)li);
  return cudaGetLastError();
}

}  // namespace probe
}  // namespace fk

// Every entry point: outputs out_v f32 (B, L) and out_i int32 (B, L). S CTAs per query
// each scan `chunk` candidates into a partial list of lp = min(L, chunk) entries at
// part (B, S, lp); with S == 1 part must be the outputs themselves. lws (B * S * 2 * lp
// entries) holds the running lists when lp > kListSmemMax, else nullptr; mws (B * 2 * L)
// the merge's lists when S > 1 and L > kListSmemMax, else nullptr.

extern "C" int fk_flash_probe(const void* q, const void* c, const void* csq, void* out_v,
                              void* out_i, void* part_v, void* part_i, void* lws_v,
                              void* lws_i, void* mws_v, void* mws_i, int N, int K, int d,
                              int L, int S, int chunk, int lp, int is_bf16, void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      is_bf16 ? launch_probe<__nv_bfloat16>(q, c, csq, N, K, d, lp, S, chunk, part_v, part_i,
                                            lws_v, lws_i, st)
              : launch_probe<float>(q, c, csq, N, K, d, lp, S, chunk, part_v, part_i, lws_v,
                                    lws_i, st);
  if (e != cudaSuccess) return (int)e;
  return (int)merge_partials(N, S, lp, L, part_v, part_i, mws_v, mws_i, out_v, out_i, st);
}

extern "C" int fk_flash_probe_grouped(const void* q, const void* c, void* out_v, void* out_i,
                                      void* part_v, void* part_i, void* lws_v, void* lws_i,
                                      void* mws_v, void* mws_i, int B, int C, int d, int L,
                                      int S, int chunk, int lp, int is_bf16, void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      is_bf16 ? launch_grouped<__nv_bfloat16>(q, c, B, C, d, lp, S, chunk, part_v, part_i,
                                              lws_v, lws_i, st)
              : launch_grouped<float>(q, c, B, C, d, lp, S, chunk, part_v, part_i, lws_v,
                                      lws_i, st);
  if (e != cudaSuccess) return (int)e;
  return (int)merge_partials(B, S, lp, L, part_v, part_i, mws_v, mws_i, out_v, out_i, st);
}

// qsq: workspace of B * P floats for ||q'||^2, written by a prologue kernel.
extern "C" int fk_flash_probe_grouped_q8(const void* qp, const void* codes, const void* scales,
                                         void* qsq, void* out_v, void* out_i, void* part_v,
                                         void* part_i, void* lws_v, void* lws_i, void* mws_v,
                                         void* mws_i, int B, int P, int W, int d, int L, int S,
                                         int chunk, int lp, void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = fk::launch_csq_f32((const float*)qp, (float*)qsq, (long long)B * P, d, st);
  if (e != cudaSuccess) return (int)e;
  const bool vec = d % 16 == 0 && aligned16(qp) && aligned16(codes);
  const int g = group_lanes(vec ? d / 16 : d);
  const dim3 grid(B, S);
  const size_t sm = stage1_smem(lp, lws_v);
  auto kernel = vec ? flash_probe_grouped_q8_kernel<true> : flash_probe_grouped_q8_kernel<false>;
  kernel<<<grid, kThreads, sm, st>>>((const float*)qp, (const int8_t*)codes,
                                     (const float*)scales, (const float*)qsq, P, W, d, lp, chunk,
                                     g, (float*)part_v, (int*)part_i, (float*)lws_v,
                                     (int*)lws_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)merge_partials(B, S, lp, L, part_v, part_i, mws_v, mws_i, out_v, out_i, st);
}

// Register and local-memory use of one kernel, for the planner's register model.
extern "C" int fk_flash_probe_attrs(int which, int* regs, int* local_bytes) {
  using namespace fk::probe;
  cudaFuncAttributes a;
  cudaError_t e;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&a, flash_probe_kernel<float, true>); break;
    case 1: e = cudaFuncGetAttributes(&a, flash_probe_grouped_kernel<float, true>); break;
    case 2: e = cudaFuncGetAttributes(&a, flash_probe_grouped_q8_kernel<true>); break;
    default: e = cudaFuncGetAttributes(&a, topl_merge_kernel); break;
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
