// FlashProbe for Hopper (sm_90a): fused distance + online top-L selection.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/flash_probe.py:
//   flash_probe_raw            (_flash_probe_kernel, l.73)            -> flash_probe_tile_kernel
//                                                                        (lists of at most 64),
//                                                                        flash_probe_kernel
//   flash_probe_grouped_raw    (_flash_probe_grouped_kernel, l.116)   -> flash_probe_grouped_warp_kernel
//                                                                        (lists of at most 64,
//                                                                        blocks of at most 1,024 rows),
//                                                                        flash_probe_grouped_kernel
//                              and, reading the store in place through its page table
//                              instead of a gathered block (with gather_global,
//                              repro/index/store.py)
//                                                                     -> flash_probe_store_kernel
//                                                                        (lists of at most 32),
//                                                                        flash_probe_store_list_kernel
//   flash_probe_grouped_q8_raw (_flash_probe_grouped_q8_kernel, l.157) -> flash_probe_grouped_q8_kernel
//                              and, reading the quantized store in place through its page
//                              table instead of a gathered block (with gather_global_q8)
//                                                                     -> flash_probe_store_q8_kernel
//                                                                        (lists of at most 64),
//                                                                        flash_probe_store_q8_list_kernel
//
// Each returns, for every query b, the L candidates of smallest score in ascending
// (score, index) order, where index is the position on the candidate axis: a centroid
// k (probe), a row of the query's own gathered block (grouped), or p * W + w over the
// flattened probe-rank-major (nprobe, W) axis (q8). Equal scores go to the lower index,
// as lax.top_k. Scores keep the reference's expanded forms:
//   probe:   ||c||^2 - 2 q.c          (||c||^2 passed in as csq)
//   grouped: ||c||^2 - 2 q.c          (summed term by term here, in fp32)
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
// That design (the list mode) serves lists longer than the modes below keep.
//
// What bounds it on the H100: bytes. The grouped kernels read a per-query candidate
// block that no other query shares (B * C * d * 4 bytes in fp32, C * (d + 4) per query
// in q8), once, with streaming 16-byte loads; scoring costs 2 d flops per row, far below
// the fp32 rate per byte. Selection touches only the few rows that beat the running
// L-th entry. The probe kernel at the IVF shape (B = 256 queries, K = 1024, d = 128)
// moves about 0.6 MB and does 67 MFLOP, 0.001 ms at the CUDA cores' fp32 rate: it is
// bound by latency (its loads, the selection's dependent shuffles, the launch). Its tile
// mode (flash_probe_tile_kernel, lists of at most 64) therefore reads each centroid once
// per query tile, not once per query, scores on the CUDA cores in fp32 FMAs (3xTF32
// wgmma would add a parity argument and buy nothing at this size), selects in
// registers, and merges a cluster's partial lists in one launch. The short-list block
// scan (the q8 rescore) has a warp-per-query mode (flash_probe_grouped_warp_kernel).
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

// One lane's share of ||c||^2 - 2 q.c for row cr, summed term by term, c c then
// -2 q c for each column, in one accumulator; cr == nullptr scores a padding row (every
// coordinate pad) without reading it. Every mode of kernel 5 sums alike (StoreRows
// too), so they agree bit for bit.
template <typename T, bool kVec, bool kStream>
__device__ __forceinline__ float expanded_part(const T* qr, const T* cr, float pad, int d,
                                               int lane_g, int g) {
  float acc = 0.f;
  if constexpr (kVec) {
    constexpr int V = Vec16<T>::N;
    for (int j = lane_g * V; j < d; j += g * V) {
      float cv[V], qm2[V];
      if (cr != nullptr) {
        load_vec<T, kStream>(cr + j, cv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) cv[e] = pad;
      }
      load_vec<T, false>(qr + j, qm2);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qm2[e] *= -2.f;
        acc = fmaf(cv[e], cv[e], acc);
        acc = fmaf(qm2[e], cv[e], acc);
      }
    }
  } else {
    for (int j = lane_g; j < d; j += g) {
      const float cv = cr != nullptr ? to_f32(cr[j]) : pad;
      const float qm2 = -2.f * to_f32(qr[j]);
      acc = fmaf(cv, cv, acc);
      acc = fmaf(qm2, cv, acc);
    }
  }
  return acc;
}

template <typename T, bool kVec>
struct GroupedRow {  // kernel 5: each query against its own candidate block
  const T* q;        // (B, d)
  const T* c;        // (B, C, d)
  int C, d;
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    const float acc = valid ? expanded_part<T, kVec, true>(q + (size_t)b * d,
                                                           c + ((size_t)b * C + idx) * d,
                                                           0.f, d, lane_g, g)
                            : 0.f;
    return group_sum(acc, g);
  }
};

// The store scans' one addressing rule: slot w of cell c is row w % ps of pool page
// table[c * maxp + w / ps], as a row of the (pages, ps, ...) pool. The paged store's
// pages are ps rows; the padded store passes no table: it is K pages of cap rows, cell c
// on page c, and no slot's page is looked up. Only live slots (w < the cell's count) are
// ever addressed.
__device__ __forceinline__ size_t page_row(const int* table, int maxp, int ps, int cell,
                                          int w) {
  const int page = table != nullptr ? __ldg(table + (size_t)cell * maxp + w / ps) : cell;
  return (size_t)page * ps + w % ps;
}

template <typename T, bool kVec>
struct StoreRow {      // kernel 5, store mode, lists longer than a warp keeps
  const T* q;          // (B, d)
  const T* rows;       // (pages, ps, d)
  const int* table;    // (cells, maxp) page ids, or nullptr: cell c on page c
  const int* counts;   // (cells,)
  const int* probe;    // (B, P)
  int P, maxp, ps, width, d;
  float pad;           // the store's padding coordinate, as its dtype holds it
  // Candidate idx = p * width + w is slot w of cell probe[b, p]; a slot at or past the
  // cell's count is a pad, scored from the constant without a read.
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    float acc = 0.f;
    if (valid) {
      const int p = idx / width, w = idx - p * width;
      const int cell = __ldg(probe + (size_t)b * P + p);
      const T* cr =
          w < __ldg(counts + cell) ? rows + page_row(table, maxp, ps, cell, w) * d : nullptr;
      acc = expanded_part<T, kVec, false>(q + (size_t)b * d, cr, pad, d, lane_g, g);
    }
    return group_sum(acc, g);
  }
};

// One lane's share of q'.r and ||r||^2 of one q8 row, r = code * s: with kVec the
// lane takes the row's 16-byte vectors lane_g, lane_g + g, ... (16 codes each),
// else its values lane_g, lane_g + g, ..., each r rounded once and added by one FMA
// into each sum. Q supplies q' (vec(j, 16 values) / at(j)), Cd the codes. The block
// kernel and the store's list mode sum through this with the same g, and the store's
// cell mode (q8_dequant, Q8Rows) in the same order, so their scores agree bit for bit.
template <bool kVec, class Q, class Cd>
__device__ __forceinline__ void q8_parts(const Q& q, const Cd& cd, float s, int d,
                                         int lane_g, int g, float& cross, float& rsq) {
  if constexpr (kVec) {
    for (int j = lane_g * 16; j < d; j += g * 16) {
      float cv[16], qv[16];
      cd.vec(j, cv);
      q.vec(j, qv);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float r = cv[e] * s;
        cross = fmaf(qv[e], r, cross);
        rsq = fmaf(r, r, rsq);
      }
    }
  } else {
    for (int j = lane_g; j < d; j += g) {
      const float r = cd.at(j) * s;
      cross = fmaf(q.at(j), r, cross);
      rsq = fmaf(r, r, rsq);
    }
  }
}

// The q8 score from a row's full sums: +inf where the scale is not positive.
__device__ __forceinline__ float q8_score(float qsq, float cross, float rsq, float s) {
  return s > 0.f ? qsq - 2.f * cross + rsq : INFINITY;
}

struct GlobalQ {  // a shifted query row in global memory (read through L1)
  const float* r;
  __device__ __forceinline__ void vec(int j, float (&o)[16]) const {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float f[4];
      load_vec<float, false>(r + j + 4 * h, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * h + e] = f[e];
    }
  }
  __device__ __forceinline__ float at(int j) const { return r[j]; }
};

struct GlobalCodes {  // a row of codes read once (streamed around L1)
  const int8_t* r;
  __device__ __forceinline__ void vec(int j, float (&o)[16]) const {
    load_vec<int8_t, true>(r + j, o);
  }
  __device__ __forceinline__ float at(int j) const { return to_f32(r[j]); }
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
    if (s > 0.f)  // empty slots cost one 4-byte read
      q8_parts<kVec>(GlobalQ{qp + ((size_t)b * P + p) * d}, GlobalCodes{codes + row * d}, s,
                     d, lane_g, g, cross, rsq);
    cross = group_sum(cross, g);
    rsq = group_sum(rsq, g);
    return q8_score(valid ? qsq[(size_t)b * P + p] : 0.f, cross, rsq, s);
  }
};

template <bool kVec>
struct StoreQ8Row {     // kernel 6, store mode, lists longer than the cell mode keeps
  const float* qp;      // (B, P, d) shifted queries
  const float* qsq;     // (B, P) ||q'||^2
  const int8_t* codes;  // (pages, ps, d)
  const float* scales;  // (pages, ps), 0 on empty slots
  const int* table;     // (cells, maxp) page ids, or nullptr: cell c on page c
  const int* counts;    // (cells,)
  const int* probe;     // (B, P)
  int P, maxp, ps, width, d;
  // Candidate idx = p * width + w is slot w of cell probe[b, p]; a slot at or past the
  // cell's count scores +inf without a read.
  __device__ float operator()(int b, int idx, bool valid, int lane_g, int g) const {
    const int p = idx / width, w = idx - p * width;
    const int cell = valid ? __ldg(probe + (size_t)b * P + p) : 0;
    const bool live = valid && w < __ldg(counts + cell);
    const size_t row = live ? page_row(table, maxp, ps, cell, w) : 0;
    const float s = live ? __ldg(scales + row) : 0.f;
    float cross = 0.f, rsq = 0.f;
    if (s > 0.f)
      q8_parts<kVec>(GlobalQ{qp + ((size_t)b * P + p) * d}, GlobalCodes{codes + row * d}, s,
                     d, lane_g, g, cross, rsq);
    cross = group_sum(cross, g);
    rsq = group_sum(rsq, g);
    return q8_score(valid ? qsq[(size_t)b * P + p] : 0.f, cross, rsq, s);
  }
};

// ---- selection --------------------------------------------------------------------

__device__ __forceinline__ void swap_lists(float*& av, int*& ai, float*& bv, int*& bi) {
  float* tf = av;
  av = bv;
  bv = tf;
  int* tx = ai;
  ai = bi;
  bi = tx;
}

// Sort the round's m > 0 survivors (the shared buffer after the counter) and merge them
// into the running list (av, ai) of lp entries; the merged list is written to (bv, bi)
// and the two swap. Every thread calls it with the same m; it resets the counter and
// ends with a barrier.
__device__ void merge_survivors(int m, int lp, float*& av, int*& ai, float*& bv, int*& bi) {
  int* s_count = reinterpret_cast<int*>(smem);
  float* buf_v = reinterpret_cast<float*>(smem + 16);
  int* buf_i = reinterpret_cast<int*>(smem + 16 + kTile * 4);
  int n2 = 1;
  while (n2 < m) n2 <<= 1;
  for (int i = m + threadIdx.x; i < n2; i += blockDim.x) {
    buf_v[i] = INFINITY;
    buf_i[i] = kSentinel;
  }
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  bitonic_sort(buf_v, buf_i, n2);
  merge_lists(av, ai, lp, buf_v, buf_i, m, bv, bi, lp);
  __syncthreads();
  swap_lists(av, ai, bv, bi);
}

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
    if (m > 0) merge_survivors(m, lp, av, ai, bv, bi);  // uniform: one count for all
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

// ---- kernel 5, store mode: the posting-list scan reads the store in place ----------
//
// Query b's candidate p * width + w is slot w of cell probe[b, p]. A cell's live rows
// [0, counts[cell]) are read in place through its page-table row (page_row): they are
// contiguous within a page, pages of ps rows in a (pages, ps, d) pool (the padded store
// is K pages of cap rows and passes no table, so a cell is one page, read without a
// table lookup). No candidate block is written. Slots
// at or past counts[cell] are padding (every coordinate the store's padding value, id
// -1); no pad row is read. All of a query's pads score alike, so the scorer runs once on
// the constant and the pads a list needs enter as one sorted run (ascending index),
// exactly where they would if read.
//
// Cell mode, for lists of at most kWarpList entries (the search's top-k). The wrapper
// sorts the (query, probe) pairs by cell; a prologue kernel cuts the sorted pairs into
// units of at most kCellPairs pairs of one cell. A work item is one unit and one of S
// splits of the cell's slots. A CTA takes items from a counter; it streams the item's
// live rows with TMA bulk copies (cp.async.bulk, completion on an mbarrier) through a
// ring of kCellStages shared-memory tiles, one copy per page run of a tile (a tile is
// contiguous only within a page: at most ceil(tile_rows / ps) + 1 copies from thread 0,
// all on the stage's mbarrier, whose expected bytes are their sum; the ring stays
// contiguous). Items past a cell's live rows issue no copy. Each warp scores every tile
// against its own pair's query, keeping that pair's list in registers (lane i holds
// entry i). So a row is read from HBM once per unit, not once per pair, and every pair
// of the unit scores it from shared memory. Rows whose width is not a multiple of 16
// bytes are copied by the threads instead, through the same page_row (the scalar path).
//
// Scoring: a group of G lanes (scan_lanes: each lane up to 4 of a row's 16-byte
// vectors) takes 8 consecutive rows of the tile at once, each lane reading its vectors
// of the 8 rows with ld.shared.v4 and keeping one partial score a row; tree8 then
// reduces the 8 partials with one shuffle tree (7 halving shuffles plus one per
// remaining level) instead of 8 trees of log2(G) levels. A tile holds a whole number
// of warp steps (8 rows a group, 32 / G groups), so no read is predicated: rows past
// the tile's live ones are scored and never offered. The per-lane sums are
// expanded_part's and tree8 pairs the lanes as group_sum does, so the scores, and with
// them the selected indices, are bitwise those of the gathered block's scan.
//
// List mode, for longer lists: run_stage1 with StoreRow, a CTA per split of a query's
// nprobe * width slots, as the block kernel over the gathered block.
//
// What bounds it: bytes, at least each probed cell's live rows read once from HBM. At
// the IVF1024 shape that is 0.10 ms against 0.22 ms measured (PERF.md); streaming alone
// runs near the bound, and the rest is the scoring from shared memory, 2 d FMAs, a
// share of a shuffle tree and a 16-byte shared load per lane for every (pair, row),
// with the 8 - n warps of a unit of n pairs idle.

constexpr int kStoreMinBlocks = 4;         // __launch_bounds__: at most 64 registers a thread
constexpr int kWarpList = 32;              // longest list the cell mode keeps, one entry a lane
constexpr int kCellPairs = kThreads / 32;  // pairs of one cell a unit scores, a warp each
constexpr int kCellStages = 3;             // tiles in the shared-memory ring
constexpr int kCellHead = 128;             // the ring's mbarriers and the work item, before it

// Lane lane_g of a group of G lanes enters with partial sums of rows 0..7 in v and
// leaves with full sums: of rows held_base<G>(lane_g) + i in v[i], i < 8 / min(G, 8).
// Each halving stage keeps half the values and trades the other half with the partner
// lane O away; once one value is left, the remaining levels add it up.
template <int O, int M>
__device__ __forceinline__ void tree8(float (&v)[8], int lane_g) {
  if constexpr (O >= 1) {
    if constexpr (M > 1) {
      const bool up = (lane_g & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = up ? v[i] : v[i + M / 2];
        const float keep = up ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      tree8<O / 2, M / 2>(v, lane_g);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      tree8<O / 2, 1>(v, lane_g);
    }
  }
}

template <int G>
__device__ __forceinline__ int held_base(int lane_g) {
  int base = 0, m = 8;
#pragma unroll
  for (int o = G / 2; o >= 1 && m > 1; o >>= 1) {
    m >>= 1;
    if (lane_g & o) base += m;
  }
  return base;
}

__device__ __forceinline__ void lds128(uint32_t addr, uint4& v) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
}

__device__ __forceinline__ void lds128(uint32_t addr, float4& v) {
  uint4 u;
  lds128(addr, u);
  v = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                  __uint_as_float(u.w));
}

template <typename T, bool kVec, int G>
struct StoreRows {
  const T* q;     // this query's row (d)
  const T* rows;  // a tile of consecutive rows in shared memory
  int d;
  float pad;      // the store's padding coordinate, as its dtype holds it

  // Scores ||c||^2 - 2 q.c of rows w .. w + 7 of the tile (all 8 are read: the tile
  // holds them, and rows past its live ones are never offered), or with kPad of the
  // padding row, left as tree8 leaves them. Each lane sums its columns as
  // expanded_part does, and tree8 pairs the lanes as group_sum's butterfly does, so
  // every score is bitwise the block kernel's on the gathered row.
  template <bool kPad>
  __device__ __forceinline__ void score8(int w, int lane_g, float (&v)[8]) const {
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = 0.f;
    if constexpr (kVec) {
      constexpr int V = Vec16<T>::N;
      using VT = typename Vec16<T>::V;
      for (int j = lane_g * V; j < d; j += G * V) {
        float qm2[V];
        load_vec<T, false>(q + j, qm2);
#pragma unroll
        for (int e = 0; e < V; ++e) qm2[e] *= -2.f;
        VT raw[8];
        if constexpr (!kPad) {
          const uint32_t at = smem_u32(rows) + ((uint32_t)w * d + j) * (uint32_t)sizeof(T);
#pragma unroll
          for (int r = 0; r < 8; ++r) lds128(at + (uint32_t)(r * d * sizeof(T)), raw[r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float c[V];
          if constexpr (kPad) {
#pragma unroll
            for (int e = 0; e < V; ++e) c[e] = pad;
          } else {
            unpack(raw[r], c);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            v[r] = fmaf(c[e], c[e], v[r]);
            v[r] = fmaf(qm2[e], c[e], v[r]);
          }
        }
      }
    } else {
      for (int j = lane_g; j < d; j += G) {
        const float qm2 = -2.f * to_f32(q[j]);
        float c[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) c[r] = kPad ? pad : to_f32(rows[(size_t)(w + r) * d + j]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          v[r] = fmaf(c[r], c[r], v[r]);
          v[r] = fmaf(qm2, c[r], v[r]);
        }
      }
    }
    tree8<G / 2, 8>(v, lane_g);
  }
};

// (tv, ti) = entry lp - 1 of a warp's list, on every lane.
template <int kN>
__device__ __forceinline__ void list_tail(int lp, const float (&mv)[kN], const int (&mi)[kN],
                                          float& tv, int& ti) {
  float sv = mv[0];
  int si = mi[0];
#pragma unroll
  for (int j = 1; j < kN; ++j)
    if ((lp - 1) >> 5 == j) {
      sv = mv[j];
      si = mi[j];
    }
  tv = __shfl_sync(0xffffffffu, sv, (lp - 1) & 31);
  ti = __shfl_sync(0xffffffffu, si, (lp - 1) & 31);
}

// Insert (s, x) into a warp's ascending list of lp <= 32 kN entries, lane i holding
// entries i + 32 j in (mv[j], mi[j]); (tv, ti) is entry lp - 1 on every lane. s, x are
// the same on every lane.
template <int kN>
__device__ __forceinline__ void warp_insert(float s, int x, int lp, int lane, float (&mv)[kN],
                                            int (&mi)[kN], float& tv, int& ti) {
  if (!key_less(s, x, tv, ti)) return;
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    pos += __popc(__ballot_sync(0xffffffffu, 32 * j + lane < lp && key_less(mv[j], mi[j], s, x)));
  // entry e takes entry e - 1 for e > pos: from the lane below, or for lane 0 from
  // lane 31 of the slot below
  float uv[kN];
  int ui[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    uv[j] = __shfl_up_sync(0xffffffffu, mv[j], 1);
    ui[j] = __shfl_up_sync(0xffffffffu, mi[j], 1);
  }
#pragma unroll
  for (int j = kN - 1; j > 0; --j) {
    const float lv = __shfl_sync(0xffffffffu, mv[j - 1], 31);
    const int li = __shfl_sync(0xffffffffu, mi[j - 1], 31);
    if (lane == 0) {
      uv[j] = lv;
      ui[j] = li;
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int e = 32 * j + lane;
    if (e == pos) {
      mv[j] = s;
      mi[j] = x;
    } else if (e > pos) {
      mv[j] = uv[j];
      mi[j] = ui[j];
    }
  }
  list_tail(lp, mv, mi, tv, ti);
}

// Candidates offered at least this many: sorted and merged at once (warp_sort,
// warp_merge_sorted), else inserted one by one (warp_insert).
constexpr int kSortMin = 4;

// Sorts the 32 kS keys (v, x) a warp holds, kS a lane (position p at lane p & 31, slot
// p >> 5), ascending by (value, index): a bitonic network, the exchanges across lanes
// by shuffles.
template <int kS>
__device__ __forceinline__ void warp_sort(float (&v)[kS], int (&x)[kS], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * kS; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // positions lane and lane + 32, in one lane; ascending (k == 64)
        if (key_less(v[1], x[1], v[0], x[0])) {
          const float tv = v[0];
          const int tx = x[0];
          v[0] = v[1];
          x[0] = x[1];
          v[1] = tv;
          x[1] = tx;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const int p = 32 * s + lane;
          const float ov = __shfl_xor_sync(0xffffffffu, v[s], j);
          const int ox = __shfl_xor_sync(0xffffffffu, x[s], j);
          const bool keep_min = ((p & k) == 0) == ((p & j) == 0);
          if (keep_min ? key_less(ov, ox, v[s], x[s]) : key_less(v[s], x[s], ov, ox)) {
            v[s] = ov;
            x[s] = ox;
          }
        }
      }
    }
}

// Keeps in a warp's list (mv, mi: 32 kN ascending positions, as warp_insert's) the
// 32 kN smallest keys of the list and of the sorted candidates (cv, ci: 32 kS
// positions, the same layout): c[p] = min(list[p], cand[32 kN - 1 - p]) holds them and
// is bitonic, and a bitonic merge sorts it. Positions past the list's lp entries only
// ever hold keys at or above its lp-th, so the first lp are those of inserting the
// candidates one by one.
template <int kN, int kS>
__device__ __forceinline__ void warp_merge_sorted(float (&mv)[kN], int (&mi)[kN],
                                                  const float (&cv)[kS], const int (&ci)[kS],
                                                  int lane) {
#pragma unroll
  for (int s = 0; s < kN; ++s) {  // candidate 32 (kN - 1 - s) + 31 - lane
    constexpr int kLast = kS - 1;
    const int cs = kN - 1 - s;
    const float rv = __shfl_sync(0xffffffffu, cv[cs < kS ? cs : kLast], 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, ci[cs < kS ? cs : kLast], 31 - lane);
    if (cs < kS && key_less(rv, ri, mv[s], mi[s])) {
      mv[s] = rv;
      mi[s] = ri;
    }
  }
#pragma unroll
  for (int j = 16 * kN; j > 0; j >>= 1) {
    if (j == 32) {
      if (key_less(mv[kN - 1], mi[kN - 1], mv[0], mi[0])) {
        const float tv = mv[0];
        const int tx = mi[0];
        mv[0] = mv[kN - 1];
        mi[0] = mi[kN - 1];
        mv[kN - 1] = tv;
        mi[kN - 1] = tx;
      }
    } else {
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const float ov = __shfl_xor_sync(0xffffffffu, mv[s], j);
        const int ox = __shfl_xor_sync(0xffffffffu, mi[s], j);
        const bool keep_min = (lane & j) == 0;
        if (keep_min ? key_less(ov, ox, mv[s], mi[s]) : key_less(mv[s], mi[s], ov, ox)) {
          mv[s] = ov;
          mi[s] = ox;
        }
      }
    }
  }
}

// Rows [r0, r1) of `rows` into a warp's list of lp entries, candidate index base + r:
// each group of G lanes scores 8 rows at once, and the rows that beat the lp-th entry
// are inserted one by one, or with kSort, where at least kSortMin of them do, sorted
// and merged at once.
template <class Rows, int G, int kN, bool kSort = false>
__device__ __forceinline__ void warp_scan(const Rows& rows, int r0, int r1, int base, int lp,
                                          int lane, float (&mv)[kN], int (&mi)[kN], float& tv,
                                          int& ti) {
  constexpr int kHeld = G >= 8 ? 1 : 8 / G;
  const int lane_g = lane & (G - 1), grp = lane / G;
  const int hb = held_base<G>(lane_g);
  const bool holder = G <= 8 || (lane_g & (G / 8 - 1)) == 0;  // one lane per held row
  for (int r8 = r0; r8 < r1; r8 += 8 * (32 / G)) {
    const int rg = r8 + grp * 8;  // this group's first row
    float v[8];
    rows.template score8<false>(rg, lane_g, v);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int r = rg + hb + i;
      const int idx = base + r;
      unsigned m = __ballot_sync(0xffffffffu, holder && r < r1 && key_less(v[i], idx, tv, ti));
      if constexpr (kSort) {
        if (__popc(m) >= kSortMin) {  // uniform
          const bool mine = (m >> lane) & 1u;
          float cv[1] = {mine ? v[i] : INFINITY};
          int ci[1] = {mine ? idx : kSentinel};
          warp_sort(cv, ci, lane);
          warp_merge_sorted(mv, mi, cv, ci, lane);
          list_tail(lp, mv, mi, tv, ti);
          continue;
        }
      }
      while (m) {  // uniform
        const int src = __ffs(m) - 1;
        m &= m - 1;
        warp_insert(__shfl_sync(0xffffffffu, v[i], src), __shfl_sync(0xffffffffu, idx, src),
                    lp, lane, mv, mi, tv, ti);
      }
    }
  }
}

// The pads [w0, w1) of a pair, ascending index base + w, while they beat the lp-th entry:
// each scores sp, the same for all of them.
template <int kN>
__device__ __forceinline__ void warp_pads(float sp, int w0, int w1, int base, int lp, int lane,
                                          float (&mv)[kN], int (&mi)[kN], float& tv, int& ti) {
  for (int w = w0; w < w1 && key_less(sp, base + w, tv, ti); ++w)
    warp_insert(sp, base + w, lp, lane, mv, mi, tv, ti);
}

// Prologue of the cell mode, one CTA: sc holds the n probed cells in ascending order.
// A unit starts at every position whose distance to the start of its cell's run is a
// multiple of kCellPairs; units[u] is unit u's first position, work[0] the number of
// units, and work[1] (the work-item counter) is set to 0.
__global__ void __launch_bounds__(1024) cell_units_kernel(const int* sc, int n, int* units,
                                                          int* work) {
  __shared__ int part[32];
  __shared__ int carry[2];  // last run start so far, units so far
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    int rs = i < n && (i == 0 || sc[i] != sc[i - 1]) ? i : -1;  // inclusive max-scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, rs, o);
      if (lane >= o) rs = max(rs, v);
    }
    if (lane == 31) part[warp] = rs;
    __syncthreads();
    if (warp == 0) {
      int v = part[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = max(v, u);
      }
      part[lane] = v;
    }
    __syncthreads();
    rs = max(max(rs, warp > 0 ? part[warp - 1] : -1), carry[0]);
    const bool lead = i < n && (i - rs) % kCellPairs == 0;
    const unsigned bal = __ballot_sync(0xffffffffu, lead);
    __syncthreads();
    if (lane == 0) part[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {  // inclusive sum-scan of the warps' leads
      int v = part[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      part[lane] = v;
    }
    __syncthreads();
    const int at = carry[1] + (warp > 0 ? part[warp - 1] : 0) + __popc(bal & ((1u << lane) - 1));
    if (lead) units[at] = i;
    __syncthreads();
    if (tid == blockDim.x - 1) {
      carry[0] = rs;
      carry[1] = at + (lead ? 1 : 0);
    }
    __syncthreads();
  }
  if (tid == 0) {
    work[0] = carry[1];
    work[1] = 0;
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The cell mode. pos0 = units[u] .. : the unit's pairs are order[pos0 + w] for the
// warps w whose position still holds the unit's cell. The item's slots are split s of
// the cell's width: [s * chunk, min(width, (s + 1) * chunk)); its lists go to part slot
// pair * S + s, so query b's lists are slots [b P S, (b + 1) P S).
template <typename T, bool kVec, int G>
__global__ void __launch_bounds__(kThreads, kStoreMinBlocks)
    flash_probe_store_kernel(const T* q, const T* rows, const int* table, const int* counts,
                             const int* sc, const int* order, const int* units, int* work,
                             int npairs, int P, int maxp, int ps, int width, int d, float pad,
                             int lp, int chunk, int S, int tile_rows, float* pv, int* pi) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* s_item = reinterpret_cast<int*>(smem + 8 * kCellStages);
  T* ring = reinterpret_cast<T*>(smem + kCellHead);
  const size_t stage = (size_t)tile_rows * d;  // elements of one tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kCellStages; ++k) mbar_init(smem_u32(bars + k), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int items = work[0] * S;
  unsigned used = 0;  // tiles this CTA consumed: tile g is in stage g % kCellStages
  for (;;) {
    if (threadIdx.x == 0) *s_item = atomicAdd(work + 1, 1);
    __syncthreads();
    const int item = *s_item;
    __syncthreads();
    if (item >= items) break;
    const int u = item / S, s = item - u * S;
    const int pos0 = units[u], cell = sc[pos0];
    const int live = min(counts[cell], width);
    const int w0 = s * chunk, w1 = min(width, w0 + chunk), hi = max(w0, min(w1, live));
    const int ntiles = (hi - w0 + tile_rows - 1) / tile_rows;
    auto fill = [&](int t) {  // tile t of the item into its stage
      const unsigned k = (used + t) % kCellStages;
      const int s0 = w0 + t * tile_rows;  // the tile's first slot
      const int nt = min(tile_rows, hi - s0);
      T* dst = ring + k * stage;
      if constexpr (kVec) {  // thread 0 issues the copies
        if (threadIdx.x != 0) return;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(smem_u32(bars + k), (uint32_t)((size_t)nt * d * sizeof(T)));
      }
      // the tile's slots as runs within pages, page_row's rule a run at a time (pg:
      // the run's table entry; no table: the cell's page): one bulk copy a run, or
      // the threads' copies on the scalar path
      const int* pg = table != nullptr ? table + (size_t)cell * maxp + s0 / ps : nullptr;
      for (int r = 0, off = s0 % ps; r < nt; off = 0) {
        const int n = min(nt - r, ps - off);
        const T* src = rows + ((size_t)(pg != nullptr ? __ldg(pg++) : cell) * ps + off) * d;
        if constexpr (kVec) {
          bulk_load(smem_u32(dst + (size_t)r * d), src, (uint32_t)((size_t)n * d * sizeof(T)),
                    smem_u32(bars + k));
        } else {
          for (int e = threadIdx.x; e < n * d; e += blockDim.x) dst[(size_t)r * d + e] = src[e];
        }
        r += n;
      }
    };
    for (int t = 0; t < min(ntiles, kCellStages - 1); ++t) fill(t);
    const int pos = pos0 + warp;
    const bool mine = pos < npairs && sc[pos] == cell;  // warp-uniform
    const int pair = mine ? order[pos] : 0;
    const int b = pair / P, base = (pair - b * P) * width;
    const T* qb = q + (size_t)b * d;
    float mv[1] = {INFINITY}, tv = INFINITY;
    int mi[1] = {kSentinel}, ti = kSentinel;
    for (int t = 0; t < ntiles; ++t) {
      if (t + kCellStages - 1 < ntiles) fill(t + kCellStages - 1);  // the stage freed last round
      const unsigned g = used + t, k = g % kCellStages;
      if constexpr (kVec) mbar_wait(smem_u32(bars + k), (g / kCellStages) & 1);
      else __syncthreads();  // the threads' copies are visible
      if (mine) {
        const int r0 = t * tile_rows;
        const StoreRows<T, kVec, G> rows{qb, ring + k * stage, d, pad};
        warp_scan<StoreRows<T, kVec, G>, G>(rows, 0, min(tile_rows, hi - w0 - r0),
                                            base + w0 + r0, lp, lane, mv, mi, tv, ti);
      }
      __syncthreads();  // every warp is done with stage k before it is refilled
    }
    used += ntiles;
    if (mine) {
      if (hi < w1) {  // every pad scores alike: the scorer runs once on the constant
        const StoreRows<T, kVec, G> pads{qb, nullptr, d, pad};
        float v[8];
        pads.template score8<true>(0, lane & (G - 1), v);
        const float sp = __shfl_sync(0xffffffffu, v[0], 0);  // lane 0 holds row 0
        warp_pads(sp, hi, w1, base, lp, lane, mv, mi, tv, ti);
      }
      const size_t slot = ((size_t)pair * S + s) * lp;
      if (lane < lp) {
        pv[slot + lane] = mv[0];
        pi[slot + lane] = mi[0];
      }
    }
  }
}

// ---- kernel 6, store mode: the q8 scan reads the quantized store in place ---------
//
// The q8 proposal over the probed cells of the quantized store: codes (pages, ps, d)
// int8 and scales (pages, ps) f32 (0 on every dead slot), read in place through probe,
// counts and the page table (page_row; the padded store passes none), so the
// (B, nprobe * width) candidate block of codes and scales is never written. Query b's candidate p * width + w is slot w of cell probe[b, p], scored
// ||q'||^2 - 2 q'.r + ||r||^2 with r = code * s and q' = q - anchor[cell] (the pair's
// row of qp, with qsq its ||q'||^2: the block path's own prologue); +inf where s <= 0,
// and +inf without a read for slots at or past the cell's count. Those +inf entries
// take the lowest free indices, as the block kernel's do.
//
// Cell mode, for lists of at most kQ8List entries (two a lane) and rows of 16-code
// vectors, d <= 512: the fp32 cell mode's dataflow. The pairs are sorted by cell, so the pairs of a unit share one
// anchor and one cell; each work item streams its cell's live codes with their scales
// (one more cp.async.bulk on the same mbarrier, so a tile's scales arrive with its
// codes; a pair of copies per page run of the tile) through a ring of kCellStages tiles. r = code * s and ||r||^2 do not depend on
// the query, so all the CTA's warps dequantize each tile once into shared memory
// (q8_dequant), and each warp then scores the tile's rows for its own pair: a group of
// G lanes (the block kernel's lane count, one 16-value vector a lane) takes 8 rows at
// once, q' held in registers, and tree8 adds the lanes (Q8Rows). Every sum is Q8Row's,
// in its order and lane pairing, so store and block modes agree bit for bit. Slot
// offsets and tile sizes are multiples of 4 rows (the wrapper rounds the split), and so
// are page boundaries (ps % 4 == 0: both layouts round their pages to 8 rows; the
// wrapper sends other stores, and scales that do not start on 16 bytes, to the list
// mode). So every page run of a tile but the last is a whole number of 16-byte groups of
// scales, and the last, rounded up to 4 rows, runs up to 3 rows past the live ones but
// stays inside its own page, whose end is a multiple of 4. The dequantized tile, and
// every sum, are in the same order as without pages, so store and block modes still
// agree bit for bit.
//
// List mode, for longer lists and other rows (d % 16 != 0, the block kernel's scalar
// path; d > 512): run_stage1 with StoreQ8Row, a CTA per split of a query's
// nprobe * width slots.
//
// What bounds it: bytes, each probed cell's live codes and scales read once; beside
// them 2 d flops per (pair, live row) for q'.r (PERF.md: at IVF1024 the scoring, and
// the 40-entry lists' insertions, hold it, as they hold the fp32 cell mode).

constexpr int kQ8List = 64;  // longest list the q8 cell mode keeps, two entries a lane

struct SharedCodes {  // a row of codes in a shared-memory tile
  const int8_t* r;
  __device__ __forceinline__ void vec(int j, float (&o)[16]) const {
    uint4 v;
    lds128(smem_u32(r + j), v);
    unpack(make_int4((int)v.x, (int)v.y, (int)v.z, (int)v.w), o);
  }
};

// group_sum at a lane count known when compiling: the same butterfly, unrolled
template <int G>
__device__ __forceinline__ float group_sum_g(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void sts128(float* p, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_u32(p)), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// The vector path's shared rows (d <= 16 G: one 16-value vector a lane): element 4 h + k
// of lane lane_g's vector lies at (h * G + lane_g) * 4 + k, so the G lanes of a group
// load one 16-byte piece each from consecutive addresses (no bank conflict).
template <int G>
__device__ __forceinline__ int deq_at(int h, int lane_g) {
  return (h * G + lane_g) * 4;
}

// Dequantizes rows [0, nrows) of a tile once for every pair of the unit, with all the
// CTA's warps, a group of G lanes a row as the scorers run: r = code * s into deq (16 G
// floats a row) and ||r||^2 into rsq, each lane summing its values in order and the
// group's butterfly adding the lanes, as Q8Row sums it.
template <int G>
__device__ __forceinline__ void q8_dequant(const int8_t* tc, const float* ts, int nrows, int d,
                                           float* deq, float* rsq, int lane_g, int grp) {
  constexpr int R = 32 / G;  // rows a warp step
  for (int rb = (threadIdx.x >> 5) * R; rb < nrows; rb += (kThreads / 32) * R) {
    const int r = rb + grp;  // < tile_rows: a tile holds whole warp steps
    float sq = 0.f;
    if (lane_g * 16 < d) {
      const float s = ts[r];
      float cv[16];
      SharedCodes{tc + (size_t)r * d}.vec(lane_g * 16, cv);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        cv[e] *= s;
        sq = fmaf(cv[e], cv[e], sq);
      }
      float* row = deq + (size_t)r * 16 * G;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        sts128(row + deq_at<G>(h, lane_g), cv[4 * h], cv[4 * h + 1], cv[4 * h + 2],
               cv[4 * h + 3]);
    }
    sq = group_sum_g<G>(sq);
    if (lane_g == 0) rsq[r] = sq;
  }
}

// A tile's dequantized rows as one pair scores them (the vector path, G lanes a row,
// d <= 16 G: one vector a lane, its q' piece held in qh): score8 takes 8 rows of a
// group at once, each lane summing q'.r of its vector of each row as Q8Row does (eight
// independent chains), tree8 adding the lanes as group_sum's butterfly does; the rows a
// lane then holds get their scores, so they are bitwise the block kernel's.
template <int G>
struct Q8Rows {
  const float* deq;  // the tile's rows, 16 G floats each (deq_at)
  const float* rsq;  // their ||r||^2
  const float* ts;   // their scales
  float q2;          // the pair's ||q'||^2
  int d;
  float qh[16];

  template <bool kPad>
  __device__ __forceinline__ void score8(int w, int lane_g, float (&v)[8]) const {
    static_assert(!kPad, "the q8 pads score +inf without a scorer");
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = 0.f;
    if (lane_g * 16 < d) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float4 x;
          lds128(smem_u32(deq + (size_t)(w + r) * 16 * G + deq_at<G>(h, lane_g)), x);
          v[r] = fmaf(qh[4 * h], x.x, v[r]);
          v[r] = fmaf(qh[4 * h + 1], x.y, v[r]);
          v[r] = fmaf(qh[4 * h + 2], x.z, v[r]);
          v[r] = fmaf(qh[4 * h + 3], x.w, v[r]);
        }
      }
    }
    tree8<G / 2, 8>(v, lane_g);
    constexpr int kHeld = G >= 8 ? 1 : 8 / G;
    const int hb = held_base<G>(lane_g);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int row = w + hb + i;
      v[i] = q8_score(q2, v[i], rsq[row], ts[row]);
    }
  }
};

// G lanes a row (d <= 16 G), its tiles dequantized once a unit into shared memory past
// the ring: the rows' r values, then their ||r||^2. Launch bounds: 2 CTAs an SM, at most
// 128 registers a thread (at 3 CTAs, 80 registers, every instance spilled); 1 CTA for two
// list entries a lane at 1 or 2 lanes a row (8 rows held a lane), which spilled at 128.
template <int G, int kN>
__global__ void __launch_bounds__(kThreads, (kN > 1 && G < 4 ? 1 : 2))
    flash_probe_store_q8_kernel(const float* qp, const float* qsq, const int8_t* codes,
                                const float* scales, const int* table, const int* counts,
                                const int* sc, const int* order, const int* units, int* work,
                                int npairs, int P, int maxp, int ps, int width, int d, int lp,
                                int chunk, int S, int tile_rows, float* pv, int* pi) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* s_item = reinterpret_cast<int*>(smem + 8 * kCellStages);
  unsigned char* ring = smem + kCellHead;
  const size_t code_bytes = ((size_t)tile_rows * d + 15) / 16 * 16;
  const size_t stage = code_bytes + (size_t)tile_rows * 4;  // codes, then scales
  float* deq = reinterpret_cast<float*>(ring + kCellStages * stage);
  float* rsq = deq + (size_t)tile_rows * 16 * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lane_g = lane & (G - 1), grp = lane / G;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kCellStages; ++k) mbar_init(smem_u32(bars + k), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int items = work[0] * S;
  unsigned used = 0;  // tiles this CTA consumed: tile g is in stage g % kCellStages
  for (;;) {
    if (threadIdx.x == 0) *s_item = atomicAdd(work + 1, 1);
    __syncthreads();
    const int item = *s_item;
    __syncthreads();
    if (item >= items) break;
    const int u = item / S, s = item - u * S;
    const int pos0 = units[u], cell = sc[pos0];
    const int live = min(counts[cell], width);
    const int w0 = s * chunk, w1 = min(width, w0 + chunk), hi = max(w0, min(w1, live));
    const int ntiles = (hi - w0 + tile_rows - 1) / tile_rows;
    auto fill = [&](int t) {  // tile t of the item into its stage: codes and scales
      const unsigned k = (used + t) % kCellStages;
      if (threadIdx.x == 0) {
        const int s0 = w0 + t * tile_rows;  // the tile's first slot, a multiple of 4
        const int n4 = (min(tile_rows, hi - s0) + 3) & ~3;  // whole 16-byte groups of scales
        unsigned char* dst = ring + k * stage;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(smem_u32(bars + k), (uint32_t)n4 * (uint32_t)(d + 4));
        // one pair of copies per page run, page_row's rule a run at a time (pg: the
        // run's table entry; no table: the cell's page): n % 4 == 0
        const int* pg = table != nullptr ? table + (size_t)cell * maxp + s0 / ps : nullptr;
        for (int r = 0, off = s0 % ps; r < n4; off = 0) {
          const int n = min(n4 - r, ps - off);
          const size_t row = (size_t)(pg != nullptr ? __ldg(pg++) : cell) * ps + off;
          bulk_load(smem_u32(dst + (size_t)r * d), codes + row * d, (uint32_t)(n * d),
                    smem_u32(bars + k));
          bulk_load(smem_u32(dst + code_bytes + 4 * r), scales + row, (uint32_t)n * 4,
                    smem_u32(bars + k));
          r += n;
        }
      }
    };
    for (int t = 0; t < min(ntiles, kCellStages - 1); ++t) fill(t);
    const int pos = pos0 + warp;
    const bool mine = pos < npairs && sc[pos] == cell;  // warp-uniform
    const int pair = mine ? order[pos] : 0;
    const int base = (pair % P) * width;
    Q8Rows<G> rows;  // the pair's scorer (lanes past d hold no q')
    rows.deq = deq;
    rows.rsq = rsq;
    rows.q2 = qsq[pair];
    rows.d = d;
    if (lane_g * 16 < d) GlobalQ{qp + (size_t)pair * d}.vec(lane_g * 16, rows.qh);
    float mv[kN], tv = INFINITY;
    int mi[kN], ti = kSentinel;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      mv[j] = INFINITY;
      mi[j] = kSentinel;
    }
    for (int t = 0; t < ntiles; ++t) {
      if (t + kCellStages - 1 < ntiles) fill(t + kCellStages - 1);  // the stage freed last round
      const unsigned gt = used + t, k = gt % kCellStages;
      mbar_wait(smem_u32(bars + k), (gt / kCellStages) & 1);
      const int8_t* tc = reinterpret_cast<const int8_t*>(ring + k * stage);
      const float* ts = reinterpret_cast<const float*>(ring + k * stage + code_bytes);
      const int nrows = min(tile_rows, hi - w0 - t * tile_rows);
      q8_dequant<G>(tc, ts, nrows, d, deq, rsq, lane_g, grp);
      __syncthreads();  // the tile's rows are dequantized
      if (mine) {
        rows.ts = ts;
        warp_scan<Q8Rows<G>, G>(rows, 0, nrows, base + w0 + t * tile_rows, lp, lane, mv, mi,
                                tv, ti);
      }
      __syncthreads();  // every warp is done with stage k (and the rows) before reuse
    }
    used += ntiles;
    if (mine) {
      warp_pads(INFINITY, hi, w1, base, lp, lane, mv, mi, tv, ti);
      const size_t slot = ((size_t)pair * S + s) * lp;
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (32 * j + lane < lp) {
          pv[slot + 32 * j + lane] = mv[j];
          pi[slot + 32 * j + lane] = mi[j];
        }
    }
  }
}

// ---- kernel 4, tile mode: query tiles over a cluster's centroid slices -------------
//
// For lists of at most kTileList entries and rows of whole 16-byte vectors, at most
// kTileRowBytes long (the wrapper sends other rows, unaligned pointers and longer lists
// to the list mode). A CTA takes a tile of kTileQ queries, staged once in shared memory
// (zeros past N). The S CTAs of a thread-block cluster (S = 1, 2, 4 or 8, along x) split
// the K centroids into slices of `chunk`; each streams its slice's rows through a
// two-stage cp.async ring of kTileK-row tiles, so every centroid is read from L2 once
// per query tile, not once per query.
//
// Scoring, on the CUDA cores in fp32: warp w owns queries 2w and 2w + 1 of the tile,
// lane l rows l and l + 32 of a ring tile. Each lane sums its four dot products along d
// in element order from one 16-byte shared load of each row a step (the query rows are
// a broadcast; the staged rows are padded to an odd number of 16-byte units, so the 8
// lanes of a load phase hit 8 bank groups); the score is csq - 2 q.c. Selection: each
// warp keeps its two queries' running lists in registers (lane i holds entries i and
// i + 32); after each tile a ballot offers only the scores that beat a list's L-th
// entry, inserted one by one (warp_insert) or, where at least kSortMin do, sorted
// across the lanes and merged into the list at once (warp_sort, warp_merge_sorted: the
// first tile's all beat an empty list). There is no survivor buffer in shared memory.
// Rows past the slice (or
// past K) are never offered; a cluster's CTAs whose slice is empty keep empty lists.
//
// Merge: with S > 1 every CTA leaves its sorted partial lists in shared memory. After a
// cluster barrier CTA r copies, from every CTA of the cluster (ld.shared::cluster), the
// S lists of queries r, r + S, ... of the tile; after a second barrier (no CTA exits
// while another reads its memory) each entry goes to its rank, as in merge_lists: its
// position in its own list plus the entries of the other lists strictly before it. The
// keys are distinct (the slices are disjoint) except the empty entries (+inf,
// kSentinel), whose ranks are at least L: the lists hold at least min(L, K) = L real
// entries between them. So the probe is one launch, with no global partial lists.
//
// What bounds it: latency. At B = 256, K = 1024, d = 128 (S = 8, 128 CTAs) a CTA scores
// 16 x 128 pairs (262,144 FMAs) and selects through chains of dependent shuffles (a
// sort and merge of 64, or a few insertions, a tile and query), with two warps per SM
// sub-partition to hide them.

constexpr int kTileQ = 16;           // queries a CTA, two a warp
constexpr int kTileK = 64;           // centroid rows a ring tile, two a lane
constexpr int kTileStages = 2;       // ring tiles
constexpr int kTileList = 64;        // longest list the tile mode keeps, two entries a lane
constexpr int kTileRowBytes = 1024;  // longest row the tile mode stages

// Bytes from one staged row to the next: the row's 16-byte units, made odd.
__host__ __device__ inline int tile_row_stride(int row_bytes) {
  return 16 * ((row_bytes / 16) | 1);
}

// Dynamic shared memory of a tile-mode CTA: the query tile and the ring, and with S > 1
// the partial lists (kTileQ of L entries) and the lists of the queries it merges.
__host__ __device__ inline size_t tile_smem(int row_bytes, int L, int S) {
  size_t b = (size_t)(kTileQ + kTileStages * kTileK) * tile_row_stride(row_bytes);
  if (S > 1) b += (size_t)8 * L * (kTileQ + (size_t)((kTileQ + S - 1) / S) * S);
  return b;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void sts128_zero(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(addr), "r"(0) : "memory");
}

// Grid (ceil(N / kTileQ) * S), clusters of (S, 1, 1): CTA x takes query tile x / S and
// centroid slice x % S, rows [rank * chunk, min(K, (rank + 1) * chunk)).
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads, 2)
    flash_probe_tile_kernel(const T* q, const T* c, const float* csq, int N, int K, int d,
                            int L, int chunk, int S, float* out_v, int* out_i) {
  constexpr int V = Vec16<T>::N;
  using VT = typename Vec16<T>::V;
  const int vpr = d / V;  // 16-byte units of a row
  const int rs = tile_row_stride(d * (int)sizeof(T));
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + kTileQ * rs;
  float* part_v = reinterpret_cast<float*>(smem + (size_t)(kTileQ + kTileStages * kTileK) * rs);
  int* part_i = reinterpret_cast<int*>(part_v + kTileQ * L);
  float* stg_v = reinterpret_cast<float*>(part_i + kTileQ * L);
  int* stg_i = reinterpret_cast<int*>(stg_v + (size_t)((kTileQ + S - 1) / S) * S * L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)(blockIdx.x % S);  // the CTA's rank in its cluster
  const long long b0 = (long long)(blockIdx.x / S) * kTileQ;
  const int k0 = (int)min((long long)K, (long long)rank * chunk);
  const int k1 = (int)min((long long)K, (long long)k0 + chunk);
  const int ntiles = (k1 - k0 + kTileK - 1) / kTileK;

  auto fill = [&](int t) {  // ring tile t of the slice, then a commit
    const int r0 = k0 + t * kTileK, nr = min(kTileK, k1 - r0);
    const uint32_t dst = ring + (t % kTileStages) * kTileK * rs;
    for (int e = tid; e < nr * vpr; e += kThreads) {
      const int r = e / vpr, u = e - r * vpr;
      cp_async16(dst + r * rs + u * 16, c + (size_t)(r0 + r) * d + u * V);
    }
    cp_async_commit();
  };
  if (ntiles > 0) {  // the query tile with ring tile 0; an empty slice copies nothing
    for (int e = tid; e < kTileQ * vpr; e += kThreads) {
      const int r = e / vpr, u = e - r * vpr;
      const uint32_t dst = qs + r * rs + u * 16;
      if (b0 + r < N) cp_async16(dst, q + (size_t)(b0 + r) * d + u * V);
      else sts128_zero(dst);
    }
    fill(0);
  }

  float mv[2][kN], tv[2];
  int mi[2][kN], ti[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tv[i] = INFINITY;
    ti[i] = kSentinel;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      mv[i][j] = INFINITY;
      mi[i][j] = kSentinel;
    }
  }
  const uint32_t qa = qs + 2 * warp * rs;  // this warp's two query rows
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in for every thread; every warp is done with tile t - 1
    if (t + 1 < ntiles) fill(t + 1);  // into the stage tile t - 1 held
    const uint32_t ca = ring + (t % kTileStages) * kTileK * rs + lane * rs;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 2
    for (int u = 0; u < vpr; ++u) {
      VT rq0, rq1, rc0, rc1;
      lds128(qa + u * 16, rq0);
      lds128(qa + rs + u * 16, rq1);
      lds128(ca + u * 16, rc0);
      lds128(ca + 32 * rs + u * 16, rc1);
      float q0[V], q1[V], c0[V], c1[V];
      unpack(rq0, q0);
      unpack(rq1, q1);
      unpack(rc0, c0);
      unpack(rc1, c1);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[0][0] = fmaf(q0[e], c0[e], acc[0][0]);
        acc[0][1] = fmaf(q0[e], c1[e], acc[0][1]);
        acc[1][0] = fmaf(q1[e], c0[e], acc[1][0]);
        acc[1][1] = fmaf(q1[e], c1[e], acc[1][1]);
      }
    }
    const int r0 = k0 + t * kTileK;
    float cs[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = r0 + lane + 32 * j;
      cs[j] = k < k1 ? __ldg(csq + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sv[2];
      int sx[2];
      bool beat[2];
      int n = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sv[j] = cs[j] - 2.f * acc[i][j];
        sx[j] = r0 + lane + 32 * j;
        beat[j] = sx[j] < k1 && key_less(sv[j], sx[j], tv[i], ti[i]);
        n += __popc(__ballot_sync(0xffffffffu, beat[j]));
      }
      if (n >= kSortMin) {  // uniform: sort the tile's 64 and merge them at once
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sv[j] = beat[j] ? sv[j] : INFINITY;
          sx[j] = beat[j] ? sx[j] : kSentinel;
        }
        warp_sort(sv, sx, lane);
        warp_merge_sorted(mv[i], mi[i], sv, sx, lane);
        list_tail(L, mv[i], mi[i], tv[i], ti[i]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned m = __ballot_sync(0xffffffffu, beat[j]);
        while (m) {  // uniform
          const int src = __ffs(m) - 1;
          m &= m - 1;
          warp_insert(__shfl_sync(0xffffffffu, sv[j], src), r0 + 32 * j + src, L, lane,
                      mv[i], mi[i], tv[i], ti[i]);
        }
      }
    }
  }

  if (S == 1) {  // the lists are the outputs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long b = b0 + 2 * warp + i;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int e = 32 * j + lane;
        if (b < N && e < L) {
          out_v[b * L + e] = mv[i][j];
          out_i[b * L + e] = mi[i][j];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = 32 * j + lane;
      if (e < L) {
        part_v[(2 * warp + i) * L + e] = mv[i][j];
        part_i[(2 * warp + i) * L + e] = mi[i][j];
      }
    }
  cluster_sync();  // every CTA's partial lists are written
  const int mq = (kTileQ - rank + S - 1) / S;  // queries rank, rank + S, ... of the tile
  const int per = S * L;                       // entries of one query's lists
  for (int e = tid; e < mq * per; e += kThreads) {
    const int m = e / per, o = (e - m * per) / L, j = e - m * per - o * L;
    const int qi = rank + m * S;
    stg_v[e] = __int_as_float(ld_cluster(map_rank(smem_u32(part_v + qi * L + j), o)));
    stg_i[e] = ld_cluster(map_rank(smem_u32(part_i + qi * L + j), o));
  }
  cluster_sync();  // the copies are visible here, and no CTA reads another's memory after it
  for (int e = tid; e < mq * per; e += kThreads) {
    const int m = e / per, o = (e - m * per) / L, j = e - m * per - o * L;
    const long long b = b0 + rank + m * S;
    const float v = stg_v[e];
    const int x = stg_i[e];
    const float* lv = stg_v + m * per;
    const int* li = stg_i + m * per;
    int r = j;
    for (int p = 0; p < S; ++p)
      if (p != o) r += count_before<true>(lv + p * L, li + p * L, L, v, x);
    if (r < L && b < N) {
      out_v[b * L + r] = v;
      out_i[b * L + r] = x;
    }
  }
}

// ---- kernel 5, block mode, short lists: a warp per query ----------------------------
//
// For lists of at most kTileList entries over blocks of at most kWarpScanRows rows of
// whole 16-byte vectors (the q8 rescore: C = R = 40, L = topk). A CTA of kWarpQueries
// warps takes as many queries; each warp scans its own query's block with warp_scan,
// the list in registers (lane i holds entries i and i + 32), a step's rows sorted and
// merged at once where at least kSortMin beat the list (the first step's all do): no
// shared memory, no barrier. A step's loads (at most 4 vectors of 8 rows a lane: rows
// of at most 2 KiB) are all issued before its sums, so a step waits on memory once. BlockRows reads the rows straight from the block in global memory,
// streamed (__ldcs), in StoreRows::score8's order, with the same lane count (scan_lanes)
// and tree8 pairing, so every score is bitwise the list mode's (GroupedRow) and the
// store scan's. A warp step covers 8 rows a group of G lanes; rows of a step at or past
// C are read from row C - 1 (never offered), so no load leaves the query's block, and
// the live rows' sums do not change (tree8 keeps each row's sum to itself).

constexpr int kWarpQueries = 4;      // warps, and queries, a CTA
constexpr int kWarpScanRows = 1024;  // longest block a warp scans alone
constexpr int kWarpVecs = 4;         // 16-byte vectors of a row a lane, at most
constexpr int kWarpRowBytes = 2048;  // longest row: scan_lanes gives at most 4 a lane

template <typename T, int G>
struct BlockRows {
  const T* q;     // the query's row (d)
  const T* rows;  // its block (C, d) in global memory
  int C, d;

  template <bool kPad>
  __device__ __forceinline__ void score8(int w, int lane_g, float (&v)[8]) const {
    static_assert(!kPad, "a gathered block holds its padding rows");
    constexpr int V = Vec16<T>::N;
    using VT = typename Vec16<T>::V;
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = 0.f;
    VT raw[kWarpVecs][8];  // vectors j = (lane_g + t G) V of the 8 rows, all in flight
#pragma unroll
    for (int t = 0; t < kWarpVecs; ++t) {
      const int j = (lane_g + t * G) * V;
      if (j < d)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          raw[t][r] =
              __ldcs(reinterpret_cast<const VT*>(rows + (size_t)min(w + r, C - 1) * d + j));
    }
#pragma unroll
    for (int t = 0; t < kWarpVecs; ++t) {  // summed in expanded_part's order
      const int j = (lane_g + t * G) * V;
      if (j < d) {
        float qm2[V];
        load_vec<T, false>(q + j, qm2);
#pragma unroll
        for (int e = 0; e < V; ++e) qm2[e] *= -2.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float cv[V];
          unpack(raw[t][r], cv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            v[r] = fmaf(cv[e], cv[e], v[r]);
            v[r] = fmaf(qm2[e], cv[e], v[r]);
          }
        }
      }
    }
    tree8<G / 2, 8>(v, lane_g);
  }
};

template <typename T, int G, int kN>
__global__ void __launch_bounds__(32 * kWarpQueries)
    flash_probe_grouped_warp_kernel(const T* q, const T* c, int B, int C, int d, int L,
                                    float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpQueries + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp; no barrier follows
  const BlockRows<T, G> rows{q + b * d, c + b * C * d, C, d};
  float mv[kN], tv = INFINITY;
  int mi[kN], ti = kSentinel;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    mv[j] = INFINITY;
    mi[j] = kSentinel;
  }
  warp_scan<BlockRows<T, G>, G, kN, true>(rows, 0, C, 0, L, lane, mv, mi, tv, ti);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int e = 32 * j + lane;
    if (e < L) {
      out_v[b * L + e] = mv[j];
      out_i[b * L + e] = mi[j];
    }
  }
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_probe_store_list_kernel(const T* q, const T* rows, const int* table,
                                  const int* counts, const int* probe, int P, int maxp, int ps,
                                  int width, int d, float pad, int lp, int chunk, int g,
                                  float* pv, int* pi, float* lv, int* li) {
  run_stage1(StoreRow<T, kVec>{q, rows, table, counts, probe, P, maxp, ps, width, d, pad},
             P * width, lp, chunk, g, pv, pi, lv, li);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_probe_store_q8_list_kernel(const float* qp, const float* qsq, const int8_t* codes,
                                     const float* scales, const int* table, const int* counts,
                                     const int* probe, int P, int maxp, int ps, int width, int d,
                                     int lp, int chunk, int g, float* pv, int* pi, float* lv,
                                     int* li) {
  run_stage1(StoreQ8Row<kVec>{qp, qsq, codes, scales, table, counts, probe, P, maxp, ps, width,
                              d},
             P * width, lp, chunk, g, pv, pi, lv, li);
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
      swap_lists(av, ai, bv, bi);
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

// Lanes per row of kernel 5 (both modes): each lane takes up to 4 of the row's vectors
// (or scalars), so that a row's shuffle tree is short and a warp scores more rows at
// once. The block and store modes must use the same count to agree bit for bit.
inline int scan_lanes(int units) { return group_lanes((units + 3) / 4); }

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
  const int g = scan_lanes(vec ? d / V : d);
  const dim3 grid(B, S);
  const size_t sm = stage1_smem(lp, lv);
  auto kernel = vec ? flash_probe_grouped_kernel<T, true> : flash_probe_grouped_kernel<T, false>;
  kernel<<<grid, kThreads, sm, st>>>((const T*)q, (const T*)c, C, d, lp, chunk, g, (float*)pv,
                                     (int*)pi, (float*)lv, (int*)li);
  return cudaGetLastError();
}

// The tile mode: clusters of S CTAs along x (cudaLaunchKernelEx), one launch.
template <typename T, int kN>
cudaError_t launch_tile_n(const void* q, const void* c, const void* csq, void* out_v,
                          void* out_i, int N, int K, int d, int L, int S, int chunk,
                          cudaStream_t st) {
  auto kernel = flash_probe_tile_kernel<T, kN>;
  const size_t sm = tile_smem(d * (int)sizeof(T), L, S);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e != cudaSuccess) return e;
  const long long tiles = ((long long)N + kTileQ - 1) / kTileQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * S), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sm;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)c, (const float*)csq, N, K, d,
                         L, chunk, S, (float*)out_v, (int*)out_i);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* q, const void* c, const void* csq, void* out_v,
                        void* out_i, int N, int K, int d, int L, int S, int chunk,
                        cudaStream_t st) {
  const int row = d * (int)sizeof(T);
  if (L < 1 || L > kTileList || L > K || row % 16 != 0 || row > kTileRowBytes ||
      !aligned16(q) || !aligned16(c) || (S != 1 && S != 2 && S != 4 && S != 8) ||
      (long long)chunk * S < K)
    return cudaErrorInvalidValue;
  if (L > kWarpList) return launch_tile_n<T, 2>(q, c, csq, out_v, out_i, N, K, d, L, S, chunk, st);
  return launch_tile_n<T, 1>(q, c, csq, out_v, out_i, N, K, d, L, S, chunk, st);
}

// The block scan's warp mode: kWarpQueries queries a CTA.
template <typename T, int G, int kN>
cudaError_t launch_grouped_warp_g(const void* q, const void* c, void* out_v, void* out_i,
                                  int B, int C, int d, int L, cudaStream_t st) {
  const unsigned blocks = (unsigned)(((long long)B + kWarpQueries - 1) / kWarpQueries);
  flash_probe_grouped_warp_kernel<T, G, kN><<<blocks, 32 * kWarpQueries, 0, st>>>(
      (const T*)q, (const T*)c, B, C, d, L, (float*)out_v, (int*)out_i);
  return cudaGetLastError();
}

template <typename T, int kN>
cudaError_t launch_grouped_warp_n(int g, const void* q, const void* c, void* out_v,
                                  void* out_i, int B, int C, int d, int L, cudaStream_t st) {
  switch (g) {
    case 1: return launch_grouped_warp_g<T, 1, kN>(q, c, out_v, out_i, B, C, d, L, st);
    case 2: return launch_grouped_warp_g<T, 2, kN>(q, c, out_v, out_i, B, C, d, L, st);
    case 4: return launch_grouped_warp_g<T, 4, kN>(q, c, out_v, out_i, B, C, d, L, st);
    case 8: return launch_grouped_warp_g<T, 8, kN>(q, c, out_v, out_i, B, C, d, L, st);
    case 16: return launch_grouped_warp_g<T, 16, kN>(q, c, out_v, out_i, B, C, d, L, st);
    default: return launch_grouped_warp_g<T, 32, kN>(q, c, out_v, out_i, B, C, d, L, st);
  }
}

template <typename T>
cudaError_t launch_grouped_warp(const void* q, const void* c, void* out_v, void* out_i, int B,
                                int C, int d, int L, cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  if (L < 1 || L > kTileList || L > C || C > kWarpScanRows || d % V != 0 ||
      d * (int)sizeof(T) > kWarpRowBytes || !aligned16(q) || !aligned16(c))
    return cudaErrorInvalidValue;
  const int g = scan_lanes(d / V);  // the list mode's lane count: bitwise its scores
  if (L > kWarpList) return launch_grouped_warp_n<T, 2>(g, q, c, out_v, out_i, B, C, d, L, st);
  return launch_grouped_warp_n<T, 1>(g, q, c, out_v, out_i, B, C, d, L, st);
}

// The store scan's arguments (fk_flash_probe_store).
struct StoreArgs {
  const void *q, *rows, *table, *counts, *probe, *sc, *order;
  void* units;
  int B, P, maxp, ps, width, d, lp, S, chunk, tile_rows;
  float pad;
  void *pv, *pi, *lv, *li;
};

template <typename T, bool kVec, int G>
cudaError_t launch_store_g(const StoreArgs& a, cudaStream_t st) {
  const int npairs = a.B * a.P;
  // the cell mode: the prologue cuts the units, then as many CTAs as stay resident
  // take the work items from its counter
  auto kernel = flash_probe_store_kernel<T, kVec, G>;
  const size_t sm = kCellHead + (size_t)kCellStages * a.tile_rows * a.d * sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, sm);
  if (e != cudaSuccess) return e;
  int* units = (int*)a.units;
  cell_units_kernel<<<1, 1024, 0, st>>>((const int*)a.sc, npairs, units, units + npairs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long items = (long long)npairs * a.S;  // at least the units' items
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(items < resident ? items : resident), kThreads, sm, st>>>(
      (const T*)a.q, (const T*)a.rows, (const int*)a.table, (const int*)a.counts,
      (const int*)a.sc, (const int*)a.order, units, units + npairs, npairs, a.P, a.maxp, a.ps,
      a.width, a.d, a.pad, a.lp, a.chunk, a.S, a.tile_rows, (float*)a.pv, (int*)a.pi);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_store_v(int g, const StoreArgs& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch_store_g<T, kVec, 1>(a, st);
    case 2: return launch_store_g<T, kVec, 2>(a, st);
    case 4: return launch_store_g<T, kVec, 4>(a, st);
    case 8: return launch_store_g<T, kVec, 8>(a, st);
    case 16: return launch_store_g<T, kVec, 16>(a, st);
    default: return launch_store_g<T, kVec, 32>(a, st);
  }
}

template <typename T>
cudaError_t launch_store(const StoreArgs& a, bool cell, cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  const bool vec = a.d % V == 0 && aligned16(a.q) && aligned16(a.rows);
  const int g = scan_lanes(vec ? a.d / V : a.d);
  if (cell) return vec ? launch_store_v<T, true>(g, a, st) : launch_store_v<T, false>(g, a, st);
  const dim3 grid(a.B, a.S);
  const size_t sm = stage1_smem(a.lp, a.lv);
  auto kernel = vec ? flash_probe_store_list_kernel<T, true>
                    : flash_probe_store_list_kernel<T, false>;
  kernel<<<grid, kThreads, sm, st>>>((const T*)a.q, (const T*)a.rows, (const int*)a.table,
                                     (const int*)a.counts, (const int*)a.probe, a.P, a.maxp, a.ps,
                                     a.width, a.d, a.pad, a.lp, a.chunk, g, (float*)a.pv,
                                     (int*)a.pi, (float*)a.lv, (int*)a.li);
  return cudaGetLastError();
}

// The q8 store scan's arguments (fk_flash_probe_store_q8).
struct StoreQ8Args {
  const void *qp, *qsq, *codes, *scales, *table, *counts, *probe, *sc, *order;
  void* units;
  int B, P, maxp, ps, width, d, lp, S, chunk, tile_rows;
  void *pv, *pi, *lv, *li;
};

template <int G, int kN>
cudaError_t launch_store_q8_cell(const StoreQ8Args& a, cudaStream_t st) {
  const int npairs = a.B * a.P;
  auto kernel = flash_probe_store_q8_kernel<G, kN>;
  const size_t sm = kCellHead +
                    (size_t)kCellStages * (((size_t)a.tile_rows * a.d + 15) / 16 * 16 +
                                           (size_t)a.tile_rows * 4) +
                    (size_t)a.tile_rows * (16 * G + 1) * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, sm);
  if (e != cudaSuccess) return e;
  int* units = (int*)a.units;
  cell_units_kernel<<<1, 1024, 0, st>>>((const int*)a.sc, npairs, units, units + npairs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long items = (long long)npairs * a.S;  // at least the units' items
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(items < resident ? items : resident), kThreads, sm, st>>>(
      (const float*)a.qp, (const float*)a.qsq, (const int8_t*)a.codes, (const float*)a.scales,
      (const int*)a.table, (const int*)a.counts, (const int*)a.sc, (const int*)a.order, units,
      units + npairs, npairs, a.P, a.maxp, a.ps, a.width, a.d, a.lp, a.chunk, a.S, a.tile_rows,
      (float*)a.pv, (int*)a.pi);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_store_q8_g(int g, const StoreQ8Args& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch_store_q8_cell<1, kN>(a, st);
    case 2: return launch_store_q8_cell<2, kN>(a, st);
    case 4: return launch_store_q8_cell<4, kN>(a, st);
    case 8: return launch_store_q8_cell<8, kN>(a, st);
    case 16: return launch_store_q8_cell<16, kN>(a, st);
    default: return launch_store_q8_cell<32, kN>(a, st);
  }
}

cudaError_t launch_store_q8(const StoreQ8Args& a, bool cell, cudaStream_t st) {
  // the block kernel's lane count and path (kVec), so that the two agree bit for bit
  const bool vec = a.d % 16 == 0 && aligned16(a.qp) && aligned16(a.codes);
  const int g = group_lanes(vec ? a.d / 16 : a.d);
  if (cell) {
    // 8 rows a group of g lanes, one 16-code vector a lane, tiles copied in whole
    // 16-byte groups of scales, pages of a multiple of 4 rows (the wrapper sends other
    // rows and stores to the list mode)
    if (!vec || a.d > 16 * g || a.tile_rows % (8 * (32 / g)) != 0 || a.ps % 4 != 0 ||
        !aligned16(a.scales))
      return cudaErrorInvalidValue;
    if (a.lp > kWarpList) return launch_store_q8_g<2>(g, a, st);
    return launch_store_q8_g<1>(g, a, st);
  }
  const dim3 grid(a.B, a.S);
  const size_t sm = stage1_smem(a.lp, a.lv);
  auto kernel = vec ? flash_probe_store_q8_list_kernel<true>
                    : flash_probe_store_q8_list_kernel<false>;
  kernel<<<grid, kThreads, sm, st>>>((const float*)a.qp, (const float*)a.qsq,
                                     (const int8_t*)a.codes, (const float*)a.scales,
                                     (const int*)a.table, (const int*)a.counts,
                                     (const int*)a.probe, a.P, a.maxp, a.ps, a.width, a.d, a.lp,
                                     a.chunk, g, (float*)a.pv, (int*)a.pi, (float*)a.lv,
                                     (int*)a.li);
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

// The probe's tile mode (lists of at most 64, rows of whole 16-byte vectors of at most
// 1,024 bytes, 16-byte aligned q and c): S (1, 2, 4 or 8) CTAs of a cluster split K in
// slices of chunk (chunk * S >= K); outputs out_v f32 (N, L), out_i int32 (N, L).
extern "C" int fk_flash_probe_tile(const void* q, const void* c, const void* csq, void* out_v,
                                   void* out_i, int N, int K, int d, int L, int S, int chunk,
                                   int is_bf16, void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_tile<__nv_bfloat16>(q, c, csq, out_v, out_i, N, K, d, L, S,
                                                   chunk, st)
                       : launch_tile<float>(q, c, csq, out_v, out_i, N, K, d, L, S, chunk, st));
}

// The tile mode's dynamic shared memory for rows of row_bytes, lists of L, clusters of S.
extern "C" int fk_flash_probe_tile_smem(int row_bytes, int L, int S, int* out) {
  *out = (int)fk::probe::tile_smem(row_bytes, L, S);
  return 0;
}

// The block scan's warp mode (lists of at most 64, blocks of at most 1,024 rows of whole
// 16-byte vectors, 16-byte aligned q and c): a warp per query, no partial lists.
extern "C" int fk_flash_probe_grouped_warp(const void* q, const void* c, void* out_v,
                                           void* out_i, int B, int C, int d, int L, int is_bf16,
                                           void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16
                   ? launch_grouped_warp<__nv_bfloat16>(q, c, out_v, out_i, B, C, d, L, st)
                   : launch_grouped_warp<float>(q, c, out_v, out_i, B, C, d, L, st));
}

// The store scan: q (B, d), rows (pages, ps, d) of q's dtype, table (cells, maxp) int32
// page ids (slot w of cell c is row w % ps of page table[c * maxp + w / ps]; nullptr:
// cell c on page c, maxp 1), counts (cells,), probe (B, P) int32. cell != 0 (the cell mode): sc and order are probe's cells sorted and
// their positions b * P + p, units scratch of B * P + 2 ints; S splits of each pair's
// `width` slots in chunks, B * P * S partial lists (the merge takes P * S a query).
// cell == 0 (the list mode): S CTAs per query split its P * width slots, B * S lists
// (sc, order, units unused). With a single list per query part must be the outputs.
extern "C" int fk_flash_probe_store(const void* q, const void* rows, const void* table,
                                    const void* counts, const void* probe, const void* sc,
                                    const void* order, void* units, void* out_v, void* out_i,
                                    void* part_v, void* part_i, void* lws_v, void* lws_i,
                                    void* mws_v, void* mws_i, int B, int P, int maxp, int ps,
                                    int width, int d, int L, int S, int chunk, int lp,
                                    int tile_rows, float pad, int cell, int is_bf16,
                                    void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  if (maxp < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  const StoreArgs a{q,     rows, table, counts, probe, sc,        order, units,  B,
                    P,     maxp, ps,    width,  d,     lp,        S,     chunk,  tile_rows,
                    pad,   part_v, part_i, lws_v, lws_i};
  const cudaError_t e = is_bf16 ? launch_store<__nv_bfloat16>(a, cell != 0, st)
                                : launch_store<float>(a, cell != 0, st);
  if (e != cudaSuccess) return (int)e;
  const int lists = cell ? P * S : S;
  return (int)merge_partials(B, lists, lp, L, part_v, part_i, mws_v, mws_i, out_v, out_i, st);
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

// The q8 store scan: qp (B, P, d) f32 shifted queries, qsq workspace of B * P floats
// for ||q'||^2 (written by a prologue kernel), codes (pages, ps, d) int8, scales
// (pages, ps) f32, table (cells, maxp) int32 page ids (nullptr: cell c on page c),
// counts (cells,), probe (B, P) int32. cell != 0 (the cell mode, lists of at most
// kQ8List): sc and order are probe's cells sorted and their positions b * P + p, units
// scratch of B * P + 2 ints; S splits of each pair's width slots in chunks (a multiple
// of 4), B * P * S partial lists. cell == 0 (the list mode): S CTAs per query split its
// P * width slots, B * S lists. With a single list per query part must be the outputs.
extern "C" int fk_flash_probe_store_q8(const void* qp, void* qsq, const void* codes,
                                       const void* scales, const void* table,
                                       const void* counts, const void* probe, const void* sc,
                                       const void* order, void* units, void* out_v, void* out_i,
                                       void* part_v, void* part_i, void* lws_v, void* lws_i,
                                       void* mws_v, void* mws_i, int B, int P, int maxp, int ps,
                                       int width, int d, int L, int S, int chunk, int lp,
                                       int tile_rows, int cell, void* stream) {
  using namespace fk::probe;
  cudaStream_t st = (cudaStream_t)stream;
  if (maxp < 1 || ps < 1 || (cell && (lp > kQ8List || chunk % 4 != 0 || tile_rows % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = fk::launch_csq_f32((const float*)qp, (float*)qsq, (long long)B * P, d, st);
  if (e != cudaSuccess) return (int)e;
  const StoreQ8Args a{qp,   qsq, codes, scales, table, counts, probe,  sc,     order,
                      units, B,   P,     maxp,   ps,    width,  d,      lp,     S,
                      chunk, tile_rows, part_v, part_i, lws_v, lws_i};
  e = launch_store_q8(a, cell != 0, st);
  if (e != cudaSuccess) return (int)e;
  const int lists = cell ? P * S : S;
  return (int)merge_partials(B, lists, lp, L, part_v, part_i, mws_v, mws_i, out_v, out_i, st);
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
    case 3: e = cudaFuncGetAttributes(&a, topl_merge_kernel); break;
    case 4: e = cudaFuncGetAttributes(&a, flash_probe_store_kernel<float, true, 8>); break;
    case 5: e = cudaFuncGetAttributes(&a, flash_probe_store_kernel<__nv_bfloat16, true, 4>); break;
    case 6: e = cudaFuncGetAttributes(&a, flash_probe_store_list_kernel<float, true>); break;
    case 7: e = cudaFuncGetAttributes(&a, flash_probe_store_q8_kernel<8, 1>); break;
    case 8: e = cudaFuncGetAttributes(&a, flash_probe_store_q8_kernel<8, 2>); break;
    case 9: e = cudaFuncGetAttributes(&a, flash_probe_store_q8_list_kernel<true>); break;
    case 10: e = cudaFuncGetAttributes(&a, flash_probe_tile_kernel<float, 1>); break;
    case 11: e = cudaFuncGetAttributes(&a, flash_probe_tile_kernel<float, 2>); break;
    case 12: e = cudaFuncGetAttributes(&a, flash_probe_tile_kernel<__nv_bfloat16, 1>); break;
    case 13: e = cudaFuncGetAttributes(&a, flash_probe_grouped_warp_kernel<float, 8, 1>); break;
    case 14: e = cudaFuncGetAttributes(&a, flash_probe_grouped_warp_kernel<float, 8, 2>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
