// The device rescore cache's batched insert (sm_90a): second-chance/clock
// replacement over a set-associative id -> fp32-row table.
//
// Replaces the sequential `fori_loop` of `_cache_insert` in
// src/repro/index/rescore_cache.py (l.99-146), an XLA loop, not a Pallas kernel:
// no `pl.pallas_call` stands behind it.
//
// Iteration i of the reference loop touches only set s = id % sets, so items of
// different sets are independent and the loop is exactly "for each set, its items
// in batch order". The wrapper (kernels/rescore_cache.py) groups the batch by set
// with one stable sort and gives each set its segment [seg[s], seg[s + 1]) of
// `order`; ids of -1 sort past the last set and are never visited. Here one warp
// owns a set: lanes 0..ways-1 hold its keys and ref bits in registers, and for
// each item, in batch order, the warp finds by ballot
//   - a hit (the lane holding the id): the row is refreshed and its ref bit set;
//   - else the first empty lane (key < 0): claimed, ref bit set;
//   - else the clock victim: the sweep from `hand` evicts the first lane with ref
//     0 and clears the ref bits of the lanes it passed; if every lane holds a ref
//     bit, all are cleared and the lane under the hand is evicted; the victim's
//     ref bit is set and `hand` becomes (victim + 1) % ways;
// then all 32 lanes copy the d-float row. The set's lanes and hand are written
// back once. Bound by bytes: ids and rows read once, rows and lanes written once.
#include "common.cuh"

namespace fk {
namespace rc {

constexpr int kWarps = 8;  // sets (warps) a CTA

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    cache_insert_kernel(int* __restrict__ keys, float* __restrict__ rows,
                        int* __restrict__ ref, int* __restrict__ hand,
                        const int* __restrict__ ids, const float* __restrict__ x,
                        const int* __restrict__ order, const int* __restrict__ seg, int sets,
                        int ways, int d) {
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= sets) return;  // uniform across the warp
  const int beg = seg[s], end = seg[s + 1];
  if (beg == end) return;
  const bool mine = lane < ways;
  const size_t base = (size_t)s * ways;
  int key = mine ? keys[base + lane] : 0;
  int rf = mine ? ref[base + lane] : 0;
  int h = hand[s];
  const unsigned live = ways == 32 ? 0xffffffffu : (1u << ways) - 1u;
  for (int t = beg; t < end; ++t) {
    const int i = order[t];
    const int id = ids[i];
    const unsigned hit = __ballot_sync(0xffffffffu, mine && key == id);
    int way;
    if (hit) {
      way = __ffs(hit) - 1;
    } else {
      const unsigned empty = __ballot_sync(0xffffffffu, mine && key < 0);
      if (empty) {
        way = __ffs(empty) - 1;
      } else {
        // bit j of rot: the lane j steps past the hand, (h + j) % ways
        const unsigned long long zero = __ballot_sync(0xffffffffu, mine && rf == 0);
        const unsigned rot = (unsigned)(((zero | (zero << ways)) >> h) & live);
        const int vpos = rot ? __ffs(rot) - 1 : ways;
        way = rot ? (h + vpos) % ways : h;
        if (mine && (lane - h + ways) % ways < vpos) rf = 0;  // second chances spent
        h = (way + 1) % ways;
      }
      if (lane == way) key = id;
    }
    if (lane == way) rf = 1;
    const size_t dst = (base + way) * (size_t)d, src = (size_t)i * d;
    if (kVec) {
      const float4* xs = reinterpret_cast<const float4*>(x + src);
      float4* rs = reinterpret_cast<float4*>(rows + dst);
      for (int j = lane; j < d / 4; j += 32) rs[j] = xs[j];
    } else {
      for (int j = lane; j < d; j += 32) rows[dst + j] = x[src + j];
    }
  }
  if (mine) {
    keys[base + lane] = key;
    ref[base + lane] = rf;
  }
  if (lane == 0) hand[s] = h;
}

}  // namespace rc
}  // namespace fk

// keys (sets, ways) int32, rows (sets, ways, d) f32, ref (sets, ways) int32, hand
// (sets,) int32, updated in place; ids (m,) int32, x (m, d) f32, order (m,) int32,
// seg (sets + 1,) int32 from the wrapper's grouping. vec: d % 4 == 0 and x, rows
// 16-byte aligned (float4 copies).
extern "C" int fk_rescore_cache_insert(void* keys, void* rows, void* ref, void* hand,
                                       const void* ids, const void* x, const void* order,
                                       const void* seg, int sets, int ways, int d, int vec,
                                       void* stream) {
  using namespace fk::rc;
  if (sets <= 0) return 0;
  if (ways < 1 || ways > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((sets + kWarps - 1) / kWarps);
  if (vec)
    cache_insert_kernel<true><<<blocks, kWarps * 32, 0, st>>>(
        (int*)keys, (float*)rows, (int*)ref, (int*)hand, (const int*)ids, (const float*)x,
        (const int*)order, (const int*)seg, sets, ways, d);
  else
    cache_insert_kernel<false><<<blocks, kWarps * 32, 0, st>>>(
        (int*)keys, (float*)rows, (int*)ref, (int*)hand, (const int*)ids, (const float*)x,
        (const int*)order, (const int*)seg, sets, ways, d);
  return (int)cudaGetLastError();
}
