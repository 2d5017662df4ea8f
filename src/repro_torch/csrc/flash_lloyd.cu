// FlashLloyd for Hopper (sm_90a): one Lloyd iteration's statistics in one pass.
//
// Replaces: src/repro/kernels/flash_lloyd.py, flash_lloyd_raw / _flash_lloyd_kernel
// (the Pallas TPU kernel that keeps the (K_pad, d) sums resident in VMEM across
// its sequential grid and adds each tile into them with a one-hot MXU product).
//
// Computes the assignments a (as FlashAssign), the per-cluster sums (K, d) and
// counts (K,), and the inertia sum_n max(m_n + ||x_n||^2, 0), reading x from HBM
// once.
//
// What bounds it on the H100: tensor-core operations, as FlashAssign: 2 N K d flops
// at 3xTF32 for f32 (3 * 2 N K d / 495 TFLOP/s) and bf16 for bf16 (2 N K d / 989
// TFLOP/s). Beside them it adds N d values into shared memory and flushes
// (K d + K) values per cluster of CTAs; the constraint the two-pass path does not
// have is shared memory, where the (K, d) f32 sums must live beside the ring.
//
// Design:
// - The argmin is the tensor-core mainloop of tc_argmin.cuh (two consumer
//   warpgroups, one TMA producer warp), with the streamed-x layout: each ring
//   stage carries its x chunk beside its centroid chunk (2 stages of 64 KB for
//   f32, 4 of 32 KB for bf16), which leaves room for the sums. The instructions
//   and chunks are FlashAssign's, so the ids equal FlashAssign's bit for bit. The
//   consumers also sum ||x||^2 of their rows from the x chunks of the first
//   centroid tile, so the inertia needs no second read of x. The cost of the
//   layout: in f32 each x chunk is split into tf32 parts again for every
//   centroid tile after the first (FlashAssign keeps x resident).
// - The sums live in the distributed shared memory of a thread-block cluster of C
//   in {1, 2, 4, 8} CTAs: CTA r holds the contiguous slice of ks = ceil(K / C)
//   rows from r ks on, of the sums and counts, so a CTA needs 4 (K d + K) / C
//   bytes of them. The C CTAs of a cluster sweep point tiles in lockstep rounds.
//   Each round the consumers publish their tile's ids in a slot of shared memory
//   (two slots, mbarriers at cluster scope: ready when every CTA of the cluster
//   has published, free when every CTA has read). Three adder warps per CTA read
//   the ids of every CTA's slot (ld.shared::cluster) and keep the rows whose id
//   this CTA owns, in the list of the warp that owns the local id (lk % 3); each
//   warp reads its rows again from L2, where the TMA has just brought them, and
//   adds them into the slice with plain shared loads and stores, 8 rows in flight
//   and a lane per four columns. Every value of a slice has one writer, so no add
//   is atomic: on this card an f32 atomicAdd to shared memory compiles to a
//   compare-and-swap loop (ATOMS.CAST.SPIN), and one to another CTA's shared
//   memory (red.shared::cluster) to a generic atom that waits for its reply
//   (cuobjdump -sass), so N d of them would cost more than the argmin. The adders
//   run beside the next round's argmin.
// - The grid is persistent (the clusters the card keeps resident, shared by the B
//   problems); every CTA of a cluster runs the same number of rounds, publishing
//   an empty tile where it has none left. The slices are zeroed and the cluster
//   synchronised before the first round; after the last the cluster synchronises
//   again and each CTA flushes its slice (non-zero values only) into the global
//   sums and counts with one atomicAdd each, so the flush is (K d + K) values per
//   cluster, and writes its inertia partial to inertia_part[b, blockIdx.x] (the
//   wrapper sums the partials).
//
// Layout: x (B, N, dp), c (B, K, dp) row-major, dp a multiple of 4 (f32) or 8
// (bf16) (the wrapper zero-pads d); a (B, N) int32; sums (B, K, dp), counts (B, K),
// inertia_part (B, grid_x) float32, sums and counts zeroed by the caller. Grid
// (grid_x, B), grid_x a multiple of C, clusters of (C, 1, 1), 384 threads (a
// 416-thread CTA would put 4 warps on one SM sub-partition and cap them at 128
// registers), dynamic shared memory smem_bytes().
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W; PERF.md): N = 65,536, K = 256,
// d = 128 in 0.078 ms f32 (C = 2; bound 0.026 ms, FlashAssign 0.048 ms) and
// 0.054 ms bf16.
#include <type_traits>

#include "tc_argmin.cuh"

namespace fk {
namespace fl {

using namespace fk::tc;

template <bool kF32>
using Ring = Cfg<kF32, false, kF32 ? 2 : 4>;
constexpr int kAdders = 96;                    // three adder warps
constexpr int kAdderWarps = kAdders / 32;
constexpr int kThreadsL = kThreads + kAdders;  // consumers, producer, adders
constexpr int kSlots = 2;                      // published tiles in flight
constexpr int kBatch = 8;                      // rows an adder warp loads at once

// Shared memory past the ring (which starts at a 1024-byte aligned base): the
// ready and free mbarriers of the published slots, the slots (a tile's ids), the
// tile's row norms, the adder warps' list lengths and the consumer warps'
// inertia, then one owned-row list per adder warp (C kBM codes each) and the
// CTA's slice of ks rows of sums and counts.
constexpr int kBars = 2 * kSlots * 8;
constexpr int kPub = kSlots * kBM * 4;
constexpr int kRowSq = kBM * 4;
constexpr int kMisc = 64;
template <bool kF32>
constexpr int kFixed = Ring<kF32>::kBytes + 1024 + kBars + kPub + kRowSq + kMisc;

inline size_t smem_bytes(bool f32, int dp, int ks, int cluster) {
  return (size_t)(f32 ? kFixed<true> : kFixed<false>) +
         (size_t)kAdderWarps * cluster * kBM * 4 + 4 * ((size_t)ks * dp + ks);
}

// arrives on an mbarrier of a CTA of the cluster (release at cluster scope)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// waits for a phase that other CTAs of the cluster complete (acquire at cluster scope)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// four consecutive values of a row
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool kF32>
__global__ void __launch_bounds__(kThreadsL, 1)
    flash_lloyd_tc(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tc_hi,
                   const __grid_constant__ CUtensorMap tc_lo, const void* __restrict__ xv,
                   const float* __restrict__ csq, int* __restrict__ a,
                   float* __restrict__ sums, float* __restrict__ cnt,
                   float* __restrict__ inertia_part, int N, int K, int Kp, int dp, int ks,
                   int cluster) {
  using C = Ring<kF32>;
  using T = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Pipe<C> pipe{base};
  uint8_t* const tail = smem_raw + (base - raw) + C::kBytes;
  const uint32_t bars = smem_u32(tail);  // ready[s] at 8 s, free[s] at 8 (kSlots + s)
  int* const pub = reinterpret_cast<int*>(tail + kBars);  // [slot][kBM] ids
  float* const row_sq = reinterpret_cast<float*>(tail + kBars + kPub);
  int* const list_n = reinterpret_cast<int*>(tail + kBars + kPub + kRowSq);
  float* const s_red = reinterpret_cast<float*>(list_n + 4);  // consumer warps
  int* const lists = reinterpret_cast<int*>(tail + kBars + kPub + kRowSq + kMisc);
  const int cap = cluster * kBM;  // entries of one adder warp's list
  float* const s_sums = reinterpret_cast<float*>(lists + kAdderWarps * cap);  // ks x dp
  float* const s_cnt = s_sums + (size_t)ks * dp;                              // ks
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nk = Kp / kBN;
  const int nd = (dp + C::kChunk - 1) / C::kChunk;
  const int tiles = (N + kBM - 1) / kBM;
  const int rounds = (tiles + gridDim.x - 1) / gridDim.x;  // the same in every CTA
  auto ready = [&](int s) { return bars + 8 * s; };
  auto freed = [&](int s) { return bars + 8 * (kSlots + s); };

  for (int i = tid; i < ks * dp + ks; i += kThreadsL) s_sums[i] = 0.f;
  if (tid == 0) {
    pipe.init();
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(ready(s), cluster);  // one arrival per publishing CTA
      mbar_init(freed(s), cluster);  // one arrival per owning CTA
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every slice zeroed, every barrier initialised

  if (tid < kConsumers) {
    // Consumers: the argmin of the CTA's tile of each round with its rows'
    // ||x||^2 (the inertia is summed here), the ids published per row (-1 past N,
    // or when the CTA has no tile this round) for the adders of every CTA of the
    // cluster.
    const float* cq = csq + (long long)b * Kp;
    const int r0 = row_of_thread();
    float inertia = 0.f;
    int t = 0;
    for (int i = 0; i < rounds; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int s = i % kSlots;
      float best_v[2], x_sq[2];
      int best_i[2];
      if (tile < tiles)
        pipe.template argmin<true>(cq, t, nk, nd, best_v, best_i, row_sq, x_sq);
      mbar_wait_cluster(freed(s), ((i / kSlots) & 1) ^ 1);  // every owner has read it
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const int n = tile * kBM + row;
          const bool valid = tile < tiles && n < N;
          pub[s * kBM + row] = valid ? best_i[r] : -1;
          if (valid) {
            a[(long long)b * N + n] = best_i[r];
            inertia += fmaxf(best_v[r] + x_sq[r], 0.f);
          }
        }
      }
      bar_sync(3, kConsumers);
      if (tid == 0)
        for (int j = 0; j < cluster; ++j) mbar_arrive_cluster(map_rank(ready(s), j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      inertia += __shfl_xor_sync(0xffffffffu, inertia, off);
    if (lane == 0) s_red[tid >> 5] = inertia;
  } else if (tid < kThreads) {
    // Producer: one thread issues the TMA of every tile the consumers sweep.
    if (tid == kConsumers) {
      int t = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        pipe.produce(&tx, &tc_hi, &tc_lo, t, tile * kBM, b, nk, nd);
    }
  } else {
    // Adders: each round, the rows of the cluster's published tiles whose cluster
    // id this CTA owns go into the list of the adder warp that owns the local id
    // lk (lk % 3); each warp then reads its rows again from L2 and adds them into
    // the slice, a lane per four columns, so that every value of the slice has
    // one writer and needs no atomic.
    const T* xb = reinterpret_cast<const T*>(xv) + (long long)b * N * dp;
    const int at = tid - kThreads;  // 0 .. kAdders - 1
    const int w = at >> 5;
    const int nv4 = dp >> 2;  // 4-value vectors of a row
    int* const mine_list = lists + w * cap;
    for (int i = 0; i < rounds; ++i) {
      const int s = i % kSlots;
      const int tile0 = blockIdx.x - (int)rank + i * gridDim.x;  // rank 0's tile
      mbar_wait_cluster(ready(s), (i / kSlots) & 1);
      bar_sync(4, kAdders);  // the previous round's lists have been read
      if (at < kAdderWarps) list_n[at] = 0;
      bar_sync(4, kAdders);
      for (int row = at; row < kBM; row += kAdders) {  // uniform in a warp
        int id[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          id[j] = j < cluster ? ld_cluster(map_rank(smem_u32(pub + s * kBM + row), j))
                              : -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int lk = id[j] - (int)rank * ks;
          const bool mine = id[j] >= 0 && lk >= 0 && lk < ks;
          const int bucket = mine ? lk % kAdderWarps : -1;
          const unsigned grp = __match_any_sync(0xffffffffu, bucket);
          const int leader = __ffs(grp) - 1;
          int pos = 0;
          if (mine && lane == leader) pos = atomicAdd(&list_n[bucket], __popc(grp));
          pos = __shfl_sync(0xffffffffu, pos, leader) + __popc(grp & ((1u << lane) - 1u));
          if (mine) lists[bucket * cap + pos] = (lk << 10) | (j << 7) | row;
        }
      }
      bar_sync(4, kAdders);  // every published id read, every entry listed
      if (at == 0)
        for (int j = 0; j < cluster; ++j) mbar_arrive_cluster(map_rank(freed(s), j));
      const int nl = list_n[w];
      for (int e0 = 0; e0 < nl; e0 += kBatch) {
        int lk[kBatch], n[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int code = e0 + u < nl ? mine_list[e0 + u] : 0;
          lk[u] = code >> 10;
          n[u] = (tile0 + ((code >> 7) & 7)) * kBM + (code & 127);
        }
        for (int v = lane; v < nv4; v += 32) {
          float4 x4[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (e0 + u < nl) x4[u] = load4(xb + (long long)n[u] * dp + 4 * v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (e0 + u < nl) {
              float4* p = reinterpret_cast<float4*>(s_sums + (size_t)lk[u] * dp) + v;
              float4 o = *p;
              o.x += x4[u].x;
              o.y += x4[u].y;
              o.z += x4[u].z;
              o.w += x4[u].w;
              *p = o;
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (e0 + u < nl) s_cnt[lk[u]] += 1.f;
        }
      }
    }
  }
  __syncwarp();
  cluster_sync();  // every addition has landed; no CTA reads another's memory after it

  if (tid == 0) {
    float total = 0.f;
    for (int j = 0; j < kConsumers / 32; ++j) total += s_red[j];
    inertia_part[(long long)b * gridDim.x + blockIdx.x] = total;
  }
  const int k0 = (int)rank * ks;
  const int rows = min(ks, K - k0);
  if (rows <= 0) return;
  float* gs = sums + ((long long)b * K + k0) * dp;
  float* gc = cnt + (long long)b * K + k0;
  for (int i = tid; i < rows * dp; i += kThreadsL) {
    const float v = s_sums[i];
    if (v != 0.f) atomicAdd(&gs[i], v);
  }
  for (int i = tid; i < rows; i += kThreadsL) {
    const float v = s_cnt[i];
    if (v != 0.f) atomicAdd(&gc[i], v);
  }
}

template <bool kF32>
cudaError_t set_smem(size_t bytes) {
  return cudaFuncSetAttribute(flash_lloyd_tc<kF32>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

inline cudaLaunchConfig_t config(dim3 grid, size_t smem, int cluster, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsL, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kF32>
cudaError_t launch(const Operands& o, const void* x, const float* csq, int* a,
                   float* sums, float* cnt, float* part, int B, int N, int K, int dp,
                   int cluster, int grid_x, cudaStream_t s) {
  const int ks = (K + cluster - 1) / cluster;
  const size_t smem = smem_bytes(kF32, dp, ks, cluster);
  cudaError_t e = set_smem<kF32>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(grid_x, B, 1), smem, cluster, s, attr);
  return cudaLaunchKernelEx(&cfg, flash_lloyd_tc<kF32>, o.tx, o.thi, o.tlo, x, csq, a,
                            sums, cnt, part, N, K, o.Kp, dp, ks, cluster);
}

}  // namespace fl
}  // namespace fk

// x (B, N, dp), c (B, K, dp); csq (B, Kp) (Kp = K rounded up to 128) and, for
// f32, csplit (2, B, K, dp) are scratch; a (B, N) int32, sums (B, K, dp), counts
// (B, K) (both zeroed) and inertia_part (B, grid_x) out. cluster in {1, 2, 4, 8},
// grid_x a multiple of it; N >= 1, K < 2^21.
extern "C" int fk_flash_lloyd(const void* x, const void* c, void* csq, void* csplit,
                              void* a, void* sums, void* cnt, void* inertia_part, int B,
                              int N, int K, int dp, int cluster, int grid_x, int is_bf16,
                              void* stream) {
  using namespace fk::fl;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = !is_bf16;
  if (dp % (f32 ? 4 : 8) != 0 || N < 1 || K < 1 || K >= (1 << 21) || B < 1 ||
      !valid_cluster(cluster) || grid_x < cluster || grid_x % cluster != 0)
    return (int)cudaErrorInvalidValue;
  Operands o;
  cudaError_t e = prepare(o, x, c, csq, csplit, B, N, K, dp, f32, s);
  if (e != cudaSuccess) return (int)e;
  const float* cq = (const float*)csq;
  e = f32 ? launch<true>(o, x, cq, (int*)a, (float*)sums, (float*)cnt,
                         (float*)inertia_part, B, N, K, dp, cluster, grid_x, s)
          : launch<false>(o, x, cq, (int*)a, (float*)sums, (float*)cnt,
                          (float*)inertia_part, B, N, K, dp, cluster, grid_x, s);
  return (int)e;
}

// The shared memory of the launch at (dp, K, cluster), read back from the kernel's
// attributes after the launch's own cudaFuncSetAttribute: dynamic bytes and static.
extern "C" int fk_flash_lloyd_smem(int is_bf16, int dp, int K, int cluster, int* dyn,
                                   int* stat) {
  using namespace fk::fl;
  if (!valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(!is_bf16, dp, (K + cluster - 1) / cluster, cluster);
  cudaFuncAttributes attr;
  cudaError_t e = is_bf16 ? set_smem<false>(smem) : set_smem<true>(smem);
  if (e != cudaSuccess) return (int)e;
  e = is_bf16 ? cudaFuncGetAttributes(&attr, flash_lloyd_tc<false>)
              : cudaFuncGetAttributes(&attr, flash_lloyd_tc<true>);
  if (e != cudaSuccess) return (int)e;
  *dyn = attr.maxDynamicSharedSizeBytes;
  *stat = (int)attr.sharedSizeBytes;
  return 0;
}

// Clusters of `cluster` CTAs that can be resident at once for the launch at
// (dp, K, cluster) (cudaOccupancyMaxActiveClusters): the persistent grid's size.
extern "C" int fk_flash_lloyd_clusters(int is_bf16, int dp, int K, int cluster,
                                       int* out) {
  using namespace fk::fl;
  if (!valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(!is_bf16, dp, (K + cluster - 1) / cluster, cluster);
  cudaError_t e = is_bf16 ? set_smem<false>(smem) : set_smem<true>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(cluster, 1, 1), smem, cluster, 0, attr);
  const void* fn = is_bf16 ? (const void*)flash_lloyd_tc<false>
                           : (const void*)flash_lloyd_tc<true>;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}
