// Set-matching auction for Hopper (sm_90a).
//
// K12 u3d_auction_lap replaces the Pallas kernel
//    uni3detr_tpu/ops/matching_pallas.py::_auction_kernel (entry
//    auction_lap_pallas): an asymmetric single-phase forward auction of
//    M bidders (GT columns, M <= N) over N items (queries), all prices
//    starting at 0, eps = spread / eps_div. Each Jacobi round:
//    1. every unassigned bidder finds its best value v1 = max_j
//       (benefit[i,j] - price[j]) at the first (lowest) item j1, the
//       second value v2 over the other items (v1 when there is none) and
//       bids price[j1] + (v1 - v2) + eps;
//    2. every item takes its highest bid, ties to the lowest bidder;
//    3. the previous owners of re-sold items are evicted;
//    4. the winners are installed and the prices set to the bids.
//    It stops when every bidder holds an item or after max_iters rounds;
//    bidders left unassigned return -1.
//
// What bounds it: the chain of dependent rounds. On the model's own costs
// at random init (near-equal values) a train step's instances run 40 (SUN
// RGB-D) to 66 (nuScenes) rounds, a third of the bidders still open in an
// average round (a price war), so a round's latency is what counts: its
// row passes, barriers and bid resolution, not the M*N of the first round.
// Design, per instance:
// - A round costs O(open bidders): the open bidders are kept in a list
//   (losers and evicted owners append themselves), each bid is one 64-bit
//   shared-memory atomicMax on its item's key (the bid's order-preserving
//   integer image above M-1-i, so the largest key is the highest bid with
//   ties to the lowest bidder; the atomic is a compare-and-swap loop on
//   this card, yet a scan of the round's bids per item measured slower),
//   and after a barrier each bidder reads its item's key and, if it names
//   it, evicts the owner and installs itself. Only touched items are read
//   or written; keys are double-buffered by round parity and cleared a
//   round later by the bidders that used them. In a cluster each block
//   takes its own bidders' bids in its own keys (local atomics only), and
//   a bidder reads its item's key in every block.
// - A row pass (step 1) is one warp when many bidders are open, and is
//   split over up to 16 warps (partial top-2 per part, merged in order)
//   when few are, so the last rounds do not run a 1024-wide row 32 lanes
//   at a time.
// - The benefit rows live in shared memory: one block when the instance
//   fits (SUN RGB-D 64 x 384, 96 KB), else a cluster of two blocks that
//   each hold every other bidder row (nuScenes 96 x 1024: 2 x 192 KB;
//   KITTI 256 x 384; alternate rows, because the open bidders of a price
//   war bunch in one half, and a block waits for the other at every
//   barrier). Prices and owners are mirrored in both blocks (a round
//   changes a few) through distributed shared memory, and the round's
//   phases are separated by cluster barriers. A larger instance reads its
//   rows from global memory (L2) in one block, whose row passes are
//   slower.
//
// The arithmetic is the TPU kernel's, operation for operation (fp32
// subtractions, adds and compares only, eps one fp32 division), so the
// assignment equals the plain version bit for bit; the kernel also writes
// the rounds each instance ran and the bids it placed.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int AUC_THREADS = 512;
constexpr int AUC_WARPS = AUC_THREADS / 32;
constexpr float AUC_NEG = -1e30f;   // the TPU kernel's "no value"
constexpr unsigned FULL = 0xffffffffu;

// best value v1 at item j1 (lowest on ties) and the best value v2 of the
// other items, of a set of (value, item) pairs
struct Top2 {
  float v1;
  int j1;
  float v2;
};

__device__ __forceinline__ Top2 top2_empty(int N) {
  return {-CUDART_INF_F, N, AUC_NEG};
}

__device__ __forceinline__ void top2_push(Top2& t, float v, int j) {
  if (v > t.v1) {         // strict: the first maximum stays
    t.v2 = fmaxf(t.v2, t.v1);
    t.v1 = v;
    t.j1 = j;
  } else {
    t.v2 = fmaxf(t.v2, v);
  }
}

// the union of two disjoint sets; exact in any order (max is exact)
__device__ __forceinline__ void top2_merge(Top2& a, float v1, int j1,
                                           float v2) {
  if (v1 > a.v1 || (v1 == a.v1 && j1 < a.j1)) {
    a.v2 = fmaxf(fmaxf(a.v2, v2), a.v1);
    a.v1 = v1;
    a.j1 = j1;
  } else {
    a.v2 = fmaxf(fmaxf(a.v2, v2), v1);
  }
}

__device__ __forceinline__ void top2_warp(Top2& t) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v1 = __shfl_xor_sync(FULL, t.v1, o);
    const int j1 = __shfl_xor_sync(FULL, t.j1, o);
    const float v2 = __shfl_xor_sync(FULL, t.v2, o);
    top2_merge(t, v1, j1, v2);
  }
}

// order-preserving image of a bid above bidder i's tie rank: the largest
// key is the highest bid, ties to the lowest bidder. -0.0 counts as +0.0,
// as the plain version's == does. Every key of a finite bid is > 0, so 0
// is "no bid".
__device__ __forceinline__ unsigned long long bid_key(float bid, int i,
                                                      int M) {
  if (bid == 0.f) bid = 0.f;
  unsigned u = __float_as_uint(bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(M - 1 - i);
}

// shared-memory layout of one block; the same in every block of a cluster
struct Layout {
  int N, MH, parts;
  __host__ __device__ Layout(int M, int N_, int CL) : N(N_) {
    MH = (M + CL - 1) / CL;
    parts = MH > AUC_WARPS ? MH : AUC_WARPS;
  }
  // keys 2 x N u64 | price N | owner N | item MH | list 2 x MH | top MH |
  // bid MH | partial v1, j1, v2 x parts | count 2 | (16-byte aligned)
  // benefit MH x N
  __host__ __device__ long long state_bytes() const {
    const long long b = 16LL * N + 8LL * N + 4LL * (6 * MH + 3 * parts + 2);
    return (b + 15) / 16 * 16;
  }
  __host__ __device__ long long bytes(bool with_benefit) const {
    return state_bytes() + (with_benefit ? 4LL * MH * N : 0);
  }
};

// rank r's copy of a shared-memory address of this block
template <int CL, typename T>
__device__ __forceinline__ T* peer(T* p, int r) {
  if constexpr (CL == 1) {
    return p;
  } else {
    return cg::this_cluster().map_shared_rank(p, r);
  }
}

// every thread of the instance's blocks; release/acquire at cluster scope
template <int CL>
__device__ __forceinline__ void round_barrier() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// One instance per block (CL == 1) or per cluster of CL blocks, block r
// holding the bidders i with i % CL == r (local index i / CL).
// SMEM_BENEFIT: the block's benefit rows in shared memory, else read from
// global memory (one block only).
template <int CL, bool SMEM_BENEFIT>
__global__ void __launch_bounds__(AUC_THREADS) u3d_auction_kernel(
    const float* __restrict__ benefit, const float* __restrict__ spread,
    int* __restrict__ out, int* __restrict__ counts, int M, int N,
    float eps_div, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(M, N, CL);
  const int MH = L.MH;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  float* s_price = reinterpret_cast<float*>(s_key + 2 * N);
  int* s_owner = reinterpret_cast<int*>(s_price + N);
  int* s_item = s_owner + N;                    // this block's bidders
  int* s_list = s_item + MH;                    // 2 x MH open bidders
  int* s_top = s_list + 2 * MH;                 // per list entry
  float* s_bid = reinterpret_cast<float*>(s_top + MH);
  float* s_pv1 = s_bid + MH;
  int* s_pj1 = reinterpret_cast<int*>(s_pv1 + L.parts);
  float* s_pv2 = reinterpret_cast<float*>(s_pj1 + L.parts);
  int* s_cnt = reinterpret_cast<int*>(s_pv2 + L.parts);   // 2
  const int rank = CL == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int inst = blockIdx.x / CL;
  const int mh = (M - rank + CL - 1) / CL;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  const float* ben = benefit + (long long)inst * M * N;
  if (SMEM_BENEFIT) {
    float* s_ben = reinterpret_cast<float*>(smem + L.state_bytes());
    const long long n = (long long)mh * N;
    for (long long e = tid; e < n; e += AUC_THREADS)
      s_ben[e] = ben[((e / N) * CL + rank) * N + e % N];
    ben = s_ben;
  }
  const float eps = spread[inst] / eps_div;
  for (int j = tid; j < N; j += AUC_THREADS) {
    s_price[j] = 0.f;
    s_owner[j] = -1;
    s_key[j] = 0ull;
    s_key[N + j] = 0ull;
  }
  for (int e = tid; e < mh; e += AUC_THREADS) {
    s_item[e] = -1;
    s_list[e] = e * CL + rank;
  }
  if (tid == 0) {
    s_cnt[0] = mh;
    s_cnt[1] = 0;
  }
  round_barrier<CL>();   // also: every block of the cluster has started

  int it = 0, prev_n = 0;
  long long bids = 0;
  for (;; ++it) {
    const int par = it & 1;
    const int n_loc = s_cnt[par];
    int n_all = n_loc;
    for (int r = 0; r < CL; ++r)
      if (r != rank) n_all += *peer<CL>(s_cnt + par, r);
    if (n_all == 0 || it >= max_iters) break;
    bids += n_all;
    const int* list = s_list + par * MH;
    unsigned long long* key = s_key + par * N;

    // clear the keys the last round used (read before its last barrier)
    for (int e = tid; e < prev_n; e += AUC_THREADS)
      s_key[(par ^ 1) * N + s_top[e]] = 0ull;

    // 1. row passes: P parts of each open row, one warp a part
    int P = 1;
    while (P < AUC_WARPS && n_loc * P * 2 <= AUC_WARPS && N >= 64 * P) P *= 2;
    const int chunk = (N + P - 1) / P;
    for (int t = warp; t < n_loc * P; t += AUC_WARPS) {
      const int e = t / P, part = t - e * P;
      const int lr = SMEM_BENEFIT ? list[e] / CL : list[e];   // local row
      const float* row = ben + (long long)lr * N;
      const int j_end = min(N, (part + 1) * chunk);
      Top2 a = top2_empty(N);
      for (int j = part * chunk + lane; j < j_end; j += 32)
        top2_push(a, row[j] - s_price[j], j);
      top2_warp(a);
      if (lane == 0) {
        s_pv1[t] = a.v1;
        s_pj1[t] = a.j1;
        s_pv2[t] = a.v2;
      }
    }
    __syncthreads();
    // merge the parts of a row in one warp, then bid
    for (int e = warp; e < n_loc; e += AUC_WARPS) {
      Top2 a = top2_empty(N);
      if (lane < P) {
        a.v1 = s_pv1[e * P + lane];
        a.j1 = s_pj1[e * P + lane];
        a.v2 = s_pv2[e * P + lane];
      }
      top2_warp(a);
      if (lane == 0) {
        const float v2 = a.v2 <= AUC_NEG / 2 ? a.v1 : a.v2;
        const float bid = (s_price[a.j1] + (a.v1 - v2)) + eps;
        s_top[e] = a.j1;
        s_bid[e] = bid;
        if (bid > AUC_NEG / 2) atomicMax(key + a.j1, bid_key(bid, list[e], M));
      }
    }
    round_barrier<CL>();

    // 2-4. each open bidder reads its item's key: the winner evicts the
    // owner and installs itself (mirrored into every block), the others
    // stay open. Appends go to the list of the bidder's block.
    if (tid == 0) s_cnt[par] = 0;   // next used two rounds on
    for (int e = tid; e < n_loc; e += AUC_THREADS) {
      const int i = list[e], j = s_top[e];
      const float bid = s_bid[e];
      unsigned long long k = key[j];
      for (int r = 0; r < CL; ++r)
        if (r != rank) k = max(k, *peer<CL>(key + j, r));
      const bool won = bid > AUC_NEG / 2 &&
                       (unsigned)(k & 0xffffffffull) == (unsigned)(M - 1 - i);
      int stay = i;
      if (won) {
        const int prev = s_owner[j];
        s_item[i / CL] = j;
        for (int r = 0; r < CL; ++r) {
          *peer<CL>(s_owner + j, r) = i;
          *peer<CL>(s_price + j, r) = bid;
        }
        stay = prev;
        if (prev >= 0) *peer<CL>(s_item + prev / CL, prev % CL) = -1;
      }
      if (stay >= 0) {
        const int r = stay % CL;
        const int slot = atomicAdd(peer<CL>(s_cnt + (par ^ 1), r), 1);
        *peer<CL>(s_list + (par ^ 1) * MH + slot, r) = stay;
      }
    }
    round_barrier<CL>();
    prev_n = n_loc;
  }
  for (int e = tid; e < mh; e += AUC_THREADS)
    out[(long long)inst * M + e * CL + rank] = s_item[e];
  if (rank == 0 && tid == 0) {
    counts[2 * inst] = it;
    counts[2 * inst + 1] = (int)bids;
  }
  if constexpr (CL > 1) round_barrier<CL>();   // peers read us
}

template <int CL, bool SMEM_BENEFIT>
cudaError_t launch(const float* benefit, const float* spread, int* out,
                   int* counts, int G, int M, int N, float eps_div,
                   int max_iters, long long bytes, cudaStream_t s) {
  auto kernel = u3d_auction_kernel<CL, SMEM_BENEFIT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * CL));
  cfg.blockDim = dim3(AUC_THREADS);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, benefit, spread, out, counts, M, N,
                            eps_div, max_iters);
}

}  // namespace

extern "C" {

// benefit (G, M, N) fp32, spread (G,) fp32 -> out (G, M) int32 and
// counts (G, 2) int32 (rounds, bids). variant: -1 the first that fits of
// 0 one block with the benefit in shared memory, 1 a cluster of two
// blocks, 2 one block reading the benefit from global memory; a forced
// variant that does not fit is refused. *ran (may be null) reports the
// variant launched.
int u3d_auction_lap(const void* benefit, const void* spread, void* out,
                    void* counts, int G, int M, int N, float eps_div,
                    int max_iters, int variant, int* ran, void* stream) {
  if (G == 0 || M == 0) return (int)cudaSuccess;
  if (M > N || variant < -1 || variant > 2) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const long long need[3] = {Layout(M, N, 1).bytes(true),
                             Layout(M, N, 2).bytes(true),
                             Layout(M, N, 1).bytes(false)};
  if (variant < 0) {
    variant = 2;
    for (int v = 1; v >= 0; --v)
      if (need[v] <= optin) variant = v;
  }
  if (need[variant] > optin) return (int)cudaErrorInvalidValue;
  if (ran) *ran = variant;
  const float* b = (const float*)benefit;
  const float* sp = (const float*)spread;
  int* o = (int*)out;
  int* c = (int*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    e = launch<1, true>(b, sp, o, c, G, M, N, eps_div, max_iters, need[0], s);
  else if (variant == 1)
    e = launch<2, true>(b, sp, o, c, G, M, N, eps_div, max_iters, need[1], s);
  else
    e = launch<1, false>(b, sp, o, c, G, M, N, eps_div, max_iters, need[2], s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
