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
// Design: one block per instance, the whole state (prices, owners, bids)
// in shared memory, and the benefit matrix too when it fits: a SUN RGB-D
// instance (64 x 384 fp32, 96 KB) needs the opt-in above the 48 KB
// default; a KITTI instance (256 x 384, 384 KB) does not fit the 227 KB
// a block may have, and is read from global memory, where it stays
// resident in L2. Step 1 gives each warp one bidder row (warp-shuffle
// argmax, then max); step 2 gives each thread one item and scans the
// bidders in index order. Bound: the dependent rounds (2-3 on DETR-shaped
// costs, ~1000 on duplicated-GT ones), each two passes over M*N values
// plus two block barriers; instances run on separate SMs.
//
// The arithmetic is the TPU kernel's, operation for operation (fp32 adds
// and compares only, eps one fp32 division), so the assignment equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int AUC_THREADS = 256;
constexpr float AUC_NEG = -1e30f;

template <bool SMEM_BENEFIT>
__global__ void __launch_bounds__(AUC_THREADS) u3d_auction_kernel(
    const float* __restrict__ benefit, const float* __restrict__ spread,
    int* __restrict__ out, int M, int N, float eps_div, int max_iters) {
  extern __shared__ float smem[];
  float* s_price = smem;                                   // N
  int* s_owner = reinterpret_cast<int*>(s_price + N);      // N
  float* s_bid = reinterpret_cast<float*>(s_owner + N);    // M
  int* s_top = reinterpret_cast<int*>(s_bid + M);          // M
  int* s_item = s_top + M;                                 // M
  const int inst = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const float* ben = benefit + (long long)inst * M * N;
  if (SMEM_BENEFIT) {
    float* s_ben = reinterpret_cast<float*>(s_item + M);  // M*N
    for (int e = tid; e < M * N; e += blockDim.x) s_ben[e] = ben[e];
    ben = s_ben;
  }
  const float eps = spread[inst] / eps_div;
  for (int j = tid; j < N; j += blockDim.x) {
    s_price[j] = 0.f;
    s_owner[j] = -1;
  }
  for (int i = tid; i < M; i += blockDim.x) s_item[i] = -1;
  __syncthreads();

  for (int it = 0;; ++it) {
    int open = 0;
    for (int i = tid; i < M; i += blockDim.x) open |= s_item[i] < 0;
    if (!__syncthreads_or(open) || it >= max_iters) break;

    // 1. bids of the unassigned bidders, one warp per bidder row
    for (int i = warp; i < M; i += n_warps) {
      if (s_item[i] >= 0) {
        if (lane == 0) s_top[i] = -1;
        continue;
      }
      const float* row = ben + (long long)i * N;
      float v1 = -CUDART_INF_F;
      int j1 = N;
      for (int j = lane; j < N; j += 32) {
        const float v = row[j] - s_price[j];
        if (v > v1) {       // strict: a lane keeps its first maximum
          v1 = v;
          j1 = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v1, o);
        const int oj = __shfl_xor_sync(0xffffffffu, j1, o);
        if (ov > v1 || (ov == v1 && oj < j1)) {
          v1 = ov;
          j1 = oj;
        }
      }
      float v2 = AUC_NEG;   // the TPU kernel masks the top item with NEG
      for (int j = lane; j < N; j += 32)
        if (j != j1) v2 = fmaxf(v2, row[j] - s_price[j]);
      for (int o = 16; o > 0; o >>= 1)
        v2 = fmaxf(v2, __shfl_xor_sync(0xffffffffu, v2, o));
      if (v2 <= AUC_NEG / 2) v2 = v1;
      if (lane == 0) {
        s_top[i] = j1;
        s_bid[i] = (s_price[j1] + (v1 - v2)) + eps;
      }
    }
    __syncthreads();

    // 2-4. per item: best bid (lowest bidder on ties), evict, install.
    // Bidders touched here are distinct: a winner bid on this item only
    // and held nothing, an evicted bidder owned this item only.
    for (int j = tid; j < N; j += blockDim.x) {
      float best = AUC_NEG;
      int win = -1;
      for (int i = 0; i < M; ++i) {
        if (s_top[i] == j && s_bid[i] > best) {
          best = s_bid[i];
          win = i;
        }
      }
      if (win >= 0) {
        const int prev = s_owner[j];
        if (prev >= 0) s_item[prev] = -1;
        s_item[win] = j;
        s_owner[j] = win;
        s_price[j] = best;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < M; i += blockDim.x)
    out[(long long)inst * M + i] = s_item[i];
}

// shared memory of the state, and of the benefit matrix with it
long long smem_bytes(int M, int N, bool with_benefit) {
  long long bytes = (2LL * N + 3LL * M) * 4;
  if (with_benefit) bytes += (long long)M * N * 4;
  return bytes;
}

}  // namespace

extern "C" {

// benefit (G, M, N) fp32, spread (G,) fp32 -> out (G, M) int32.
// *benefit_in_smem (may be null) reports which variant ran.
int u3d_auction_lap(const void* benefit, const void* spread, void* out,
                    int G, int M, int N, float eps_div, int max_iters,
                    int* benefit_in_smem, void* stream) {
  if (G == 0 || M == 0) return (int)cudaSuccess;
  if (M > N) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const long long full = smem_bytes(M, N, true);
  const bool in_smem = full <= optin;
  const long long bytes = smem_bytes(M, N, in_smem);
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  if (benefit_in_smem) *benefit_in_smem = in_smem ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_smem) {
    e = cudaFuncSetAttribute(u3d_auction_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    u3d_auction_kernel<true><<<G, AUC_THREADS, bytes, s>>>(
        (const float*)benefit, (const float*)spread, (int*)out, M, N, eps_div,
        max_iters);
  } else {
    e = cudaFuncSetAttribute(u3d_auction_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    u3d_auction_kernel<false><<<G, AUC_THREADS, bytes, s>>>(
        (const float*)benefit, (const float*)spread, (int*)out, M, N, eps_div,
        max_iters);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
