// Paired farthest point sampling (D-FPS) for Hopper (sm_90a).
//
// Replaces the Pallas kernel uni3detr_tpu/ops/fps.py::_fps_pair_kernel
// (entry farthest_point_sample_pair_pallas): two independent D-FPS runs
// (the raw points and the voxel coordinates of one scene) in one launch.
// u3d_fps runs the same kernel on one set and replaces _fps_kernel (entry
// farthest_point_sample_pallas).
//
// Design: one block per (set, batch element). Each of the S-1 steps
// updates every point's min distance to the last pick and takes a block
// argmax (largest distance, lowest index on ties). The 100k-point set is
// 1.6 MB with its min-distance state, too big for shared memory, so
// coordinates (structure of arrays, for coalesced loads) and state live
// in global memory and stay resident in the 50 MB L2. Bound: the S
// dependent steps, each a pass over N points by one SM plus two block
// barriers; the two sets run concurrently on two SMs.
//
// Semantics of the reference sampler: sampling starts at index 0; masked
// points hold min distance -1 and are never picked while a valid point
// remains; once the valid points are exhausted the argmax returns
// duplicates. The distance is ((dx*dx + dy*dy) + dz*dz) with round-to-
// nearest operations and no FMA contraction, so indices match the plain
// version bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int FPS_THREADS = 1024;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(FPS_THREADS) fps_pair_kernel(
    const float* __restrict__ planes_a, const uint8_t* __restrict__ mask_a,
    float* __restrict__ mind_a, int* __restrict__ idx_a, int Na,
    const float* __restrict__ planes_b, const uint8_t* __restrict__ mask_b,
    float* __restrict__ mind_b, int* __restrict__ idx_b, int Nb, int S) {
  __shared__ float s_val[FPS_THREADS / 32];
  __shared__ int s_idx[FPS_THREADS / 32];
  __shared__ int s_last;
  const int set = blockIdx.x;
  const int b = blockIdx.y;
  const int N = set ? Nb : Na;
  // planes (B, 3, N): x, y, z rows
  const float* xs = (set ? planes_b : planes_a) + (long long)b * 3 * N;
  const float* ys = xs + N;
  const float* zs = ys + N;
  const uint8_t* mask = (set ? mask_b : mask_a) + (long long)b * N;
  float* mind = (set ? mind_b : mind_a) + (long long)b * N;
  int* idx = (set ? idx_b : idx_a) + (long long)b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // each thread owns points threadIdx.x + j*blockDim.x in every step, so
  // the state needs no barrier between steps
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    mind[i] = mask[i] ? 1e10f : -1.0f;
  if (threadIdx.x == 0) idx[0] = 0;
  int last = 0;

  for (int s = 1; s < S; ++s) {
    const float px = xs[last], py = ys[last], pz = zs[last];
    float best = -CUDART_INF_F;
    int besti = INT_MAX;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float m = mind[i];
      if (m >= 0.f) {  // valid point (masked points stay at -1)
        const float dx = __fsub_rn(xs[i], px);
        const float dy = __fsub_rn(ys[i], py);
        const float dz = __fsub_rn(zs[i], pz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        m = fminf(m, d);
        mind[i] = m;
      }
      if (m > best) {  // ascending i: the first maximum wins
        best = m;
        besti = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(best, besti, __shfl_down_sync(0xffffffffu, best, off),
                   __shfl_down_sync(0xffffffffu, besti, off));
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -CUDART_INF_F;
      besti = lane < nwarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(best, besti, __shfl_down_sync(0xffffffffu, best, off),
                     __shfl_down_sync(0xffffffffu, besti, off));
      if (lane == 0) {
        s_last = besti;
        idx[s] = besti;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

extern "C" int u3d_fps_pair(const void* planes_a, const void* mask_a,
                            void* mind_a, void* idx_a, int Na,
                            const void* planes_b, const void* mask_b,
                            void* mind_b, void* idx_b, int Nb, int B, int S,
                            void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  dim3 grid(2, B);
  fps_pair_kernel<<<grid, FPS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)planes_a, (const uint8_t*)mask_a, (float*)mind_a,
      (int*)idx_a, Na, (const float*)planes_b, (const uint8_t*)mask_b,
      (float*)mind_b, (int*)idx_b, Nb, S);
  return (int)cudaGetLastError();
}

// Single-set D-FPS (K11): a grid of (1, B) blocks only ever takes set a.
extern "C" int u3d_fps(const void* planes, const void* mask, void* mind,
                       void* idx, int N, int B, int S, void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  dim3 grid(1, B);
  fps_pair_kernel<<<grid, FPS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const uint8_t*)mask, (float*)mind, (int*)idx, N,
      nullptr, nullptr, nullptr, nullptr, 0, S);
  return (int)cudaGetLastError();
}
