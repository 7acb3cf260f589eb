// Farthest point sampling (D-FPS) for Hopper (sm_90a).
//
// u3d_fps_pair (K4) replaces the Pallas kernel
// uni3detr_tpu/ops/fps.py::_fps_pair_kernel (entry
// farthest_point_sample_pair_pallas): two independent D-FPS runs (the raw
// points and the voxel coordinates of one scene) in one launch. u3d_fps
// (K11) runs the same kernel on one set and replaces _fps_kernel (entry
// farthest_point_sample_pallas).
//
// What bounds it on this card: the arithmetic is ~9 fp32 operations per
// valid point and step (3.4 GFLOP at 420k points x 899 steps, 0.05 ms at
// 67 TFLOP/s) and the data is ~13 bytes a point, but the S-1 steps are
// dependent: each needs the argmax of the whole set before the next can
// start. The floor is therefore S-1 reductions across the card. Giving
// each set to one SM (the first design) made every step a pass of one SM
// over megabytes of L2, 30-50x above that floor.
//
// Design: one cooperative grid, one block per SM, spans every problem (a
// set of one batch element). Each block owns a contiguous slice of every
// problem; the slice's x/y/z planes and its min-distance state stay in
// shared memory for the whole run (16 bytes a point: 51 KB a block at the
// nuScenes eval shapes, 189 KB at its B=4 train shapes). Where the slices
// do not fit, the wrapper picks the streamed variant of the same kernel,
// which reads the slice's coordinates and keeps its state in global
// memory (L2-resident). Each step:
//   1. every block updates its slices and reduces each problem to the
//      block's (largest distance, lowest index) with that point's
//      coordinates;
//   2. writes them to a partials buffer, one per step parity, so that one
//      grid barrier per step suffices (a block can only write the same
//      buffer again after everyone has passed the next barrier, i.e. has
//      finished reading it);
//   3. waits at a hand-written grid barrier (a monotone arrival counter:
//      barrier e completes when the counter reaches e * gridDim.x; the
//      launch is cooperative, so all blocks are resident);
//   4. every block reduces all blocks' partials of each problem in the
//      same way and so agrees on the winner and its coordinates without a
//      second pass or a dependent load of the winner's point.
// The partials are read with ld.global.cg: they change every other step
// and a line cached in L1 from two steps back would be stale.
//
// Semantics of the reference sampler: sampling starts at index 0; masked
// points hold min distance -1 and are never picked while a valid point
// remains; once the valid points are exhausted the argmax returns
// duplicates. The distance is ((dx*dx + dy*dy) + dz*dz) with round-to-
// nearest operations and no FMA contraction. The merge of two candidates
// is by (value descending, index ascending): a total order, so the lowest
// index wins a tie that spans two slices and the indices match the plain
// version bit for bit whatever the grid.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int FPS_THREADS = 512;
constexpr int FPS_WARPS = FPS_THREADS / 32;
constexpr int FPS_MAX_PROBLEMS = 32;    // sets x batch elements per launch
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The problems of one launch: nsets sets (a, then b) of B batch elements,
// problem p = set * B + b. Points of all problems are packed one after the
// other in (3, Ntot) planes and an (Ntot,) mask.
struct Slice {
  long long goff;   // first point of the problem in the packed planes
  int n;            // points in the problem
  int lo, hi;       // this block's slice [lo, hi) of the problem
  int soff;         // first shared-memory slot of the slice
};

__device__ __forceinline__ Slice slice_of(int p, int Na, int Nb, int B) {
  const int G = gridDim.x;
  const int set = p / B, b = p % B;
  const int La = (Na + G - 1) / G, Lb = (Nb + G - 1) / G;
  Slice s;
  s.n = set ? Nb : Na;
  const int L = set ? Lb : La;
  s.goff = set ? (long long)B * Na + (long long)b * Nb : (long long)b * Na;
  s.lo = min(blockIdx.x * L, s.n);
  s.hi = min(s.lo + L, s.n);
  s.soff = set ? B * La + b * Lb : b * La;
  return s;
}

// Barrier e of the grid: returns once every block has arrived e times.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned int c;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(c) : "l"(count) : "memory");
    } while (c < target);
    __threadfence();
  }
  __syncthreads();
}

template <bool IN_SMEM>
__global__ void __launch_bounds__(FPS_THREADS) u3d_fps_grid_kernel(
    const float* __restrict__ planes, const uint8_t* __restrict__ mask,
    float* __restrict__ mind_g, float4* part_v, int* part_i,
    unsigned int* bar, int* __restrict__ idx, int Na, int Nb, int B,
    int nsets, int S) {
  extern __shared__ float4 fps_smem[];
  __shared__ float s_wv[FPS_MAX_PROBLEMS][FPS_WARPS];
  __shared__ int s_wi[FPS_MAX_PROBLEMS][FPS_WARPS];
  __shared__ float4 s_last[FPS_MAX_PROBLEMS];   // coordinates of the pick
  const int P = nsets * B;
  const int G = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long Ntot = (long long)B * Na + (nsets > 1 ? (long long)B * Nb : 0);
  const float* xs = planes;
  const float* ys = planes + Ntot;
  const float* zs = planes + 2 * Ntot;
  // shared-memory planes of this block's slices: x, y, z, min distance
  const int G_L = B * ((Na + G - 1) / G + (nsets > 1 ? (Nb + G - 1) / G : 0));
  float* s_x = reinterpret_cast<float*>(fps_smem);
  float* s_y = s_x + G_L;
  float* s_z = s_y + G_L;
  float* s_m = s_z + G_L;

  for (int p = 0; p < P; ++p) {
    const Slice sl = slice_of(p, Na, Nb, B);
    for (int i = sl.lo + tid; i < sl.hi; i += FPS_THREADS) {
      const long long gi = sl.goff + i;
      const float m = mask[gi] ? 1e10f : -1.0f;
      if (IN_SMEM) {
        const int li = sl.soff + i - sl.lo;
        s_x[li] = xs[gi];
        s_y[li] = ys[gi];
        s_z[li] = zs[gi];
        s_m[li] = m;
      } else {
        mind_g[gi] = m;
      }
    }
  }
  if (tid < P) {
    const Slice sl = slice_of(tid, Na, Nb, B);
    s_last[tid] = make_float4(xs[sl.goff], ys[sl.goff], zs[sl.goff], 0.f);
    if (blockIdx.x == 0) idx[(long long)tid * S] = 0;
  }
  __syncthreads();

  for (int s = 1; s < S; ++s) {
    const int par = s & 1;
    // 1. update the slices; block argmax per problem
    for (int p = 0; p < P; ++p) {
      const Slice sl = slice_of(p, Na, Nb, B);
      const float4 q = s_last[p];
      float best = -CUDART_INF_F;
      int besti = INT_MAX;
      for (int i = sl.lo + tid; i < sl.hi; i += FPS_THREADS) {
        const int li = sl.soff + i - sl.lo;
        const long long gi = sl.goff + i;
        float m = IN_SMEM ? s_m[li] : mind_g[gi];
        if (m >= 0.f) {   // valid point (masked points stay at -1)
          const float dx = __fsub_rn(IN_SMEM ? s_x[li] : xs[gi], q.x);
          const float dy = __fsub_rn(IN_SMEM ? s_y[li] : ys[gi], q.y);
          const float dz = __fsub_rn(IN_SMEM ? s_z[li] : zs[gi], q.z);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          m = fminf(m, d);
          if (IN_SMEM) s_m[li] = m; else mind_g[gi] = m;
        }
        if (m > best) {   // ascending i: the first maximum wins
          best = m;
          besti = i;
        }
      }
      warp_argmax(best, besti);
      if (lane == 0) {
        s_wv[p][warp] = best;
        s_wi[p][warp] = besti;
      }
    }
    __syncthreads();
    // 2. one partial (value, index, coordinates) per problem and block
    for (int p = warp; p < P; p += FPS_WARPS) {
      float v = lane < FPS_WARPS ? s_wv[p][lane] : -CUDART_INF_F;
      int i = lane < FPS_WARPS ? s_wi[p][lane] : INT_MAX;
      warp_argmax(v, i);
      if (lane == 0) {
        float4 c = make_float4(v, 0.f, 0.f, 0.f);
        if (i != INT_MAX) {
          const Slice sl = slice_of(p, Na, Nb, B);
          if (IN_SMEM) {
            const int li = sl.soff + i - sl.lo;
            c.y = s_x[li];
            c.z = s_y[li];
            c.w = s_z[li];
          } else {
            c.y = xs[sl.goff + i];
            c.z = ys[sl.goff + i];
            c.w = zs[sl.goff + i];
          }
        }
        const long long e = ((long long)par * P + p) * G + blockIdx.x;
        __stcg(part_v + e, c);
        __stcg(part_i + e, i);
      }
    }
    // 3. every block has written its partials of this step
    grid_barrier(bar, (unsigned int)s * G);
    // 4. the winner of every problem, the same in every block
    for (int p = warp; p < P; p += FPS_WARPS) {
      float v = -CUDART_INF_F, x = 0.f, y = 0.f, z = 0.f;
      int i = INT_MAX;
      const long long base = ((long long)par * P + p) * G;
      for (int j = lane; j < G; j += 32) {
        const float4 c = __ldcg(part_v + base + j);
        const int ci = __ldcg(part_i + base + j);
        if (beats(c.x, ci, v, i)) {
          v = c.x;
          i = ci;
          x = c.y;
          y = c.z;
          z = c.w;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(FULL, v, off);
        const int oi = __shfl_down_sync(FULL, i, off);
        const float ox = __shfl_down_sync(FULL, x, off);
        const float oy = __shfl_down_sync(FULL, y, off);
        const float oz = __shfl_down_sync(FULL, z, off);
        if (beats(ov, oi, v, i)) {
          v = ov;
          i = oi;
          x = ox;
          y = oy;
          z = oz;
        }
      }
      if (lane == 0) {
        s_last[p] = make_float4(x, y, z, 0.f);
        if (blockIdx.x == 0) idx[(long long)p * S + s] = i;
      }
    }
    __syncthreads();
  }
}

template <bool IN_SMEM>
int launch_fps_grid(const void* planes, const void* mask, void* mind,
                    void* part_v, void* part_i, void* bar, void* idx, int Na,
                    int Nb, int B, int nsets, int S, int G,
                    cudaStream_t stream) {
  const long long La = (Na + G - 1) / G, Lb = nsets > 1 ? (Nb + G - 1) / G : 0;
  const size_t smem = IN_SMEM ? (size_t)(16 * B * (La + Lb)) : 0;
  auto kern = u3d_fps_grid_kernel<IN_SMEM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, FPS_THREADS, smem)) != cudaSuccess)
    return (int)e;
  // every block must be resident at once, or the grid barrier never opens
  if ((long long)per_sm * sms < G)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a0 = (const float*)planes;
  const uint8_t* a1 = (const uint8_t*)mask;
  float* a2 = (float*)mind;
  float4* a3 = (float4*)part_v;
  int* a4 = (int*)part_i;
  unsigned int* a5 = (unsigned int*)bar;
  int* a6 = (int*)idx;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &Na, &Nb, &B, &nsets,
                  &S};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(G),
                                  dim3(FPS_THREADS), args, smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

int launch_fps(const void* planes, const void* mask, void* mind,
               void* part_v, void* part_i, void* bar, void* idx, int Na,
               int Nb, int B, int nsets, int S, int G, int in_smem,
               void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  if (nsets * B > FPS_MAX_PROBLEMS || G <= 0 || Na <= 0 ||
      (nsets > 1 && Nb <= 0))
    return (int)cudaErrorInvalidValue;
  return in_smem
      ? launch_fps_grid<true>(planes, mask, mind, part_v, part_i, bar, idx,
                              Na, Nb, B, nsets, S, G, (cudaStream_t)stream)
      : launch_fps_grid<false>(planes, mask, mind, part_v, part_i, bar, idx,
                               Na, Nb, B, nsets, S, G, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// out[0]: SMs of the current device; out[1]: the dynamic shared memory a
// block of the in-shared-memory variant may take; out[2]: the most
// problems (sets x batch elements) one launch takes.
int u3d_fps_limits(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return (int)e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, u3d_fps_grid_kernel<true>)) !=
      cudaSuccess)
    return (int)e;
  out[1] = optin - (int)attr.sharedSizeBytes;
  out[2] = FPS_MAX_PROBLEMS;
  return (int)cudaSuccess;
}

// planes (3, B*Na + B*Nb) fp32: set a's batch elements, then set b's;
// mask (B*Na + B*Nb) uint8; mind: (B*Na + B*Nb) fp32 scratch of the
// streamed variant; part_v (2, 2B, G) float4 and part_i (2, 2B, G) int32
// scratch; bar: one uint32, zero; idx (2B, S) int32 out.
int u3d_fps_pair(const void* planes, const void* mask, void* mind,
                 void* part_v, void* part_i, void* bar, void* idx, int Na,
                 int Nb, int B, int S, int G, int in_smem, void* stream) {
  return launch_fps(planes, mask, mind, part_v, part_i, bar, idx, Na, Nb, B,
                    2, S, G, in_smem, stream);
}

// Single-set D-FPS (K11): the same kernel with one set, (3, B*N) planes.
int u3d_fps(const void* planes, const void* mask, void* mind, void* part_v,
            void* part_i, void* bar, void* idx, int N, int B, int S, int G,
            int in_smem, void* stream) {
  return launch_fps(planes, mask, mind, part_v, part_i, bar, idx, N, 0, B, 1,
                    S, G, in_smem, stream);
}

}  // extern "C"
