// Trilinear volume sampling (N4) for Hopper (sm_90a).
//
// N4 u3d_grid_sample_3d replaces XLA code, not a Pallas kernel: the
// eight-corner trilinear sampling of uni3detr_tpu/ops/sample.py::
// grid_sample_3d (:24), F.grid_sample's align_corners=False borders with
// zero padding, on a channels-last (B, D, H, W, C) volume at (B, N, 3)
// points in [-1, 1]. The decoder's cross-attention samples the fused
// volume once a layer with it (models/transformer.py), and OV's view
// transformer samples each depth volume (C = 1, models/view_trans.py).
// u3d_grid_sample_3d_backward is its gradient: the volume's, and the
// coordinates' where they need one (the first decoder layer's learned
// reference points).
//
// What bounds it on this card: bytes. A forward reads eight corner rows of
// C channels and writes one row a point, B * N * (8 + 1) * C * elem bytes
// (a SUN RGB-D eval batch: 8 x 1200 points x 256 bf16 channels, 44 MB,
// 13 us at 3.35 TB/s); the weights are ~40 scalar operations a point. The
// plain version (ops/sample.py::grid_sample_3d_plain) spends ~257
// elementwise launches a call on them, so on the card its cost is the
// host's enqueue, and its autograd backward zero-fills one volume per
// corner (8 x 332 MB at nuScenes' B = 4) and adds them.
//
// Design: one thread per (point, 16-byte chunk of its C channels): a warp
// streams consecutive chunks of one point's corner rows (scalar channels
// where C * elem is not a multiple of 16 or a pointer is not 16-byte
// aligned; then neighbouring threads take neighbouring points). Each
// thread computes its point's corner rows, in-range flags and weights in
// registers (a warp's lanes of one point repeat the same ~40 operations
// instead of sharing them through shared memory), starts its eight corner
// loads, and sums. The backward adds each (point, corner, chunk)'s
// g * w into one zeroed gradient volume in the volume's dtype with
// atomics (bf16x2 pairs under bf16): the plain backward's scatter_add
// also sums in the volume's dtype, and no accumulator wider than the
// volume is ever allocated, so the step's peak memory cannot rise. Only
// the order of the sums differs from the plain version (atomics): a
// voxel that takes one nonzero term is bit-equal. The coordinates'
// gradient, where asked for, reduces each corner's dot(g, row) over the
// point's lanes (shuffles within a warp, fp32 atomics across warps) into
// a zeroed fp32 (B, N, 3).
//
// Rounding: the forward is bit-equal to the plain version in bf16 and in
// fp32. The coordinates are cast to the volume's dtype, and every
// operation of the plain version is one fp32 operation (__fadd_rn,
// __fmul_rn: no FMA contraction) rounded to the volume's dtype, as
// PyTorch's elementwise kernels compute: ((g + 1) * size - 1) * 0.5,
// floor, f = x - x0, 1 - f, ((wx * wy) * wz) * ok, row * w, and the
// running sum over the corners in the order (dz, dy, dx).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SAMPLE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// The volume's element type: storage, widening to fp32 (exact), and
// rounding an fp32 result to it.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(float s) { return s; }
  static __device__ __forceinline__ float put(float x) { return x; }
  static __device__ __forceinline__ float rnd(float x) { return x; }
};

struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float get(uint16_t s) {
    return __uint_as_float((unsigned)s << 16);
  }
  static __device__ __forceinline__ uint16_t put(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float rnd(float x) { return get(put(x)); }
};

template <class R>
__device__ __forceinline__ float add(float a, float b) {
  return R::rnd(__fadd_rn(a, b));
}
template <class R>
__device__ __forceinline__ float sub(float a, float b) {
  return R::rnd(__fsub_rn(a, b));
}
template <class R>
__device__ __forceinline__ float mul(float a, float b) {
  return R::rnd(__fmul_rn(a, b));
}

// One point's eight corners in the order (dz, dy, dx), dx fastest: the
// row of the corner (clamped into the volume), its weight (0 outside) and
// its in-range flag; f and 1 - f per axis (x, y, z) for the gradient.
struct Corners {
  int row[8];
  float w[8];
  float ok[8];
  float f[3];
  float u[3];
};

// ((g + 1) * size - 1) * 0.5 in the volume's dtype
template <class R>
__device__ __forceinline__ float unnormalize(float g, int size) {
  return mul<R>(sub<R>(mul<R>(add<R>(g, 1.f), (float)size), 1.f), 0.5f);
}

template <class R>
__device__ __forceinline__ void corners(const float* c, int D, int H, int W,
                                        Corners& k) {
  const int size[3] = {W, H, D};
  float lo[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = unnormalize<R>(R::rnd(c[a]), size[a]);
    lo[a] = floorf(x);
    k.f[a] = sub<R>(x, lo[a]);
    k.u[a] = sub<R>(1.f, k.f[a]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int d[3] = {q & 1, (q >> 1) & 1, q >> 2};
    bool ok = true;
    int idx[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // integer-valued floats: exact below 2^24; fmaxf maps NaN to 0
      const float i = lo[a] + (float)d[a];
      ok = ok && i >= 0.f && i < (float)size[a];
      idx[a] = (int)fminf(fmaxf(i, 0.f), (float)(size[a] - 1));
    }
    k.row[q] = (idx[2] * H + idx[1]) * W + idx[0];
    k.ok[q] = ok ? 1.f : 0.f;
    const float wx = d[0] ? k.f[0] : k.u[0];
    const float wy = d[1] ? k.f[1] : k.u[1];
    const float wz = d[2] ? k.f[2] : k.u[2];
    k.w[q] = mul<R>(mul<R>(mul<R>(wx, wy), wz), k.ok[q]);
  }
}

// VW consecutive elements at p (16 bytes, aligned, when VW > 1), widened
template <class R, int VW>
__device__ __forceinline__ void load(const typename R::S* p, float (&x)[VW]) {
  if constexpr (VW == 1) {
    x[0] = R::get(p[0]);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (sizeof(typename R::S) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// x holds values of the volume's dtype already
template <class R, int VW>
__device__ __forceinline__ void store(typename R::S* p, const float (&x)[VW]) {
  if constexpr (VW == 1) {
    p[0] = R::put(x[0]);
  } else {
    unsigned w[4];
    if constexpr (sizeof(typename R::S) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (unsigned)R::put(x[2 * i]) |
               ((unsigned)R::put(x[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// x holds values of the volume's dtype already (the bf16 pairs convert
// exactly)
template <class R, int VW>
__device__ __forceinline__ void atomic_add(typename R::S* p,
                                           const float (&x)[VW]) {
  if constexpr (sizeof(typename R::S) == 4) {
#pragma unroll
    for (int j = 0; j < VW; ++j) atomicAdd(reinterpret_cast<float*>(p) + j,
                                           x[j]);
  } else if constexpr (VW == 1) {
    atomicAdd(reinterpret_cast<__nv_bfloat16*>(p), __float2bfloat16_rn(x[0]));
  } else {
#pragma unroll
    for (int i = 0; i < VW / 2; ++i)
      atomicAdd(reinterpret_cast<__nv_bfloat162*>(p) + i,
                __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]));
  }
}

// out (B, N, C) = the trilinear sample of vol (B, D, H, W, C) at coords
// (B, N, 3) fp32; thread t takes chunk t % nvec of point t / nvec.
template <class R, int VW>
__global__ void __launch_bounds__(SAMPLE_THREADS) u3d_grid_sample_3d_kernel(
    const typename R::S* __restrict__ vol, const float* __restrict__ coords,
    typename R::S* __restrict__ out, int N, int D, int H, int W, int C,
    long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int nvec = C / VW;
  const long long p = t / nvec;
  const int k = (int)(t - p * nvec);
  Corners cn;
  corners<R>(coords + 3 * p, D, H, W, cn);
  const typename R::S* base =
      vol + (p / N) * ((long long)D * H * W * C) + (long long)k * VW;
  float v[8][VW];
#pragma unroll
  for (int q = 0; q < 8; ++q) load<R, VW>(base + (long long)cn.row[q] * C,
                                          v[q]);
  float acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = mul<R>(v[0][j], cn.w[0]);
#pragma unroll
  for (int q = 1; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = add<R>(acc[j], mul<R>(v[q][j],
                                                               cn.w[q]));
  store<R, VW>(out + p * C + (long long)k * VW, acc);
}

// gvol (B, D, H, W, C), zeroed, += each corner's g * w (rounded to the
// volume's dtype, as the plain backward's product); gcoords (B, N, 3)
// fp32, zeroed, += d(sum g * out)/d(coords). Either may be null. Every
// lane runs to the end (the coordinates' reduction shuffles across the
// warp); a lane past the last chunk only reads point 0 and writes nothing.
template <class R, int VW>
__global__ void __launch_bounds__(SAMPLE_THREADS)
    u3d_grid_sample_3d_backward_kernel(
        const typename R::S* __restrict__ vol,
        const float* __restrict__ coords,
        const typename R::S* __restrict__ gout, typename R::S* gvol,
        float* gcoords, int N, int D, int H, int W, int C,
        long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < total;
  const int nvec = C / VW;
  const long long p = valid ? t / nvec : 0;
  const int k = (int)(valid ? t - p * nvec : 0);
  Corners cn;
  corners<R>(coords + 3 * p, D, H, W, cn);
  float g[VW];
  if (valid) {
    load<R, VW>(gout + p * C + (long long)k * VW, g);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) g[j] = 0.f;
  }
  const long long vbase =
      (p / N) * ((long long)D * H * W * C) + (long long)k * VW;
  float dc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long at = vbase + (long long)cn.row[q] * C;
    if (gvol != nullptr && valid && cn.ok[q] != 0.f) {
      float c[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) c[j] = mul<R>(g[j], cn.w[q]);
      atomic_add<R, VW>(gvol + at, c);
    }
    if (gcoords != nullptr) {
      float v[VW];
      load<R, VW>(vol + at, v);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VW; ++j) dot = fmaf(g[j], v[j], dot);
      // w = ((wx * wy) * wz) * ok, with wx = f or 1 - f along x
      const float gw = dot * cn.ok[q];
      const int d[3] = {q & 1, (q >> 1) & 1, q >> 2};
      const float wa[3] = {d[0] ? cn.f[0] : cn.u[0],
                           d[1] ? cn.f[1] : cn.u[1],
                           d[2] ? cn.f[2] : cn.u[2]};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float other = wa[(a + 1) % 3] * wa[(a + 2) % 3];
        dc[a] += (d[a] ? gw : -gw) * other;
      }
    }
  }
  if (gcoords == nullptr) return;
  // dx/dg = size / 2 per axis
  dc[0] *= 0.5f * (float)W;
  dc[1] *= 0.5f * (float)H;
  dc[2] *= 0.5f * (float)D;
  if ((nvec & (nvec - 1)) == 0) {
    // a point's lanes form aligned groups of min(nvec, 32) in a warp
    const int seg = nvec < 32 ? nvec : 32;
    for (int off = seg >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < 3; ++a) dc[a] += __shfl_xor_sync(FULL, dc[a], off);
    if (!valid || (k & (seg - 1)) != 0) return;
  } else if (!valid) {
    return;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) atomicAdd(gcoords + 3 * p + a, dc[a]);
}

int blocks(long long total) {
  return (int)((total + SAMPLE_THREADS - 1) / SAMPLE_THREADS);
}

template <class R>
int launch_forward(const void* vol, const void* coords, void* out, int B,
                   int N, int D, int H, int W, int C, int vec,
                   cudaStream_t stream) {
  using S = typename R::S;
  constexpr int VW = 16 / sizeof(S);
  if (vec && C % VW != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N * (vec ? C / VW : C);
  if (total == 0) return (int)cudaSuccess;
  if (vec)
    u3d_grid_sample_3d_kernel<R, VW><<<blocks(total), SAMPLE_THREADS, 0,
                                       stream>>>(
        (const S*)vol, (const float*)coords, (S*)out, N, D, H, W, C, total);
  else
    u3d_grid_sample_3d_kernel<R, 1><<<blocks(total), SAMPLE_THREADS, 0,
                                      stream>>>(
        (const S*)vol, (const float*)coords, (S*)out, N, D, H, W, C, total);
  return (int)cudaGetLastError();
}

template <class R>
int launch_backward(const void* vol, const void* coords, const void* gout,
                    void* gvol, void* gcoords, int B, int N, int D, int H,
                    int W, int C, int vec, cudaStream_t stream) {
  using S = typename R::S;
  constexpr int VW = 16 / sizeof(S);
  if (vec && C % VW != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N * (vec ? C / VW : C);
  if (total == 0 || (gvol == nullptr && gcoords == nullptr))
    return (int)cudaSuccess;
  if (vec)
    u3d_grid_sample_3d_backward_kernel<R, VW><<<blocks(total),
                                                SAMPLE_THREADS, 0, stream>>>(
        (const S*)vol, (const float*)coords, (const S*)gout, (S*)gvol,
        (float*)gcoords, N, D, H, W, C, total);
  else
    u3d_grid_sample_3d_backward_kernel<R, 1><<<blocks(total),
                                               SAMPLE_THREADS, 0, stream>>>(
        (const S*)vol, (const float*)coords, (const S*)gout, (S*)gvol,
        (float*)gcoords, N, D, H, W, C, total);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int N, int D, int H, int W, int C) {
  return B < 0 || N < 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 ||
         (long long)D * H * W > INT32_MAX;
}

}  // namespace

extern "C" {

// vol (B, D, H, W, C) fp32 (bf16 == 0) or bf16, contiguous; coords
// (B, N, 3) fp32; out (B, N, C) in the volume's dtype. vec != 0: C * elem
// is a multiple of 16 and every pointer 16-byte aligned.
int u3d_grid_sample_3d(const void* vol, const void* coords, void* out, int B,
                       int N, int D, int H, int W, int C, int bf16, int vec,
                       void* stream) {
  if (bad_shape(B, N, D, H, W, C)) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_forward<BF16>(vol, coords, out, B, N, D, H, W, C, vec,
                                     (cudaStream_t)stream)
              : launch_forward<F32>(vol, coords, out, B, N, D, H, W, C, vec,
                                    (cudaStream_t)stream);
}

// gout (B, N, C) in the volume's dtype; gvol (B, D, H, W, C) zeroed, or
// null for no volume gradient; gcoords (B, N, 3) fp32 zeroed, or null for
// no coordinates' gradient.
int u3d_grid_sample_3d_backward(const void* vol, const void* coords,
                                const void* gout, void* gvol, void* gcoords,
                                int B, int N, int D, int H, int W, int C,
                                int bf16, int vec, void* stream) {
  if (bad_shape(B, N, D, H, W, C)) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_backward<BF16>(vol, coords, gout, gvol, gcoords, B, N,
                                      D, H, W, C, vec, (cudaStream_t)stream)
              : launch_backward<F32>(vol, coords, gout, gvol, gcoords, B, N,
                                     D, H, W, C, vec, (cudaStream_t)stream);
}

}  // extern "C"
