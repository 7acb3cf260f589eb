// Sparse-conv kernels of the sparse encoder, for Hopper (sm_90a).
//
// K1 u3d_match_positions replaces the Pallas kernel
//    uni3detr_tpu/ops/sparse_conv_pallas.py::_match_kernel_count
//    (entry match_positions). One thread per (site, offset) query does a
//    binary search over the sorted site ids. Bound: ~log2(V) dependent
//    loads per query, all inside the site-id list (160 KB at V=40k, so it
//    stays in L1/L2); the TPU's window walk existed only because the TPU
//    has no general gather.
// K2 u3d_gather_conv_* replaces _kernel_unpacked (entry
//    gather_conv_pallas): out[v] = sum_k feats[nb[v,k]] @ W[k], with
//    nb == V (the dummy row) contributing zero.
// K3 u3d_gather_conv_ids_* replaces _kernel_idmatch (entry
//    gather_conv_ids): the same gather-GEMM, each neighbour row found
//    inside the kernel by binary search of its query id.
//
// K2/K3 design: a block owns a tile of TM output rows and TN output
// channels. It first resolves the K*TM neighbour rows of its tile into
// shared memory (K3 searches them there), then for every offset k and
// every TK-wide slice of input channels it gathers the TM neighbour rows
// (zero for a miss) and the matching slice of W[k] into shared memory
// and accumulates in fp32 registers, 4x4 outputs per thread. Each
// gathered row is read in the input dtype and widened to fp32 exactly,
// as the TPU kernel casts each gathered row to the input dtype before
// the product; the result is rounded to the input dtype once at the end.
// Bound: at the encoder's widths (C, Cout <= 128, V <= 40k) the convs
// are a few GFLOP each and the gathers are scattered 2-byte (bf16)
// reads; this first version runs on the fp32 CUDA cores, not wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output channels per block
constexpr int TK = 16;        // input channels per shared-memory slice
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int MAX_K = 27;     // kernel volume of a 3x3x3 conv

__device__ __forceinline__ int find_row(const int* __restrict__ ids, int n,
                                        int q, int miss) {
  // row of id q in the ascending list ids[0:n], or `miss`; q < 0 never
  // matches (site ids are >= 0, pads are INT_MAX)
  if (q < 0) return miss;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < q) lo = mid + 1; else hi = mid;
  }
  return (lo < n && ids[lo] == q) ? lo : miss;
}

__global__ void match_positions_kernel(const int* __restrict__ site_ids,
                                       const int* __restrict__ qids,
                                       int* __restrict__ out, int V,
                                       long long per_batch, int n_sites) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= per_batch) return;
  const long long off = (long long)blockIdx.y * per_batch + i;
  out[off] = find_row(site_ids + (long long)blockIdx.y * V, V, qids[off],
                      n_sites);
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// index: IDMATCH ? query ids (B, Vout, K) : rulebook rows (B, Vout, K)
template <typename T, bool IDMATCH>
__global__ void __launch_bounds__(NT) gather_conv_kernel(
    const T* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const T* __restrict__ w,
    T* __restrict__ out, int V, int C, int Vout, int K, int Cout) {
  __shared__ int s_row[MAX_K][TM];
  __shared__ float s_a[TM][TK];
  __shared__ float s_b[TK][TN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* fb = feats + (long long)b * V * C;

  for (int e = tid; e < K * TM; e += NT) {
    const int k = e / TM, r = e % TM;
    const int m = m0 + r;
    int row = -1;
    if (m < Vout) {
      const int q = index[((long long)b * Vout + m) * K + k];
      if (IDMATCH) {
        row = find_row(site_ids + (long long)b * V, V, q, -1);
      } else {
        row = (q >= 0 && q < V) ? q : -1;
      }
    }
    s_row[k][r] = row;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    for (int c0 = 0; c0 < C; c0 += TK) {
      for (int e = tid; e < TM * TK; e += NT) {
        const int r = e / TK, c = e % TK;
        const int row = s_row[k][r];
        float v = 0.f;
        if (row >= 0 && c0 + c < C) v = to_f32(fb[(long long)row * C + c0 + c]);
        s_a[r][c] = v;
      }
      for (int e = tid; e < TK * TN; e += NT) {
        const int c = e / TN, n = e % TN;
        float v = 0.f;
        if (c0 + c < C && n0 + n < Cout)
          v = to_f32(w[((long long)k * C + c0 + c) * Cout + n0 + n]);
        s_b[c][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_a[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_b[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= Vout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout)
        out[((long long)b * Vout + m) * Cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool IDMATCH>
int launch_gather_conv(const void* feats, const void* index,
                       const void* site_ids, const void* w, void* out, int B,
                       int V, int C, int Vout, int K, int Cout,
                       void* stream) {
  if (K > MAX_K) return (int)cudaErrorInvalidValue;
  if (B == 0 || Vout == 0 || Cout == 0) return (int)cudaSuccess;
  dim3 grid((Vout + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  gather_conv_kernel<T, IDMATCH><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)feats, (const int*)index, (const int*)site_ids,
      (const T*)w, (T*)out, V, C, Vout, K, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* u3d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int u3d_match_positions(const void* site_ids, const void* qids, void* out,
                        int B, int V, int Vout, int K, int n_sites,
                        void* stream) {
  const long long per_batch = (long long)Vout * K;
  if (B == 0 || per_batch == 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid((unsigned)((per_batch + threads - 1) / threads), B);
  match_positions_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)site_ids, (const int*)qids, (int*)out, V, per_batch,
      n_sites);
  return (int)cudaGetLastError();
}

int u3d_gather_conv_f32(const void* feats, const void* nb, const void* w,
                        void* out, int B, int V, int C, int Vout, int K,
                        int Cout, void* stream) {
  return launch_gather_conv<float, false>(feats, nb, nullptr, w, out, B, V,
                                          C, Vout, K, Cout, stream);
}

int u3d_gather_conv_bf16(const void* feats, const void* nb, const void* w,
                         void* out, int B, int V, int C, int Vout, int K,
                         int Cout, void* stream) {
  return launch_gather_conv<__nv_bfloat16, false>(
      feats, nb, nullptr, w, out, B, V, C, Vout, K, Cout, stream);
}

int u3d_gather_conv_ids_f32(const void* feats, const void* site_ids,
                            const void* qids, const void* w, void* out, int B,
                            int V, int C, int Vout, int K, int Cout,
                            void* stream) {
  return launch_gather_conv<float, true>(feats, qids, site_ids, w, out, B, V,
                                         C, Vout, K, Cout, stream);
}

int u3d_gather_conv_ids_bf16(const void* feats, const void* site_ids,
                             const void* qids, const void* w, void* out,
                             int B, int V, int C, int Vout, int K, int Cout,
                             void* stream) {
  return launch_gather_conv<__nv_bfloat16, true>(
      feats, qids, site_ids, w, out, B, V, C, Vout, K, Cout, stream);
}

}  // extern "C"
