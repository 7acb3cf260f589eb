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
//
// K7 u3d_gather_conv_dw_* replaces _gather_rows_kernel_unpacked (entry
//    _rows_unpacked, via gather_rows_pallas in the conv backward) and
//    its lane-packed twin _gather_rows_kernel_packed: the weight
//    gradient of a rulebook conv, dW[k] = sum_{b,v} feats[b, nb[b,v,k]]^T
//    g[b,v], with nb == V contributing zero.
// K10 u3d_gather_conv_ids_dw_* replaces _rows_kernel_idmatch (entry
//    _rows_idmatch) and its packed twin: the same contraction with each
//    neighbour row found by binary search of its query id.
//
// K7/K10 design: the TPU kernels only materialise the (B, Vout, K*C)
// gathered rows, because a TPU has no gather, and leave the product to
// XLA; here the gather and the contraction are one kernel, so the rows
// never reach device memory. A block owns one offset k, one TC x TN
// tile of dW[k] and one chunk of `chunk_rows` rows of the flattened
// (B*Vout) row axis; per 32-row stage it resolves the neighbour rows,
// stages the gathered feature rows and the matching cotangent rows in
// shared memory (widened exactly to fp32, as the JAX backward widens
// both before its einsum) and accumulates the tile in fp32 registers.
// Each chunk writes its partial tile to a scratch buffer and a second
// kernel sums the chunks in a fixed order, so dW is deterministic.
// Bound: 2*B*Vout*27*C*Cout flops (~7 GFLOP at 16000 x 64 -> 64) on the
// fp32 CUDA cores, plus one scattered read of every gathered row.
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

constexpr int DW_TR = 32;     // rows per shared-memory stage

// One block: offset k, tile (c0, n0) of dW[k], rows [r_begin, r_end) of
// the flattened (B*Vout) axis. Thread (ty, tx) of 16 x 16 holds outputs
// c = c0 + ty + 16 i (i < TCI), n = n0 + tx + 16 j (j < TNJ).
template <typename T, bool IDMATCH, int TCI, int TNJ>
__global__ void __launch_bounds__(NT) gather_conv_dw_kernel(
    const T* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const T* __restrict__ g,
    float* __restrict__ partial, int B, int V, int C, int Vout, int K,
    int Cout, int chunk_rows, int tiles_c, int tiles_n) {
  constexpr int TC = 16 * TCI, TN = 16 * TNJ;
  __shared__ long long s_row[DW_TR];
  __shared__ float s_a[DW_TR][TC];
  __shared__ float s_b[DW_TR][TN];
  const int chunk = blockIdx.x;
  int rest = blockIdx.y;
  const int tn = rest % tiles_n;
  rest /= tiles_n;
  const int tc = rest % tiles_c;
  const int k = rest / tiles_c;
  const int c0 = tc * TC, n0 = tn * TN;
  const long long R = (long long)B * Vout;
  const long long r_begin = (long long)chunk * chunk_rows;
  const long long r_end = min(r_begin + chunk_rows, R);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[TCI][TNJ];
#pragma unroll
  for (int i = 0; i < TCI; ++i)
#pragma unroll
    for (int j = 0; j < TNJ; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += DW_TR) {
    if (tid < DW_TR) {
      const long long r = r0 + tid;
      long long row = -1;    // row of the flattened (B*V) feature table
      if (r < r_end) {
        const int b = (int)(r / Vout);
        const int q = index[r * K + k];
        int hit;
        if (IDMATCH) {
          hit = find_row(site_ids + (long long)b * V, V, q, -1);
        } else {
          hit = (q >= 0 && q < V) ? q : -1;
        }
        if (hit >= 0) row = (long long)b * V + hit;
      }
      s_row[tid] = row;
    }
    __syncthreads();
    for (int e = tid; e < DW_TR * TC; e += NT) {
      const int r = e / TC, c = e % TC;
      const long long row = s_row[r];
      float v = 0.f;
      if (row >= 0 && c0 + c < C) v = to_f32(feats[row * C + c0 + c]);
      s_a[r][c] = v;
    }
    for (int e = tid; e < DW_TR * TN; e += NT) {
      const int r = e / TN, n = e % TN;
      float v = 0.f;
      if (r0 + r < r_end && n0 + n < Cout)
        v = to_f32(g[(r0 + r) * Cout + n0 + n]);
      s_b[r][n] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < DW_TR; ++r) {
      float a[TCI], bv[TNJ];
#pragma unroll
      for (int i = 0; i < TCI; ++i) a[i] = s_a[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TNJ; ++j) bv[j] = s_b[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TCI; ++i)
#pragma unroll
        for (int j = 0; j < TNJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + ((long long)chunk * K + k) * C * Cout;
#pragma unroll
  for (int i = 0; i < TCI; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TNJ; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[(long long)c * Cout + n] = acc[i][j];
    }
  }
}

// dW[e] = sum over chunks, in chunk order, of partial[chunk][e]
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, int n_chunks,
                                  long long per_chunk) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= per_chunk) return;
  float s = 0.f;
  for (int i = 0; i < n_chunks; ++i) s += partial[i * per_chunk + e];
  dw[e] = s;
}

template <typename T, bool IDMATCH, int TCI, int TNJ>
void launch_dw_tiles(dim3 grid, const void* feats, const void* index,
                     const void* site_ids, const void* g, float* partial,
                     int B, int V, int C, int Vout, int K, int Cout,
                     int chunk_rows, int tiles_c, int tiles_n,
                     cudaStream_t stream) {
  gather_conv_dw_kernel<T, IDMATCH, TCI, TNJ><<<grid, NT, 0, stream>>>(
      (const T*)feats, (const int*)index, (const int*)site_ids,
      (const T*)g, partial, B, V, C, Vout, K, Cout, chunk_rows, tiles_c,
      tiles_n);
}

// partial: scratch of n_chunks*K*C*Cout fp32, n_chunks =
// ceil(B*Vout / chunk_rows); dw: (K, C, Cout) fp32
template <typename T, bool IDMATCH>
int launch_gather_conv_dw(const void* feats, const void* index,
                          const void* site_ids, const void* g, void* partial,
                          void* dw, int B, int V, int C, int Vout, int K,
                          int Cout, int chunk_rows, void* stream_ptr) {
  if (chunk_rows <= 0 || chunk_rows % DW_TR != 0)
    return (int)cudaErrorInvalidValue;
  const long long per_chunk = (long long)K * C * Cout;
  if (per_chunk == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long R = (long long)B * Vout;
  const int n_chunks = (int)((R + chunk_rows - 1) / chunk_rows);
  if (n_chunks == 0) {
    cudaMemsetAsync(dw, 0, per_chunk * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  const bool wide_c = C > 16, wide_n = Cout > 16;
  const int tiles_c = (C + (wide_c ? 64 : 16) - 1) / (wide_c ? 64 : 16);
  const int tiles_n = (Cout + (wide_n ? 64 : 16) - 1) / (wide_n ? 64 : 16);
  dim3 grid(n_chunks, K * tiles_c * tiles_n);
  float* p = (float*)partial;
#define U3D_DW(TCI, TNJ)                                                   \
  launch_dw_tiles<T, IDMATCH, TCI, TNJ>(grid, feats, index, site_ids, g, p, \
                                        B, V, C, Vout, K, Cout, chunk_rows, \
                                        tiles_c, tiles_n, stream)
  if (wide_c && wide_n) U3D_DW(4, 4);
  else if (wide_c) U3D_DW(4, 1);
  else if (wide_n) U3D_DW(1, 4);
  else U3D_DW(1, 1);
#undef U3D_DW
  const int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const int threads = 256;
  sum_chunks_kernel<<<(unsigned)((per_chunk + threads - 1) / threads),
                      threads, 0, stream>>>(p, (float*)dw, n_chunks,
                                            per_chunk);
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

int u3d_gather_conv_dw_f32(const void* feats, const void* nb, const void* g,
                           void* partial, void* dw, int B, int V, int C,
                           int Vout, int K, int Cout, int chunk_rows,
                           void* stream) {
  return launch_gather_conv_dw<float, false>(feats, nb, nullptr, g, partial,
                                             dw, B, V, C, Vout, K, Cout,
                                             chunk_rows, stream);
}

int u3d_gather_conv_dw_bf16(const void* feats, const void* nb, const void* g,
                            void* partial, void* dw, int B, int V, int C,
                            int Vout, int K, int Cout, int chunk_rows,
                            void* stream) {
  return launch_gather_conv_dw<__nv_bfloat16, false>(
      feats, nb, nullptr, g, partial, dw, B, V, C, Vout, K, Cout, chunk_rows,
      stream);
}

int u3d_gather_conv_ids_dw_f32(const void* feats, const void* site_ids,
                               const void* qids, const void* g, void* partial,
                               void* dw, int B, int V, int C, int Vout, int K,
                               int Cout, int chunk_rows, void* stream) {
  return launch_gather_conv_dw<float, true>(feats, qids, site_ids, g, partial,
                                            dw, B, V, C, Vout, K, Cout,
                                            chunk_rows, stream);
}

int u3d_gather_conv_ids_dw_bf16(const void* feats, const void* site_ids,
                                const void* qids, const void* g,
                                void* partial, void* dw, int B, int V, int C,
                                int Vout, int K, int Cout, int chunk_rows,
                                void* stream) {
  return launch_gather_conv_dw<__nv_bfloat16, true>(
      feats, qids, site_ids, g, partial, dw, B, V, C, Vout, K, Cout,
      chunk_rows, stream);
}

}  // extern "C"
