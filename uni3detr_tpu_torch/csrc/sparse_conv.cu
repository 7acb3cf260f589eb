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
// K2/K3 bf16 design (u3d_gather_conv_bf16, u3d_gather_conv_ids_bf16, the
// presets' dtype): tensor cores. What bounds these convs on this card:
// 2 * pairs * C * Cout products (15.9 GFLOP at 18000 sites, 128->128:
// 16 us at the 989 TFLOP/s bf16 rate) or, at the narrow widths, the bytes
// of the rulebook and the rows (120000 sites, 16->16: 20.6 MB, 6 us).
// The first version ran every product as scalar fp32 FMA, 1-2 orders
// above both. A block owns TM = 64 output rows (4 warps x 16) and up to
// 128 output channels. It resolves its K*TM neighbour rows once into
// shared memory (K3 by binary search of the query ids), then walks the
// (offset k, 128-channel chunk) stages through a ring of MM_STAGES = 2
// buffers: while the tensor cores multiply stage t, cp.async (16 bytes a
// thread, zero-filled with src-size 0 for a missing neighbour) gathers the
// TM rows of stage t+1 and the matching rows of W[k]. (A ring of 4
// 64-channel stages, or 128-row tiles, measured no faster on the H100.) Rows narrower than 8
// channels (the 4/5-channel input convs) are staged with element loads
// into a tile zero-padded to 16 columns, so one kernel serves every
// width. The product is mma.sync m16n8k16 bf16 -> fp32 fed by ldmatrix
// from rows padded by 16 bytes (conflict-free); the fp32 sum is rounded
// to bf16 once at the end, as before. The wrapper checks that features
// and weights are 16-byte aligned.
//
// K2/K3 fp32 design (u3d_gather_conv_f32, u3d_gather_conv_ids_f32): the
// fp32 path must give exact fp32 products (TF32 would not), so it stays
// on the CUDA cores: a block owns TM output rows and TN output channels,
// resolves its neighbour rows as above, then for every offset k and
// every TK-wide slice of input channels stages the rows (zero for a
// miss) and the slice of W[k] in shared memory and accumulates in fp32
// registers, 4x4 outputs per thread.
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

__global__ void u3d_match_positions_kernel(const int* __restrict__ site_ids,
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
// s_row[r * K + k]: the feature row of output row m0 + r at offset k, -1
// for a miss; the block's index rows are contiguous, so the loads are
// coalesced, and the odd row stride K keeps later reads of s_row across
// r free of bank conflicts. index: IDMATCH ? query ids (B, Vout, K) :
// rulebook rows (B, Vout, K). Ends with a block barrier.
template <bool IDMATCH, int ROWS, int THREADS>
__device__ __forceinline__ void resolve_rows(
    int* s_row, const int* __restrict__ index,
    const int* __restrict__ site_ids, int b, int m0, int V, int Vout,
    int K) {
  const int n = min(ROWS, Vout - m0) * K;
  const int* ib = index + ((long long)b * Vout + m0) * K;
  for (int e = threadIdx.x; e < ROWS * K; e += THREADS) {
    int row = -1;
    if (e < n) {
      const int q = ib[e];
      if (IDMATCH) {
        row = find_row(site_ids + (long long)b * V, V, q, -1);
      } else {
        row = (q >= 0 && q < V) ? q : -1;
      }
    }
    s_row[e] = row;
  }
  __syncthreads();
}

template <bool IDMATCH>
__global__ void __launch_bounds__(NT) u3d_gather_conv_f32_kernel(
    const float* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const float* __restrict__ w,
    float* __restrict__ out, int V, int C, int Vout, int K, int Cout) {
  __shared__ int s_row[MAX_K * TM];
  __shared__ float s_a[TM][TK];
  __shared__ float s_b[TK][TN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* fb = feats + (long long)b * V * C;
  resolve_rows<IDMATCH, TM, NT>(s_row, index, site_ids, b, m0, V, Vout, K);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    for (int c0 = 0; c0 < C; c0 += TK) {
      for (int e = tid; e < TM * TK; e += NT) {
        const int r = e / TK, c = e % TK;
        const int row = s_row[r * K + k];
        float v = 0.f;
        if (row >= 0 && c0 + c < C) v = fb[(long long)row * C + c0 + c];
        s_a[r][c] = v;
      }
      for (int e = tid; e < TK * TN; e += NT) {
        const int c = e / TN, n = e % TN;
        float v = 0.f;
        if (c0 + c < C && n0 + n < Cout)
          v = w[((long long)k * C + c0 + c) * Cout + n0 + n];
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
        out[((long long)b * Vout + m) * Cout + n] = acc[i][j];
    }
  }
}

template <bool IDMATCH>
int launch_gather_conv_f32(const void* feats, const void* index,
                           const void* site_ids, const void* w, void* out,
                           int B, int V, int C, int Vout, int K, int Cout,
                           void* stream) {
  if (K > MAX_K) return (int)cudaErrorInvalidValue;
  if (B == 0 || Vout == 0 || Cout == 0) return (int)cudaSuccess;
  dim3 grid((Vout + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  u3d_gather_conv_f32_kernel<IDMATCH><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)feats, (const int*)index, (const int*)site_ids,
      (const float*)w, (float*)out, V, C, Vout, K, Cout);
  return (int)cudaGetLastError();
}

// ---- bf16 tensor-core body --------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int MM_WARPS = 4;
constexpr int MM_TM = 16 * MM_WARPS;   // output rows per block
constexpr int MM_NT = 32 * MM_WARPS;   // threads per block
constexpr int MM_TC = 128;             // input channels per stage (at most)
constexpr int MM_STAGES = 2;           // ring of stages: double buffering
constexpr int MM_PAD = 8;              // bf16 row padding of the tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok (src-size 0: no read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// Staged channels of a stage: the chunk's width rounded up to 16.
__host__ __device__ __forceinline__ int mm_stage_cols(int C) {
  return round16(C < MM_TC ? C : MM_TC);
}

// Block: TM output rows x 8*NTILES output channels (n0 = blockIdx.y * that)
// of batch element blockIdx.z. Warp w computes rows [16w, 16w + 16).
template <bool IDMATCH, int NTILES>
__global__ void __launch_bounds__(MM_NT) u3d_gather_conv_mma_kernel(
    const bf16* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const bf16* __restrict__ w,
    bf16* __restrict__ out, int V, int C, int Vout, int K, int Cout) {
  constexpr int TN = 8 * NTILES;
  constexpr int B_LD = TN + MM_PAD;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  __shared__ int s_row[MAX_K * MM_TM];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * MM_TM;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* fb = feats + (long long)b * V * C;
  const int cmax = mm_stage_cols(C);
  const int a_ld = cmax + MM_PAD;
  bf16* s_a0 = reinterpret_cast<bf16*>(mm_smem);
  bf16* s_b0 = s_a0 + MM_STAGES * MM_TM * a_ld;

  resolve_rows<IDMATCH, MM_TM, MM_NT>(s_row, index, site_ids, b, m0, V, Vout,
                                      K);

  const int nch = (C + MM_TC - 1) / MM_TC;
  const int n_stages = K * nch;
  const bool vec_a = (C % 8) == 0, vec_b = (Cout % 8) == 0;
  const int nw = min(Cout - n0, TN);   // real output channels of the block

  // stage t: rows of offset k = t / nch, channels [c0, c0 + cw)
  auto stage = [&](int t) {
    const int buf = t % MM_STAGES;
    const int k = t / nch, c0 = (t % nch) * MM_TC;
    const int cw = min(C - c0, MM_TC);
    const int cp = round16(cw);
    bf16* sa = s_a0 + buf * MM_TM * a_ld;
    bf16* sb = s_b0 + buf * cmax * B_LD;
    if (vec_a) {
      const int chunks = cp / 8;
      for (int e = tid; e < MM_TM * chunks; e += MM_NT) {
        const int r = e / chunks, j = e % chunks;
        const int row = s_row[r * K + k];
        const bool ok = row >= 0 && j * 8 < cw;
        cp_async16(sa + r * a_ld + j * 8,
                   ok ? fb + (long long)row * C + c0 + j * 8 : fb, ok);
      }
    } else {
      for (int e = tid; e < MM_TM * cp; e += MM_NT) {
        const int r = e / cp, c = e % cp;
        const int row = s_row[r * K + k];
        sa[r * a_ld + c] = (row >= 0 && c < cw)
                               ? fb[(long long)row * C + c0 + c]
                               : __float2bfloat16_rn(0.f);
      }
    }
    const bf16* wk = w + ((long long)k * C + c0) * Cout + n0;
    if (vec_b) {
      constexpr int chunks = TN / 8;
      for (int e = tid; e < cp * chunks; e += MM_NT) {
        const int c = e / chunks, j = e % chunks;
        const bool ok = c < cw && j * 8 < nw;
        cp_async16(sb + c * B_LD + j * 8,
                   ok ? wk + (long long)c * Cout + j * 8 : w, ok);
      }
    } else {
      for (int e = tid; e < cp * TN; e += MM_NT) {
        const int c = e / TN, n = e % TN;
        sb[c * B_LD + n] = (c < cw && n < nw) ? wk[(long long)c * Cout + n]
                                              : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[NTILES][4];
#pragma unroll
  for (int i = 0; i < NTILES; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // ring of MM_STAGES buffers: stages t+1 .. t+MM_STAGES-1 load while
  // the tensor cores multiply stage t
#pragma unroll
  for (int t = 0; t < MM_STAGES - 1; ++t) {
    if (t < n_stages) stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<MM_STAGES - 2>();   // stage t has landed
    // stage t is visible to all warps, and all have finished stage t-1,
    // whose buffer the next load refills
    __syncthreads();
    if (t + MM_STAGES - 1 < n_stages) stage(t + MM_STAGES - 1);
    cp_async_commit();
    const int cp = round16(min(C - (t % nch) * MM_TC, MM_TC));
    const int buf = t % MM_STAGES;
    const bf16* sa = s_a0 + buf * MM_TM * a_ld + warp * 16 * a_ld;
    const bf16* sb = s_b0 + buf * cmax * B_LD;
    for (int kk = 0; kk < cp; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + (lane & 15) * a_ld + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NTILES; nt += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, sb + (kk + (lane & 15)) * B_LD + nt * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[nt], a, bb[0], bb[1]);
        mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
      }
    }
  }

  const int g = lane >> 2, q = lane & 3;
  bf16* ob = out + (long long)b * Vout * Cout;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    const int n = n0 + nt * 8 + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + 8 * h;
      if (m >= Vout) continue;
      if (n < Cout)
        ob[(long long)m * Cout + n] = __float2bfloat16_rn(acc[nt][2 * h]);
      if (n + 1 < Cout)
        ob[(long long)m * Cout + n + 1] =
            __float2bfloat16_rn(acc[nt][2 * h + 1]);
    }
  }
}

template <bool IDMATCH, int NTILES>
int launch_mma_tiles(const void* feats, const void* index,
                     const void* site_ids, const void* w, void* out, int B,
                     int V, int C, int Vout, int K, int Cout,
                     cudaStream_t stream) {
  constexpr int TN = 8 * NTILES;
  const int cmax = mm_stage_cols(C);
  const size_t smem = MM_STAGES * (size_t)(MM_TM * (cmax + MM_PAD) +
                                           cmax * (TN + MM_PAD)) *
                      sizeof(bf16);
  auto kern = u3d_gather_conv_mma_kernel<IDMATCH, NTILES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Vout + MM_TM - 1) / MM_TM, (Cout + TN - 1) / TN, B);
  kern<<<grid, MM_NT, smem, stream>>>(
      (const bf16*)feats, (const int*)index, (const int*)site_ids,
      (const bf16*)w, (bf16*)out, V, C, Vout, K, Cout);
  return (int)cudaGetLastError();
}

template <bool IDMATCH>
int launch_gather_conv_bf16(const void* feats, const void* index,
                            const void* site_ids, const void* w, void* out,
                            int B, int V, int C, int Vout, int K, int Cout,
                            void* stream_ptr) {
  if (K > MAX_K || C <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Vout == 0 || Cout == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define U3D_MMA(NTILES)                                                    \
  return launch_mma_tiles<IDMATCH, NTILES>(feats, index, site_ids, w, out, \
                                           B, V, C, Vout, K, Cout, stream)
  if (Cout <= 16) U3D_MMA(2);
  if (Cout <= 32) U3D_MMA(4);
  if (Cout <= 64) U3D_MMA(8);
  U3D_MMA(16);
#undef U3D_MMA
}

constexpr int DW_TR = 32;     // rows per shared-memory stage

// One block: offset k, tile (c0, n0) of dW[k], rows [r_begin, r_end) of
// the flattened (B*Vout) axis. Thread (ty, tx) of 16 x 16 holds outputs
// c = c0 + ty + 16 i (i < TCI), n = n0 + tx + 16 j (j < TNJ).
template <typename T, bool IDMATCH, int TCI, int TNJ>
__global__ void __launch_bounds__(NT) u3d_gather_conv_dw_kernel(
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
__global__ void u3d_sum_chunks_kernel(const float* __restrict__ partial,
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
  u3d_gather_conv_dw_kernel<T, IDMATCH, TCI, TNJ><<<grid, NT, 0, stream>>>(
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
  u3d_sum_chunks_kernel<<<(unsigned)((per_chunk + threads - 1) / threads),
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
  u3d_match_positions_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)site_ids, (const int*)qids, (int*)out, V, per_batch,
      n_sites);
  return (int)cudaGetLastError();
}

int u3d_gather_conv_f32(const void* feats, const void* nb, const void* w,
                        void* out, int B, int V, int C, int Vout, int K,
                        int Cout, void* stream) {
  return launch_gather_conv_f32<false>(feats, nb, nullptr, w, out, B, V, C,
                                       Vout, K, Cout, stream);
}

// feats and w 16-byte aligned (the wrapper checks)
int u3d_gather_conv_bf16(const void* feats, const void* nb, const void* w,
                         void* out, int B, int V, int C, int Vout, int K,
                         int Cout, void* stream) {
  return launch_gather_conv_bf16<false>(feats, nb, nullptr, w, out, B, V, C,
                                        Vout, K, Cout, stream);
}

int u3d_gather_conv_ids_f32(const void* feats, const void* site_ids,
                            const void* qids, const void* w, void* out, int B,
                            int V, int C, int Vout, int K, int Cout,
                            void* stream) {
  return launch_gather_conv_f32<true>(feats, qids, site_ids, w, out, B, V, C,
                                      Vout, K, Cout, stream);
}

int u3d_gather_conv_ids_bf16(const void* feats, const void* site_ids,
                             const void* qids, const void* w, void* out,
                             int B, int V, int C, int Vout, int K, int Cout,
                             void* stream) {
  return launch_gather_conv_bf16<true>(feats, qids, site_ids, w, out, B, V,
                                       C, Vout, K, Cout, stream);
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
