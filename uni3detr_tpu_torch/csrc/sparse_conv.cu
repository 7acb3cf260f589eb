// Sparse-conv kernels of the sparse encoder, for Hopper (sm_90a).
//
// K1 u3d_match_positions replaces the Pallas kernel
//    uni3detr_tpu/ops/sparse_conv_pallas.py::_match_kernel_count
//    (entry match_positions): the row of each query id in the sorted site
//    ids (lower bound, a miss -> n_sites). Bound: the query ids read and
//    the rows written once (64 MB a nuScenes scene: ~19 us); the TPU's
//    window walk existed only because the TPU has no general gather. The
//    first design gave each thread one (row, offset) query: a warp's 32
//    lanes then searched ~27 targets in 9 far-apart bands of the id list,
//    ~17 dependent loads each, most of them to different cache lines. A
//    block now stages a tile of MT_ROWS = 32 rows x K query ids in shared
//    memory (coalesced in and out) and gives each thread a run of MT_RUN
//    consecutive offsets of one row, one warp a run: a warp's lanes take
//    32 consecutive rows, so their targets are neighbours in the id list
//    and their searches touch the same lines. A run's first search is
//    bracketed by the row's own site id (site ids are unique: a query d
//    ids away lies at most d rows away), which leaves one step for the
//    (0, 0) run and ~11 for the (0, +-1) runs of a 1440-wide grid. A run's
//    queries of a submanifold rulebook are consecutive ids (the dx = -1,
//    0, +1 of one (dz, dy)), so the next query of the run is a short
//    forward scan from the last position (at most MT_SCAN steps, then a
//    binary search of the rest); any query order stays exact, since the
//    lower bound is monotone in the query.
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
// never reach device memory (560 MB a call at nuScenes 32->32).
//
// bf16 (u3d_gather_conv{,_ids}_dw_bf16, the presets' dtype): dW is one
// (K*C x Cout) GEMM rows^T @ g contracted over the R = B*Vout rows, on
// the tensor cores. bf16 x bf16 products are exact in fp32, so mma.sync
// m16n8k16 bf16 -> fp32 computes the products the JAX backward computes
// after widening both operands. What bounds it: the index (4 bytes per
// row and offset) and the features and cotangents once; the 2*pairs*C*
// Cout products at the bf16 rate are 6-30x below that at every preset
// shape. In practice the staging traffic binds: every column tile reads
// the cotangent rows again, and the gathers are scattered 16-byte reads.
// A block owns TM consecutive columns of the flattened (k, c) axis
// (several offsets when C < TM, so C=5 wastes only the 135 -> 144
// padding), TN output channels and one chunk of the row axis: 256 x
// Cout up to 64 channels, else 128 x 128 (DwTile: each thread holds at
// most 64 fp32 sums). Each warp owns two 16-column sub-tiles, so every
// cotangent fragment feeds two products. Per DW_RS = 64-row stage the
// threads resolve the tile's (row, offset) neighbours (K10 by binary
// search of the query ids), then cp.async gathers the feature rows (16
// bytes a copy, src-size 0 zero-fills a miss; element loads for C % 8 !=
// 0) and the cotangent rows, which are read once per tile and not once
// per offset. The index entries of a stage are fetched one stage ahead of
// its gathers, the gathers one stage ahead of its products; each thread's
// staging addresses are fixed before the loop (runtime divisions per
// stage cost ~30% at the nuScenes shapes). Index and cotangents are read
// under an L2 evict-first policy, so the feature rows stay. Both operands
// are contracted over their row index, so ldmatrix.trans feeds both.
// Each chunk writes its partial tile; a second kernel sums the chunks in
// a fixed order, so dW is deterministic (no float atomics). The chunk
// size comes from the wrapper (ops/sparse_conv_cuda.py::dw_plan): enough
// blocks to fill the card, partials bounded.
//
// fp32 (u3d_gather_conv{,_ids}_dw_f32): exact fp32 products on the CUDA
// cores (the parity phases need them; TF32 would round). A block owns one
// offset k, one TC x TN tile of dW[k] and one chunk of rows; per 32-row
// stage it resolves the rows, stages them and the cotangent rows in
// shared memory and accumulates in fp32 registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
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

constexpr int MT_ROWS = 32;       // K1: rulebook rows of a block
constexpr int MT_RUN = 3;         // offsets a thread resolves in one row
constexpr int MT_SCAN = 2;        // forward steps before a binary search

__device__ __forceinline__ int lower_bound_ids(const int* __restrict__ ids,
                                               int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// blockDim.x = 32 x (runs of a row), one run a thread
__global__ void u3d_match_positions_kernel(
    const int* __restrict__ site_ids, const int* __restrict__ qids,
    int* __restrict__ out, int V, int Vout, int K, int n_sites) {
  extern __shared__ int s_q[];    // MT_ROWS x K query ids, then rows
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * MT_ROWS;
  const int rows = min(MT_ROWS, Vout - v0);
  const long long base = ((long long)b * Vout + v0) * K;
  const int n = rows * K;
  for (int e = threadIdx.x; e < n; e += blockDim.x) s_q[e] = qids[base + e];
  __syncthreads();
  const int* ids = site_ids + (long long)b * V;
  const int runs = (K + MT_RUN - 1) / MT_RUN;
  for (int t = threadIdx.x; t < runs * MT_ROWS; t += blockDim.x) {
    const int r = t % MT_ROWS, k0 = t / MT_ROWS * MT_RUN;
    if (r >= rows) continue;
    // the row's own site id s = ids[v] brackets any query's lower bound:
    // ids are unique ints, ascending, so lb(q) lies in [v - (s - q), v]
    // for q <= s and in [v + 1, v + (q - s)] for q > s
    const int v = v0 + r;
    const int s = v < V ? ids[v] : INT_MAX;
    int* q = s_q + r * K;         // stride K = 27 (odd): no bank conflicts
    int p = 0, q_last = -1;       // lower bound of the run's last query
    for (int k = k0; k < min(K, k0 + MT_RUN); ++k) {
      const int qk = q[k];
      if (qk < 0) {               // site ids are >= 0, pads are INT_MAX
        q[k] = n_sites;
        continue;
      }
      if (q_last < 0) {
        int lo = 0, hi = V;
        if (s != INT_MAX) {
          const long long d = (long long)qk - s;
          lo = d <= 0 ? (int)max(0LL, v + d) : v + 1;
          hi = d <= 0 ? v : (int)min((long long)V, v + d);
        }
        p = lower_bound_ids(ids, lo, hi, qk);
      } else if (qk < q_last) {
        p = lower_bound_ids(ids, 0, p, qk);
      } else {
        for (int step = 0; p < V && ids[p] < qk; ++p)
          if (++step > MT_SCAN) {
            p = lower_bound_ids(ids, p, V, qk);
            break;
          }
      }
      q_last = qk;
      q[k] = (p < V && ids[p] == qk) ? p : n_sites;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[base + e] = s_q[e];
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

constexpr int DW_TR = 32;     // fp32: rows per shared-memory stage

// fp32 body. One block: offset k, tile (c0, n0) of dW[k], rows [r_begin,
// r_end) of the flattened (B*Vout) axis. Thread (ty, tx) of 16 x 16 holds
// outputs c = c0 + ty + 16 i (i < TCI), n = n0 + tx + 16 j (j < TNJ).
template <bool IDMATCH, int TCI, int TNJ>
__global__ void __launch_bounds__(NT) u3d_gather_conv_dw_f32_kernel(
    const float* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const float* __restrict__ g,
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
      if (row >= 0 && c0 + c < C) v = feats[row * C + c0 + c];
      s_a[r][c] = v;
    }
    for (int e = tid; e < DW_TR * TN; e += NT) {
      const int r = e / TN, n = e % TN;
      float v = 0.f;
      if (r0 + r < r_end && n0 + n < Cout) v = g[(r0 + r) * Cout + n0 + n];
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

// ---- K7/K10 bf16 tensor-core body ----------------------------------------
// (ops/sparse_conv_cuda.py::dw_tile mirrors the tiles, DW_RS the stage)

constexpr int DW_WARPS = 8;
constexpr int DW_NT = 32 * DW_WARPS;   // threads per block
constexpr int DW_RS = 64;              // rows a stage: 4 mma k-steps
constexpr int DW_STAGES = 2;           // ring of gathered stages

// Offsets that TM consecutive columns of the (k, c) axis can touch: the
// stride of a stage's index rows in shared memory.
__host__ __device__ __forceinline__ int dw_tile_offsets(int TM, int C,
                                                        int K) {
  return min(K, (TM + C - 2) / C + 1);
}

// An L2 policy for data read once (the index, the cotangent rows): it
// goes first, so the feature rows that other stages gather again stay
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// 4 and 16 bytes global -> shared under an L2 policy, zero-filled when !ok
__device__ __forceinline__ void cp_async4_hint(void* dst, const void* src,
                                               bool ok, uint64_t policy) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(ok ? 4 : 0), "l"(policy));
}

__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src,
                                                bool ok, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(ok ? 16 : 0), "l"(policy));
}

// The block tile: DW_WARPS / WN x WN warps, each owning MSUB 16-column
// sub-tiles of the (k, c) axis and NTW 8-channel tiles, so a thread holds
// MSUB * NTW * 4 fp32 sums (at most 64) and every cotangent fragment
// feeds MSUB products.
template <int WN, int MSUB, int NTW>
struct DwTile {
  static constexpr int WM = DW_WARPS / WN;
  static constexpr int TM = 16 * MSUB * WM;   // (k, c) columns a block
  static constexpr int TN = 8 * NTW * WN;     // output channels a block
  static constexpr int A_LD = TM + MM_PAD, G_LD = TN + MM_PAD;
  static size_t smem(int C, int K) {
    return (size_t)DW_RS *
           (DW_STAGES * (A_LD + G_LD) * sizeof(bf16) +
            2 * dw_tile_offsets(TM, C, K) * sizeof(int));
  }
};

// Block (chunk, m-tile, n-tile) = (blockIdx.x, .y, .z): partial[chunk][m]
// [n] for m in [m0, m0 + TM) of the K*C columns (m = k*C + c) and n in
// [n0, n0 + TN), summed over rows [r_begin, r_end) of the flattened
// (B*Vout) axis.
//
// Each stage t of DW_RS rows passes three steps, each in its own
// iteration of the main loop so that their memory latencies overlap:
// fetch (cp.async of the stage's index entries at the tile's offsets,
// DW_STAGES iterations before its products), resolve + gather (each
// entry turned in place into a feature-table row or -1, then cp.async of
// the gathered rows and cotangent rows into ring slot t % DW_STAGES,
// DW_STAGES - 1 iterations before) and the products on the tensor cores.
template <bool IDMATCH, int WN, int MSUB, int NTW>
__global__ void __launch_bounds__(DW_NT, 2) u3d_gather_conv_dw_mma_kernel(
    const bf16* __restrict__ feats, const int* __restrict__ index,
    const int* __restrict__ site_ids, const bf16* __restrict__ g,
    float* __restrict__ partial, int B, int V, int C, int Vout, int K,
    int Cout, int chunk_rows) {
  using T = DwTile<WN, MSUB, NTW>;
  constexpr int TM = T::TM, TN = T::TN, A_LD = T::A_LD, G_LD = T::G_LD;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int M = K * C;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.z * TN;
  const int R = B * Vout;
  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, R);
  const int n_stages = (r_end - r_begin + DW_RS - 1) / DW_RS;
  const int k_lo = m0 / C;
  const int nk = (min(m0 + TM, M) - 1) / C + 1 - k_lo;
  const int kt = dw_tile_offsets(TM, C, K);
  const int ma = min(TM, round16(M - m0));   // staged columns
  const int nw = min(Cout - n0, TN);         // real output channels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec_a = (C % 8) == 0, vec_g = (Cout % 8) == 0;
  bf16* s_a0 = reinterpret_cast<bf16*>(dw_smem);
  bf16* s_g0 = s_a0 + DW_STAGES * DW_RS * A_LD;
  int* s_idx0 = reinterpret_cast<int*>(s_g0 + DW_STAGES * DW_RS * G_LD);

  // Every address below is a stage-invariant offset per thread plus the
  // stage's first row: the divisions happen once, before the loop.
  //
  // s_idx[i * kt + kl] of stage t (slot t & 1): the index entry of row
  // r0 + i at offset k_lo + kl, then, resolved, its feature-table row
  // (b * V + site) or -1 for a miss or a row past the chunk. Thread tid
  // owns entries e = tid + DW_NT * u, i = e / nk (exact in fp32 here).
  const int n_idx = DW_RS * nk;
  const uint64_t once = evict_first_policy();
  const float inv_nk = 1.f / nk;
  auto entry = [&](int e, int& i, int& kl) {
    i = __float2int_rz((e + 0.5f) * inv_nk);
    kl = e - i * nk;
  };
  auto fetch = [&](int t) {
    int* si = s_idx0 + (t & 1) * DW_RS * kt;
    const int r0 = r_begin + t * DW_RS;
    const int* ib = index + (long long)r0 * K + k_lo;
    for (int e = tid; e < n_idx; e += DW_NT) {
      int i, kl;
      entry(e, i, kl);
      const bool ok = r0 + i < r_end;
      cp_async4_hint(si + i * kt + kl, ok ? ib + i * K + kl : index, ok,
                     once);
    }
  };
  auto resolve = [&](int t) {
    int* si = s_idx0 + (t & 1) * DW_RS * kt;
    const int r0 = r_begin + t * DW_RS;
    const int b0 = r0 / Vout;
    for (int e = tid; e < n_idx; e += DW_NT) {
      int i, kl;
      entry(e, i, kl);
      const int r = r0 + i;
      int row = -1;
      if (r < r_end) {
        int b = b0;
        while (r >= (b + 1) * Vout) ++b;
        const int q = si[i * kt + kl];
        int hit;
        if (IDMATCH) {
          hit = find_row(site_ids + (long long)b * V, V, q, -1);
        } else {
          hit = (q >= 0 && q < V) ? q : -1;
        }
        if (hit >= 0) row = b * V + hit;
      }
      si[i * kt + kl] = row;
    }
  };

  // Gathered rows (DW_RS x ma, zero for a miss or a column past K*C).
  // C % 8 == 0: thread tid stages the 8 columns of chunk tid % A_CH (8
  // columns never straddle two offsets) in rows tid / A_CH + A_VSTEP u;
  // else column tid % TM element by element in rows tid / TM + A_ESTEP u.
  // The column's offset and channel are fixed per thread.
  constexpr int A_CH = TM / 8, A_VSTEP = DW_NT / A_CH;
  constexpr int A_ESTEP = DW_NT / TM;
  static_assert(DW_NT % A_CH == 0 && DW_NT % TM == 0, "staging map");
  const int acol = vec_a ? 8 * (tid % A_CH) : tid % TM;
  const int ai0 = vec_a ? tid / A_CH : tid / TM;
  const bool a_staged = acol < ma, a_real = m0 + acol < M;
  const int akl = a_real ? (m0 + acol) / C - k_lo : 0;
  const int ac = a_real ? m0 + acol - (akl + k_lo) * C : 0;
  // Cotangent rows (DW_RS x TN, zero past the chunk or Cout); Cout % 8
  // == 0: thread tid copies chunk gj = tid % G_CH of rows tid / G_CH +
  // G_STEP u
  constexpr int G_CH = TN / 8, G_STEP = DW_NT / G_CH;
  const int gj = tid % G_CH, gi0 = tid / G_CH;
  const bool g_ok = 8 * gj < nw;

  auto load = [&](int t) {
    const int slot = t % DW_STAGES;
    const int* sr = s_idx0 + (t & 1) * DW_RS * kt + akl;
    bf16* sa = s_a0 + slot * DW_RS * A_LD + acol;
    bf16* sg = s_g0 + slot * DW_RS * G_LD;
    const int r0 = r_begin + t * DW_RS;
    if (a_staged) {
      if (vec_a) {
        const bf16* fa = feats + ac;
#pragma unroll
        for (int i = ai0; i < DW_RS; i += A_VSTEP) {
          const int row = a_real ? sr[i * kt] : -1;
          cp_async16(sa + i * A_LD, row >= 0 ? fa + (long long)row * C : feats,
                     row >= 0);
        }
      } else {
        // 4-5 channels: rows not 16-byte aligned; 8 loads in flight
        constexpr int U = 8;
        for (int i0 = ai0; i0 < DW_RS; i0 += U * A_ESTEP) {
          bf16 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * A_ESTEP;
            const int row = (a_real && i < DW_RS) ? sr[i * kt] : -1;
            v[u] = row >= 0 ? feats[(long long)row * C + ac]
                            : __float2bfloat16_rn(0.f);
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (i0 + u * A_ESTEP < DW_RS) sa[(i0 + u * A_ESTEP) * A_LD] = v[u];
        }
      }
    }
    if (vec_g) {
      const bf16* gb = g + (long long)r0 * Cout + n0 + 8 * gj;
#pragma unroll
      for (int i = gi0; i < DW_RS; i += G_STEP) {
        const bool ok = g_ok && r0 + i < r_end;
        cp_async16_hint(sg + i * G_LD + 8 * gj,
                        ok ? gb + (long long)i * Cout : g, ok, once);
      }
    } else {
      for (int e = tid; e < DW_RS * TN; e += DW_NT) {
        const int i = e / TN, n = e % TN;
        const int r = r0 + i;
        sg[i * G_LD + n] = (r < r_end && n < nw)
                               ? g[(long long)r * Cout + n0 + n]
                               : __float2bfloat16_rn(0.f);
      }
    }
  };

  // warp (wm, wn): columns [16 MSUB wm, +16 MSUB), channels [8 NTW wn,
  // +8 NTW) of the block tile; sub-tiles past the staged columns hold
  // unstaged data and are never written out
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int wcol = 16 * MSUB * wm, wch = 8 * NTW * wn;
  const bool active = wcol < ma && wch < nw;
  float acc[MSUB][NTW][4];
#pragma unroll
  for (int s = 0; s < MSUB; ++s)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;

  // cp.async groups in commit order: fetch(0), an empty group, then per
  // iteration fetch(t + DW_STAGES) and load(t + DW_STAGES - 1), empty
  // where the stage does not exist, so the waits below count alike
  fetch(0);
  cp_async_commit();
  cp_async_commit();
  for (int t = 1 - DW_STAGES; t < n_stages; ++t) {
    const int tf = t + DW_STAGES, tl = tf - 1;
    // refills the index slot of stage tl - 1, whose gathers every warp
    // issued before the last barrier
    if (tf < n_stages) fetch(tf);
    cp_async_commit();
    cp_async_wait<2>();   // this thread's fetch(tl) has landed
    __syncthreads();      // ... and every thread's
    if (tl < n_stages) resolve(tl);
    // the resolved rows are visible, and every warp has finished the
    // products of stage t - 1, whose ring slot load(tl) refills
    __syncthreads();
    if (tl < n_stages) load(tl);
    cp_async_commit();
    cp_async_wait<2 * (DW_STAGES - 1)>();   // this thread's load(t)
    __syncthreads();                        // ... and every thread's
    if (t < 0 || !active) continue;
    const bf16* sa = s_a0 + (t % DW_STAGES) * DW_RS * A_LD + wcol;
    const bf16* sg = s_g0 + (t % DW_STAGES) * DW_RS * G_LD + wch;
#pragma unroll
    for (int kk = 0; kk < DW_RS; kk += 16) {
      // A (16 columns x 16 rows) is stored row-major by row r: the
      // transposed load gives the m16n8k16 A fragment
      uint32_t a[MSUB][4];
#pragma unroll
      for (int s = 0; s < MSUB; ++s)
        ldmatrix_x4_trans(a[s], sa + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                         A_LD +
                                     16 * s + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NTW; nt += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, sg + (kk + (lane & 15)) * G_LD + nt * 8 +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int s = 0; s < MSUB; ++s) {
          mma_bf16(acc[s][nt], a[s], bb[0], bb[1]);
          mma_bf16(acc[s][nt + 1], a[s], bb[2], bb[3]);
        }
      }
    }
  }
  if (!active) return;

  const int gq = lane >> 2, q = lane & 3;
  float* out = partial + (long long)blockIdx.x * M * Cout;
#pragma unroll
  for (int s = 0; s < MSUB; ++s)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int n = n0 + wch + nt * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wcol + 16 * s + gq + 8 * h;
        if (m >= M) continue;
        if (n < Cout) out[(long long)m * Cout + n] = acc[s][nt][2 * h];
        if (n + 1 < Cout)
          out[(long long)m * Cout + n + 1] = acc[s][nt][2 * h + 1];
      }
    }
}

constexpr int SUM_WAYS = 8;   // warps of the chunk sum, each a share of chunks

// dW[e] = sum over the chunks of partial[chunk][e]: warp w sums chunks w,
// w + SUM_WAYS, ... in order for 32 consecutive entries, then the SUM_WAYS
// sums are added in warp order, so the result does not depend on timing.
// IDMATCH only names the kernel apart for K7 and K10 in a profile.
template <bool IDMATCH>
__global__ void __launch_bounds__(32 * SUM_WAYS) u3d_dw_sum_chunks_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int n_chunks,
    long long per_chunk) {
  __shared__ float s[SUM_WAYS][32];
  const int lane = threadIdx.x & 31, way = threadIdx.x >> 5;
  const long long e = blockIdx.x * 32LL + lane;
  float acc = 0.f;
  if (e < per_chunk)
    for (int i = way; i < n_chunks; i += SUM_WAYS)
      acc += partial[i * per_chunk + e];
  s[way][lane] = acc;
  __syncthreads();
  if (way == 0 && e < per_chunk) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WAYS; ++w) total += s[w][lane];
    dw[e] = total;
  }
}

template <bool IDMATCH>
int launch_dw_sum(const float* partial, void* dw, int n_chunks,
                  long long per_chunk, cudaStream_t stream) {
  u3d_dw_sum_chunks_kernel<IDMATCH>
      <<<(unsigned)((per_chunk + 31) / 32), 32 * SUM_WAYS, 0, stream>>>(
          partial, (float*)dw, n_chunks, per_chunk);
  return (int)cudaGetLastError();
}

template <bool IDMATCH, int TCI, int TNJ>
void launch_dw_f32_tiles(dim3 grid, const void* feats, const void* index,
                         const void* site_ids, const void* g, float* partial,
                         int B, int V, int C, int Vout, int K, int Cout,
                         int chunk_rows, int tiles_c, int tiles_n,
                         cudaStream_t stream) {
  u3d_gather_conv_dw_f32_kernel<IDMATCH, TCI, TNJ><<<grid, NT, 0, stream>>>(
      (const float*)feats, (const int*)index, (const int*)site_ids,
      (const float*)g, partial, B, V, C, Vout, K, Cout, chunk_rows, tiles_c,
      tiles_n);
}

// n_chunks = ceil(B*Vout / chunk_rows), or -1 for arguments the kernels
// do not take (row indices must fit an int)
int dw_chunks(int B, int V, int Vout, int K, int chunk_rows, int multiple) {
  if (K > MAX_K || chunk_rows <= 0 || chunk_rows % multiple != 0) return -1;
  const long long R = (long long)B * Vout;
  if (R + chunk_rows >= INT_MAX || (long long)B * V >= INT_MAX) return -1;
  return (int)((R + chunk_rows - 1) / chunk_rows);
}

// partial: scratch of n_chunks*K*C*Cout fp32; dw: (K, C, Cout) fp32
template <bool IDMATCH>
int launch_gather_conv_dw_f32(const void* feats, const void* index,
                              const void* site_ids, const void* g,
                              void* partial, void* dw, int B, int V, int C,
                              int Vout, int K, int Cout, int chunk_rows,
                              void* stream_ptr) {
  const int n_chunks = dw_chunks(B, V, Vout, K, chunk_rows, DW_TR);
  if (n_chunks < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long per_chunk = (long long)K * C * Cout;
  if (per_chunk == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_chunks == 0) {
    cudaMemsetAsync(dw, 0, per_chunk * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  const bool wide_c = C > 16, wide_n = Cout > 16;
  const int tiles_c = (C + (wide_c ? 64 : 16) - 1) / (wide_c ? 64 : 16);
  const int tiles_n = (Cout + (wide_n ? 64 : 16) - 1) / (wide_n ? 64 : 16);
  dim3 grid(n_chunks, K * tiles_c * tiles_n);
  float* p = (float*)partial;
#define U3D_DW(TCI, TNJ)                                                      \
  launch_dw_f32_tiles<IDMATCH, TCI, TNJ>(grid, feats, index, site_ids, g, p, \
                                         B, V, C, Vout, K, Cout, chunk_rows, \
                                         tiles_c, tiles_n, stream)
  if (wide_c && wide_n) U3D_DW(4, 4);
  else if (wide_c) U3D_DW(4, 1);
  else if (wide_n) U3D_DW(1, 4);
  else U3D_DW(1, 1);
#undef U3D_DW
  const int status = (int)cudaGetLastError();
  if (status != 0) return status;
  return launch_dw_sum<IDMATCH>(p, dw, n_chunks, per_chunk, stream);
}

template <bool IDMATCH, int WN, int MSUB, int NTW>
int launch_dw_mma(int n_chunks, const void* feats, const void* index,
                  const void* site_ids, const void* g, float* partial, int B,
                  int V, int C, int Vout, int K, int Cout, int chunk_rows,
                  cudaStream_t stream) {
  using T = DwTile<WN, MSUB, NTW>;
  const size_t smem = T::smem(C, K);
  auto kern = u3d_gather_conv_dw_mma_kernel<IDMATCH, WN, MSUB, NTW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_chunks, (K * C + T::TM - 1) / T::TM,
            (Cout + T::TN - 1) / T::TN);
  kern<<<grid, DW_NT, smem, stream>>>(
      (const bf16*)feats, (const int*)index, (const int*)site_ids,
      (const bf16*)g, partial, B, V, C, Vout, K, Cout, chunk_rows);
  return (int)cudaGetLastError();
}

// As launch_gather_conv_dw_f32, on the tensor cores; chunk_rows a
// multiple of DW_RS, feats and g 16-byte aligned (the wrapper checks)
template <bool IDMATCH>
int launch_gather_conv_dw_bf16(const void* feats, const void* index,
                               const void* site_ids, const void* g,
                               void* partial, void* dw, int B, int V, int C,
                               int Vout, int K, int Cout, int chunk_rows,
                               void* stream_ptr) {
  const int n_chunks = dw_chunks(B, V, Vout, K, chunk_rows, DW_RS);
  if (n_chunks < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long per_chunk = (long long)K * C * Cout;
  if (per_chunk == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_chunks == 0) {
    cudaMemsetAsync(dw, 0, per_chunk * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  float* p = (float*)partial;
  int status;
  // tiles (TM x TN): 256 x 16/32/64 up to 64 channels, else 128 x 128
#define U3D_DW(WN, MSUB, NTW)                                            \
  status = launch_dw_mma<IDMATCH, WN, MSUB, NTW>(                        \
      n_chunks, feats, index, site_ids, g, p, B, V, C, Vout, K, Cout, \
      chunk_rows, stream)
  if (Cout <= 16) U3D_DW(1, 2, 2);
  else if (Cout <= 32) U3D_DW(1, 2, 4);
  else if (Cout <= 64) U3D_DW(1, 2, 8);
  else U3D_DW(2, 2, 8);
#undef U3D_DW
  if (status != 0) return status;
  return launch_dw_sum<IDMATCH>(p, dw, n_chunks, per_chunk, stream);
}

}  // namespace

extern "C" {

const char* u3d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int u3d_match_positions(const void* site_ids, const void* qids, void* out,
                        int B, int V, int Vout, int K, int n_sites,
                        void* stream) {
  if (B == 0 || Vout == 0 || K == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)MT_ROWS * K * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = 32 * min((K + MT_RUN - 1) / MT_RUN, 32);
  dim3 grid((unsigned)((Vout + MT_ROWS - 1) / MT_ROWS), B);
  u3d_match_positions_kernel<<<grid, threads, smem,
                               (cudaStream_t)stream>>>(
      (const int*)site_ids, (const int*)qids, (int*)out, V, Vout, K, n_sites);
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
  return launch_gather_conv_dw_f32<false>(feats, nb, nullptr, g, partial, dw,
                                         B, V, C, Vout, K, Cout, chunk_rows,
                                         stream);
}

int u3d_gather_conv_dw_bf16(const void* feats, const void* nb, const void* g,
                            void* partial, void* dw, int B, int V, int C,
                            int Vout, int K, int Cout, int chunk_rows,
                            void* stream) {
  return launch_gather_conv_dw_bf16<false>(feats, nb, nullptr, g, partial, dw,
                                          B, V, C, Vout, K, Cout, chunk_rows,
                                          stream);
}

int u3d_gather_conv_ids_dw_f32(const void* feats, const void* site_ids,
                               const void* qids, const void* g, void* partial,
                               void* dw, int B, int V, int C, int Vout, int K,
                               int Cout, int chunk_rows, void* stream) {
  return launch_gather_conv_dw_f32<true>(feats, qids, site_ids, g, partial,
                                        dw, B, V, C, Vout, K, Cout,
                                        chunk_rows, stream);
}

int u3d_gather_conv_ids_dw_bf16(const void* feats, const void* site_ids,
                                const void* qids, const void* g,
                                void* partial, void* dw, int B, int V, int C,
                                int Vout, int K, int Cout, int chunk_rows,
                                void* stream) {
  return launch_gather_conv_dw_bf16<true>(feats, qids, site_ids, g, partial,
                                         dw, B, V, C, Vout, K, Cout,
                                         chunk_rows, stream);
}

}  // extern "C"
