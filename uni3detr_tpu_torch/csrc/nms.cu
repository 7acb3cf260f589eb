// Rotated 3D IoU and per-class greedy NMS for Hopper (sm_90a).
//
// N1 u3d_iou3d_rotated_kernel replaces XLA code, not a Pallas kernel: the
// pairwise exact rotated 3D IoU of uni3detr_tpu/geom/iou.py::iou3d_rotated
// (:120) over _rect_pair_intersection_area (:60-81). One thread computes
// one pair: the Sutherland-Hodgman clip of box i's BEV rectangle by the
// four edges of box j runs in registers (fixed 8-vertex buffers, every
// index static after unrolling; a vertex lands in its output slot by a
// compare per slot, never by a dynamic index into local memory). A block
// stages the corners, extents and volumes of a 64-box row block and a
// 64-box column block in shared memory and covers their 64 x 64 pairs.
// The operation order is the JAX package's: the scale-relative inside
// hysteresis eps = 1e-5 * max(scale, 1e-3)^2, the 1e-12 guard of the
// crossing's denominator, the emit order (crossing point, then the next
// vertex), the shoelace sum and the z overlap; every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), so the
// kernel differs from the plain version by the order of the shoelace sum
// and the libm's sin and cos only. A pair without z overlap is 0 exactly
// in the reference too (a finite area times 0), so it skips the clip.
//
// The kernel computes two box sets against each other
// (u3d_iou_rotated_sets: (B, M) x (B, N) -> (B, M, N); the matrix is the
// case of one set against itself), in 3D or, with the BEV template
// flag, in bird's-eye view: the BEV intersection over clip(a1 + a2 -
// inter, eps) with the areas dx * dy, as geom/iou.py::iou_bev_rotated
// (:107-117), no z test. Box merging reads the matrix form; the KITTI and
// indoor metrics read the two-set forms (detections x GT of a scene).
//
// u3d_iou3d_rotated_mask is the same kernel writing NMS's overlap bitmask
// instead of the matrix: bit c of row r set when r < c, both boxes valid
// with one label, and IoU(r, c) > thr, the 3D IoU or, with the BEV flag,
// the bird's-eye one (ops/nms.py::nms_bev_rotated :96, the per-class NMS
// of the test-time augmentation merge, train/tta.py:75-84). Greedy NMS per class on boxes that
// carry one label each keeps what one greedy pass keeps whose overlap
// test also asks for equal labels, so one bitmask serves every class; the
// pass may visit the classes in any order, so the caller orders the boxes
// by class, by descending score within a class. Then only tiles on the
// diagonal's class blocks hold candidate pairs: a tile whose rows and
// columns share no label writes zeros without staging a box, and the
// warps of the other tiles clip few pairs of two classes. (In plain rank
// order one or two lanes of a warp match labels and the warp clips all
// the same: 0.51 ms against 0.16 ms device at ScanNet's 5000 boxes of 18
// classes on an H100 80GB HBM3 at 700 W, tools/time_nms.py.)
//
// What bounds N1 on this card: arithmetic. The matrix of N boxes is N^2 x
// 4 bytes (100 MB at N = 5000, 0.03 ms at 3.35 TB/s) against ~270 fp32
// operations a clipped pair (chip_smoke.IOU_OPS_PER_PAIR; ~18M of the 25M
// pairs of a ScanNet scene overlap in z: 0.07 ms at 67 TFLOP/s); the clip
// is branchy scalar code, so the card runs far below its fp32 peak. The
// BEV bitmask has no z test to skip a pair: on the TTA merge's two views
// of the flagship's detections (B=4, 2000 boxes a scene, 10 classes)
// 3.3M same-class pairs clip, 0.28 ms device against a 0.013 ms bound on
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 50).
//
// N2 u3d_nms_greedy replaces uni3detr_tpu/ops/nms.py::_greedy_suppress
// (:45-82), XLA's wavefront over the (N, N) suppression DAG per class.
// One block per scene scans the bitmask in scan order, with no host round
// trip. For each chunk of 64 positions the block ORs the chunk's column of
// the bitmask over the positions kept so far (one removed-mask word), then
// one thread decides the chunk serially from its diagonal words; the kept
// positions' bits stay in shared memory. All scenes run in one launch.
// Bound: the bitmask's bytes read once (3.2 MB a scene at N = 5000); the
// chain of chunks (a column reduction and 64 serial steps each) is what
// it really waits on. (ORing each kept row into a removed mask in shared
// memory after each chunk, as mmcv's nms3d does, leaves every thread ~60
// row loads a chunk in a chain: 1.29 ms against 0.19 ms device at ScanNet's
// 5000 boxes on an H100 80GB HBM3 at 700 W, tools/time_nms.py.)
//
// N3 u3d_soft_nms_kernel replaces uni3detr_tpu/ops/nms.py::soft_nms3d
// (:103-135), XLA's serial fori_loop under the soft_nms branch of
// train/coder.py::post_process (:73-88, vmapped over the classes). One
// block per (scene, class) holds the class's live scores in shared memory
// in fp32 (other classes' and invalid boxes at -inf, as in JAX; 20 KB at
// ScanNet's 5000 boxes). Each step is a block-wide argmax (ties to the
// lower index, as jnp.argmax), the prune test, and, while the step keeps
// a box, live[i] *= expf(-(iou[top, i]^2) / sigma) over the row of N1's
// matrix, then live[top] = -inf. The loop stops at the first step that
// keeps nothing: JAX's later steps change nothing. The products and the
// division are rounded one by one (no FMA, a true division as JAX's),
// so the kernel equals ops/nms.py::soft_nms_plain run on the card bit for
// bit. Each box has one label, so no two blocks write one box: each block
// initialises and writes the outputs of its class's boxes (block 0 those
// of the boxes of no class), the kept box's score, keep flag and step.
// Bound: the kept boxes' IoU rows read once (kept x N x 4 bytes) against
// the chain of steps, each a reduction over N and two barriers; compacting
// each class's boxes, or computing the rows on the fly, is left for later.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NV = 8;          // max vertices of a rect-rect intersection
constexpr int IOU_TILE = 64;   // boxes of a row block and of a column block
constexpr int IOU_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SOFT_THREADS = 256;
typedef unsigned long long u64;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// A box as the pair test reads it: BEV corners (counter-clockwise from
// (+dx/2, +dy/2) in the box frame), BEV extents, z interval, BEV area,
// volume.
struct BoxG {
  float cx[4], cy[4];
  float dx, dy, lo, hi, area, vol;
};

__device__ __forceinline__ BoxG make_box(const float* b, bool bottom) {
  BoxG g;
  const float x = b[0], y = b[1], z = b[2], dx = b[3], dy = b[4],
              dz = b[5], yaw = b[6];
  const float hx = mul(dx, 0.5f), hy = mul(dy, 0.5f);
  const float c = cosf(yaw), s = sinf(yaw);
  const float ox[4] = {hx, -hx, -hx, hx};
  const float oy[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    g.cx[k] = sub(add(x, mul(ox[k], c)), mul(oy[k], s));
    g.cy[k] = add(add(y, mul(ox[k], s)), mul(oy[k], c));
  }
  g.dx = dx;
  g.dy = dy;
  if (bottom) {
    g.lo = z;
    g.hi = add(z, dz);
  } else {
    const float h = mul(dz, 0.5f);
    g.lo = sub(z, h);
    g.hi = add(z, h);
  }
  g.area = mul(dx, dy);
  g.vol = mul(g.area, dz);
  return g;
}

// Write (x, y) to output slot cnt (dropped past NV, as the reference's
// compaction drops it) and count it.
__device__ __forceinline__ void emit(float (&ox)[NV], float (&oy)[NV],
                                     int& cnt, float x, float y) {
#pragma unroll
  for (int s = 0; s < NV; ++s)
    if (cnt == s) {
      ox[s] = x;
      oy[s] = y;
    }
  ++cnt;
}

// Clip the polygon (vx, vy)[:nv] by the half-plane left of p->q.
__device__ __forceinline__ void clip_halfplane(float (&vx)[NV],
                                               float (&vy)[NV], int& nv,
                                               float px, float py, float qx,
                                               float qy, float eps) {
  const float ex = sub(qx, px), ey = sub(qy, py);
  float d[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    d[i] = sub(mul(ex, sub(vy[i], py)), mul(ey, sub(vx[i], px)));
  float ox[NV], oy[NV];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    ox[s] = 0.f;
    oy[s] = 0.f;
  }
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < nv) {
      // next vertex (i + 1) % nv; past the buffer the index clamps to its
      // last slot, as the reference's gather clamps
      const int jn = i + 1 < NV ? i + 1 : NV - 1;
      const bool wrap = !(i + 1 < nv);
      const float nx = wrap ? vx[0] : vx[jn];
      const float ny = wrap ? vy[0] : vy[jn];
      const float dn = wrap ? d[0] : d[jn];
      const bool cur_in = d[i] >= -eps, nxt_in = dn >= -eps;
      float den = sub(d[i], dn);
      if (fabsf(den) < 1e-12f) den = 1e-12f;
      const float t = __fdiv_rn(d[i], den);
      if (cur_in != nxt_in)
        emit(ox, oy, cnt, add(vx[i], mul(t, sub(nx, vx[i]))),
             add(vy[i], mul(t, sub(ny, vy[i]))));
      if (nxt_in) emit(ox, oy, cnt, nx, ny);
    }
  }
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    vx[s] = ox[s];
    vy[s] = oy[s];
  }
  nv = cnt;
}

// The BEV intersection area of a and b: a's rectangle clipped by b's
// four edges, then the shoelace sum, clamped at 0.
__device__ float bev_inter(const BoxG& a, const BoxG& b) {
  const float scale = fmaxf(fmaxf(a.dx, a.dy), fmaxf(b.dx, b.dy));
  const float sc = fmaxf(scale, 1e-3f);
  const float eps = mul(1e-5f, mul(sc, sc));
  float vx[NV], vy[NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vx[i] = a.cx[i];
    vy[i] = a.cy[i];
    vx[i + 4] = 0.f;
    vy[i + 4] = 0.f;
  }
  int nv = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    clip_halfplane(vx, vy, nv, b.cx[k], b.cy[k], b.cx[(k + 1) % 4],
                   b.cy[(k + 1) % 4], eps);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i < nv) {
      const int jn = i + 1 < NV ? i + 1 : NV - 1;
      const bool wrap = !(i + 1 < nv);
      const float xn = wrap ? vx[0] : vx[jn];
      const float yn = wrap ? vy[0] : vy[jn];
      sum = add(sum, sub(mul(vx[i], yn), mul(xn, vy[i])));
    }
  }
  return fmaxf(mul(0.5f, sum), 0.f);
}

__device__ float pair_iou(const BoxG& a, const BoxG& b) {
  const float zo = fmaxf(sub(fminf(a.hi, b.hi), fmaxf(a.lo, b.lo)), 0.f);
  if (!(zo > 0.f)) return 0.f;   // the reference's area x 0 = 0
  const float inter = mul(bev_inter(a, b), zo);
  const float uni = fmaxf(sub(add(a.vol, b.vol), inter), 1e-6f);
  return fminf(fmaxf(__fdiv_rn(inter, uni), 0.f), 1.f);
}

__device__ float pair_iou_bev(const BoxG& a, const BoxG& b) {
  const float inter = bev_inter(a, b);
  const float uni = fmaxf(sub(add(a.area, b.area), inter), 1e-6f);
  return fminf(fmaxf(__fdiv_rn(inter, uni), 0.f), 1.f);
}

// Stage a row block of set a and a column block of set b (and labels) in
// shared memory; rows past M and columns past N are never read.
__device__ __forceinline__ void stage_boxes(BoxG* s_row, BoxG* s_col,
                                            const float* a, int M, int r0,
                                            const float* b, int N, int c0,
                                            bool bottom) {
  const int tid = threadIdx.x;
  if (tid < IOU_TILE && r0 + tid < M)
    s_row[tid] = make_box(a + (long long)(r0 + tid) * 7, bottom);
  else if (tid >= IOU_TILE && tid < 2 * IOU_TILE &&
           c0 + tid - IOU_TILE < N)
    s_col[tid - IOU_TILE] =
        make_box(b + (long long)(c0 + tid - IOU_TILE) * 7, bottom);
}

// N1, matrix: out[b, r, c] = IoU(box r of set a, box c of set b), 3D or
// BEV. Grid (column blocks, row blocks, B); thread t covers column t % 64
// of rows t / 64 + 4 i.
template <bool BEV>
__global__ void __launch_bounds__(IOU_THREADS) u3d_iou3d_rotated_kernel(
    const float* __restrict__ a, const float* __restrict__ bset, int M,
    int N, int bottom, float* __restrict__ out) {
  __shared__ BoxG s_row[IOU_TILE], s_col[IOU_TILE];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * IOU_TILE, c0 = blockIdx.x * IOU_TILE;
  stage_boxes(s_row, s_col, a + (long long)b * M * 7, M, r0,
              bset + (long long)b * N * 7, N, c0, bottom != 0);
  __syncthreads();
  const int col = threadIdx.x % IOU_TILE;
  const int c = c0 + col;
  if (c >= N) return;
  for (int rr = threadIdx.x / IOU_TILE; rr < IOU_TILE;
       rr += IOU_THREADS / IOU_TILE) {
    const int r = r0 + rr;
    if (r >= M) break;
    out[((long long)b * M + r) * N + c] =
        BEV ? pair_iou_bev(s_row[rr], s_col[col])
            : pair_iou(s_row[rr], s_col[col]);
  }
}

// N1, bitmask: mask[b, w, r] bit j = pair (r, 64 w + j) of boxes in scan
// order overlaps (see the header); word w of every row is one contiguous
// column, which N2 reads in coalesced loads. Blocks left of the diagonal
// write 0.
// Warp w of the block holds 32 columns of one row per step, so one ballot
// is half of the row's word. BEV selects the bird's-eye IoU (z ignored).
template <bool BEV>
__global__ void __launch_bounds__(IOU_THREADS) u3d_iou3d_rotated_mask_kernel(
    const float* __restrict__ boxes, const int* __restrict__ labels, int N,
    int W, float thr, int bottom, u64* __restrict__ mask) {
  __shared__ BoxG s_row[IOU_TILE], s_col[IOU_TILE];
  __shared__ int s_lrow[IOU_TILE], s_lcol[IOU_TILE];
  __shared__ unsigned s_half[IOU_TILE][2];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * IOU_TILE, c0 = blockIdx.x * IOU_TILE;
  const int tid = threadIdx.x;
  u64* mcol = mask + ((long long)b * W + blockIdx.x) * N;
  if (c0 + IOU_TILE <= r0) {     // every pair has c < r
    if (tid < IOU_TILE && r0 + tid < N) mcol[r0 + tid] = 0ull;
    return;
  }
  const float* bx = boxes + (long long)b * N * 7;
  const int* lab = labels + (long long)b * N;
  if (tid < IOU_TILE) s_lrow[tid] = r0 + tid < N ? lab[r0 + tid] : -1;
  else if (tid < 2 * IOU_TILE)
    s_lcol[tid - IOU_TILE] =
        c0 + tid - IOU_TILE < N ? lab[c0 + tid - IOU_TILE] : -1;
  __syncthreads();
  const int col = tid % IOU_TILE;
  const int c = c0 + col;
  const int lane = tid % 32, half = (tid / 32) % 2;
  // a tile without a candidate pair (the labels of its rows and columns
  // never meet, as off the diagonal of class-grouped boxes) writes 0
  bool any = false;
  for (int rr = tid / IOU_TILE; rr < IOU_TILE;
       rr += IOU_THREADS / IOU_TILE)
    any |= r0 + rr < c && c < N && s_lrow[rr] >= 0 &&
           s_lrow[rr] == s_lcol[col];
  if (!__syncthreads_or(any)) {
    if (tid < IOU_TILE && r0 + tid < N) mcol[r0 + tid] = 0ull;
    return;
  }
  stage_boxes(s_row, s_col, bx, N, r0, bx, N, c0, bottom != 0);
  __syncthreads();
  for (int rr = tid / IOU_TILE; rr < IOU_TILE;
       rr += IOU_THREADS / IOU_TILE) {
    const int r = r0 + rr;
    const int lr = s_lrow[rr];
    bool bit = false;
    if (r < c && c < N && lr >= 0 && lr == s_lcol[col])
      bit = (BEV ? pair_iou_bev(s_row[rr], s_col[col])
                 : pair_iou(s_row[rr], s_col[col])) > thr;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) s_half[rr][half] = word;
  }
  __syncthreads();
  if (tid < IOU_TILE && r0 + tid < N)
    mcol[r0 + tid] = ((u64)s_half[tid][1] << 32) | (u64)s_half[tid][0];
}

// N2: one block per scene, over the bitmask in column words (word w of
// position r at mask[b, w, r]); labels in scan order, -1 for an invalid
// box. keep[b, order[b, r]] = 1 for the kept positions r. Chunk ch
// (positions 64 ch .. 64 ch + 63) needs one word of the removed mask: the
// OR of column ch over the positions kept in earlier chunks, read by the
// whole block in coalesced loads and reduced through shuffles; thread 0
// then decides the chunk's 64 positions in order from its diagonal words.
__global__ void __launch_bounds__(SCAN_THREADS) u3d_nms_greedy_kernel(
    const u64* __restrict__ mask, const int* __restrict__ labels,
    const long long* __restrict__ order, int N, int W,
    unsigned char* __restrict__ keep) {
  extern __shared__ u64 s_kept[];        // W words: bit j of word c kept
  __shared__ u64 s_diag[64];
  __shared__ u64 s_part[SCAN_THREADS / 32];
  __shared__ unsigned s_valid[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const u64* m = mask + (long long)b * W * N;
  const int* lab = labels + (long long)b * N;
  const long long* ord = order + (long long)b * N;
  unsigned char* kp = keep + (long long)b * N;
  for (int i = tid; i < N; i += SCAN_THREADS) kp[i] = 0;
  for (int ch = 0; ch < W; ++ch) {
    const int base = ch * 64;
    const u64* col = m + (long long)ch * N;
    u64 acc = 0ull;
#pragma unroll 4
    for (int r = tid; r < base; r += SCAN_THREADS) {
      const u64 word = col[r];
      if ((s_kept[r >> 6] >> (r & 63)) & 1ull) acc |= word;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc |= __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s_part[warp] = acc;
    if (tid < 64) {
      const int r = base + tid;
      s_diag[tid] = r < N ? col[r] : 0ull;
      const unsigned v = __ballot_sync(0xffffffffu, r < N && lab[r] >= 0);
      if (lane == 0) s_valid[warp] = v;
    }
    __syncthreads();
    if (tid == 0) {
      u64 cur = 0ull;
#pragma unroll
      for (int w = 0; w < SCAN_THREADS / 32; ++w) cur |= s_part[w];
      const u64 valid = ((u64)s_valid[1] << 32) | (u64)s_valid[0];
      u64 kept = 0ull;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const u64 bit = 1ull << j;
        if ((valid & bit) && !(cur & bit)) {
          kept |= bit;
          cur |= s_diag[j];
        }
      }
      s_kept[ch] = kept;
    }
    __syncthreads();
    if (tid < 64 && ((s_kept[ch] >> tid) & 1ull)) kp[ord[base + tid]] = 1;
  }
}

// (v2, i2) ranks above (v1, i1): a higher score, or an equal one at a
// lower index.
__device__ __forceinline__ bool ranks_above(float v2, int i2, float v1,
                                            int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

// N3: block (c, b) runs the soft-NMS of class c of scene b. iou (B, N, N)
// row-major with row i box i's; outputs (B, N).
__global__ void __launch_bounds__(SOFT_THREADS) u3d_soft_nms_kernel(
    const float* __restrict__ iou, const float* __restrict__ scores,
    const int* __restrict__ labels, const unsigned char* __restrict__ valid,
    int N, int C, float sigma, float prune, int max_out,
    float* __restrict__ out, unsigned char* __restrict__ keep,
    int* __restrict__ step) {
  extern __shared__ float s_live[];
  __shared__ float s_val[SOFT_THREADS / 32];
  __shared__ int s_idx[SOFT_THREADS / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long off = (long long)b * N;
  const float* rows = iou + off * N;
  for (int i = tid; i < N; i += SOFT_THREADS) {
    const int lab = labels[off + i];
    const bool mine = valid[off + i] && lab == c;
    s_live[i] = mine ? scores[off + i] : -CUDART_INF_F;
    if ((lab >= 0 && lab < C ? lab : 0) == c) {
      out[off + i] = 0.f;
      keep[off + i] = 0;
      step[off + i] = -1;
    }
  }
  __syncthreads();
  for (int k = 0; k < max_out; ++k) {
    // argmax: a -inf entry never wins, so an all -inf block ends at N
    float bv = -CUDART_INF_F;
    int bi = N;
    for (int i = tid; i < N; i += SOFT_THREADS) {
      const float v = s_live[i];
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ranks_above(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    bv = s_val[0];
    bi = s_idx[0];
#pragma unroll
    for (int w = 1; w < SOFT_THREADS / 32; ++w)
      if (ranks_above(s_val[w], s_idx[w], bv, bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    // every thread holds the same (bv, bi): the break is uniform
    if (bi == N || !(bv > prune)) break;
    if (tid == 0) {
      out[off + bi] = fmaxf(bv, 0.f);
      keep[off + bi] = 1;
      step[off + bi] = k;
    }
    const float* row = rows + (long long)bi * N;
    for (int i = tid; i < N; i += SOFT_THREADS) {
      const float r = row[i];
      const float decay = expf(__fdiv_rn(-mul(r, r), sigma));
      s_live[i] = i == bi ? -CUDART_INF_F : mul(s_live[i], decay);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes a (B, M, 7), b (B, N, 7) fp32 -> out (B, M, N) fp32; bev != 0
// for the BEV IoU (z ignored), else 3D with bottom != 0 for bottom z.
int u3d_iou_rotated_sets(const void* a, const void* b, void* out, int B,
                         int M, int N, int bev, int bottom, void* stream) {
  if (B == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  const int nr = (M + IOU_TILE - 1) / IOU_TILE;
  const int nc = (N + IOU_TILE - 1) / IOU_TILE;
  if (nr > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(nc, nr, B);
  if (bev)
    u3d_iou3d_rotated_kernel<true><<<grid, IOU_THREADS, 0,
                                     (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, M, N, bottom, (float*)out);
  else
    u3d_iou3d_rotated_kernel<false><<<grid, IOU_THREADS, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, M, N, bottom, (float*)out);
  return (int)cudaGetLastError();
}

// bev != 0: the bird's-eye IoU (z ignored), else 3D with bottom != 0 for
// bottom z.
int u3d_iou3d_rotated_mask(const void* boxes, const void* labels, void* mask,
                           int B, int N, float thr, int bev, int bottom,
                           void* stream) {
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const int W = (N + 63) / 64;
  if (W > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(W, W, B);
  if (bev)
    u3d_iou3d_rotated_mask_kernel<true><<<grid, IOU_THREADS, 0,
                                          (cudaStream_t)stream>>>(
        (const float*)boxes, (const int*)labels, N, W, thr, bottom,
        (u64*)mask);
  else
    u3d_iou3d_rotated_mask_kernel<false><<<grid, IOU_THREADS, 0,
                                           (cudaStream_t)stream>>>(
        (const float*)boxes, (const int*)labels, N, W, thr, bottom,
        (u64*)mask);
  return (int)cudaGetLastError();
}

int u3d_nms_greedy(const void* mask, const void* labels, const void* order,
                   void* keep, int B, int N, void* stream) {
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const int W = (N + 63) / 64;
  const size_t smem = (size_t)W * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        u3d_nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  u3d_nms_greedy_kernel<<<B, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)mask, (const int*)labels, (const long long*)order, N, W,
      (unsigned char*)keep);
  return (int)cudaGetLastError();
}

// iou (B, N, N), scores (B, N) fp32, labels (B, N) int32, valid (B, N)
// uint8 -> out (B, N) fp32, keep (B, N) uint8, step (B, N) int32.
int u3d_soft_nms(const void* iou, const void* scores, const void* labels,
                 const void* valid, int B, int N, int C, float sigma,
                 float prune, int max_out, void* out, void* keep,
                 void* step, void* stream) {
  if (B == 0 || N == 0 || C == 0) return (int)cudaSuccess;
  if (C > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        u3d_soft_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  u3d_soft_nms_kernel<<<dim3(C, B), SOFT_THREADS, smem,
                        (cudaStream_t)stream>>>(
      (const float*)iou, (const float*)scores, (const int*)labels,
      (const unsigned char*)valid, N, C, sigma, prune, max_out,
      (float*)out, (unsigned char*)keep, (int*)step);
  return (int)cudaGetLastError();
}

}  // extern "C"
