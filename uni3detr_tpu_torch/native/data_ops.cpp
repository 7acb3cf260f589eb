// Native (C++) host-side data ops for the uni3detr_tpu_torch data pipeline
// (a copy of uni3detr_tpu/native/data_ops.cpp).
//
// Role parity: the reference pipeline runs these inner loops in numba
// njit/CUDA (mmdet3d box_np_ops.points_in_rbbox, box_collision_test,
// noise_per_object_v3_ -- see reference dbsampler.py:246-258 and
// mmdet3d/datasets/pipelines ObjectNoise).  numpy broadcasting
// materializes (P,N,2) temporaries (~12M floats at nuScenes scale,
// measured 616 ms/scene for points_in_rbbox alone), so the hot loops
// live here instead.  This is host code: the loader threads call it,
// never the device.
//
// Layout contracts (all row-major, C-contiguous, float32):
//   points: (P, pdim), xyz in columns 0..2
//   boxes:  (N, >=7) storage layout (cx, cy, cz_bottom, dx, dy, dz, yaw)
//   masks:  uint8, 1 = true
//
// Built by uni3detr_tpu_torch/native/__init__.py with plain g++ at first
// use; every entry point is extern "C" for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct RotRect {
    // BEV rotated rectangle: center, half sizes, axis unit vectors.
    float cx, cy, hx, hy, c, s;
};

inline RotRect make_rect(const float* b) {
    RotRect r;
    r.cx = b[0];
    r.cy = b[1];
    r.hx = 0.5f * b[3];
    r.hy = 0.5f * b[4];
    r.c = std::cos(b[6]);
    r.s = std::sin(b[6]);
    return r;
}

// Separating-axis test between two rotated BEV rectangles.  Matches the
// numpy reference in data/box_np_ops.py::box_collision_test exactly:
// four candidate axes (two per rectangle), separation is STRICT
// (max < min), overlap = no axis separates.
inline bool rects_overlap(const RotRect& a, const RotRect& b) {
    const float axes[4][2] = {
        {a.c, a.s}, {-a.s, a.c}, {b.c, b.s}, {-b.s, b.c}};
    const float dx = b.cx - a.cx, dy = b.cy - a.cy;
    for (int k = 0; k < 4; ++k) {
        const float ux = axes[k][0], uy = axes[k][1];
        // projection radius of each rect onto the axis
        const float ra = a.hx * std::fabs(ux * a.c + uy * a.s)
                       + a.hy * std::fabs(-ux * a.s + uy * a.c);
        const float rb = b.hx * std::fabs(ux * b.c + uy * b.s)
                       + b.hy * std::fabs(-ux * b.s + uy * b.c);
        const float d = std::fabs(ux * dx + uy * dy);
        // strict inequality: d > ra + rb  <=>  max < min in the numpy SAT
        if (d > ra + rb) return false;
    }
    return true;
}

}  // namespace

extern "C" {

// (P, pdim) x (N, bdim) -> (P, N) uint8 membership mask.
// z_center != 0 treats boxes[:, 2] as the z center (else bottom).
void points_in_rbbox(const float* pts, int64_t P, int64_t pdim,
                     const float* boxes, int64_t N, int64_t bdim,
                     int z_center, uint8_t* out) {
    // Hoist per-box trig/extent into a small struct-of-arrays pass.
    // 12M point-box pairs run in ~25 ms single-core vs 616 ms numpy.
    constexpr int kMaxStack = 512;
    float cb[kMaxStack], sb[kMaxStack], bx[kMaxStack], by[kMaxStack],
        hx[kMaxStack], hy[kMaxStack], z0[kMaxStack], z1[kMaxStack];
    float* heap = nullptr;
    float *pcb = cb, *psb = sb, *pbx = bx, *pby = by, *phx = hx,
          *phy = hy, *pz0 = z0, *pz1 = z1;
    if (N > kMaxStack) {
        heap = new float[8 * N];
        pcb = heap; psb = heap + N; pbx = heap + 2 * N; pby = heap + 3 * N;
        phx = heap + 4 * N; phy = heap + 5 * N; pz0 = heap + 6 * N;
        pz1 = heap + 7 * N;
    }
    for (int64_t i = 0; i < N; ++i) {
        const float* b = boxes + i * bdim;
        pcb[i] = std::cos(-b[6]);
        psb[i] = std::sin(-b[6]);
        pbx[i] = b[0];
        pby[i] = b[1];
        phx[i] = 0.5f * b[3];
        phy[i] = 0.5f * b[4];
        pz0[i] = z_center ? b[2] - 0.5f * b[5] : b[2];
        pz1[i] = pz0[i] + b[5];
    }
    for (int64_t p = 0; p < P; ++p) {
        const float x = pts[p * pdim + 0];
        const float y = pts[p * pdim + 1];
        const float z = pts[p * pdim + 2];
        uint8_t* row = out + p * N;
        for (int64_t i = 0; i < N; ++i) {
            if (z < pz0[i] || z > pz1[i]) { row[i] = 0; continue; }
            const float dx = x - pbx[i], dy = y - pby[i];
            const float lx = dx * pcb[i] - dy * psb[i];
            const float ly = dx * psb[i] + dy * pcb[i];
            row[i] = (std::fabs(lx) <= phx[i])
                  && (std::fabs(ly) <= phy[i]);
        }
    }
    delete[] heap;
}

// (P, pdim) x (N, bdim) -> (P,) uint8: 1 = point is inside ANY box.
// Fused any() with per-point early exit (ObjectSample background drop).
void points_in_any_rbbox(const float* pts, int64_t P, int64_t pdim,
                         const float* boxes, int64_t N, int64_t bdim,
                         int z_center, uint8_t* out) {
    for (int64_t p = 0; p < P; ++p) {
        const float x = pts[p * pdim + 0];
        const float y = pts[p * pdim + 1];
        const float z = pts[p * pdim + 2];
        uint8_t hit = 0;
        for (int64_t i = 0; i < N && !hit; ++i) {
            const float* b = boxes + i * bdim;
            const float zb = z_center ? b[2] - 0.5f * b[5] : b[2];
            if (z < zb || z > zb + b[5]) continue;
            const float cr = std::cos(-b[6]), sr = std::sin(-b[6]);
            const float dx = x - b[0], dy = y - b[1];
            const float lx = dx * cr - dy * sr;
            const float ly = dx * sr + dy * cr;
            hit = (std::fabs(lx) <= 0.5f * b[3])
               && (std::fabs(ly) <= 0.5f * b[4]);
        }
        out[p] = hit;
    }
}

// (Na, bdim) x (Nb, bdim) -> (Na, Nb) uint8 BEV SAT overlap matrix.
void box_collision_test(const float* a, int64_t Na, int64_t adim,
                        const float* b, int64_t Nb, int64_t bdim,
                        uint8_t* out) {
    for (int64_t i = 0; i < Na; ++i) {
        const RotRect ra = make_rect(a + i * adim);
        for (int64_t j = 0; j < Nb; ++j) {
            const RotRect rb = make_rect(b + j * bdim);
            out[i * Nb + j] = rects_overlap(ra, rb);
        }
    }
}

// Full ObjectNoise rejection loop (pipeline.py ObjectNoise.__call__):
// for each GT box take the first of T pre-drawn (translation, yaw)
// trials whose perturbed box does not collide with any OTHER box in the
// current (partially updated) box list; on acceptance rigidly move the
// points that were inside the ORIGINAL box (membership mask computed
// once at entry) about the original box's volume center.
//
//   pts    (P, pdim)   modified in place (xyz columns)
//   boxes  (G, bdim)   modified in place
//   trans  (G, T, 3)   pre-drawn translations
//   rots   (G, T)      pre-drawn yaw deltas
//   accepted (G,) int32 out: accepted trial index, -1 = none
void object_noise(float* pts, int64_t P, int64_t pdim,
                  float* boxes, int64_t G, int64_t bdim,
                  const float* trans, const float* rots, int64_t T,
                  int32_t* accepted) {
    if (G == 0) return;
    // membership masks vs the ORIGINAL boxes (numpy path computes
    // in_box before the loop).  One pass, (P, G) uint8.
    uint8_t* in_box = new uint8_t[P * G];
    points_in_rbbox(pts, P, pdim, boxes, G, bdim, /*z_center=*/0, in_box);

    float* orig = new float[G * 7];
    for (int64_t i = 0; i < G; ++i)
        std::memcpy(orig + i * 7, boxes + i * bdim, 7 * sizeof(float));

    for (int64_t i = 0; i < G; ++i) {
        accepted[i] = -1;
        float* bi = boxes + i * bdim;
        for (int64_t t = 0; t < T; ++t) {
            float nb[7];
            std::memcpy(nb, bi, 7 * sizeof(float));
            const float* tv = trans + (i * T + t) * 3;
            const float a = rots[i * T + t];
            nb[0] += tv[0];
            nb[1] += tv[1];
            nb[2] += tv[2];
            nb[6] += a;
            const RotRect rn = make_rect(nb);
            bool collides = false;
            for (int64_t j = 0; j < G && !collides; ++j) {
                if (j == i) continue;
                collides = rects_overlap(rn, make_rect(boxes + j * bdim));
            }
            if (collides) continue;
            // rigid move of member points about the original volume
            // center (pipeline.py:246-253)
            const float* ob = orig + i * 7;
            const float ctrx = ob[0], ctry = ob[1],
                        ctrz = ob[2] + 0.5f * ob[5];
            const float ca = std::cos(a), sa = std::sin(a);
            for (int64_t p = 0; p < P; ++p) {
                if (!in_box[p * G + i]) continue;
                float* q = pts + p * pdim;
                const float lx = q[0] - ctrx, ly = q[1] - ctry,
                            lz = q[2] - ctrz;
                // local @ rot.T with rot = [[c,-s,0],[s,c,0],[0,0,1]]
                q[0] = lx * ca - ly * sa + ctrx + tv[0];
                q[1] = lx * sa + ly * ca + ctry + tv[1];
                q[2] = lz + ctrz + tv[2];
            }
            std::memcpy(bi, nb, 7 * sizeof(float));
            accepted[i] = static_cast<int32_t>(t);
            break;
        }
    }
    delete[] in_box;
    delete[] orig;
}

}  // extern "C"
