"""The benchmark's own count of a cell's work: FLOPs, bytes and least
times, worked out after the window from the inputs of the traced
iterations (:class:`Work`), as the per-layer readers ask for them.

- Sparse convs: 2 * pairs * Cin * Cout, the pairs being the (output site,
  kernel tap) pairs that find an input site, derived here with NumPy from
  the points (voxel ids, the strided site sets cut at their budgets,
  searches of every tap); never read from the program. Training adds the
  feature gradient (the same pairs, Cin and Cout swapped; none for the
  first conv, whose input needs none) and the weight gradient (the same
  pairs).
- Dense ops (SECOND3D, the FPN, the head): the model family's count
  (``families/<family>.py``: ``FlopCounterMode`` over the plain
  reference on meta tensors), forward (inference) or forward and
  backward (training).
- Least times: the larger of operations over the H100's peak for their
  type and bytes over its memory rate, each input read once and each
  output written once (the arithmetic of ``chip_smoke.py``'s roofline
  helper, frozen here).
"""
from __future__ import annotations

import math

import numpy as np

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)
H100_BYTES_PER_S = 3.35e12
H100_PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
FPS_OPS_PER_POINT_STEP = 9    # 3 subtractions, 3 products, 2 sums, 1 min


def least_s(ops, nbytes, peak):
    """The least time the card could take: max(ops / peak, bytes / rate)."""
    return max(ops / H100_PEAK_OPS[peak], nbytes / H100_BYTES_PER_S)


def conv_least(pairs, V, C, Vout, Cout, B, ids=False, elem=2, K=27):
    """K2 (K3 with ``ids``): reads features (B, V, C), the rulebook or
    query ids (B, Vout, K) int32 (and site ids), the weights; writes (B,
    Vout, Cout)."""
    nbytes = (elem * (B * V * C + K * C * Cout + B * Vout * Cout)
              + 4 * B * Vout * K + (4 * B * V if ids else 0))
    return least_s(2 * pairs * C * Cout, nbytes, "bf16")


def dw_least(pairs, V, C, Vout, Cout, B, ids=False, elem=2, K=27):
    """K7 (K10 with ``ids``): reads features, index and cotangent (B,
    Vout, Cout); writes dW (K, C, Cout) fp32."""
    nbytes = (elem * (B * V * C + B * Vout * Cout) + 4 * B * Vout * K
              + (4 * B * V if ids else 0) + 4 * K * C * Cout)
    return least_s(2 * pairs * C * Cout, nbytes, "bf16")


def match_least(V, Vout, B, K=27):
    """K1: a binary search per query over the site ids."""
    q = B * Vout * K
    return least_s(q * math.ceil(math.log2(V + 1)), 4 * (B * V + 2 * q),
                   "fp32")


def fps_least(valid, sizes, S):
    """K4: FPS_OPS_PER_POINT_STEP operations per valid point and step;
    reads planes and masks (13 B a point), writes S indices a set."""
    return least_s(FPS_OPS_PER_POINT_STEP * sum(valid) * (S - 1),
                   13 * sum(sizes) + 4 * S * len(sizes), "fp32")


# -- sites and pairs ----------------------------------------------------------

def _offsets():
    r = np.arange(3)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)


def _lin(c, grid):
    D, H, W = grid
    return (c[:, 0] * H + c[:, 1]) * W + c[:, 2]


def _coords(lin, grid):
    D, H, W = grid
    return np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)


def voxel_ids(points, cfg, V):
    """Sorted linear ids of the occupied voxels of one scene, cut at V."""
    D, H, W = cfg["grid_size"]
    lo = np.asarray(cfg["pc_range"][:3], np.float32)
    inv = (1.0 / np.asarray(cfg["voxel_size"], np.float32)).astype(np.float32)
    idx = np.floor((points[:, :3] - lo) * inv).astype(np.int64)
    ok = ((idx >= 0) & (idx < np.array([W, H, D]))).all(-1)
    ix, iy, iz = idx[ok].T
    return np.unique((iz * H + iy) * W + ix)[:V]


def budget(cfg, V, i):
    b = -(-int(V * cfg["encoder_budget_shrink"][i]) // 8) * 8
    caps = cfg.get("encoder_budget_caps")
    if caps is not None:
        b = min(b, caps[i])
    return max(b, 256)


def _taps(out_c, grid, stride, pad):
    D, H, W = grid
    off = _offsets()
    if stride == 1:
        tap = out_c[:, None, :] + off[None] - 1
    else:
        tap = out_c[:, None, :] * 2 - np.asarray(pad) + off[None]
    ok = ((tap >= 0) & (tap < np.array([D, H, W]))).all(-1)
    return np.where(ok, (tap[..., 0] * H + tap[..., 1]) * W + tap[..., 2],
                    -1)


def _hits(ids, q):
    pos = np.searchsorted(ids, q).clip(max=max(len(ids) - 1, 0))
    return int(((q >= 0) & (ids[pos] == q)).sum()) if len(ids) else 0


def scene_sites(points, cfg, V):
    """One scene: per stage its site count and the pairs of its
    submanifold convs and (after the first) of the strided conv into it."""
    grid = tuple(cfg["grid_size"])
    ids = voxel_ids(points, cfg, V)
    stages = [{"sites": len(ids), "subm_pairs":
               _hits(ids, _taps(_coords(ids, grid), grid, 1, None))}]
    for i in range(len(cfg["encoder_channels"]) - 1):
        pad = cfg["encoder_downsample_paddings"][i]
        og = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
        c = _coords(ids, grid)
        cand = c[:, None, :] + np.asarray(pad) - _offsets()[None]
        ok = ((cand % 2 == 0).all(-1) & (cand >= 0).all(-1)
              & (cand // 2 < np.array(og)).all(-1))
        out = np.unique(_lin((cand[ok] // 2), og))[:budget(cfg, V, i)]
        down = _hits(ids, _taps(_coords(out, og), grid, 2, pad))
        ids, grid = out, og
        stages.append({"sites": len(ids), "down_pairs": down, "subm_pairs":
                       _hits(ids, _taps(_coords(ids, grid), grid, 1, None))})
    return stages


def sparse_work(stages_per_scene, cfg, V, train):
    """FLOPs and least seconds of the sparse encoder's kernels over a
    batch, from each scene's :func:`scene_sites`: ``{"flops", "least_s",
    "conv_out_flops"}``."""
    B = len(stages_per_scene)
    chans = cfg["encoder_channels"]
    n = len(chans)
    rows = [V] + [budget(cfg, V, i) for i in range(n - 1)]
    cin0 = cfg["in_point_features"]
    width = [cfg["encoder_base_channels"]] + [chans[i][-1]
                                              for i in range(n - 1)]
    flops = 0.0
    least = 0.0
    for s in range(n):
        pairs_subm = sum(sc[s]["subm_pairs"] for sc in stages_per_scene)
        C = width[s]
        convs = []                          # (pairs, Cin, Cout, Vin, ids)
        if s == 0:
            convs.append((pairs_subm, cin0, C, rows[0], False, True))
        else:
            pd = sum(sc[s]["down_pairs"] for sc in stages_per_scene)
            convs.append((pd, width[s - 1], C, rows[s - 1], True, False))
        nblk = len(chans[s]) - 1 if s < n - 1 else len(chans[s])
        convs += [(pairs_subm, C, C, rows[s], False, False)] * (2 * nblk)
        least += match_least(rows[s], rows[s], B)
        for pairs, ci, co, vin, ids, first in convs:
            f = 2.0 * pairs * ci * co
            flops += f
            least += conv_least(pairs, vin, ci, rows[s], co, B, ids)
            if train:
                flops += f                                  # dW
                least += dw_least(pairs, vin, ci, rows[s], co, B, ids)
                if not first:                               # dfeats
                    flops += f
                    if ids:
                        least += conv_least(pairs, rows[s], co, vin, ci, B,
                                            True)
                    else:
                        least += conv_least(pairs, rows[s], co, rows[s], ci,
                                            B)
    sites_last = sum(sc[-1]["sites"] for sc in stages_per_scene)
    out_f = 2.0 * sites_last * width[-1] * cfg["encoder_out_channels"]
    return {"flops": flops, "least_s": least,
            "conv_out_flops": out_f * (3 if train else 1)}


def fps_work(points_valid, voxels, cfg, V):
    """Least seconds of K4 over a batch: two sets a scene."""
    S = cfg["num_query"]
    P = cfg["num_points"]
    return sum(fps_least([pv, nv], [P, V], S)
               for pv, nv in zip(points_valid, voxels))


def scene_counts(points, cfg, V):
    """Per scene: the stage list of :func:`scene_sites` and its valid
    voxels."""
    st = scene_sites(points, cfg, V)
    return {"stages": st, "voxels": st[0]["sites"],
            "points": int(points.shape[0])}


class Work:
    """The cell's own inputs in the traced iterations, counted on demand by
    the per-layer readers: ``batches`` holds, per traced iteration, its
    pool index and its points (B, P, C); each pool batch is counted once.
    ``per_iter(fn)`` is the mean over the traced iterations of ``fn(work,
    counts)``, ``counts`` being the iteration's :func:`scene_counts`;
    ``dense(cfg, batch, train)`` gives the dense FLOPs of a batch."""

    def __init__(self, cfg, V, batch, train, batches, dense):
        self.cfg, self.V, self.batch, self.train = cfg, V, batch, train
        self.batches = batches
        self.dense = dense
        self._counts = {}
        self._dense = None

    def counts(self, key, points):
        if key not in self._counts:
            self._counts[key] = [scene_counts(p, self.cfg, self.V)
                                 for p in points]
        return self._counts[key]

    def dense_flops(self):
        if self._dense is None:
            self._dense = self.dense(self.cfg, self.batch, self.train)
        return self._dense

    def per_iter(self, fn):
        vals = [fn(self, self.counts(k, p)) for k, p in self.batches]
        return sum(vals) / len(vals)


# -- what the readers count, per iteration (``Work.per_iter``) -----------------

def model_flops(work, counts):
    """The model FLOPs of a batch: the dense FLOPs, the sparse convs and
    the encoder's output conv."""
    sw = sparse_work([c["stages"] for c in counts], work.cfg, work.V,
                     work.train)
    return work.dense_flops() + sw["flops"] + sw["conv_out_flops"]


def sparse_conv_least_s(work, counts):
    """The least seconds of K1-K3 (and K7, K10 in training) a batch."""
    return sparse_work([c["stages"] for c in counts], work.cfg, work.V,
                       work.train)["least_s"]


def fps_least_s(work, counts):
    """The least seconds of K4 a batch."""
    return fps_work([c["points"] for c in counts],
                    [c["voxels"] for c in counts], work.cfg, work.V)
