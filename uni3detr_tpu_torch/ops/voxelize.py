"""Hard and dynamic voxelization with the mean VFE (port of
``uni3detr_tpu/ops/voxelize.py``).

One stable sort over linear voxel ids, then per-voxel sums from
differences of an fp64 prefix sum: static shapes, no atomics, so the
result is the same on every run and on every device. Rows come out in
ascending linear-id order with the invalid rows last; the sparse encoder
relies on that order.
``grid_size = (D, H, W)`` over (z, y, x); coords are int32 ``(z, y, x)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

INT_MAX = 2 ** 31 - 1


def cumsum_lines(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` along ``dim`` as one 1-D scan per line.

    On CUDA a 1-D cumsum is one device-wide scan, while a scan along a
    batched or non-innermost dim runs a kernel that is slow for few long
    lines (a (1, 100k, 4) prefix sum over dim 1 took ~9 ms on an H100).
    """
    x = x.movedim(dim, -1)
    lines = x.reshape(-1, x.shape[-1])
    out = torch.stack([torch.cumsum(line, 0) for line in lines])
    return out.reshape(x.shape).movedim(-1, dim)


def _voxel_ids(points, mask, pc_range, voxel_size, grid_size):
    """(B, P) linear voxel id (z*H*W + y*W + x) or -1, and validity."""
    D, H, W = grid_size
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    # XLA folds the JAX package's division by the constant cell size into
    # a product with its fp32 reciprocal, which puts a point within an ulp
    # of a cell edge in another cell than a division would; the same
    # product here, on every device
    inv = torch.tensor(voxel_size, dtype=torch.float32).reciprocal()
    inv = inv.to(device=points.device, dtype=points.dtype)
    ix, iy, iz = torch.floor((points[..., :3] - lo) * inv).long().unbind(-1)
    inb = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
           & (iz >= 0) & (iz < D) & mask)
    lin = (iz * H + iy) * W + ix
    return torch.where(inb, lin, torch.full_like(lin, -1)), inb


def hard_voxelize(points: torch.Tensor, mask: torch.Tensor, *,
                  pc_range: Sequence[float], voxel_size: Sequence[float],
                  grid_size: Sequence[int], max_points: int,
                  max_voxels: int):
    """points (B, P, C) xyz first; mask (B, P) bool.

    Returns feats (B, V, C) (mean over the first ``max_points`` points of
    each voxel, in input order), coords (B, V, 3) int32 (z, y, x), -1 on
    invalid rows, and vmask (B, V). V = ``max_voxels``; voxels beyond the
    budget are dropped in ascending-id order.
    """
    B, P, C = points.shape
    D, H, W = grid_size
    V = max_voxels
    dev = points.device
    lin, valid = _voxel_ids(points, mask, pc_range, voxel_size, grid_size)
    sort_key = torch.where(valid, lin, torch.full_like(lin, INT_MAX))
    # stable: keeps the point order inside a voxel, which decides the
    # max_points cut
    s_lin, order = torch.sort(sort_key, dim=1, stable=True)
    s_valid = torch.gather(valid, 1, order)
    s_pts = torch.gather(points, 1, order[..., None].expand(-1, -1, C))

    iota = torch.arange(P, device=dev).expand(B, P)
    newseg = torch.cat([torch.ones_like(s_valid[:, :1]),
                        s_lin[:, 1:] != s_lin[:, :-1]], dim=1) & s_valid
    seg_id = cumsum_lines(newseg.long(), 1) - 1
    seg_start = torch.cummax(
        torch.where(newseg, iota, torch.full_like(iota, -1)), dim=1).values
    rank = iota - seg_start
    keep = s_valid & (seg_id < V)
    if max_points > 0:
        keep = keep & (rank < max_points)

    first_slot = torch.where(newseg & (seg_id < V), seg_id,
                             torch.full_like(seg_id, V))
    # each voxel sum is a difference of two prefix sums over the sorted
    # points: centre each channel and sum in fp64. In fp32 (the JAX
    # package's choice) a 300k-point nuScenes scan loses ~1e-2 m per
    # voxel mean, and the card's parallel scan rounds otherwise than the
    # CPU's sequential one; in fp64 both give the mean within one fp32
    # rounding.
    keepd = keep[..., None].to(torch.float64)
    n_keep = keepd.sum(dim=1).clamp(min=1.0)                   # (B, 1)
    center = (s_pts.double() * keepd).sum(dim=1) / n_keep      # (B, C)
    centered = torch.where(keep[..., None], s_pts.double() - center[:, None],
                           torch.zeros_like(s_pts, dtype=torch.float64))
    csum = cumsum_lines(centered, 1)
    ccnt = cumsum_lines(keep.long(), 1)
    starts = torch.full((B, V + 1), P, dtype=torch.long, device=dev)
    starts.scatter_(1, first_slot, iota)   # slot V collects non-starts
    start_v = starts[:, :V]
    next_start = torch.cat(
        [starts[:, 1:V], torch.full((B, 1), P, dtype=torch.long,
                                    device=dev)], dim=1)
    end_row = (next_start - 1).clamp(0, P - 1)
    prev_row = (start_v - 1).clamp(0, P - 1)
    has_prev = start_v > 0
    g = lambda t, r: torch.gather(t, 1, r[..., None].expand(-1, -1, C))
    seg_sum = g(csum, end_row) - torch.where(
        has_prev[..., None], g(csum, prev_row), torch.zeros(()).to(csum))
    counts = (torch.gather(ccnt, 1, end_row)
              - torch.where(has_prev, torch.gather(ccnt, 1, prev_row),
                            torch.zeros_like(end_row)))
    counts = torch.where(start_v < P, counts, torch.zeros_like(counts))
    feats = seg_sum / counts[..., None].clamp(min=1) + center[:, None]
    feats = torch.where(counts[..., None] > 0, feats,
                        torch.zeros_like(feats)).to(points.dtype)

    # voxel coords from the first point of each kept segment
    lin_per_vox = torch.zeros((B, V + 1), dtype=torch.long, device=dev)
    lin_per_vox.scatter_(1, first_slot, s_lin)
    lin_per_vox = lin_per_vox[:, :V]
    coords = torch.stack([lin_per_vox // (H * W), (lin_per_vox // W) % H,
                          lin_per_vox % W], dim=-1)
    vmask = counts > 0
    coords = torch.where(vmask[..., None], coords,
                         torch.full_like(coords, -1)).to(torch.int32)
    return feats, coords, vmask


def dynamic_voxelize(points: torch.Tensor, mask: torch.Tensor, *,
                     pc_range: Sequence[float], voxel_size: Sequence[float],
                     grid_size: Sequence[int], max_voxels: int):
    """Dynamic voxelization with the mean VFE: :func:`hard_voxelize`
    without a per-voxel point cap (``max_points=0``), every point of a
    voxel in its mean (the JAX package's ``dynamic_voxelize``)."""
    return hard_voxelize(points, mask, pc_range=pc_range,
                         voxel_size=voxel_size, grid_size=grid_size,
                         max_points=0, max_voxels=max_voxels)


def scatter_to_dense(feats, coords, vmask, grid_size):
    """Per-voxel features -> dense channels-last (B, D, H, W, C) volume."""
    B, V, C = feats.shape
    D, H, W = grid_size
    c = coords.long()
    lin = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    lin = torch.where(vmask, lin, torch.full_like(lin, D * H * W))
    dense = feats.new_zeros(B, D * H * W + 1, C)
    vals = torch.where(vmask[..., None], feats, torch.zeros_like(feats))
    dense.scatter_(1, lin[..., None].expand(-1, -1, C), vals)
    return dense[:, :-1].reshape(B, D, H, W, C)
