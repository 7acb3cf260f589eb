"""Site sets and query ids of the sparse encoder (port of the sort route
of ``uni3detr_tpu/ops/sparse_conv.py``).

A site set is a list of active voxels sorted by linear id
``(z*H + y)*W + x`` with the invalid rows last (id INT_MAX). A conv
finds the neighbour of site v at kernel offset k by looking up the
*query id* of (v, k) in the sorted id list: ``match_positions`` turns
query ids into a rulebook, ``gather_conv_ids`` searches them itself
(both in ``sparse_conv_cuda``). Query id -1 marks an offset that falls
off the grid or an invalid row. The backward of a strided conv looks up
:func:`strided_inverse_query_ids` in the output site list.

Batched over a leading B axis; coords are int32 (z, y, x).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .voxelize import INT_MAX, cumsum_lines


def kernel_offsets(kernel: int = 3, device=None) -> torch.Tensor:
    """(K, 3) offsets in (z, y, x), row-major over the kernel volume."""
    r = torch.arange(kernel, device=device)
    z, y, x = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([z.reshape(-1), y.reshape(-1), x.reshape(-1)], -1)


def linear_ids(coords, mask, grid) -> torch.Tensor:
    """(B, V, 3) z,y,x -> (B, V) int32 linear ids; invalid -> INT_MAX."""
    D, H, W = grid
    c = coords.long()
    lin = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    return torch.where(mask, lin, torch.full_like(lin, INT_MAX)).to(
        torch.int32)


def _ids_in_grid(nb, valid, grid) -> torch.Tensor:
    D, H, W = grid
    inb = ((nb[..., 0] >= 0) & (nb[..., 0] < D)
           & (nb[..., 1] >= 0) & (nb[..., 1] < H)
           & (nb[..., 2] >= 0) & (nb[..., 2] < W) & valid)
    nid = (nb[..., 0] * H + nb[..., 1]) * W + nb[..., 2]
    return torch.where(inb, nid, torch.full_like(nid, -1)).to(torch.int32)


def subm_query_ids(coords, mask, grid, kernel: int = 3) -> torch.Tensor:
    """(B, V, K) linear ids of each site's submanifold neighbours, at
    offsets centred on the site (``off - kernel//2``); -1 off grid or on
    an invalid row."""
    offs = kernel_offsets(kernel, coords.device) - kernel // 2
    nb = coords.long()[..., None, :] + offs
    return _ids_in_grid(nb, mask[..., None], grid)


def strided_query_ids(out_coords, out_mask, in_grid, padding: Sequence[int],
                      stride: int = 2, kernel: int = 3) -> torch.Tensor:
    """(B, Vout, K) INPUT-space linear ids read by a strided conv: output
    o reads input ``stride*o - padding + off``; -1 off grid / invalid."""
    offs = kernel_offsets(kernel, out_coords.device)
    pad = torch.as_tensor(padding, device=out_coords.device)
    src = out_coords.long()[..., None, :] * stride - pad + offs
    return _ids_in_grid(src, out_mask[..., None], in_grid)


def strided_inverse_query_ids(in_coords, in_mask, out_grid,
                              padding: Sequence[int], stride: int = 2,
                              kernel: int = 3) -> torch.Tensor:
    """(B, V, K) OUTPUT-space linear ids of the output each input feeds
    at offset k (input = ``stride*o - padding + off``), the read set of
    the transposed conv; -1 off the stride lattice, off the grid or on an
    invalid row. An output cut by the site budget simply misses when it
    is looked up, as it does in the forward."""
    Do, Ho, Wo = out_grid
    offs = kernel_offsets(kernel, in_coords.device)
    pad = torch.as_tensor(padding, device=in_coords.device)
    num = in_coords.long()[..., None, :] + pad - offs
    div = torch.div(num, stride, rounding_mode="floor")
    ok = ((num % stride == 0).all(-1) & (num >= 0).all(-1)
          & (div[..., 0] < Do) & (div[..., 1] < Ho) & (div[..., 2] < Wo)
          & in_mask[..., None])
    nid = (div[..., 0] * Ho + div[..., 1]) * Wo + div[..., 2]
    return torch.where(ok, nid, torch.full_like(nid, -1)).to(torch.int32)


def downsample_sites(coords, mask, grid, padding: Sequence[int],
                     out_budget: int, stride: int = 2, kernel: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Output site set of a strided conv, deduplicated and sorted.

    Output o covers inputs ``stride*o - p + [0, kernel)``; per axis an
    input enables at most two outputs (kernel 3, stride 2). The candidates
    of every input are sorted, deduplicated and cut to ``out_budget`` in
    ascending-id order, which keeps the sorted invariant.

    Returns (out_coords (B, out_budget, 3) int32, out_mask, out_grid).
    """
    B, V, _ = coords.shape
    pz, py, px = padding
    out_grid = tuple((g + 2 * p - kernel) // stride + 1
                     for g, p in zip(grid, padding))
    Do, Ho, Wo = out_grid
    c = coords.long()

    def axis_cands(i, p, lim):
        hi = torch.div(i + p, stride, rounding_mode="floor")
        lo = torch.div(i + p - kernel + stride, stride,
                       rounding_mode="floor").clamp(min=0)
        lo2 = torch.where(lo < hi, lo, hi)
        cand = torch.stack([lo2, hi], -1)                      # (B, V, 2)
        ok = ((cand >= 0) & (cand < lim)
              & (cand * stride - p <= i[..., None])
              & (i[..., None] <= cand * stride - p + kernel - 1))
        return cand, ok

    cz, okz = axis_cands(c[..., 0], pz, Do)
    cy, oky = axis_cands(c[..., 1], py, Ho)
    cx, okx = axis_cands(c[..., 2], px, Wo)
    oz = cz[..., :, None, None]
    oy = cy[..., None, :, None]
    ox = cx[..., None, None, :]
    ok = (okz[..., :, None, None] & oky[..., None, :, None]
          & okx[..., None, None, :] & mask[..., None, None, None])
    lin = (oz * Ho + oy) * Wo + ox
    lin = torch.where(ok, lin, torch.full_like(lin, INT_MAX)).reshape(B, -1)
    s, _ = torch.sort(lin, dim=1)
    newseg = torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool),
                        s[:, 1:] != s[:, :-1]], dim=1) & (s != INT_MAX)
    seg_id = cumsum_lines(newseg.long(), 1) - 1
    slot = torch.where(newseg & (seg_id < out_budget), seg_id,
                       torch.full_like(seg_id, out_budget))
    out_lin = torch.full((B, out_budget + 1), INT_MAX, dtype=torch.long,
                         device=coords.device)
    out_lin.scatter_(1, slot, s)      # slot out_budget collects the rest
    out_lin = out_lin[:, :out_budget]
    out_mask = out_lin != INT_MAX
    safe = torch.where(out_mask, out_lin, torch.zeros_like(out_lin))
    oc = torch.stack([safe // (Ho * Wo), (safe // Wo) % Ho, safe % Wo], -1)
    oc = torch.where(out_mask[..., None], oc, torch.full_like(oc, -1))
    return oc.to(torch.int32), out_mask, out_grid
