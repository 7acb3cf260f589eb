"""Trilinear and bilinear sampling (port of ``uni3detr_tpu/ops/sample.py``).

``F.grid_sample`` semantics with align_corners=False and zero padding,
written as eight (or four) corner gathers on a channels-last volume (or
image), the JAX package's layout. As there, the sample coordinates are
first cast to the input's dtype (bf16 under the bf16 presets), and the
weights and the sum are computed in that dtype.
"""
from __future__ import annotations

import torch


def _unnormalize(g, size):
    return ((g + 1.0) * size - 1.0) * 0.5


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """volume (B, D, H, W, C); coords (B, N, 3) in [-1, 1] ordered
    (x, y, z) -> (B, N, C)."""
    B, D, H, W, C = volume.shape
    pts = coords.to(volume.dtype)
    x = _unnormalize(pts[..., 0], W)
    y = _unnormalize(pts[..., 1], H)
    z = _unnormalize(pts[..., 2], D)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    flat = volume.reshape(B, D * H * W, C)
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                      & (zi >= 0) & (zi < D))
                lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                       + xi.clamp(0, W - 1))
                wx = fx if dx == 1 else 1.0 - fx
                wy = fy if dy == 1 else 1.0 - fy
                wz = fz if dz == 1 else 1.0 - fz
                w = (wx * wy * wz) * ok.to(volume.dtype)
                val = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
                c = val * w[..., None]
                out = c if out is None else out + c
    return out


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """image (..., H, W, C); coords (..., N, 2) in [-1, 1] ordered (x, y)
    -> (..., N, C). Corners outside the image weigh zero."""
    H, W, C = image.shape[-3:]
    batch = image.shape[:-3]
    img = image.reshape(-1, H * W, C)
    pts = coords.reshape(img.shape[0], -1, 2).to(image.dtype)
    x = _unnormalize(pts[..., 0], W)
    y = _unnormalize(pts[..., 1], H)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    # one row gather per corner over the flattened (batch, pixel) rows
    rows = img.reshape(-1, C)
    base = (torch.arange(img.shape[0], device=image.device) * (H * W))[:, None]
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1) + base
            wx = fx if dx == 1 else 1.0 - fx
            wy = fy if dy == 1 else 1.0 - fy
            w = (wx * wy) * ok.to(image.dtype)
            c = rows[lin] * w[..., None]
            out = c if out is None else out + c
    return out.reshape(*batch, -1, C)
