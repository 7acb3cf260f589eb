"""Deformable convolution v2 (port of ``uni3detr_tpu/models/dcn.py``).

A plain conv (``conv_offset``, symmetric padding (k-1)/2) predicts per
output position k*k (dy, dx) offsets and k*k modulation masks (the
sigmoid of its last k*k channels). Each tap ``i*s + {-(k-1)/2 .. (k-1)/2}
+ offset`` samples the input bilinearly (``grid_sample_2d``: zero
outside the image), is scaled by its mask, and the taps are contracted
with the weight in one matrix product. Parameter names are mmcv's
``ModulatedDeformConv2dPack`` (``weight`` (out, in, k, k),
``conv_offset.{weight,bias}``), so a reference checkpoint loads as it
is.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.sample import grid_sample_2d


class DeformConv2dV2(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        # zero offsets and masks of 0.5 at init: a plain conv scaled by 1/2
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k, stride,
                                     padding=(k - 1) // 2)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def offsets_and_mask(self, x: torch.Tensor):
        """x (B, C, H, W) -> (offsets (B, Ho, Wo, k*k, 2) as (dy, dx) in
        pixels, masks (B, Ho, Wo, k*k))."""
        kk = self.kernel_size ** 2
        om = self.conv_offset(x).permute(0, 2, 3, 1)        # (B, Ho, Wo, 3kk)
        B, Ho, Wo, _ = om.shape
        return (om[..., :2 * kk].reshape(B, Ho, Wo, kk, 2),
                torch.sigmoid(om[..., 2 * kk:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, out, Ho, Wo), in x's dtype."""
        B, C, H, W = x.shape
        k, s = self.kernel_size, self.stride
        off, mask = self.offsets_and_mask(x)
        Ho, Wo = off.shape[1:3]
        f32 = dict(dtype=torch.float32, device=x.device)
        ys = torch.arange(Ho, **f32) * s
        xs = torch.arange(Wo, **f32) * s
        d = torch.arange(k, **f32) - (k - 1) / 2
        dy, dx = torch.meshgrid(d, d, indexing="ij")
        py = ys[:, None, None] + dy.reshape(1, 1, -1) + off[..., 0]
        px = xs[None, :, None] + dx.reshape(1, 1, -1) + off[..., 1]
        # to [-1, 1] grid coordinates (align_corners=False)
        grid = torch.stack([(px * 2 + 1) / W - 1, (py * 2 + 1) / H - 1], -1)
        taps = grid_sample_2d(x.permute(0, 2, 3, 1),
                              grid.reshape(B, Ho * Wo * k * k, 2))
        taps = taps.reshape(B, Ho, Wo, k * k, C) * mask[..., None]
        # (out, in, kh, kw) -> (kh*kw*in, out): the taps' (tap, channel) order
        w = self.weight.permute(2, 3, 1, 0).reshape(k * k * C, -1)
        out = torch.matmul(taps.reshape(B, Ho, Wo, k * k * C).float(),
                           w.float())
        return out.to(x.dtype).permute(0, 3, 1, 2)
