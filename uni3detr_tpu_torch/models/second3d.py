"""Dense 3D backbone + FPN over the voxel volume (port of
``uni3detr_tpu/models/second3d.py``).

Three parallel stages of (1,3,3) convs striding only H/W, a per-stage
upsample back to the common resolution, sum fusion, then three 3x3x3
convs. Layout NCDHW; key layout of the reference ``SECOND3D``
(``blocks.{i}``) and ``SECOND3DFPN`` (``deblocks.{i}``,
``extra_blocks``).

Precision follows the JAX package: each conv and BN runs in fp32 (flax
promotes a bf16 input against the fp32 kernel) and the ReLU output is
cast back to the compute dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import FlaxBatchNormStats


class BatchNorm3d(FlaxBatchNormStats, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (eps 1e-3, momentum 0.01) with flax's running
    statistics in training (:class:`FlaxBatchNormStats`)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.01)


def _conv_bn_relu(cin, cout, kernel, stride=1, padding=0):
    return [nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                      bias=False),
            BatchNorm3d(cout), nn.ReLU()]


def _run(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Run (conv, BN, ReLU) triples in fp32, casting each output back."""
    dt = x.dtype
    mods = list(seq)
    for j in range(0, len(mods), 3):
        conv, bn = mods[j], mods[j + 1]
        x = torch.relu(bn(conv(x.float()))).to(dt)
    return x


class SECOND3D(nn.Module):

    def __init__(self, in_channels: int = 256,
                 out_channels: Sequence[int] = (128, 256, 512),
                 layer_nums: Sequence[int] = (5, 5, 5),
                 layer_strides: Sequence[int] = (1, 2, 4)):
        super().__init__()
        blocks = []
        for cout, n, s in zip(out_channels, layer_nums, layer_strides):
            mods = _conv_bn_relu(in_channels, cout, (1, 3, 3),
                                 stride=(1, s, s), padding=(0, 1, 1))
            for _ in range(n):
                mods += _conv_bn_relu(cout, cout, (1, 3, 3),
                                      padding=(0, 1, 1))
            blocks.append(nn.Sequential(*mods))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        return tuple(_run(blk, x) for blk in self.blocks)


class SECOND3DFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_extra_conv: int = 3):
        super().__init__()
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1:
                up = nn.ConvTranspose3d(cin, cout, (1, s, s),
                                        stride=(1, s, s), bias=False)
            else:
                up = nn.Conv3d(cin, cout, 1, bias=False)
            deblocks.append(nn.Sequential(up, BatchNorm3d(cout), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)
        extra = []
        for _ in range(num_extra_conv):
            extra += _conv_bn_relu(out_channels[-1], out_channels[-1], 3,
                                   padding=1)
        self.extra_blocks = nn.Sequential(*extra)

    def forward(self, feats):
        out = None
        for x, blk in zip(feats, self.deblocks):
            y = _run(blk, x)
            out = y if out is None else out + y
        return _run(self.extra_blocks, out)
