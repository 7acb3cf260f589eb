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

Under spatial sharding (``parallel/spatial.py``) each forward is given
the global H of its input(s): a tensor whose H is below it is this
rank's H slice. The (1,3,3) convs and the 3x3x3 extra convs take a one-
row halo each side, a strided first conv one row before its slice; the
deconvs and the 1x1 deblock are local. A stage whose output H does not
divide by S runs whole on a gathered input (``constrain``'s rule), and a
whole deblock output is cut to the fused volume's slices. BN sums over
every rank on a slice, over the data axis on a whole tensor.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..parallel import dist, spatial
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


def _run(seq: nn.Sequential, x: torch.Tensor,
         sliced: bool = False) -> torch.Tensor:
    """Run (conv, BN, ReLU) triples in fp32, casting each output back;
    with ``sliced`` over this rank's H slice (``spatial.conv``, BN over
    every rank)."""
    dt = x.dtype
    mods = list(seq)
    with dist.spatial_slices(sliced):
        for j in range(0, len(mods), 3):
            conv, bn = mods[j], mods[j + 1]
            y = spatial.conv(conv, x.float()) if sliced else conv(x.float())
            x = torch.relu(bn(y)).to(dt)
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
        self.layer_strides = tuple(layer_strides)

    def heights(self, h: int):
        """The global H of each stage's output for an input of ``h``."""
        return tuple(spatial.conv_out(h, 3, s, 1) for s in self.layer_strides)

    def forward(self, x, h=None):
        """x (B, C, D, H, W); ``h``: its global H under spatial sharding
        (x holds this rank's slice when its H is below it). Returns the
        stages' outputs, each a slice where its global H divides by S."""
        if h is None or x.shape[3] == h:
            return tuple(_run(blk, x) for blk in self.blocks)
        outs = []
        for blk, st in zip(self.blocks, self.layer_strides):
            if spatial.aligned(h, 3, st, 1):
                outs.append(_run(blk, x, sliced=True))
            else:   # the stage runs whole: its output H does not divide
                outs.append(_run(blk, spatial.gather(x, 3)))
        return tuple(outs)


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
        self.upsample_strides = tuple(upsample_strides)

    def height(self, hs) -> int:
        """The global H of the fused output for inputs of global H
        ``hs``."""
        return hs[0] * self.upsample_strides[0]

    def forward(self, feats, hs=None):
        """feats: SECOND3D's outputs; ``hs``: their global H under
        spatial sharding (a tensor below its H is this rank's slice).
        The fused output is this rank's slice when its global H divides
        by S."""
        sliced = hs is not None and dist.spatial_active() \
            and spatial.divides(self.height(hs))
        out = None
        for i, (x, blk) in enumerate(zip(feats, self.deblocks)):
            if hs is not None and x.shape[3] != hs[i]:
                y = _run(blk, x, sliced=True)
            else:
                y = _run(blk, x)
                if sliced:
                    y = spatial.shard(y, 3)
            out = y if out is None else out + y
        return _run(self.extra_blocks, out, sliced=sliced)
