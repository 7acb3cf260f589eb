"""ResNet-50 image backbone and FPN neck (port of
``uni3detr_tpu/models/resnet.py``).

mmdet's ResNet-50 (pytorch style: the stride on the 3x3 conv, which pads
(1, 1)), with DCNv2 as the 3x3 conv of the stages in ``stage_with_dcn``,
and mmdet's FPN (1x1 laterals, a top-down nearest upsample-add with
JAX's half-pixel rule, 3x3 output convs, a stride-2 subsample for the
fifth level). Keys are the reference checkpoint's (``conv1``, ``bn1``,
``layer{i}.{j}.conv{1,2,3}`` ..., ``lateral_convs.{i}.conv``,
``fpn_convs.{i}.conv``).

Dtypes follow what the JAX package computes: its flax convs promote a
bf16 image and fp32 parameters to fp32, and only the stem's output is
cast back to the image's dtype before the max-pool. So the stages run
in fp32 on the bf16-rounded stem output, whatever the preset's dtype.
BatchNorm is eps 1e-5, flax momentum 0.9 (torch momentum 0.1), and in
training moves its running variance as flax does (:class:`BatchNorm2d`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .dcn import DeformConv2dV2
from .layers import FlaxBatchNormStats

STAGE_BLOCKS = (3, 4, 6, 3)     # ResNet-50


class BatchNorm2d(FlaxBatchNormStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with flax's running
    statistics in training (:class:`FlaxBatchNormStats`)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_dcn: bool = False, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = DeformConv2dV2(planes, planes, 3, stride) if use_dcn \
            else nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-50 -> the four stage outputs (B, 256 * 2^i, H / 2^(i+2),
    W / 2^(i+2)), fp32.

    ``frozen_stages`` k >= 0 freezes the stem and stages 1..k as mmdet's
    ``_freeze_stages``: their parameters do not require gradients (an
    optimizer built over the trainable parameters never updates them, not
    even by weight decay), in training they keep eval-mode BatchNorm and
    their outputs are detached (inference is unaffected)."""

    def __init__(self, stage_with_dcn: Sequence[bool] = (False, True, True,
                                                         True),
                 frozen_stages: int = 1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for i, n in enumerate(STAGE_BLOCKS):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(
                    inplanes, planes, 2 if (i > 0 and j == 0) else 1,
                    use_dcn=stage_with_dcn[i], downsample=j == 0))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        for m in self._frozen():
            m.requires_grad_(False)

    @staticmethod
    def frozen_param_prefixes(frozen_stages: int,
                              scope: str = "img_backbone"):
        """The parameter-name prefixes that ``frozen_stages`` freezes
        (``uni3detr_tpu/models/resnet.py::ResNet.frozen_param_prefixes``
        under the port's keys)."""
        if frozen_stages < 0:
            return ()
        return (f"{scope}.conv1.", f"{scope}.bn1.") + tuple(
            f"{scope}.layer{i + 1}." for i in range(frozen_stages))

    def _frozen(self):
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [getattr(self, f"layer{i + 1}")
                                         for i in range(self.frozen_stages)]

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self._frozen():
            m.eval()
        return self

    def forward(self, x: torch.Tensor):
        """x (B, 3, H, W), the preset's dtype (bf16-rounded values are
        computed in fp32)."""
        dt = x.dtype
        x = F.relu(self.bn1(self.conv1(x.float()))).to(dt)
        frozen = self.training and self.frozen_stages >= 0
        if frozen:
            x = x.detach()
        x = F.max_pool2d(x, 3, 2, padding=1).float()
        outs = []
        for i in range(len(STAGE_BLOCKS)):
            x = getattr(self, f"layer{i + 1}")(x)
            if self.training and i + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x)
        return tuple(outs)


class _ConvModule(nn.Module):
    """mmcv ConvModule without norm: the conv under ``.conv``."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2)

    def forward(self, x):
        return self.conv(x)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, *size) by ``jax.image.resize(..., "nearest")``:
    output pixel o takes input floor((o + 0.5) * in / out), computed in
    fp32 in that order (equal to ``F.interpolate(mode="nearest")`` at an
    exact 2x, not at other ratios)."""
    for axis, n in zip((2, 3), size):
        m = x.shape[axis]
        if m == n:
            continue
        src = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
               * m / n).floor().long()
        x = x.index_select(axis, src)
    return x


class FPN(nn.Module):
    """mmdet FPN with ``num_outs`` levels, extra ones by a stride-2
    subsample of the last (``add_extra_convs=False``). ``forward`` builds
    only the first ``levels`` outputs, all that the model reads."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            _ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3) for _ in in_channels)

    def forward(self, feats, levels: int | None = None):
        levels = self.num_outs if levels is None else levels
        lat = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest(lat[i],
                                                     lat[i - 1].shape[2:])
        outs = [self.fpn_convs[i](lat[i]) for i in range(min(levels,
                                                             len(lat)))]
        while len(outs) < levels:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
