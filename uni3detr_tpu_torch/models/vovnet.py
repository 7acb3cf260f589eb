"""VoVNet image backbone: OSA modules with effective squeeze-excitation
(port of ``uni3detr_tpu/models/vovnet.py``, the reference's
``models/backbones/vovnet.py``; no shipped config uses it).

The defaults are the V2-39 layout: a stem of three 3x3 convs (64, 64,
128; the first and the third with stride 2), then four stages of
(1, 1, 2, 2) OSA modules with 128, 160, 192, 224 channels a layer and
256, 512, 768, 1024 out, a 3x3 stride-2 max-pool before stages 3-5. An
OSA module runs five 3x3 ConvBNReLU layers in a chain, concatenates its
input and every layer's output, maps them to the stage's width with a
1x1 ConvBNReLU (``concat``) and scales the result by eSE: the spatial
mean through a Linear with bias (``ese.fc``) and ``relu6(x + 3) / 6``.
From the second OSA module of a stage on, the module's input is added.

As the JAX package's flax modules:

- every conv pads ``"SAME"``: a 3x3 stride-2 conv on an even size pads
  (0, 1), on an odd size (1, 1);
- the max-pool pads (1, 1) with -inf;
- BatchNorm is eps 1e-5, flax momentum 0.9 (torch 0.1), with flax's
  biased running variance (``resnet.BatchNorm2d``);
- a ConvBNReLU computes in fp32 (flax promotes the input to its fp32
  kernel) and returns its input's dtype; eSE's Linear returns fp32, so
  an OSA module's output is fp32 whatever its input.

Tensors are (B, C, H, W), as the port's ResNet; the keys are the JAX
package's module names (``stem1``, ``stage2_osa0.conv3.bn``, ...).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .resnet import BatchNorm2d

LAYERS_PER_BLOCK = 5           # 3x3 ConvBNReLU layers of an OSA module
BLOCKS = (1, 1, 2, 2)          # OSA modules of stages 2-5 (V2-39)


def same_padding(size: int, kernel: int, stride: int):
    """flax ``"SAME"`` padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBNReLU(nn.Module):

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        ph = same_padding(x.shape[2], self.kernel, self.stride)
        pw = same_padding(x.shape[3], self.kernel, self.stride)
        y = self.conv(F.pad(x.float(), (*pw, *ph)))
        return F.relu(self.bn(y)).to(x.dtype)


class ESE(nn.Module):
    """Effective squeeze-excitation: x * hard_sigmoid(fc(mean_hw(x)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x):
        g = x.mean(dim=(2, 3))
        g = self.fc(g.float())
        return x * (F.relu6(g + 3.0) / 6.0)[:, :, None, None]


class OSA(nn.Module):

    def __init__(self, cin: int, stage_ch: int, concat_ch: int,
                 identity: bool = False):
        super().__init__()
        self.identity = identity
        c = cin
        for i in range(LAYERS_PER_BLOCK):
            self.add_module(f"conv{i}", ConvBNReLU(c, stage_ch))
            c = stage_ch
        self.concat = ConvBNReLU(cin + LAYERS_PER_BLOCK * stage_ch,
                                 concat_ch, kernel=1)
        self.ese = ESE(concat_ch)

    def forward(self, x):
        outs = [x]
        y = x
        for i in range(LAYERS_PER_BLOCK):
            y = getattr(self, f"conv{i}")(y)
            outs.append(y)
        y = self.ese(self.concat(torch.cat(outs, dim=1)))
        if self.identity and x.shape[1] == y.shape[1]:
            y = y + x
        return y


class VoVNet(nn.Module):
    """(B, 3, H, W) -> the outputs of the four stages."""

    def __init__(self, stage_ch: Sequence[int] = (128, 160, 192, 224),
                 concat_ch: Sequence[int] = (256, 512, 768, 1024)):
        super().__init__()
        self.stem1 = ConvBNReLU(3, 64, stride=2)
        self.stem2 = ConvBNReLU(64, 64)
        self.stem3 = ConvBNReLU(64, 128, stride=2)
        c = 128
        for i in range(4):
            for j in range(BLOCKS[i]):
                self.add_module(f"stage{i + 2}_osa{j}", OSA(
                    c, stage_ch[i], concat_ch[i], identity=j > 0))
                c = concat_ch[i]

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        outs = []
        for i in range(4):
            if i > 0:
                x = F.max_pool2d(x, 3, 2, padding=1)
            for j in range(BLOCKS[i]):
                x = getattr(self, f"stage{i + 2}_osa{j}")(x)
            outs.append(x)
        return tuple(outs)
