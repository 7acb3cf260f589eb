"""Common building blocks (port of ``uni3detr_tpu/models/layers.py``).

Module and parameter names follow the reference PyTorch ``state_dict``
(see ``uni3detr_tpu/train/torch_import.py``), so a reference checkpoint
loads as it is.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class FlaxBatchNormStats:
    """Train-mode forward of ``nn.BatchNorm{2,3}d`` with flax's running
    statistics (put before the torch class in the bases): the running
    variance moves towards the biased batch variance E[x^2] - E[x]^2,
    where torch would store the unbiased one, and a batch of one value
    per channel normalizes with variance 0 (x - mean(x) = 0, gradient 0:
    the output is the bias), where torch refuses. Normalization, eval mode
    and the state_dict keys are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp(min=0.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        if x.numel() == x.shape[1]:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return (x - x) * self.weight.view(shape) + self.bias.view(shape)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over a masked voxel list (B, V, C), eps 1e-3.

    Computed in fp32, multiplied by the mask and returned in the input
    dtype. In training the statistics are taken over the mask-valid rows
    of the whole batch, two-pass, with the biased variance, and the
    running statistics move by ``momentum`` towards the same biased
    values (flax's rule; ``nn.BatchNorm1d`` would store the unbiased
    variance). The state_dict keys are those of ``nn.BatchNorm1d``.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            m = mask[..., None].float()
            red = tuple(range(x.dim() - 1))
            cnt = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(dim=red) / cnt
            var = (((xf - mean) ** 2) * m).sum(dim=red) / cnt
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return (y * mask[..., None]).to(x.dtype)


class MLP(nn.Module):
    """Linear-ReLU x (n-1) + Linear; keys ``layers.{i}``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def branch_mlp(dim: int, output_dim: int, layer_norm: bool,
               num_fcs: int = 2) -> nn.Sequential:
    """Head branch: num_fcs x (Linear [+LN] + ReLU) + Linear, as the
    reference Sequential (cls: indices 0,1,3,4,6; reg/iou: 0,2,4)."""
    mods = []
    for _ in range(num_fcs):
        mods.append(nn.Linear(dim, dim))
        if layer_norm:
            mods.append(nn.LayerNorm(dim, eps=1e-5))
        mods.append(nn.ReLU())
    mods.append(nn.Linear(dim, output_dim))
    return nn.Sequential(*mods)


def sine_pos_embed(pos: torch.Tensor, num_feats: int = 128,
                   temperature: float = 10000.0) -> torch.Tensor:
    """(..., n) positions -> (..., n * num_feats): per coordinate the
    interleaved [sin(x/t0), cos(x/t1), ...], t_i = temperature^(2(i//2)/
    num_feats), scale 2*pi."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    x = pos[..., None] * (2 * math.pi) / dim_t
    out = torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])],
                      dim=-1).reshape(*x.shape[:-1], num_feats)
    return out.reshape(*pos.shape[:-1], pos.shape[-1] * num_feats)
