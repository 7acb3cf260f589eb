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

from ..parallel import dist


class FlaxBatchNormStats:
    """Train-mode forward of ``nn.BatchNorm{2,3}d`` with flax's running
    statistics (put before the torch class in the bases): the running
    variance moves towards the biased batch variance E[x^2] - E[x]^2,
    where torch would store the unbiased one, and a batch of one value
    per channel normalizes with variance 0 (x - mean(x) = 0, gradient 0:
    the output is the bias), where torch refuses. Normalization, eval mode
    and the state_dict keys are torch's. Inside ``dist.sharded_batch()``
    over several ranks (the train step's) the statistics are the global
    batch's (``_global_forward``), as the JAX package's: summed over
    every rank for an H slice of the volume (``dist.spatial_slices()``),
    else over the data axis; the reference's SyncBN-less DDP would take
    each card's (ROADMAP Queue 3)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if dist.batch_ranks() > 1:
            return self._global_forward(x)
        with torch.no_grad():
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp(min=0.0)
            _update_running(self, mean, var)
        if x.numel() == x.shape[1]:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return (x - x) * self.weight.view(shape) + self.bias.view(shape)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the ranks of a sharded batch: flax's
        statistics of the global batch, as the JAX package's one jit over
        the sharded batch takes them (E[x^2] - E[x]^2, biased, at least
        0), from one sum of (sum x, sum x^2, count) over the ranks
        (``_GlobalBNTrain``); computed in fp32, returned in the input
        dtype. One rank keeps torch's fused kernel above, which
        normalizes with the same biased variance."""
        return _GlobalBNTrain.apply(x, self.weight, self.bias, self)


class _GlobalBNTrain(torch.autograd.Function):
    """Train-mode BN over the ranks of ``dist.batch_group()`` with an
    analytic backward that keeps only x (autograd through the
    normalization kept two more fp32 copies of every activation): with
    xh = (x - mean) rstd over the n entries a channel of the global batch
    and dxh = g weight, dx = rstd (dxh - sum(dxh) / n - xh sum(dxh xh) /
    n), the sums over the same ranks as the forward's."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        (sums,) = dist.batch_sum(torch.cat([
            xf.sum(dim=dims), (xf * xf).sum(dim=dims),
            xf.new_full((1,), x.numel() // x.shape[1])]))
        C = x.shape[1]
        n = sums[2 * C:]
        mean = sums[:C] / n
        var = (sums[C:2 * C] / n - mean * mean).clamp(min=0.0)
        _update_running(bn, mean, var)
        rstd = torch.rsqrt(var + bn.eps)
        y = (xf - mean.view(shape)) * rstd.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd, n)
        ctx.group = dist.batch_group()
        return (y * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd, n = ctx.saved_tensors
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xh = (x.float() - mean.view(shape)) * rstd.view(shape)
        gf = g.float()
        dw = (gf * xh).sum(dim=dims)
        db = gf.sum(dim=dims)
        dxh = gf * weight.view(shape)
        sums = dist.all_reduce_sum(torch.stack(
            [dxh.sum(dim=dims), (dxh * xh).sum(dim=dims)]), ctx.group)
        dx = (dxh - (sums[0] / n).view(shape)
              - xh * (sums[1] / n).view(shape)) * rstd.view(shape)
        return dx.to(x.dtype), dw, db, None


def _update_running(bn, mean, var) -> None:
    """flax's running-statistics update: towards (mean, var) by
    ``momentum``."""
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked.add_(1)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over a masked voxel list (B, V, C), eps 1e-3.

    Computed in fp32, multiplied by the mask and returned in the input
    dtype. In training the statistics are taken over the mask-valid rows
    of the whole batch, two-pass, with the biased variance, and the
    running statistics move by ``momentum`` towards the same biased
    values (flax's rule; ``nn.BatchNorm1d`` would store the unbiased
    variance). The state_dict keys are those of ``nn.BatchNorm1d``.
    Inside ``dist.sharded_batch()`` over several ranks (the train
    step's) the sums run over the valid rows of the global batch, the
    count clamped after the sum (ROADMAP Queue 3): over every rank for an
    H slice of the dense volume (``dist.spatial_slices()``), each rank
    counting its own rows, else over the data axis.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (..., C) with mask (...): the normalized x, 0 where masked."""
        if self.training:
            return _MaskedBNTrain.apply(x, mask, self.weight, self.bias, self)
        y = (x.float() - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps)
        y = y * self.weight + self.bias
        return (y * mask[..., None]).to(x.dtype)


class _MaskedBNTrain(torch.autograd.Function):
    """Train-mode :class:`MaskedBatchNorm` with the batch statistics (over
    the ranks of a sharded batch too) and an analytic backward: with
    xh = (x - mean) rstd over the n masked entries and dxh = m g weight,
    dx = m rstd (dxh - sum(dxh) / n - xh sum(dxh xh) / n), the sums over
    the global batch; masked-out entries touch neither the statistics nor
    the output, so their gradient is 0."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, bn):
        xf = x.float()
        m = mask[..., None].float()
        red = tuple(range(x.dim() - 1))
        s, n = dist.batch_sum((xf * m).sum(dim=red), m.sum())
        cnt = n.clamp(min=1.0)
        mean = s / cnt
        (ss,) = dist.batch_sum((((xf - mean) ** 2) * m).sum(dim=red))
        var = ss / cnt
        _update_running(bn, mean, var)
        rstd = torch.rsqrt(var + bn.eps)
        y = (xf - mean) * rstd
        y = y * weight + bias
        ctx.save_for_backward(x, mask, weight, mean, rstd, cnt)
        # the backward's sums run over the forward's ranks
        ctx.sum_over = (dist.batch_group(),) if dist.batch_ranks() > 1 \
            else None
        return (y * m).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mask, weight, mean, rstd, cnt = ctx.saved_tensors
        m = mask[..., None].float()
        red = tuple(range(x.dim() - 1))
        xh = (x.float() - mean) * rstd
        gm = g.float() * m
        dw = (gm * xh).sum(dim=red)
        db = gm.sum(dim=red)
        dxh = gm * weight
        sums = torch.stack([dxh.sum(dim=red), (dxh * xh).sum(dim=red)])
        if ctx.sum_over is not None:
            sums = dist.all_reduce_sum(sums, ctx.sum_over[0])
        dx = (dxh - sums[0] / cnt - xh * (sums[1] / cnt)) * (rstd * m)
        return dx.to(x.dtype), None, dw, db, None


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
