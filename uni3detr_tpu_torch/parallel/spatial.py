"""The dense volume split along H over the spatial ranks (the port's
counterpart of ``constrain`` in ``uni3detr_tpu/parallel/mesh.py``, with
the halo exchanges that XLA inserts there written out).

Within a data group of S ranks (``dist.set_layout``) rank s holds rows
``s * L .. (s + 1) * L - 1`` of every volume whose H = S * L divides by
S; a volume whose H does not divide stays whole on every rank of the
group, as ``constrain`` leaves it replicated. Three differentiable
operations move between the two, each one ``all_reduce`` over the
spatial group on a zeroed buffer into which every rank writes its own
rows (the sum is the exchange: one code path on NCCL and on gloo, which
takes few collectives on CUDA tensors):

- ``shard``: whole -> this rank's slice; the backward pads zeros;
- ``gather``: slices -> the whole volume; the backward hands each rank
  the sum of the group's cotangents of its own slice;
- ``halo``: this rank's slice with ``before`` rows of the previous
  rank's and ``after`` of the next one's, zeros past the volume's edges
  (the conv's own padding); the backward sends each halo row's
  cotangent to the rank that owns the row, which adds it.

``conv3d`` / ``conv`` run a convolution over a slice (a halo, then no H
padding) and ``max_pool3d`` a pooling; ``aligned`` says when a strided
conv's output rows split over the ranks as its input rows do.

The model splits its volume only where ``dist.spatial_active()``: inside
``dist.sharded_batch()`` (the train step) with S > 1. Everywhere else it
runs the whole volume.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn
from torch.nn import functional as F

from . import dist


def divides(h: int) -> bool:
    """Whether a volume of global height ``h`` is split (else whole)."""
    return h % dist.spatial_size() == 0


def conv_out(h: int, k: int, stride: int, pad: int) -> int:
    """The output height of a conv over ``h`` rows."""
    return (h + 2 * pad - k) // stride + 1


def aligned(h: int, k: int, stride: int, pad: int) -> bool:
    """Whether a conv over an H-split volume of ``h`` rows can run on the
    slices: its output rows split over the ranks, rank s's from rank s's
    input rows and a halo (the output has h / stride rows)."""
    S = dist.spatial_size()
    return h % (stride * S) == 0 and conv_out(h, k, stride, pad) == h // stride


def shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` (whole, the same on every rank of the
    group) along ``dim``; its backward pads zeros (``narrow``)."""
    S = dist.spatial_size()
    L = x.shape[dim] // S
    return x.narrow(dim, dist.spatial_index() * L, L)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole volume from every rank's slice ``x`` along ``dim``."""
    return _Gather.apply(x, dim)


def halo(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    """``x`` (this rank's slice along ``dim``) with the previous rank's
    last ``before`` rows in front and the next rank's first ``after``
    rows behind, zeros past the volume's edges."""
    if not (before or after):
        return x
    if max(before, after) > x.shape[dim]:
        raise ValueError(f"halo of {before}, {after} rows over a slice of "
                         f"{x.shape[dim]}")
    return _Halo.apply(x, dim, before, after)


def _sum(buf: torch.Tensor) -> torch.Tensor:
    tdist.all_reduce(buf, group=dist.spatial_group())
    return buf


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        S, s = dist.spatial_size(), dist.spatial_index()
        L = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = S * L
        buf = x.new_zeros(shape)
        buf.narrow(dim, s * L, L).copy_(x)
        ctx.dim, ctx.L = dim, L
        return _sum(buf)

    @staticmethod
    def backward(ctx, g):
        g = _sum(g.contiguous().clone())
        s = dist.spatial_index()
        return g.narrow(ctx.dim, s * ctx.L, ctx.L).contiguous(), None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, before, after):
        S, s = dist.spatial_size(), dist.spatial_index()
        L = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = before + after
        buf = x.new_zeros([S] + shape)
        mine = buf[s]
        mine.narrow(dim, 0, before).copy_(x.narrow(dim, L - before, before))
        mine.narrow(dim, before, after).copy_(x.narrow(dim, 0, after))
        _sum(buf)
        shape[dim] = before
        lo = buf[s - 1].narrow(dim, 0, before) if s > 0 \
            else x.new_zeros(shape)
        shape[dim] = after
        hi = buf[s + 1].narrow(dim, before, after) if s < S - 1 \
            else x.new_zeros(shape)
        ctx.dim, ctx.before, ctx.after, ctx.L = dim, before, after, L
        return torch.cat([lo, x, hi], dim)

    @staticmethod
    def backward(ctx, g):
        S, s = dist.spatial_size(), dist.spatial_index()
        dim, before, after, L = ctx.dim, ctx.before, ctx.after, ctx.L
        own = g.narrow(dim, before, L).contiguous().clone()
        shape = list(own.shape)
        shape[dim] = before + after
        buf = g.new_zeros([S] + shape)
        if s > 0:
            buf[s - 1].narrow(dim, 0, before).copy_(g.narrow(dim, 0, before))
        if s < S - 1:
            buf[s + 1].narrow(dim, before, after).copy_(
                g.narrow(dim, before + L, after))
        _sum(buf)
        own.narrow(dim, L - before, before).add_(
            buf[s].narrow(dim, 0, before))
        own.narrow(dim, 0, after).add_(buf[s].narrow(dim, before, after))
        return own, None, None, None


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def conv3d(x, weight, stride=1, padding=0, dim: int = 3, bias=None):
    """``F.conv3d`` of an NCDHW tensor whose ``dim`` axis (H) is this
    rank's slice: the halo the H kernel needs, then no H padding. The
    caller checks ``aligned``."""
    stride, padding = _triple(stride), list(_triple(padding))
    i = dim - 2
    k, st, p = weight.shape[dim], stride[i], padding[i]
    x = halo(x, p, max(k - st - p, 0), dim)
    padding[i] = 0
    return F.conv3d(x, weight, bias, stride, tuple(padding))


def conv(mod: nn.Module, x: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """``mod`` over the H slice ``x`` (NCDHW): an ``nn.Conv3d`` through
    ``conv3d``; an ``nn.ConvTranspose3d`` whose H kernel equals its
    stride maps each input row to its own output rows and runs as it is."""
    if isinstance(mod, nn.ConvTranspose3d):
        i = dim - 2
        if mod.kernel_size[i] != mod.stride[i] or mod.padding[i]:
            raise ValueError("a transposed conv over an H slice needs its "
                             "H kernel equal to its stride, no padding")
        return mod(x)
    assert mod.dilation == (1, 1, 1) and mod.groups == 1
    return conv3d(x, mod.weight, mod.stride, mod.padding, dim, mod.bias)


def max_pool3d(x, k: int, stride: int, padding, dim: int = 3):
    """``F.max_pool3d`` of a non-negative NCDHW tensor over this rank's
    H slice: a zero halo stands for the -inf padding."""
    padding = list(_triple(padding))
    i = dim - 2
    p = padding[i]
    x = halo(x, p, max(k - stride - p, 0), dim)
    padding[i] = 0
    return F.max_pool3d(x, k, stride=stride, padding=tuple(padding))
