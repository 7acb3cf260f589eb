"""Depth-preserving sparse middle encoder (port of the gather route of
``uni3detr_tpu/models/sparse_encoder.py::SparseEncoderHD``).

An input submanifold conv, four stages of residual SparseBasicBlocks
with a strided conv closing stages 1-3, a 1x1x1 conv-out, then a dense
(B, D', H', W', C) volume that keeps the depth axis.

One route on every device: each site set gets ONE rulebook from
``match_positions`` (K1), shared by all its submanifold convs, which run
``gather_conv`` (K2); the strided convs run ``gather_conv_ids`` (K3),
which finds its neighbours by id. Strided site sets come from the sort
route of ``downsample_sites``, cut to the per-stage budget. The convs go
through ``GatherConvFn`` / ``GatherConvIdsFn``, whose backward runs K2 /
K3 for the feature gradient and K7 / K10 for the weight gradient; the
site sets and rulebooks are integer work, built without autograd.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.sparse_conv import (downsample_sites, linear_ids,
                               strided_inverse_query_ids, strided_query_ids,
                               subm_query_ids)
from ..ops.sparse_conv_cuda import (GatherConvFn, GatherConvIdsFn,
                                    match_positions)
from ..ops.voxelize import scatter_to_dense
from .layers import MaskedBatchNorm


class SparseConvWeight(nn.Module):
    """A sparse conv's weight in the mmcv layout (kd, kh, kw, in, out)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            kernel, kernel, kernel, in_channels, out_channels))
        bound = 1.0 / math.sqrt(kernel ** 3 * in_channels)
        nn.init.normal_(self.weight, std=bound)

    def kernel(self) -> torch.Tensor:
        """(K, in, out): row-major over (z, y, x) offsets."""
        k = self.weight.shape
        return self.weight.reshape(k[0] * k[1] * k[2], k[3], k[4])


class SparseBasicBlock(nn.Module):
    """conv1-bn1-relu-conv2-bn2 + identity, relu (submanifold)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConvWeight(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConvWeight(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, x, nb, mask):
        y = GatherConvFn.apply(x, nb, self.conv1.kernel())
        y = torch.relu(self.bn1(y, mask))
        y = self.bn2(GatherConvFn.apply(y, nb, self.conv2.kernel()), mask)
        return torch.relu(y + x)


def _conv_bn(cin: int, cout: int, kernel: int = 3) -> nn.ModuleList:
    """Reference ``Sequential(SparseConv, BN1d, ReLU)`` key layout."""
    return nn.ModuleList([SparseConvWeight(cin, cout, kernel),
                          MaskedBatchNorm(cout), nn.ReLU()])


class SparseEncoderHD(nn.Module):

    def __init__(self, in_channels: int, sparse_shape: Tuple[int, int, int],
                 base_channels: int = 16, output_channels: int = 256,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 downsample_paddings: Sequence[Tuple[int, int, int]] = (
                     (1, 1, 1), (1, 1, 1), (0, 1, 1)),
                 budget_shrink: Sequence[float] = (1.0, 0.5, 0.25),
                 budget_caps: Sequence[int] | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = tuple(tuple(b) for b in encoder_channels)
        self.downsample_paddings = tuple(downsample_paddings)
        self.budget_shrink = tuple(budget_shrink)
        self.budget_caps = budget_caps
        self.compute_dtype = compute_dtype
        self.conv_input = _conv_bn(in_channels, base_channels)
        layers = {}
        cin = base_channels
        n_stages = len(self.encoder_channels)
        for i, blocks in enumerate(self.encoder_channels):
            strided = i < n_stages - 1
            body = blocks[:-1] if strided else blocks
            mods = []
            for ch in body:
                if ch != cin:
                    raise ValueError("SparseBasicBlock needs in == out "
                                     f"channels, got {cin} -> {ch}")
                mods.append(SparseBasicBlock(ch))
            if strided:
                mods.append(_conv_bn(cin, blocks[-1]))
                cin = blocks[-1]
            layers[f"encoder_layer{i + 1}"] = nn.ModuleList(mods)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = _conv_bn(cin, output_channels, kernel=1)

    def stage_budget(self, V: int, i: int) -> int:
        """Site budget after the i-th strided conv."""
        budget = -(-int(V * self.budget_shrink[i]) // 8) * 8
        if self.budget_caps is not None:
            budget = min(budget, self.budget_caps[i])
        return max(budget, 256)

    @torch.no_grad()
    def site_sets(self, coords, vmask, backward: bool = False):
        """The site set of every stage, from the voxel list alone.

        A list with one dict per stage: ``coords``, ``mask``, ``grid``,
        ``ids`` (sorted linear ids), ``qids`` (submanifold query ids),
        ``n_sites`` (the row budget) and, after the first, ``sq`` (the
        strided conv's query ids into the previous set) and, with
        ``backward``, ``invq`` (the output-space ids each input of the
        strided conv feeds, for its feature gradient)."""
        V = coords.shape[1]
        sets = [dict(coords=coords, mask=vmask, grid=self.sparse_shape,
                     n_sites=V)]
        for i in range(len(self.encoder_channels) - 1):
            prev, pad = sets[-1], self.downsample_paddings[i]
            budget = self.stage_budget(V, i)
            c, m, g = downsample_sites(prev["coords"], prev["mask"],
                                       prev["grid"], pad, budget)
            sets.append(dict(coords=c, mask=m, grid=g, n_sites=budget,
                             sq=strided_query_ids(c, m, prev["grid"], pad)))
            if backward:
                sets[-1]["invq"] = strided_inverse_query_ids(
                    prev["coords"], prev["mask"], g, pad)
        for s in sets:
            s["ids"] = linear_ids(s["coords"], s["mask"], s["grid"])
            s["qids"] = subm_query_ids(s["coords"], s["mask"], s["grid"])
        return sets

    def forward(self, feats, coords, vmask):
        """feats (B, V, C), coords (B, V, 3) int32 (z, y, x) sorted by
        linear id with invalid rows last, vmask (B, V).

        Returns (volume (B, D', H', W', Cout), out_grid)."""
        sets = self.site_sets(coords, vmask, backward=torch.is_grad_enabled())
        x = feats.to(self.compute_dtype)
        for i, s in enumerate(sets):
            mods = self.encoder_layers[f"encoder_layer{i + 1}"]
            nb = match_positions(s["ids"], s["qids"], s["n_sites"])
            if i == 0:
                conv, bn, _ = self.conv_input
                x = GatherConvFn.apply(x, nb, conv.kernel())
            else:
                conv, bn, _ = self.encoder_layers[f"encoder_layer{i}"][-1]
                x = GatherConvIdsFn.apply(x, sets[i - 1]["ids"], s["sq"],
                                          conv.kernel(), s.get("invq"),
                                          s["ids"])
            x = torch.relu(bn(x, s["mask"]))
            for block in (mods if i == len(sets) - 1 else mods[:-1]):
                x = block(x, nb, s["mask"])
        # conv_out: 1x1x1 sparse conv == per-voxel matmul. The JAX Dense
        # promotes a bf16 input against its fp32 kernel, so this runs in
        # fp32 and the volume leaves the encoder in fp32.
        conv, bn, _ = self.conv_out
        last = sets[-1]
        x = x.float() @ conv.kernel()[0].float()
        x = torch.relu(bn(x, last["mask"]))
        return (scatter_to_dense(x, last["coords"], last["mask"],
                                 last["grid"]), last["grid"])
