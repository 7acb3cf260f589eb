"""Depth-preserving sparse middle encoder (port of
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

``impl="dense"`` (the JAX package's ``encoder_impl='dense'``) runs the
same parameters as masked dense convs over the scattered volume: the
voxels scatter once into (B, D, H, W, C) with their occupancy, every
conv is ``F.conv3d`` (cuDNN on the card, as XLA's convolution in JAX),
the batch norms run over the occupied cells and zero the others, and
each strided conv's occupancy is a 3x3x3 stride-2 max-pool of the one
before with the conv's padding. At the active sites that equals the
gather route wherever its budgets cut no site: inactive cells hold zeros.
Under spatial sharding (``spatial=True`` in the train step,
``parallel/spatial.py``) the dense route runs on H slices: the scattered
volume and its occupancy are cut, every conv and occupancy pooling
takes its halo, the batch norms sum over every rank's occupied cells,
and after a strided stage a volume whose H does not divide by S is
gathered and runs whole (``constrain``'s rule). The gather route always
runs whole.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.sparse_conv import (downsample_sites, linear_ids,
                               strided_inverse_query_ids, strided_query_ids,
                               subm_query_ids)
from ..ops.sparse_conv_cuda import (GatherConvFn, GatherConvIdsFn,
                                    match_positions)
from ..ops.voxelize import scatter_to_dense
from ..parallel import dist, spatial as spatial_ops
from ..utils.profiling import count, full_rows
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

    def dense(self, x, stride: int = 1, padding=(1, 1, 1),
              sliced: bool = False):
        """The conv over a channels-last volume (B, D, H, W, in) -> (B, D',
        H', W', out) in x's dtype: a cross-correlation over (z, y, x),
        as the sparse conv computes it, so the taps are not flipped.
        ``sliced``: x is this rank's H slice (a halo, no H padding)."""
        w = self.weight.permute(4, 3, 0, 1, 2).to(x.dtype)
        xc = x.permute(0, 4, 1, 2, 3)
        if sliced:
            y = spatial_ops.conv3d(xc, w, stride, padding)
        else:
            y = F.conv3d(xc, w, stride=stride, padding=tuple(padding))
        return y.permute(0, 2, 3, 4, 1)


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

    def dense(self, x, occ, sliced: bool = False):
        """The block over a channels-last volume with occupancy ``occ``
        (``sliced``: this rank's H slices of both)."""
        y = torch.relu(self.bn1(self.conv1.dense(x, sliced=sliced), occ))
        y = self.bn2(self.conv2.dense(y, sliced=sliced), occ)
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
                 compute_dtype: torch.dtype = torch.float32,
                 impl: str = "gather"):
        super().__init__()
        if impl not in ("gather", "dense"):
            raise ValueError(f"encoder impl {impl!r} not in gather, dense")
        self.impl = impl
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

    def forward(self, feats, coords, vmask, spatial: bool = False):
        """feats (B, V, C), coords (B, V, 3) int32 (z, y, x) sorted by
        linear id with invalid rows last, vmask (B, V); ``spatial``: the
        dense route may split the volume along H (``dense_forward``).

        Returns (volume (B, D', H', W', Cout), out_grid)."""
        if self.impl == "dense":
            return self.dense_forward(feats, coords, vmask, spatial)
        sets = self.site_sets(coords, vmask, backward=torch.is_grad_enabled())
        # the strided stages' sites; a full budget dropped sites
        for i, s in enumerate(sets[1:], 2):
            count(f"sites.encoder_layer{i}", s["mask"])
            count(f"site_budget_full.encoder_layer{i}", s["mask"], full_rows)
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

    def dense_forward(self, feats, coords, vmask, spatial: bool = False):
        """The masked-dense route (``impl="dense"``; see the module
        docstring), same arguments and results as :meth:`forward`. The
        occupancy has no budget, so it is the any-covered-input set of
        each strided conv. With ``spatial`` inside the train step
        (``dist.spatial_active()``) the volume returned is this rank's H
        slice where the output grid's H divides by S; the grid is the
        global one."""
        grid = self.sparse_shape
        x = scatter_to_dense(feats.to(self.compute_dtype), coords, vmask,
                             grid)
        with torch.no_grad():
            occ = scatter_to_dense(vmask[..., None].float(), coords, vmask,
                                   grid)[..., 0] > 0
        on = spatial and dist.spatial_active()
        h = grid[1]
        sliced = on and spatial_ops.divides(h)
        if sliced:
            x, occ = spatial_ops.shard(x, 2), spatial_ops.shard(occ, 2)
        conv, bn, _ = self.conv_input
        with dist.spatial_slices(sliced):
            x = torch.relu(bn(conv.dense(x, sliced=sliced), occ))
        n_stages = len(self.encoder_channels)
        for i in range(n_stages):
            mods = self.encoder_layers[f"encoder_layer{i + 1}"]
            strided = i < n_stages - 1
            with dist.spatial_slices(sliced):
                for block in (mods[:-1] if strided else mods):
                    x = block.dense(x, occ, sliced)
            if not strided:
                continue
            pad = tuple(self.downsample_paddings[i])
            if sliced and not spatial_ops.aligned(h, 3, 2, pad[1]):
                x = spatial_ops.gather(x, 2)
                with torch.no_grad():
                    occ = spatial_ops.gather(occ.to(torch.uint8), 2) > 0
                sliced = False
            conv, bn, _ = mods[-1]
            x = conv.dense(x, stride=2, padding=pad, sliced=sliced)
            with torch.no_grad():
                pool = spatial_ops.max_pool3d if sliced else F.max_pool3d
                occ = pool(occ[:, None].float(), 3, stride=2,
                           padding=pad)[:, 0] > 0
            with dist.spatial_slices(sliced):
                x = torch.relu(bn(x, occ))
            h = spatial_ops.conv_out(h, 3, 2, pad[1])
            if on and not sliced and spatial_ops.divides(h):
                x, occ = spatial_ops.shard(x, 2), spatial_ops.shard(occ, 2)
                sliced = True
        # conv_out: a per-cell matmul in fp32, as the gather route's
        conv, bn, _ = self.conv_out
        x = x.float() @ conv.kernel()[0].float()
        with dist.spatial_slices(sliced):
            x = torch.relu(bn(x, occ))
        return x, (x.shape[1], h, x.shape[3])
