"""Uni3DETR detection head (port of ``uni3detr_tpu/models/head.py``).

Query groups of ``num_query`` each: learned anchors with their own
content embedding, then FPS-on-points and FPS-on-voxels, which share the
second content embedding; in eval a fourth group of random points shares
it too (train 3 groups, eval 4). Per decoder layer the cls
(Linear+LN+ReLU), reg and IoU branches decode boxes in ``pc_range``.
Returns the (L, B, G*nq, .) stacks that the coder reads.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..geom.boxes import inverse_sigmoid
from .layers import branch_mlp
from .transformer import Uni3DETRDecoder, _Transformer

_CLS_BIAS_INIT = float(-math.log((1 - 0.01) / 0.01))


class Uni3DETRHead(nn.Module):

    def __init__(self, num_classes: int, num_query: int = 300,
                 code_size: int = 8, embed_dim: int = 256,
                 num_decoder_layers: int = 3, num_heads: int = 8,
                 ffn_dim: int = 512, dropout: float = 0.0,
                 pc_range: Tuple[float, ...] = (-3.2, -0.2, -2.0, 3.2, 6.2,
                                                0.56)):
        super().__init__()
        self.num_query = num_query
        self.pc_range = tuple(pc_range)
        L, C = num_decoder_layers, embed_dim
        self.tgt_embed = nn.Embedding(2 * num_query, C)
        self.refpoint_embed = nn.Embedding(num_query, 3)
        self.cls_branches = nn.ModuleList(
            branch_mlp(C, num_classes, layer_norm=True) for _ in range(L))
        for br in self.cls_branches:
            nn.init.constant_(br[-1].bias, _CLS_BIAS_INIT)
        self.reg_branches = nn.ModuleList(
            branch_mlp(C, code_size, layer_norm=False) for _ in range(L))
        self.iou_branches = nn.ModuleList(
            branch_mlp(C, 1, layer_norm=False) for _ in range(L))
        self.transformer = _Transformer(Uni3DETRDecoder(
            L, embed_dim=C, num_heads=num_heads, ffn_dim=ffn_dim,
            dropout=dropout))

    def forward(self, volume, fpsbpts, random_points=None):
        """volume (B, D, H, W, C) channels-last; fpsbpts (B, 2*nq, 3) in
        [0, 1]; random_points (B, nq, 3) uniform in [0, 1), the eval
        group (unused in training)."""
        B = fpsbpts.shape[0]
        nq = self.num_query
        tgt = self.tgt_embed.weight
        C = tgt.shape[1]
        shared = tgt[nq:].expand(B, 1, nq, C)
        contents = [tgt[:nq].expand(B, 1, nq, C), shared, shared]
        refs = [self.refpoint_embed.weight.expand(B, 1, nq, 3),
                inverse_sigmoid(fpsbpts).reshape(B, 2, nq, 3)]
        if not self.training:
            if random_points is None:
                raise ValueError("eval needs the random query group")
            contents.append(shared)
            refs.append(inverse_sigmoid(random_points)[:, None])
        query = torch.cat(contents, dim=1)                  # (B, G, nq, C)
        ref = torch.cat(refs, dim=1)
        G = query.shape[1]
        states, refs_in = self.transformer.decoder(query, ref, volume,
                                                   self.reg_branches)
        pr = self.pc_range
        all_cls, all_box, all_iou = [], [], []
        for l, (h, r) in enumerate(zip(states, refs_in)):
            h = h.reshape(B, G * nq, C)
            r = r.reshape(B, G * nq, 3)
            tmp = self.reg_branches[l](h)
            xy = torch.sigmoid(tmp[..., 0:2] + r[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + r[..., 2:3])
            box = torch.cat([xy[..., 0:1] * (pr[3] - pr[0]) + pr[0],
                             xy[..., 1:2] * (pr[4] - pr[1]) + pr[1],
                             tmp[..., 2:4],
                             z * (pr[5] - pr[2]) + pr[2],
                             tmp[..., 5:]], dim=-1)
            all_cls.append(self.cls_branches[l](h))
            all_box.append(box)
            all_iou.append(self.iou_branches[l](h)[..., 0])
        return {
            "all_cls_scores": torch.stack(all_cls).float(),
            "all_bbox_preds": torch.stack(all_box).float(),
            "all_iou_preds": torch.stack(all_iou).float(),
        }
