"""Open-vocabulary CLIP-classifier head (port of
``uni3detr_tpu/models/head_clip.py``).

The decoder and the reg / IoU branches are the Lidar head's. The cls
branch ends in a ``clip_dim`` embedding (2 x (Linear, LN, ReLU), no final
Linear) that is multiplied with the frozen, L2-normalised CLIP text
embeddings of the classes (``zs_weights``, a buffer stored (clip_dim,
ncls) as the reference registers it). An uncertainty branch (the LN
form, ncls + 1 outputs) feeds the training loss. Query groups: the
learned anchors alone in camera-only mode (no FPS seeds); with points
the FPS-on-points and FPS-on-voxels groups share the second content
embedding, and eval adds the random-point group (train 3 groups, eval
4). In training the decoder's dropout draws from torch's global
generator, as the Lidar head's does.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..geom.boxes import inverse_sigmoid
from .head import decode_layer_boxes
from .layers import branch_mlp
from .transformer import Uni3DETRDecoder, _Transformer


def clip_cls_branch(dim: int, clip_dim: int, num_fcs: int = 2
                    ) -> nn.Sequential:
    """num_fcs x (Linear, LN, ReLU) to ``clip_dim`` (keys 0, 1, 3, 4)."""
    mods = []
    for i in range(num_fcs):
        mods += [nn.Linear(dim if i == 0 else clip_dim, clip_dim),
                 nn.LayerNorm(clip_dim, eps=1e-5), nn.ReLU()]
    return nn.Sequential(*mods)


class Uni3DETRHeadCLIP(nn.Module):

    def __init__(self, num_classes: int, num_query: int = 300,
                 code_size: int = 8, embed_dim: int = 256,
                 num_decoder_layers: int = 6, num_heads: int = 8,
                 ffn_dim: int = 512, dropout: float = 0.0,
                 clip_dim: int = 1024,
                 pc_range: Tuple[float, ...] = (-3.2, -0.2, -2.0, 3.2, 6.2,
                                                0.56)):
        super().__init__()
        self.num_query = num_query
        self.pc_range = tuple(pc_range)
        L, C = num_decoder_layers, embed_dim
        self.tgt_embed = nn.Embedding(2 * num_query, C)
        self.refpoint_embed = nn.Embedding(num_query, 3)
        self.cls_branches = nn.ModuleList(
            clip_cls_branch(C, clip_dim) for _ in range(L))
        self.uncertainty_branches = nn.ModuleList(
            branch_mlp(C, num_classes + 1, layer_norm=True)
            for _ in range(L))
        self.reg_branches = nn.ModuleList(
            branch_mlp(C, code_size, layer_norm=False) for _ in range(L))
        self.iou_branches = nn.ModuleList(
            branch_mlp(C, 1, layer_norm=False) for _ in range(L))
        self.transformer = _Transformer(Uni3DETRDecoder(
            L, embed_dim=C, num_heads=num_heads, ffn_dim=ffn_dim,
            dropout=dropout))
        zs = torch.randn(num_classes, clip_dim)
        self.register_buffer(
            "zs_weights", (zs / zs.norm(dim=-1, keepdim=True)).T.contiguous())

    def forward(self, volume, fpsbpts=None, random_points=None):
        """volume (B, D, H, W, C) channels-last; fpsbpts (B, 2*nq, 3) in
        [0, 1], or None in camera-only mode; random_points (B, nq, 3), the
        eval group when there are FPS seeds."""
        B = volume.shape[0]
        nq = self.num_query
        tgt = self.tgt_embed.weight
        C = tgt.shape[1]
        contents = [tgt[:nq].expand(B, 1, nq, C)]
        refs = [self.refpoint_embed.weight.expand(B, 1, nq, 3)]
        if fpsbpts is not None:
            shared = tgt[nq:].expand(B, 1, nq, C)
            contents += [shared, shared]
            refs.append(inverse_sigmoid(fpsbpts).reshape(B, 2, nq, 3))
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
        outs = {"all_cls_scores": [], "all_bbox_preds": [],
                "all_iou_preds": [], "all_uncertainty_preds": []}
        for l, (h, r) in enumerate(zip(states, refs_in)):
            h = h.reshape(B, G * nq, C)
            e = self.cls_branches[l](h)
            outs["all_cls_scores"].append(e @ self.zs_weights.to(e.dtype))
            outs["all_uncertainty_preds"].append(
                self.uncertainty_branches[l](h))
            outs["all_bbox_preds"].append(decode_layer_boxes(
                self.reg_branches[l](h), r.reshape(B, G * nq, 3),
                self.pc_range))
            outs["all_iou_preds"].append(self.iou_branches[l](h)[..., 0])
        return {k: torch.stack(v).float() for k, v in outs.items()}
