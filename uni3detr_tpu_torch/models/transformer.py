"""Grouped DAB-style decoder with volume cross-attention (port of
``uni3detr_tpu/models/transformer.py``).

Per layer: self-attention / LN / cross-attention / LN / FFN / LN
(post-norm). The cross-attention samples the fused volume trilinearly at
the sigmoided reference point, weighted by a learned per-query sigmoid,
and adds an MLP encoding of the raw reference. After each layer the
reference moves by the reg branch's xy/z in logit space, detached.
Query groups fold into the batch axis, so they never attend to each
other. Keys follow the reference ``transformer.decoder`` layout. In
training, dropout acts where the JAX package puts it: on the attention
weights and the output of the self-attention, on the cross-attention's
projected output, and after both FFN layers.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.sample import grid_sample_3d
from .layers import MLP, sine_pos_embed


class _SelfAttention(nn.Module):
    """Holds ``attn`` so keys read ``attentions.0.attn.in_proj_weight``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0):
        super().__init__()
        self.attn = nn.MultiheadAttention(embed_dim, num_heads,
                                          dropout=dropout, batch_first=True)

    def forward(self, q, v):
        return self.attn(q, q, v, need_weights=False)[0]


class UniCrossAtten(nn.Module):
    """Volume-sampling cross-attention, one sample point per query
    (num_points=1, as every shipped config)."""

    def __init__(self, embed_dim: int = 256, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attention_weights = nn.Linear(embed_dim, 1)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        self.position_encoder = nn.Sequential(
            nn.Linear(3, embed_dim), nn.LayerNorm(embed_dim, eps=1e-5),
            nn.ReLU(), nn.Linear(embed_dim, embed_dim),
            nn.LayerNorm(embed_dim, eps=1e-5), nn.ReLU())

    def forward(self, x, query_pos, volume, ref_raw):
        """x (B, G, nq, C); volume (B, D, H, W, C) channels-last; ref_raw
        (B, G, nq, 3) in logit space."""
        B, G, nq, C = x.shape
        attw = torch.sigmoid(self.attention_weights(x + query_pos))
        grid = torch.sigmoid(ref_raw) * 2.0 - 1.0       # (x, y, z)
        sampled = grid_sample_3d(volume, grid.reshape(B, G * nq, 3))
        sampled = sampled.reshape(B, G, nq, C)
        out = F.dropout(self.output_proj(sampled * attw), self.dropout,
                        self.training)
        return out + x + self.position_encoder(ref_raw)


class _FFN(nn.Module):
    """mmcv FFN key layout: ``layers.0.0`` and ``layers.1``."""

    def __init__(self, embed_dim, ffn_dim, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dim, ffn_dim), nn.ReLU()),
            nn.Linear(ffn_dim, embed_dim))

    def forward(self, x):
        y = F.dropout(self.layers[0](x), self.dropout, self.training)
        return F.dropout(self.layers[1](y), self.dropout, self.training)


class DecoderLayer(nn.Module):

    def __init__(self, embed_dim=256, num_heads=8, ffn_dim=512,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.attentions = nn.ModuleList([
            _SelfAttention(embed_dim, num_heads, dropout),
            UniCrossAtten(embed_dim, dropout)])
        self.ffns = nn.ModuleList([_FFN(embed_dim, ffn_dim, dropout)])
        self.norms = nn.ModuleList(
            nn.LayerNorm(embed_dim, eps=1e-5) for _ in range(3))

    def forward(self, x, query_pos, volume, ref_raw):
        B, G, nq, C = x.shape
        q = (x + query_pos).reshape(B * G, nq, C)
        attn = self.attentions[0](q, x.reshape(B * G, nq, C))
        attn = F.dropout(attn, self.dropout, self.training)
        x = self.norms[0](x + attn.reshape(B, G, nq, C))
        x = self.norms[1](self.attentions[1](x, query_pos, volume, ref_raw))
        return self.norms[2](x + self.ffns[0](x))


class Uni3DETRDecoder(nn.Module):

    def __init__(self, num_layers, embed_dim=256, num_heads=8, ffn_dim=512,
                 dropout=0.0):
        super().__init__()
        self.ref_point_head = MLP(3 * 128, embed_dim, embed_dim, 3)
        self.query_scale = MLP(embed_dim, embed_dim, embed_dim, 3)
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, num_heads, ffn_dim, dropout)
            for _ in range(num_layers))

    def forward(self, query, ref, volume, reg_branches):
        """query (B, G, nq, C); ref (B, G, nq, 3) logit space. Returns
        per-layer states and the reference entering each layer."""
        x = query
        states, refs_in = [], []
        for l, layer in enumerate(self.layers):
            raw_pos = self.ref_point_head(
                sine_pos_embed(torch.sigmoid(ref), num_feats=128))
            query_pos = raw_pos if l == 0 else self.query_scale(x) * raw_pos
            x = layer(x, query_pos, volume, ref)
            states.append(x)
            refs_in.append(ref)
            tmp = reg_branches[l](x)
            ref = torch.cat([tmp[..., 0:2] + ref[..., 0:2],
                             tmp[..., 4:5] + ref[..., 2:3]], dim=-1).detach()
        return states, refs_in


class _Transformer(nn.Module):
    """Holds ``decoder`` so keys read ``transformer.decoder.*``."""

    def __init__(self, decoder: Uni3DETRDecoder):
        super().__init__()
        self.decoder = decoder
