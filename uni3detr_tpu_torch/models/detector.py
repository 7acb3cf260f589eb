"""Uni3DETR detector (port of ``uni3detr_tpu/models/detector.py``).

points -> hard (or dynamic) voxelize + mean VFE -> SparseEncoderHD ->
SECOND3D -> SECOND3DFPN -> paired D-FPS query seeds -> Uni3DETRHead.
Submodule names are the reference's (``pts_middle_encoder``,
``pts_backbone``, ``pts_neck``, ``pts_bbox_head``), so ``state_dict()``
is a reference checkpoint. ``model.train()`` is the JAX package's
``train=True``: the train voxel budget, batch statistics, dropout and
three query groups.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Uni3DETRConfig
from ..ops.fps import farthest_point_sample_pair
from ..ops.voxelize import dynamic_voxelize, hard_voxelize
from .head import Uni3DETRHead
from .second3d import SECOND3D, SECOND3DFPN
from .sparse_encoder import SparseEncoderHD


def _minmax_norm(pts: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalization to [0, 1] over axis 1."""
    mn = pts.amin(dim=1, keepdim=True)
    mx = pts.amax(dim=1, keepdim=True)
    return (pts - mn) / (mx - mn).clamp(min=1e-6)


class Uni3DETR(nn.Module):

    def __init__(self, cfg: Uni3DETRConfig):
        super().__init__()
        if cfg.encoder_impl != "gather":
            raise NotImplementedError("the port runs the gather encoder "
                                      "only")
        self.cfg = cfg
        dtype = cfg.torch_dtype
        self.pts_middle_encoder = SparseEncoderHD(
            cfg.in_point_features, tuple(cfg.grid_size),
            base_channels=cfg.encoder_base_channels,
            output_channels=cfg.encoder_out_channels,
            encoder_channels=cfg.encoder_channels,
            downsample_paddings=cfg.encoder_downsample_paddings,
            budget_shrink=cfg.encoder_budget_shrink,
            budget_caps=cfg.encoder_budget_caps, compute_dtype=dtype)
        self.pts_backbone = SECOND3D(
            cfg.encoder_out_channels, cfg.backbone_channels,
            cfg.backbone_layers, cfg.backbone_strides)
        self.pts_neck = SECOND3DFPN(
            cfg.backbone_channels, cfg.neck_channels,
            cfg.neck_upsample_strides)
        self.pts_bbox_head = Uni3DETRHead(
            cfg.num_classes, num_query=cfg.num_query,
            code_size=cfg.code_size, embed_dim=cfg.embed_dim,
            num_decoder_layers=cfg.num_decoder_layers,
            num_heads=cfg.num_heads, ffn_dim=cfg.ffn_dim,
            dropout=cfg.dropout, pc_range=tuple(cfg.pc_range))

    @torch.no_grad()
    def voxelize(self, points, pts_mask):
        cfg = self.cfg
        kw = dict(pc_range=tuple(cfg.pc_range),
                  voxel_size=tuple(cfg.voxel_size),
                  grid_size=tuple(cfg.grid_size),
                  max_voxels=cfg.max_voxels if self.training
                  else cfg.max_voxels_test)
        if cfg.dynamic_voxelization:
            return dynamic_voxelize(points, pts_mask, **kw)
        return hard_voxelize(points, pts_mask,
                             max_points=cfg.max_points_per_voxel, **kw)

    def forward(self, points, pts_mask, random_points=None,
                return_intermediates: bool = False):
        """points (B, P, C) xyz first; pts_mask (B, P) bool;
        random_points (B, nq, 3) uniform [0, 1) for the eval query group
        (unused in training).

        Returns the head's per-layer output stacks; with
        ``return_intermediates`` also a dict of the voxelization and the
        FPS indices. In eval mode no autograd graph is recorded;
        voxelization and FPS never record one.
        """
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(points, pts_mask, random_points,
                                 return_intermediates)

    def _forward(self, points, pts_mask, random_points, return_intermediates):
        cfg = self.cfg
        dtype = cfg.torch_dtype
        feats, coords, vmask = self.voxelize(points, pts_mask)
        volume, _ = self.pts_middle_encoder(feats, coords, vmask)
        ms = self.pts_backbone(volume.to(dtype).permute(0, 4, 1, 2, 3))
        fused = self.pts_neck(ms).to(dtype)
        fused = fused.permute(0, 2, 3, 4, 1).contiguous()   # (B, D, H, W, C)

        nq = cfg.num_query
        with torch.no_grad():
            xyz = points[..., :3].float().contiguous()
            # voxel-coordinate FPS: (z, y, x) ints -> (x, y, z) floats
            vc = coords.flip(-1).float()
            vc = torch.where(vmask[..., None], vc, torch.zeros_like(vc))
            idx1, idx2 = farthest_point_sample_pair(xyz, pts_mask, vc,
                                                    vmask, nq)
            take = lambda p, i: torch.gather(
                p, 1, i.long()[..., None].expand(-1, -1, 3))
            fpsbpts = torch.cat([_minmax_norm(take(xyz, idx1)),
                                 _minmax_norm(take(vc, idx2))], dim=1)
        outs = self.pts_bbox_head(fused, fpsbpts, random_points)
        if return_intermediates:
            return outs, {"feats": feats, "coords": coords, "vmask": vmask,
                          "fps_idx": (idx1, idx2)}
        return outs
