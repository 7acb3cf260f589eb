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
from ..parallel import dist, spatial as spatial_ops
from ..utils.profiling import count, full_rows, span
from .head import Uni3DETRHead
from .second3d import SECOND3D, SECOND3DFPN
from .sparse_encoder import SparseEncoderHD


def _minmax_norm(pts: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalization to [0, 1] over axis 1."""
    mn = pts.amin(dim=1, keepdim=True)
    mx = pts.amax(dim=1, keepdim=True)
    return (pts - mn) / (mx - mn).clamp(min=1e-6)


class PointBranch:
    """The point branch shared by ``Uni3DETR`` and ``OV_Uni3DETR``:
    voxelize, sparse encoder, SECOND3D, SECOND3DFPN and the paired FPS
    seeds, under the reference names ``pts_*``. ``cfg.encoder_impl``
    picks the encoder's route on the same parameters: ``gather`` (K1-K3)
    or ``dense`` (masked dense convs, no sparse-conv kernel)."""

    def _build_point_branch(self, cfg: Uni3DETRConfig):
        self.pts_middle_encoder = SparseEncoderHD(
            cfg.in_point_features, tuple(cfg.grid_size),
            base_channels=cfg.encoder_base_channels,
            output_channels=cfg.encoder_out_channels,
            encoder_channels=cfg.encoder_channels,
            downsample_paddings=cfg.encoder_downsample_paddings,
            budget_shrink=cfg.encoder_budget_shrink,
            budget_caps=cfg.encoder_budget_caps,
            compute_dtype=cfg.torch_dtype, impl=cfg.encoder_impl)
        self.pts_backbone = SECOND3D(
            cfg.encoder_out_channels, cfg.backbone_channels,
            cfg.backbone_layers, cfg.backbone_strides)
        self.pts_neck = SECOND3DFPN(
            cfg.backbone_channels, cfg.neck_channels,
            cfg.neck_upsample_strides)

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

    def point_volume(self, points, pts_mask, spatial: bool = True):
        """-> (fused volume (B, D, H, W, C) channels-last in the compute
        dtype, FPS seeds (B, 2*nq, 3) in [0, 1], the encoder's output grid
        (D, H, W), intermediates: voxels and FPS indices).

        With ``spatial`` in a spatially sharded train step
        (``parallel/spatial.py``) the dense part runs on H slices, as the
        JAX detector's ``constrain`` calls place it: the gather-route
        encoder runs whole on every rank of the group and its output is
        cut (the dense route cuts its own), SECOND3D and the FPN run on
        the slices, and the fused volume is gathered whole before the
        head samples it; FPS, the head and the loss run whole."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        on = spatial and dist.spatial_active()
        with span("voxelize"):
            feats, coords, vmask = self.voxelize(points, pts_mask)
            count("voxels_kept", vmask)
            # a scene whose every voxel row is taken dropped points
            count("voxel_budget_full", vmask, full_rows)
        with span("sparse_encoder"):
            volume, grid = self.pts_middle_encoder(feats, coords, vmask,
                                                   spatial=on)
        with span("backbone"):
            x = volume.to(dtype)
            if on:
                h = grid[1]
                if x.shape[2] == h and spatial_ops.divides(h):
                    x = spatial_ops.shard(x, 2)
                hs = self.pts_backbone.heights(h)
                ms = self.pts_backbone(x.permute(0, 4, 1, 2, 3), h)
            else:
                ms = self.pts_backbone(x.permute(0, 4, 1, 2, 3))
        with span("neck"):
            if on:
                fused = self.pts_neck(ms, hs)
                if fused.shape[3] != self.pts_neck.height(hs):
                    fused = spatial_ops.gather(fused, 3)
            else:
                fused = self.pts_neck(ms)
            fused = fused.to(dtype)      # (B, D, H, W, C) below
            fused = fused.permute(0, 2, 3, 4, 1).contiguous()

        nq = cfg.num_query
        with torch.no_grad(), span("fps"):
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
        return fused, fpsbpts, grid, {"feats": feats, "coords": coords,
                                      "vmask": vmask,
                                      "fps_idx": (idx1, idx2)}


class Uni3DETR(PointBranch, nn.Module):

    def __init__(self, cfg: Uni3DETRConfig):
        super().__init__()
        self.cfg = cfg
        self._build_point_branch(cfg)
        self.pts_bbox_head = Uni3DETRHead(
            cfg.num_classes, num_query=cfg.num_query,
            code_size=cfg.code_size, embed_dim=cfg.embed_dim,
            num_decoder_layers=cfg.num_decoder_layers,
            num_heads=cfg.num_heads, ffn_dim=cfg.ffn_dim,
            dropout=cfg.dropout, pc_range=tuple(cfg.pc_range))

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
        with span("forward"), torch.set_grad_enabled(
                self.training and torch.is_grad_enabled()):
            fused, fpsbpts, _, inter = self.point_volume(points, pts_mask)
            with span("head"):
                outs = self.pts_bbox_head(fused, fpsbpts, random_points)
        return (outs, inter) if return_intermediates else outs
