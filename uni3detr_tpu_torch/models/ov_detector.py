"""OV-Uni3DETR detector (port of ``uni3detr_tpu/models/ov_detector.py``).

- Point branch (``cfg.use_lidar``): the Lidar detector's voxelizer,
  sparse encoder, SECOND3D, FPN and paired FPS seeds (``pts_*``).
- Image branch (``cfg.use_camera``): ResNet-50 + DCNv2 (``img_backbone``)
  and FPN (``img_neck``), then per level a 1x1 ``input_proj`` and a 1x1
  ``depth_net`` whose softmax over ``depth_dim`` bins is the depth
  distribution; ``view_trans`` lifts them onto the encoder's output grid
  (D, H, W) and runs its 3D convs.
- With both: the volumes concatenate [points, image] on the channel axis
  and ``conv_trans_head_1`` (Conv3d 2C -> C with bias, BN, ReLU) fuses
  them. In training the pair is the modality dropout's: one draw ri a
  step for the whole batch, [image, image] (ri 0), [points, points] (1)
  or [points, image] (2). Both branches run forward whatever ri is, as
  the JAX package computes both and selects, so both update their BN
  statistics and the FPS seeds always feed the head; only the unused
  branch gets no gradient. Camera-only mode derives the grid from the
  encoder's paddings and runs the head on the learned queries alone.
- ``pts_bbox_head``: the CLIP head.

Dtypes are those the JAX package computes: the image is cast to the
preset's dtype, the image branch then runs in fp32 (flax promotes to its
fp32 parameters), the lifted volume is cast to the preset's dtype, the
fusion conv and its BN run in fp32 and return to that dtype, and the
head samples the volume in it. The input is a batch dict with the JAX
package's keys. ``model.train()`` is the JAX package's ``train=True``:
the train voxel budget, batch statistics (the frozen ResNet stages
excepted), dropout and the train query groups. Voxelization and FPS
never record an autograd graph.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..config import OVUni3DETRConfig
from ..utils.profiling import span
from .detector import PointBranch
from .head_clip import Uni3DETRHeadCLIP
from .resnet import FPN, ResNet
from .second3d import BatchNorm3d
from .view_trans import Uni3DViewTrans


def encoder_grid(cfg: OVUni3DETRConfig):
    """The sparse encoder's output grid (D, H, W): three stride-2
    stages (k 3) with the configured paddings."""
    grid = tuple(cfg.grid_size)
    for pad in cfg.encoder_downsample_paddings:
        grid = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
    return grid


class OV_Uni3DETR(PointBranch, nn.Module):

    def __init__(self, cfg: OVUni3DETRConfig):
        super().__init__()
        self.cfg = cfg
        self.last_modality = None
        C = cfg.embed_dim
        if cfg.use_lidar:
            self._build_point_branch(cfg)
        if cfg.use_camera:
            D, H, W = encoder_grid(cfg)
            self.img_backbone = ResNet(cfg.stage_with_dcn, cfg.frozen_stages)
            self.img_neck = FPN(out_channels=C, num_outs=5)
            self.input_proj = nn.Conv2d(C, C, 1)
            self.depth_net = nn.Conv2d(C, cfg.depth_dim, 1)
            self.view_trans = Uni3DViewTrans(
                (W, H, D), cfg.pc_range, embed_dims=C,
                num_convs=cfg.num_view_convs,
                kernel_size=tuple(cfg.view_kernel),
                num_sweeps=cfg.num_sweeps, sweep_fusion=cfg.sweep_fusion)
        if cfg.use_lidar and cfg.use_camera:
            self.conv_trans_head_1 = nn.Sequential(
                nn.Conv3d(2 * C, C, 3, padding=1), BatchNorm3d(C),
                nn.ReLU())
        self.pts_bbox_head = Uni3DETRHeadCLIP(
            cfg.num_classes, num_query=cfg.num_query,
            code_size=cfg.code_size, embed_dim=C,
            num_decoder_layers=cfg.num_decoder_layers,
            num_heads=cfg.num_heads, ffn_dim=cfg.ffn_dim,
            dropout=cfg.dropout, clip_dim=cfg.clip_dim,
            pc_range=tuple(cfg.pc_range))

    def image_features(self, images):
        """images (B, N, H, W, 3) -> (per level (B, N, Hl, Wl, C)
        projected features, per level (B, N, Hl, Wl, depth_dim) depth
        distributions), fp32 channels-last."""
        cfg = self.cfg
        B, N, H, W, _ = images.shape
        x = images.reshape(B * N, H, W, 3).to(cfg.torch_dtype)
        x = x.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        feats = self.img_neck(self.img_backbone(x), cfg.fpn_levels)
        mlvl, depths = [], []
        for f in feats:
            p = self.input_proj(f)
            d = F.softmax(self.depth_net(p), dim=1)
            for out, t in ((mlvl, p), (depths, d)):
                t = t.permute(0, 2, 3, 1)
                out.append(t.reshape(B, N, *t.shape[1:]))
        return mlvl, depths

    def image_volume(self, batch):
        """The image branch: ((B, D, H, W, C) fp32 on the encoder grid, the
        lifted (B, N, V, C) voxel features)."""
        mlvl, depths = self.image_features(batch["images"])
        return self.view_trans(
            mlvl, depths, batch["lidar2img"], batch["uni_rot_aug"],
            tuple(self.cfg.img_size), sweep_times=batch.get("sweep_times"),
            img_rot_aug=batch.get("img_rot_aug"),
            img_trans_aug=batch.get("img_trans_aug"), return_lifted=True)

    def forward(self, batch, random_points=None,
                return_intermediates: bool = False, modality=None,
                generator=None):
        """batch: a dict with points (B, P, C) + pts_mask (B, P) and/or
        images (B, N, H, W, 3) + lidar2img (B, N, 4, 4) + uni_rot_aug
        (B, 3, 3) (optional img_rot_aug (B, 2, 2), img_trans_aug (B, 2),
        sweep_times (B, S)); random_points (B, nq, 3) uniform [0, 1), the
        eval query group when there are points.

        In training with both branches, ``modality`` pins ri (0, 1 or 2);
        without it ri is drawn on the host from ``generator`` (a CPU
        ``torch.Generator``; torch's global one when None), so the draw
        makes no device sync. The ri used is kept in ``last_modality``.

        Returns the head's per-layer output stacks (cls, boxes, IoU and
        uncertainty); with ``return_intermediates`` also a dict of the
        voxelization, the FPS indices, the lifted image features, the
        image volume, the fused volume and ri, where they exist. In eval
        no autograd graph is recorded."""
        with span("forward"), torch.set_grad_enabled(
                self.training and torch.is_grad_enabled()):
            return self._forward(batch, random_points, return_intermediates,
                                 modality, generator)

    def draw_modality(self, modality=None, generator=None) -> int:
        """ri of this step: ``modality`` when given, else uniform over
        {0, 1, 2} from the host generator."""
        if modality is None:
            modality = int(torch.randint(0, 3, (), generator=generator))
        if modality not in (0, 1, 2):
            raise ValueError(f"modality {modality} not in 0, 1, 2")
        return modality

    def _forward(self, batch, random_points, return_intermediates,
                 modality=None, generator=None):
        cfg = self.cfg
        dtype = cfg.torch_dtype
        use_pts = cfg.use_lidar and "points" in batch
        use_img = cfg.use_camera and "images" in batch
        if not (use_pts or use_img):
            raise ValueError("the batch holds no input this model uses")
        inter = {}
        fpsbpts = None
        if use_pts:
            # JAX's OV detector constrains nothing on its point branch:
            # under --spatial-shard it runs whole on each rank of a group
            pts_feat, fpsbpts, grid, inter = self.point_volume(
                batch["points"], batch["pts_mask"], spatial=False)
            if use_img and tuple(grid) != encoder_grid(cfg):
                raise ValueError(f"encoder grid {grid} is not the image "
                                 f"volume's {encoder_grid(cfg)}")
        if use_img:
            img_vol, lifted = self.image_volume(batch)
            img_feat = img_vol.to(dtype)
            inter.update(lifted=lifted, image_volume=img_feat)
        if use_pts and use_img:
            pts_feat = pts_feat.to(dtype)
            pair = (pts_feat, img_feat)
            if self.training:
                ri = self.draw_modality(modality, generator)
                self.last_modality = inter["modality"] = ri
                pair = ((img_feat, img_feat), (pts_feat, pts_feat),
                        pair)[ri]
            unified = torch.cat(pair, dim=-1)
            fused = self.conv_trans_head_1(            # (B, 2C, D, H, W) in
                unified.float().permute(0, 4, 1, 2, 3))
            volume = fused.to(dtype).permute(0, 2, 3, 4, 1)
            inter["fused_volume"] = volume
        else:
            volume = pts_feat if use_pts else img_feat
        with span("head"):
            outs = self.pts_bbox_head(volume.to(dtype), fpsbpts,
                                      random_points)
        return (outs, inter) if return_intermediates else outs
