"""Camera -> voxel lift (port of ``uni3detr_tpu/models/view_trans.py``).

The encoder grid's voxel centres (x-major ``linspace(0, 1, n)`` per
axis, scaled to ``pc_range``) are pulled back through the inverse of the
point-cloud augmentation rotation, projected through each camera's
``lidar2img`` (then the image augmentation ``uv @ img_rot_aug +
img_trans_aug``), and kept where the depth is positive and (u, v, depth
bin) lies inside the frustum. Each FPN level is sampled bilinearly at
(u, v) and weighted by its depth distribution sampled trilinearly at (u,
v, depth); levels and cameras sum. The (B, X*Y*Z, C) voxel list becomes
a (B, C, D, H, W) volume for ``num_convs`` x (Conv3d, BN, ReLU), and the
result is returned channels-last (B, D, H, W, C) like the point branch's.

The JAX package computes all of this in fp32 (its flax convs promote the
fp32 features), so the port does too. BatchNorm is eps 1e-3, flax
momentum 0.99 (torch 0.01), as the JAX package's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.sample import grid_sample_2d, grid_sample_3d
from .second3d import BatchNorm3d

DEPTH_EPS = 1e-5


def make_reference_voxels(voxel_shape, pc_range) -> torch.Tensor:
    """(X*Y*Z, 3) voxel centres in world coordinates, x-major (the
    reference meshgrid): ``linspace(0, 1, n)`` per axis scaled to the
    range, in fp32 as ``jnp.linspace`` computes it (i / (n - 1))."""
    axes = [torch.arange(n, dtype=torch.float32) / max(n - 1, 1)
            for n in voxel_shape]
    ref = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32)
    hi = torch.tensor(pc_range[3:6], dtype=torch.float32)
    return ref * (hi - lo) + lo


def project_voxels(ref_voxels, lidar2img, img_shape, depth_dim,
                   img_rot_aug=None, img_trans_aug=None):
    """ref_voxels (B, V, 3) world; lidar2img (B, N, 4, 4) -> (grid2d (B*N,
    V, 2) as (u, v), grid3d (B*N, V, 3) as (u, v, depth bin), all in [-1,
    1], and the mask (B, N, V) of voxels in front of the camera and
    inside the frustum)."""
    B, N = lidar2img.shape[:2]
    V = ref_voxels.shape[1]
    hom = torch.cat([ref_voxels, torch.ones_like(ref_voxels[..., :1])], -1)
    cam = torch.einsum("bnij,bvj->bnvi", lidar2img, hom)   # (B, N, V, 4)
    depth = cam[..., 2:3]
    mask = depth[..., 0] > DEPTH_EPS
    uv = cam[..., :2] / depth.clamp(min=DEPTH_EPS)
    if img_rot_aug is not None:
        uv = torch.einsum("bnvj,bji->bnvi", uv, img_rot_aug.to(uv.dtype))
    if img_trans_aug is not None:
        uv = uv + img_trans_aug.to(uv.dtype)[:, None, None, :]
    H, W = img_shape
    u = uv[..., 0] / W * 2.0 - 1.0
    v = uv[..., 1] / H * 2.0 - 1.0
    dz = depth[..., 0] / depth_dim * 2.0 - 1.0
    mask = mask & (u > -1.0) & (u < 1.0) & (v > -1.0) & (v < 1.0) \
        & (dz > -1.0) & (dz < 1.0)
    grid2d = torch.stack([u, v], -1).reshape(B * N, V, 2)
    grid3d = torch.stack([u, v, dz], -1).reshape(B * N, V, 3)
    return grid2d, grid3d, mask


def sample_camera_features(mlvl_feats, depths, ref_voxels, lidar2img,
                           img_shape, img_rot_aug=None, img_trans_aug=None):
    """mlvl_feats: list of (B, N, Hl, Wl, C); depths: list of (B, N, Hl,
    Wl, DD) depth distributions (one a level; a level past the list's end
    takes its last); ref_voxels (B, V, 3) world coordinates, already
    pulled back; lidar2img (B, N, 4, 4); img_shape (H, W) of the
    (augmented) image -> (B, N, V, C), zero outside each camera's
    frustum."""
    B, N = lidar2img.shape[:2]
    V = ref_voxels.shape[1]
    grid2d, grid3d, mask = project_voxels(
        ref_voxels, lidar2img, img_shape, depths[0].shape[-1], img_rot_aug,
        img_trans_aug)
    out = None
    for lvl, feat in enumerate(mlvl_feats):
        f = grid_sample_2d(feat.reshape(B * N, *feat.shape[2:]), grid2d)
        d = depths[min(lvl, len(depths) - 1)]
        # depth bins on the D axis of a (B*N, DD, Hl, Wl, 1) volume
        dvol = d.reshape(B * N, *d.shape[2:]).permute(0, 3, 1, 2)[..., None]
        contrib = f * grid_sample_3d(dvol, grid3d)
        out = contrib if out is None else out + contrib
    out = out.reshape(B, N, V, -1)
    return out * mask[..., None].to(out.dtype)


class _Conv1x1(nn.Sequential):
    """The JAX package's ``Dense`` + ReLU over a (..., C) voxel list, its
    weight held as the reference's 1x1x1 Conv3d (key ``.0``). The
    reference puts a BatchNorm3d before the ReLU; the JAX package has
    none and folds the reference's eval-mode BN into the Dense at import,
    as ``train.torch_import`` folds it into ``.0``, so the port trains
    what the JAX package trains."""

    def __init__(self, cin, cout):
        super().__init__(nn.Conv3d(cin, cout, 1))

    def forward(self, x):
        conv = self[0]
        w = conv.weight.reshape(conv.out_channels, conv.in_channels)
        return torch.relu(nn.functional.linear(x, w, conv.bias))


class Uni3DViewTrans(nn.Module):
    """Lift + sweep fusion + ``num_convs`` 3D convs; (B, D, H, W, C) out.

    With ``num_sweeps`` S > 1 the camera axis is laid out (S * cams):
    each sweep's cameras sum into a volume, then ``sweep_fusion``
    ("sweep_sum", "sweep_cat" or "with_time") combines the sweeps;
    ``with_time`` appends each sweep's time as a channel and maps back to
    C (``time_conv``), ``sweep_cat`` concatenates them (``trans_conv``),
    each a 1x1 conv with bias and a ReLU, the JAX package's Dense."""

    def __init__(self, voxel_shape: Tuple[int, int, int],
                 pc_range: Sequence[float], embed_dims: int = 256,
                 num_convs: int = 3,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 num_sweeps: int = 1, sweep_fusion: str = ""):
        super().__init__()
        self.voxel_shape = tuple(voxel_shape)
        self.pc_range = tuple(pc_range)
        # a buffer, so that the forward makes no host-to-device copy
        self.register_buffer("ref_voxels", make_reference_voxels(
            self.voxel_shape, self.pc_range), persistent=False)
        self.num_sweeps = num_sweeps
        self.sweep_fusion = sweep_fusion
        C = embed_dims
        if num_sweeps > 1 and "with_time" in sweep_fusion:
            self.time_conv = _Conv1x1(C + 1, C)
        if num_sweeps > 1 and "sweep_cat" in sweep_fusion:
            self.trans_conv = _Conv1x1(num_sweeps * C, C)
        pad = tuple((s - 1) // 2 for s in kernel_size)
        for k in range(num_convs):
            self.add_module(f"conv_trans_head_{k + 1}", nn.Sequential(
                nn.Conv3d(C, C, kernel_size, padding=pad),
                BatchNorm3d(C), nn.ReLU()))
        self.num_convs = num_convs

    def reference_voxels(self, uni_rot_aug):
        """(B, V, 3) voxel centres pulled back through the inverse of the
        point-cloud augmentation rotation (B, 3, 3): row vectors, as the
        reference, ``ref @ inv(R)``."""
        # inv_ex: no check of the result, so no wait on the device
        inv = torch.linalg.inv_ex(uni_rot_aug.float())[0]
        return torch.einsum("bvj,bji->bvi", self.ref_voxels.expand(
            uni_rot_aug.shape[0], -1, -1), inv)

    def lift(self, mlvl_feats, depths, lidar2img, uni_rot_aug, img_shape,
             img_rot_aug=None, img_trans_aug=None):
        """The lifted (B, N, V, C) per-camera voxel features."""
        return sample_camera_features(
            mlvl_feats, depths, self.reference_voxels(uni_rot_aug),
            lidar2img, img_shape, img_rot_aug, img_trans_aug)

    def forward(self, mlvl_feats, depths, lidar2img, uni_rot_aug,
                img_shape, sweep_times=None, img_rot_aug=None,
                img_trans_aug=None, return_lifted: bool = False):
        """-> (B, D, H, W, C) (and the lifted (B, N, V, C) voxel features
        with ``return_lifted``)."""
        S = self.num_sweeps
        per_cam = self.lift(mlvl_feats, depths, lidar2img, uni_rot_aug,
                            img_shape, img_rot_aug, img_trans_aug)
        B, _, V, C = per_cam.shape
        feats = per_cam.reshape(B, S, -1, V, C).sum(dim=2)    # (B, S, V, C)
        if S > 1 and "with_time" in self.sweep_fusion:
            t = sweep_times if sweep_times is not None \
                else feats.new_zeros(B, S)
            t = t[:, :, None, None].to(feats.dtype).expand(B, S, V, 1)
            feats = self.time_conv(torch.cat([feats, t], -1))
        if S > 1 and "sweep_cat" in self.sweep_fusion:
            feats = self.trans_conv(
                feats.transpose(1, 2).reshape(B, V, S * C))
        else:
            feats = feats.sum(dim=1)
        X, Y, Z = self.voxel_shape
        # (B, X*Y*Z, C) x-major -> (B, C, Z, Y, X) = (B, C, D, H, W)
        vol = feats.reshape(B, X, Y, Z, -1).permute(0, 4, 3, 2, 1)
        for k in range(self.num_convs):
            vol = getattr(self, f"conv_trans_head_{k + 1}")(vol)
        vol = vol.permute(0, 2, 3, 4, 1)                     # (B, D, H, W, C)
        return (vol, per_cam) if return_lifted else vol
