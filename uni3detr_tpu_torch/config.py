"""Model hyperparameters of the PyTorch port.

The same fields, names and defaults as ``uni3detr_tpu.models.config
.Uni3DETRConfig`` (that module imports jax, so the port keeps its own
copy); ``tests/test_torch_port_modules.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Uni3DETRConfig:
    # task
    num_classes: int = 10
    code_size: int = 8
    # geometry
    pc_range: Tuple[float, ...] = (-3.2, -0.2, -2.0, 3.2, 6.2, 0.56)
    voxel_size: Tuple[float, ...] = (0.02, 0.02, 0.02)
    grid_size: Tuple[int, int, int] = (128, 320, 320)  # (D, H, W)
    # voxelization budgets (static shapes); (train, test) voxel budgets
    max_points_per_voxel: int = 5
    max_voxels: int = 16000
    max_voxels_test: int = 40000
    num_points: int = 100000
    max_gt: int = 48
    dynamic_voxelization: bool = False
    in_point_features: int = 4
    encoder_impl: str = "gather"
    # encoder
    encoder_base_channels: int = 16
    encoder_out_channels: int = 256
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    encoder_downsample_paddings: Tuple[Tuple[int, int, int], ...] = (
        (1, 1, 1), (1, 1, 1), (0, 1, 1))
    # site budget after each strided downsample:
    # min(ceil8(V * shrink_i), caps_i), at least 256
    encoder_budget_shrink: Tuple[float, float, float] = (1.0, 0.5, 0.25)
    encoder_budget_caps: Optional[Tuple[int, int, int]] = None
    # backbone / neck
    backbone_channels: Tuple[int, ...] = (128, 256, 512)
    backbone_layers: Tuple[int, ...] = (5, 5, 5)
    backbone_strides: Tuple[int, ...] = (1, 2, 4)
    neck_channels: Tuple[int, ...] = (256, 256, 256)
    neck_upsample_strides: Tuple[int, ...] = (1, 2, 4)
    # head
    num_query: int = 300
    embed_dim: int = 256
    num_decoder_layers: int = 3
    num_heads: int = 8
    ffn_dim: int = 512
    dropout: float = 0.1
    gt_repeattimes: int = 1
    # training / matching (not used by the eval port yet)
    sync_cls_avg_factor: bool = True
    cls_cost_weight: float = 2.0
    reg_cost_weight: float = 0.25
    iou_cost_weight: float = 1.2
    iou_cost_type: str = "iou3d"
    cls_cost_type: str = "focal"
    iou_loss_type: str = "iou3d"
    loss_cls_weight: float = 1.5
    loss_bbox_weight: float = 0.25
    loss_iou_weight: float = 1.2
    matcher: str = "auction"
    matcher_phases: int | None = None
    code_weights: Tuple[float, ...] = (1.0,) * 8
    # decode / post-processing
    post_center_range: Tuple[float, ...] = (-3.2, -0.2, -2.0, 3.2, 6.2, 0.56)
    max_num: int = 1000
    coder_alpha: float = 1.0
    post_processing: str = "nms"  # nms | soft_nms | box_merging | none
    nms_thr: float = 0.5
    soft_nms_sigma: float = 0.3
    soft_nms_prune: float = 1e-2
    score_thr: float | Tuple[float, ...] | None = None
    num_thr: int | None = None
    # compute
    compute_dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32


@dataclasses.dataclass(frozen=True)
class OVUni3DETRConfig(Uni3DETRConfig):
    """OV-Uni3DETR: the multimodal open-vocabulary model (the fields of
    ``uni3detr_tpu.models.config.OVUni3DETRConfig``)."""
    use_lidar: bool = True
    use_camera: bool = True
    multimodal: bool = True
    num_cams: int = 1
    num_sweeps: int = 1  # camera sweeps; image axis laid out (S * cams)
    sweep_fusion: str = "sweep_sum"  # sweep_sum | sweep_cat | with_time
    img_size: Tuple[int, int] = (480, 640)  # (H, W) padded input
    depth_dim: int = 64
    num_view_convs: int = 3
    view_kernel: Tuple[int, int, int] = (3, 3, 3)
    fpn_levels: int = 4
    stage_with_dcn: Tuple[bool, ...] = (False, True, True, True)
    frozen_stages: int = 1
    use_grid_mask: bool = True
    clip_dim: int = 1024
    zeroshot_path: Optional[str] = None
    uncertainty_consistency_weight: float = 1.0
