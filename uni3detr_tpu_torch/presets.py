"""Presets of the port: the same values as ``uni3detr_tpu/presets.py``.

Only the configurations the port runs today are here;
``tests/test_torch_port_modules.py`` checks each against the JAX preset
of the same name.
"""
from __future__ import annotations

import dataclasses

from .config import Uni3DETRConfig

# uni3detr_sunrgbd.py:10-12,26-140,230-242
SUNRGBD = Uni3DETRConfig(
    num_classes=10, code_size=8,
    pc_range=(-3.2, -0.2, -2.0, 3.2, 6.2, 0.56),
    voxel_size=(0.02, 0.02, 0.02), grid_size=(128, 320, 320),
    max_points_per_voxel=5, max_voxels=16000, max_voxels_test=40000,
    num_points=100000, max_gt=64, in_point_features=4,
    encoder_base_channels=16, encoder_out_channels=256,
    encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
    encoder_downsample_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)),
    num_query=300, num_decoder_layers=3,
    post_center_range=(-3.2, -0.2, -2.0, 3.2, 6.2, 0.56),
    max_num=1000, coder_alpha=1.0, post_processing="nms", nms_thr=0.5,
    encoder_budget_shrink=(0.7, 0.3, 0.12),
    compute_dtype="bfloat16",
)

# uni3detr_nuscenes.py:13-19,31-130,265-317 (10-dim code with velocity)
NUSCENES = Uni3DETRConfig(
    num_classes=10, code_size=10,
    pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
    voxel_size=(0.075, 0.075, 0.2), grid_size=(41, 1440, 1440),
    max_points_per_voxel=10, max_voxels=90000, max_voxels_test=120000,
    num_points=300000, max_gt=90, in_point_features=5,
    num_query=900, num_decoder_layers=3,
    code_weights=(1.0,) * 10,
    post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
    max_num=900, coder_alpha=1.0, post_processing="nms", nms_thr=0.2,
    num_thr=500,
    encoder_budget_shrink=(0.9, 0.4, 0.15),
    compute_dtype="bfloat16",
)

# uni3detr_scannet.py:9-12,60-113
SCANNET = dataclasses.replace(
    SUNRGBD,
    num_classes=18,
    pc_range=(-6.4, -6.4, -0.1, 6.4, 6.4, 2.46),
    grid_size=(128, 640, 640),
    max_num=5000,
    post_center_range=(-6.4, -6.4, -0.1, 6.4, 6.4, 2.46),
    encoder_budget_shrink=(0.85, 0.4, 0.16),
)

# uni3detr_scannet_large.py diff: dynamic voxelization, base 32 / out 512
SCANNET_LARGE = dataclasses.replace(
    SCANNET,
    dynamic_voxelization=True,
    max_voxels=60000, max_voxels_test=120000,  # static budget for dynamic
    encoder_base_channels=32, encoder_out_channels=512,
    encoder_channels=((32, 32, 64), (64, 64, 128), (128, 128, 256),
                      (256, 256)),
    in_point_features=4,
)

# uni3detr_kitti_car.py:10-11,26-116,147-155,285-291: 9 decoder layers,
# one-to-many matching (5 copies of each GT), box merging, budget caps
KITTI_CAR = Uni3DETRConfig(
    num_classes=1, code_size=8,
    pc_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
    voxel_size=(0.05, 0.05, 0.1), grid_size=(41, 1600, 1408),
    max_points_per_voxel=5, max_voxels=16000, max_voxels_test=40000,
    num_points=18000, max_gt=50, in_point_features=4,
    num_query=300, num_decoder_layers=9, gt_repeattimes=5,
    post_center_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
    max_num=150, coder_alpha=0.2, post_processing="box_merging",
    score_thr=0.5,
    matcher_phases=3,
    encoder_budget_shrink=(2.0, 1.4, 0.6),
    encoder_budget_caps=(33600, 24000, 10400),
    compute_dtype="bfloat16",
)

# uni3detr_kitti_3classes.py: 3 classes, per-class score thresholds
KITTI_3CLASSES = dataclasses.replace(
    KITTI_CAR,
    num_classes=3,
    score_thr=(0.0, 0.3, 0.65),
)

# tiny model for tests (not a reference config)
TINY_SYNTHETIC = Uni3DETRConfig(
    num_classes=3, code_size=8,
    pc_range=(-2.0, -2.0, -1.0, 2.0, 2.0, 1.0),
    voxel_size=(0.125, 0.125, 0.25), grid_size=(8, 32, 32),
    max_points_per_voxel=4, max_voxels=256, max_voxels_test=256,
    num_points=2048, max_gt=8, in_point_features=3,
    encoder_base_channels=8, encoder_out_channels=32,
    encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
    encoder_downsample_paddings=((1, 1, 1), (1, 1, 1), (1, 1, 1)),
    backbone_channels=(16, 16, 16), backbone_layers=(1, 1, 1),
    neck_channels=(32, 32, 32),
    num_query=16, embed_dim=32, num_decoder_layers=2, num_heads=4,
    ffn_dim=64, max_num=32,
    post_center_range=(-2.0, -2.0, -1.0, 2.0, 2.0, 1.0),
)

PRESETS = {
    "uni3detr_sunrgbd": SUNRGBD,
    "uni3detr_nuscenes": NUSCENES,
    "uni3detr_scannet": SCANNET,
    "uni3detr_scannet_large": SCANNET_LARGE,
    "uni3detr_kitti_car": KITTI_CAR,
    "uni3detr_kitti_3classes": KITTI_3CLASSES,
    "uni3detr_tiny_synthetic": TINY_SYNTHETIC,
}
