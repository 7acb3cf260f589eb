"""Presets of the port: the same values as ``uni3detr_tpu/presets.py``.

Only the configurations the port runs today are here;
``tests/test_torch_port_modules.py`` checks each against the JAX preset
of the same name.
"""
from __future__ import annotations

import dataclasses

from .config import OVUni3DETRConfig, Uni3DETRConfig

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

_OV_COMMON = dict(
    num_classes=46, code_size=8,
    pc_range=(-3.2, -0.2, -2.0, 3.2, 6.2, 0.56),
    voxel_size=(0.02, 0.02, 0.02), grid_size=(128, 320, 320),
    max_points_per_voxel=5, max_voxels=16000, max_voxels_test=40000,
    num_points=100000, max_gt=64, in_point_features=4,
    num_query=300,
    post_center_range=(-3.2, -0.2, -2.0, 3.2, 6.2, 0.56),
    max_num=1000, coder_alpha=1.0, post_processing="nms", nms_thr=0.5,
    num_cams=1, img_size=(480, 640), depth_dim=64, clip_dim=1024,
    encoder_budget_shrink=(0.7, 0.3, 0.12),  # same geometry as SUNRGBD
    compute_dtype="bfloat16",
)

# ov_uni3detr_sunrgbd_pc.py: point-only OV, 46 classes, 3 decoder layers
OV_SUNRGBD_PC = OVUni3DETRConfig(
    **_OV_COMMON, use_camera=False, multimodal=False,
    num_decoder_layers=3)

# ov_uni3detr_sunrgbd_rgb.py: camera-only, 6 decoder layers, voxel lift
OV_SUNRGBD_RGB = OVUni3DETRConfig(
    **_OV_COMMON, use_lidar=False, multimodal=False,
    num_decoder_layers=6)

# ov_uni3detr_sunrgbd_mm.py: both branches + fusion
OV_SUNRGBD_MM = OVUni3DETRConfig(
    **_OV_COMMON, multimodal=True, num_decoder_layers=6)

# ov_uni3detr_sunrgbd_mm.py's training: per-module lr multipliers (the
# reference's paramwise_cfg; ``train.step.make_optimizer(lr_mult=...)``)
# and the staged init's branch prefixes (``train.checkpoint.load_branch``)
OV_SUNRGBD_MM_LR_MULT = {
    'img_backbone': 0.1, 'img_neck': 0.1, 'view_trans': 0.1,
    'input_proj': 0.1, 'depth_net': 0.1, 'pts_middle_encoder': 0.1,
    'pts_backbone': 0.1, 'pts_neck': 0.1,
}
OV_SUNRGBD_MM_LOAD_IMG = ('img_backbone', 'img_neck', 'view_trans',
                          'input_proj', 'depth_net')
OV_SUNRGBD_MM_LOAD_PTS = ('pts_middle_encoder', 'pts_backbone', 'pts_neck')

# tiny OV model for tests (not a reference config)
OV_TINY_SYNTHETIC = OVUni3DETRConfig(
    **{k: getattr(TINY_SYNTHETIC, k)
       for k in TINY_SYNTHETIC.__dataclass_fields__},
    num_cams=1, img_size=(32, 32), depth_dim=8, num_view_convs=1,
    fpn_levels=2, stage_with_dcn=(False, False, True, True),
    clip_dim=16, multimodal=True,
)

# the 46 SUN RGB-D classes of the OV presets and the 10 seen in training
# (configs/ov_uni3detr/ov_uni3detr_sunrgbd_pc.py class_names, seen_classes)
OV_SUNRGBD_CLASSES = (
    'chair', 'table', 'pillow', 'sofa_chair', 'desk', 'bed', 'sofa',
    'computer', 'box', 'lamp', 'garbage_bin', 'cabinet', 'shelf', 'drawer',
    'sink', 'night_stand', 'kitchen_counter', 'paper', 'end_table',
    'kitchen_cabinet', 'picture', 'book', 'stool', 'coffee_table',
    'bookshelf', 'painting', 'key_board', 'dresser', 'tv', 'whiteboard',
    'cpu', 'toilet', 'file_cabinet', 'bench', 'ottoman', 'plant', 'monitor',
    'printer', 'recycle_bin', 'door', 'fridge', 'towel', 'cup', 'mirror',
    'laptop', 'cloth')
OV_SUNRGBD_SEEN = ('chair', 'table', 'pillow', 'sofa_chair', 'desk', 'bed',
                   'sofa', 'computer', 'lamp', 'box')

PRESETS = {
    "uni3detr_sunrgbd": SUNRGBD,
    "uni3detr_nuscenes": NUSCENES,
    "uni3detr_scannet": SCANNET,
    "uni3detr_scannet_large": SCANNET_LARGE,
    "uni3detr_kitti_car": KITTI_CAR,
    "uni3detr_kitti_3classes": KITTI_3CLASSES,
    "uni3detr_tiny_synthetic": TINY_SYNTHETIC,
    "ov_uni3detr_sunrgbd_pc": OV_SUNRGBD_PC,
    "ov_uni3detr_sunrgbd_rgb": OV_SUNRGBD_RGB,
    "ov_uni3detr_sunrgbd_mm": OV_SUNRGBD_MM,
    "ov_uni3detr_tiny_synthetic": OV_TINY_SYNTHETIC,
}
