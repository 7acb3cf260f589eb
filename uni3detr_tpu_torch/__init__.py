"""PyTorch / CUDA port of uni3detr_tpu for NVIDIA Hopper GPUs.

Runs the ``uni3detr_sunrgbd``, ``uni3detr_nuscenes``,
``uni3detr_scannet``, ``uni3detr_scannet_large``, ``uni3detr_kitti_car``
and ``uni3detr_kitti_3classes`` presets: inference
(``models.detector.Uni3DETR`` from points to head outputs, hard or
dynamic voxelization, ``train.coder`` to decode and run the per-class
NMS, or ``eval.postprocess`` to merge boxes on the host), training
(``train.step``: losses, one-to-many matching, the sparse-conv backward,
clip + AdamW and the step or cyclic schedules), checkpoints
(``train.checkpoint``) and the metrics (``eval.kitti_eval``,
``eval.indoor_eval``); and the OV presets
``ov_uni3detr_sunrgbd_{mm,pc,rgb}`` (``models.ov_detector.OV_Uni3DETR``:
points and / or one RGB image, ResNet-50 + DCNv2, the camera-to-voxel
lift, fusion, the CLIP head), inference and training (the uncertainty
loss, the modality dropout, frozen ResNet stages, per-module lr
multipliers, staged branch loading). The kernels of those paths (rulebook match,
gather conv and id-matching gather conv with their weight gradients,
paired and single-set FPS, the auction matcher, the rotated IoU as an
NMS bitmask, a matrix or two box sets in 3D or bird's-eye view, and the
greedy NMS scan) are hand-written CUDA in ``csrc/``, built on first use;
CPU tensors take their plain PyTorch versions. The metric and
box-merging entry points take numpy boxes and a ``device`` (the card
unless the caller asks for the CPU). The evaluation entry point
(``cli.test``, ``cli.eval_metric``) runs a config file under
``configs/`` (``config_file``) on its data root (``data``: the info
pkls, the test pipeline, batching) through the pipelined loop of
``train.evaluator`` (with ``train.tta``: the views merged by a BEV NMS
on the IoU kernel's BEV bitmask) to indoor, KITTI or nuScenes metrics
and submission files.

Tests: ``python -m pytest tests/test_torch_port_*.py`` on the CPU (the
port against the JAX package), and on a machine with an NVIDIA GPU
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``
(the kernels against their plain versions) and ``python3 chip_smoke.py``.
"""
