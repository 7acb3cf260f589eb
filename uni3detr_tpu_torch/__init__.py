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
``eval.indoor_eval``). The kernels of those paths (rulebook match,
gather conv and id-matching gather conv with their weight gradients,
paired and single-set FPS, the auction matcher, the rotated IoU as an
NMS bitmask, a matrix or two box sets in 3D or bird's-eye view, and the
greedy NMS scan) are hand-written CUDA in ``csrc/``, built on first use;
CPU tensors take their plain PyTorch versions. The metric and
box-merging entry points take numpy boxes and a ``device`` (the card
unless the caller asks for the CPU).

Tests: ``python -m pytest tests/test_torch_port_*.py`` on the CPU (the
port against the JAX package), and on a machine with an NVIDIA GPU
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``
(the kernels against their plain versions) and ``python3 chip_smoke.py``.
"""
