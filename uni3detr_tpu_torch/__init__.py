"""PyTorch / CUDA port of uni3detr_tpu for NVIDIA Hopper GPUs.

Runs the ``uni3detr_sunrgbd`` and ``uni3detr_nuscenes`` presets:
inference (``models.detector.Uni3DETR`` from points to head outputs,
``train.coder`` to decode and run NMS), training (``train.step``: losses,
matching, the sparse-conv backward, clip + AdamW and the step or cyclic
schedules) and checkpoints (``train.checkpoint``). The kernels of those
paths (rulebook match, gather conv and id-matching gather conv with
their weight gradients, paired and single-set FPS, the auction matcher)
are hand-written CUDA in ``csrc/``, built on first use; CPU tensors take
their plain PyTorch versions.
"""
