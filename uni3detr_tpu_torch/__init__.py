"""PyTorch / CUDA port of uni3detr_tpu for NVIDIA Hopper GPUs.

Eval-only flagship slice: ``models.detector.Uni3DETR`` runs points to
head outputs, ``train.coder`` decodes and runs NMS. The four kernels of
that path (rulebook match, gather conv, id-matching gather conv, paired
FPS) are hand-written CUDA in ``csrc/``, built on first use; CPU tensors
take their plain PyTorch versions.
"""
