"""Host-side evaluation of the port: box merging, per-scene
post-processing, KITTI and indoor AP (jax-free ports of
``uni3detr_tpu/data/eval`` and ``uni3detr_tpu/train/evaluator.py``)."""
