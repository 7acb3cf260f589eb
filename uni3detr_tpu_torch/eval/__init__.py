"""Host-side evaluation of the port: box merging, per-scene
post-processing, KITTI, indoor and nuScenes metrics, and the KITTI and
nuScenes submission writers (jax-free ports of
``uni3detr_tpu/data/eval`` and ``uni3detr_tpu/train/evaluator.py``)."""
