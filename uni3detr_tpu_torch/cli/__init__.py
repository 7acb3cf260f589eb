"""Command-line entry points of the port, each ``python -m
uni3detr_tpu_torch.cli.<name>``: ``create_data`` (KITTI and nuScenes
info pkls from the raw releases, the GT database of ``ObjectSample``),
``train``, ``test``, ``eval_metric``, ``import_ckpt`` (a reference
``.pth`` into a checkpoint of the port) and ``get_flops``."""
