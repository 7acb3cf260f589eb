"""Command-line entry points of the port: ``python -m
uni3detr_tpu_torch.cli.train``, ``python -m uni3detr_tpu_torch.cli.test``
and ``python -m uni3detr_tpu_torch.cli.eval_metric``."""
