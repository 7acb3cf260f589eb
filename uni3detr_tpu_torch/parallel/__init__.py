"""Data parallelism of the port: one process per card over
``torch.distributed`` (``dist``), and a launcher of such processes
(``launch``)."""
