"""Training of the port: losses, the train step, decode and
post-processing, checkpoints and the import of a reference checkpoint
(``torch_import``)."""
