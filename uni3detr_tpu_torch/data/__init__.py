"""Host-side data of the port: datasets over the reference's info pkls
(train and val splits, ``RepeatDataset``, ``CBGSDataset``), the train-
and test-time pipeline transforms, the numpy box ops, batching and
prefetch, and the devkit-free nuScenes converter (jax-free copies of
``uni3detr_tpu/data``)."""
