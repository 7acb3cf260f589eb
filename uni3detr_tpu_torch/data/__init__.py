"""Host-side data of the port: datasets over the reference's info pkls,
the test-time pipeline transforms, batching and prefetch (jax-free
copies of ``uni3detr_tpu/data``)."""
