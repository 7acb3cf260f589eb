"""The plain reference the benchmark judges the port against: fp32 PyTorch
and NumPy, importing nothing of the port (``model``, ``loss``,
``postprocess``, ``geometry``)."""
