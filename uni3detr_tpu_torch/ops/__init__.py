"""Voxelizer, site sets, the CUDA kernels with their plain versions,
volume sampling and NMS of the port."""
