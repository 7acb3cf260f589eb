"""Farthest point sampling (port of ``uni3detr_tpu/ops/fps.py``).

:func:`farthest_point_sample_pair` (K4, replaces ``_fps_pair_kernel``)
samples two independent point sets in one launch of the kernel in
``csrc/fps.cu`` for CUDA tensors, and through the plain PyTorch loop
:func:`farthest_point_sample_plain` for CPU tensors.
:func:`farthest_point_sample` (K11, replaces ``_fps_kernel``) samples one
set with the same kernel body. Each wrapper's ``launches`` attribute
counts kernel launches.

Semantics (mmcv D-FPS): sampling starts at index 0, masked points are
never chosen, ties go to the lowest index, and once the valid points are
exhausted the sampler returns duplicates.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def farthest_point_sample_plain(xyz: torch.Tensor, mask: torch.Tensor,
                                num_samples: int) -> torch.Tensor:
    """xyz (B, N, 3), mask (B, N) bool -> (B, S) int32 indices."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    mind = torch.where(mask, torch.full((B, N), 1e10, device=xyz.device),
                       torch.full((B, N), -1.0, device=xyz.device))
    idx = torch.zeros((B, num_samples), dtype=torch.long, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    bidx = torch.arange(B, device=xyz.device)
    for i in range(1, num_samples):
        diff = xyz - xyz[bidx, last][:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        mind = torch.where(mask, torch.minimum(mind, d), mind)
        last = torch.argmax(mind, dim=1)   # first maximum
        idx[:, i] = last
    return idx.to(torch.int32)


def _planes(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, 3, N) fp32 coordinate planes."""
    return xyz.float().transpose(1, 2).contiguous()


def _check_sets(name: str, sets) -> bool:
    """Validate (xyz, mask) pairs; True when all lie on the CPU (the
    plain path), False when all lie on one CUDA device."""
    B = sets[0][0].shape[0]
    for xyz, mask in sets:
        if not (xyz.dim() == 3 and xyz.shape[-1] == 3
                and mask.shape == xyz.shape[:2] and mask.dtype == torch.bool
                and xyz.shape[0] == B and xyz.shape[1] > 0):
            raise ValueError(f"{name}: xyz (B, N, 3) with N > 0 and a bool "
                             "mask (B, N)")
    tensors = [t for s in sets for t in s]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    return False


def farthest_point_sample(xyz: torch.Tensor, mask: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """K11: one D-FPS sample, (B, N, 3) with its mask -> (B, S) int32."""
    if _check_sets("farthest_point_sample", [(xyz, mask)]):
        return farthest_point_sample_plain(xyz, mask, num_samples)
    dev = xyz.device
    B, N, _ = xyz.shape
    planes = _planes(xyz)
    m = mask.contiguous()
    mind = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, num_samples), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = cuda_lib.library().u3d_fps(
            planes.data_ptr(), m.data_ptr(), mind.data_ptr(), idx.data_ptr(),
            N, B, num_samples, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "u3d_fps")
    farthest_point_sample.launches += 1
    return idx


farthest_point_sample.launches = 0


def farthest_point_sample_pair(xyz_a: torch.Tensor, mask_a: torch.Tensor,
                               xyz_b: torch.Tensor, mask_b: torch.Tensor,
                               num_samples: int):
    """K4: two D-FPS samples, (B, Na, 3) and (B, Nb, 3) with their
    masks -> two (B, S) int32 index tensors."""
    if _check_sets("farthest_point_sample_pair",
                   [(xyz_a, mask_a), (xyz_b, mask_b)]):
        return (farthest_point_sample_plain(xyz_a, mask_a, num_samples),
                farthest_point_sample_plain(xyz_b, mask_b, num_samples))
    dev = xyz_a.device
    B, Na, _ = xyz_a.shape
    Nb = xyz_b.shape[1]
    pa, pb = _planes(xyz_a), _planes(xyz_b)
    ma, mb = mask_a.contiguous(), mask_b.contiguous()
    mind_a = torch.empty((B, Na), dtype=torch.float32, device=dev)
    mind_b = torch.empty((B, Nb), dtype=torch.float32, device=dev)
    idx_a = torch.empty((B, num_samples), dtype=torch.int32, device=dev)
    idx_b = torch.empty((B, num_samples), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = cuda_lib.library().u3d_fps_pair(
            pa.data_ptr(), ma.data_ptr(), mind_a.data_ptr(),
            idx_a.data_ptr(), Na, pb.data_ptr(), mb.data_ptr(),
            mind_b.data_ptr(), idx_b.data_ptr(), Nb, B, num_samples,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "u3d_fps_pair")
    farthest_point_sample_pair.launches += 1
    return idx_a, idx_b


farthest_point_sample_pair.launches = 0
