"""Farthest point sampling (port of ``uni3detr_tpu/ops/fps.py``).

:func:`farthest_point_sample_pair` (K4, replaces ``_fps_pair_kernel``)
samples two independent point sets in one launch of the kernel in
``csrc/fps.cu`` for CUDA tensors, and through the plain PyTorch loop
:func:`farthest_point_sample_plain` for CPU tensors.
:func:`farthest_point_sample` (K11, replaces ``_fps_kernel``) samples one
set with the same kernel. Each wrapper's ``launches`` attribute counts
kernel launches.

The kernel is one cooperative grid over the card (:func:`fps_plan`):
every block owns a slice of every set and the blocks agree on each
step's pick through a grid barrier. A grid that cannot be resident at
once makes the launch fail, and the wrapper raise. One launch takes at
most ``_device_limits(...)[2]`` problems (sets x batch elements, 32); a
larger batch runs in several launches, each counted.

Semantics (mmcv D-FPS): sampling starts at index 0, masked points are
never chosen, ties go to the lowest index, and once the valid points are
exhausted the sampler returns duplicates.
"""
from __future__ import annotations

import ctypes
import functools

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


# bytes of shared memory a point of a block's slice takes: x, y, z and its
# min distance, fp32
FPS_SMEM_BYTES_PER_POINT = 16


def fps_plan(sizes, batch: int, sms: int, smem_limit: int):
    """Grid of the FPS kernel: one block per SM, each owning a contiguous
    slice of every (set, batch element) problem. Returns ``(grid,
    in_smem)``: ``in_smem`` when the slices of all problems (``sizes``
    points per set, ``batch`` elements each) fit ``smem_limit`` bytes of a
    block's shared memory, else the kernel streams them from global
    memory."""
    grid = sms
    need = FPS_SMEM_BYTES_PER_POINT * batch * sum(-(-n // grid)
                                                  for n in sizes)
    return grid, need <= smem_limit


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SMs, shared-memory bytes for slices, most problems per launch) of
    CUDA device ``index``."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        cuda_lib.check(cuda_lib.library().u3d_fps_limits(out),
                       "u3d_fps_limits")
    return tuple(out)


def _fps_launch(name: str, sets, num_samples: int) -> torch.Tensor:
    """Launch ``name`` once on the (xyz, mask) sets: (len(sets) * B, S)
    int32, set-major. The points of all sets go into one (3, sum B*N)
    fp32 plane array and one mask, set after set."""
    dev = sets[0][0].device
    B = sets[0][0].shape[0]
    sizes = [xyz.shape[1] for xyz, _ in sets]
    sms, smem_limit, _ = _device_limits(dev.index)
    grid, in_smem = fps_plan(sizes, B, sms, smem_limit)
    if (num_samples - 1) * grid >= 2 ** 32:
        raise ValueError(f"{name}: {num_samples} samples overflow the grid "
                         "barrier's counter")
    planes = torch.cat([xyz.float().reshape(-1, 3) for xyz, _ in sets]
                       ).T.contiguous()
    mask = torch.cat([m.reshape(-1) for _, m in sets]).contiguous()
    P = len(sets) * B
    mind = torch.empty(0 if in_smem else mask.numel(), dtype=torch.float32,
                       device=dev)
    part_v = torch.empty((2, P, grid, 4), dtype=torch.float32, device=dev)
    part_i = torch.empty((2, P, grid), dtype=torch.int32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    idx = torch.empty((P, num_samples), dtype=torch.int32, device=dev)
    ptrs = (planes.data_ptr(), mask.data_ptr(), mind.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), bar.data_ptr(),
            idx.data_ptr())
    with torch.cuda.device(dev):
        status = getattr(cuda_lib.library(), name)(
            *ptrs, *sizes, B, num_samples, grid, int(in_smem),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, name)
    return idx


def _fps_batched(name: str, sets, num_samples: int):
    """Run ``name`` on the (xyz, mask) sets in as few launches as the
    kernel's problems per launch (sets x batch elements) allow, splitting
    the batch: ``([(B, S) int32 per set], launches)``."""
    B = sets[0][0].shape[0]
    max_problems = _device_limits(sets[0][0].device.index)[2]
    step = max(1, max_problems // len(sets))
    chunks = [_fps_launch(name, [(x[b:b + step], m[b:b + step])
                                 for x, m in sets], num_samples)
              .view(len(sets), -1, num_samples) for b in range(0, B, step)]
    idx = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
    return list(idx.unbind(0)), len(chunks)


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
    (idx,), launches = _fps_batched("u3d_fps", [(xyz, mask)], num_samples)
    farthest_point_sample.launches += launches
    return idx


farthest_point_sample.launches = 0


def farthest_point_sample_pair(xyz_a: torch.Tensor, mask_a: torch.Tensor,
                               xyz_b: torch.Tensor, mask_b: torch.Tensor,
                               num_samples: int):
    """K4: two D-FPS samples, (B, Na, 3) and (B, Nb, 3) with their
    masks -> two (B, S) int32 index tensors."""
    sets = [(xyz_a, mask_a), (xyz_b, mask_b)]
    if _check_sets("farthest_point_sample_pair", sets):
        return (farthest_point_sample_plain(xyz_a, mask_a, num_samples),
                farthest_point_sample_plain(xyz_b, mask_b, num_samples))
    (idx_a, idx_b), launches = _fps_batched("u3d_fps_pair", sets,
                                            num_samples)
    farthest_point_sample_pair.launches += launches
    return idx_a, idx_b


farthest_point_sample_pair.launches = 0
