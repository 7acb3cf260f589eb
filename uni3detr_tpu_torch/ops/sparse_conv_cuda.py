"""Sparse-conv kernels of the encoder: wrappers and plain versions
(the counterpart of ``uni3detr_tpu/ops/sparse_conv_pallas.py``).

Each wrapper takes a tensor on the CPU through its plain PyTorch
version and a CUDA tensor through its hand-written kernel in
``csrc/sparse_conv.cu``; it never falls back from one to the other. The
wrapper's ``launches`` attribute counts kernel launches.

- :func:`match_positions` (K1, replaces ``_match_kernel_count``): query
  ids -> rulebook rows into the sorted site list, ``n_sites`` on a miss.
- :func:`gather_conv` (K2, replaces ``_kernel_unpacked``):
  ``out[b, v] = sum_k feats[b, nb[b, v, k]] @ W[k]``, ``nb == V`` -> 0.
- :func:`gather_conv_ids` (K3, replaces ``_kernel_idmatch``): the same
  conv with the neighbours found by id inside the kernel.

Outputs keep the input dtype (bf16 or fp32); products accumulate in
fp32. Eval only: there is no autograd rule yet.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_args(name: str, tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.is_cuda and t.device == dev,
                 f"{name}: all tensors must be on one CUDA device")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: the CUDA kernel has no "
                                  "backward yet (eval only)")


# --------------------------------------------------------------------------
# K1: rulebook from query ids
# --------------------------------------------------------------------------

def match_positions_plain(site_ids: torch.Tensor, qids: torch.Tensor,
                          n_sites: int) -> torch.Tensor:
    """site_ids (B, V) ascending int32 (INT_MAX pads); qids (B, Vout, K)
    int32 (-1 = none) -> (B, Vout, K) int32 rows, ``n_sites`` on a miss."""
    B, V = site_ids.shape
    q = qids.reshape(B, -1)
    qc = q.clamp(min=0)
    pos = torch.searchsorted(site_ids, qc)
    hit = (q >= 0) & (pos < V) & (
        torch.gather(site_ids, 1, pos.clamp(max=V - 1)) == qc)
    return torch.where(hit, pos, torch.full_like(pos, n_sites)).to(
        torch.int32).reshape(qids.shape)


def match_positions(site_ids: torch.Tensor, qids: torch.Tensor,
                    n_sites: int) -> torch.Tensor:
    """K1. See :func:`match_positions_plain` for the contract."""
    _require(site_ids.dim() == 2 and qids.dim() == 3
             and qids.shape[0] == site_ids.shape[0],
             "match_positions: site_ids (B, V), qids (B, Vout, K)")
    _require(site_ids.dtype == torch.int32 and qids.dtype == torch.int32,
             "match_positions: ids must be int32")
    if site_ids.device.type == "cpu" and qids.device.type == "cpu":
        return match_positions_plain(site_ids, qids, n_sites)
    _check_cuda_args("match_positions", (site_ids, qids))
    B, V = site_ids.shape
    _, Vout, K = qids.shape
    out = torch.empty((B, Vout, K), dtype=torch.int32, device=qids.device)
    with torch.cuda.device(qids.device):
        status = cuda_lib.library().u3d_match_positions(
            site_ids.data_ptr(), qids.data_ptr(), out.data_ptr(), B, V,
            Vout, K, int(n_sites), _stream(qids))
    cuda_lib.check(status, "u3d_match_positions")
    match_positions.launches += 1
    return out


match_positions.launches = 0


# --------------------------------------------------------------------------
# K2: gather conv over a rulebook
# --------------------------------------------------------------------------

def gather_conv_plain(features: torch.Tensor, neighbor_idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """features (B, V, C); neighbor_idx (B, Vout, K) with V = missing;
    weights (K, C, Cout) -> (B, Vout, Cout) in the features' dtype.

    The gathered rows and the weights are taken in the features' dtype
    and multiplied in fp32, as the JAX reference's dot with fp32
    accumulation."""
    B, V, C = features.shape
    _, Vout, K = neighbor_idx.shape
    padded = torch.cat([features, features.new_zeros(B, 1, C)], dim=1)
    bidx = torch.arange(B, device=features.device)[:, None, None]
    gathered = padded[bidx, neighbor_idx.long().clamp(0, V)]
    w = weights.to(features.dtype).reshape(K * C, -1).float()
    out = gathered.reshape(B, Vout, K * C).float() @ w
    return out.to(features.dtype)


def _conv_args(name, features, weights):
    _require(features.dim() == 3 and weights.dim() == 3
             and weights.shape[1] == features.shape[2],
             f"{name}: features (B, V, C), weights (K, C, Cout)")
    _require(features.dtype in (torch.float32, torch.bfloat16),
             f"{name}: features must be float32 or bfloat16")
    return weights.to(features.dtype).contiguous()


def _conv_suffix(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


def gather_conv(features: torch.Tensor, neighbor_idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """K2. See :func:`gather_conv_plain` for the contract."""
    w = _conv_args("gather_conv", features, weights)
    _require(neighbor_idx.dim() == 3 and neighbor_idx.dtype == torch.int32
             and neighbor_idx.shape[0] == features.shape[0]
             and neighbor_idx.shape[2] == weights.shape[0],
             "gather_conv: neighbor_idx (B, Vout, K) int32")
    if features.device.type == "cpu" and neighbor_idx.device.type == "cpu":
        return gather_conv_plain(features, neighbor_idx, weights)
    _check_cuda_args("gather_conv", (features, neighbor_idx, w))
    B, V, C = features.shape
    _, Vout, K = neighbor_idx.shape
    Cout = w.shape[2]
    out = torch.empty((B, Vout, Cout), dtype=features.dtype,
                      device=features.device)
    name = f"u3d_gather_conv_{_conv_suffix(features.dtype)}"
    with torch.cuda.device(features.device):
        status = getattr(cuda_lib.library(), name)(
            features.data_ptr(), neighbor_idx.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, V, C, Vout, K, Cout, _stream(features))
    cuda_lib.check(status, name)
    gather_conv.launches += 1
    return out


gather_conv.launches = 0


# --------------------------------------------------------------------------
# K3: gather conv with the neighbours found by id
# --------------------------------------------------------------------------

def gather_conv_ids_plain(features: torch.Tensor, site_ids: torch.Tensor,
                          qids: torch.Tensor, weights: torch.Tensor
                          ) -> torch.Tensor:
    """features (B, V, C) in site order; site_ids (B, V) their ascending
    ids (INT_MAX pads); qids (B, Vout, K) query ids (-1 = none); weights
    (K, C, Cout) -> (B, Vout, Cout)."""
    nb = match_positions_plain(site_ids, qids, features.shape[1])
    return gather_conv_plain(features, nb, weights)


def gather_conv_ids(features: torch.Tensor, site_ids: torch.Tensor,
                    qids: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """K3. See :func:`gather_conv_ids_plain` for the contract."""
    w = _conv_args("gather_conv_ids", features, weights)
    _require(site_ids.dtype == torch.int32 and qids.dtype == torch.int32
             and site_ids.shape == features.shape[:2]
             and qids.dim() == 3 and qids.shape[0] == features.shape[0]
             and qids.shape[2] == weights.shape[0],
             "gather_conv_ids: site_ids (B, V), qids (B, Vout, K) int32")
    if all(t.device.type == "cpu" for t in (features, site_ids, qids)):
        return gather_conv_ids_plain(features, site_ids, qids, weights)
    _check_cuda_args("gather_conv_ids", (features, site_ids, qids, w))
    B, V, C = features.shape
    _, Vout, K = qids.shape
    Cout = w.shape[2]
    out = torch.empty((B, Vout, Cout), dtype=features.dtype,
                      device=features.device)
    name = f"u3d_gather_conv_ids_{_conv_suffix(features.dtype)}"
    with torch.cuda.device(features.device):
        status = getattr(cuda_lib.library(), name)(
            features.data_ptr(), site_ids.data_ptr(), qids.data_ptr(),
            w.data_ptr(), out.data_ptr(), B, V, C, Vout, K, Cout,
            _stream(features))
    cuda_lib.check(status, name)
    gather_conv_ids.launches += 1
    return out


gather_conv_ids.launches = 0
