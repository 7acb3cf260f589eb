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
- :func:`gather_conv_dw` (K7, replaces ``_gather_rows_kernel_unpacked``
  and its packed twin): the weight gradient of a K2 conv,
  ``dW[k] = sum_{b,v} feats[b, nb[b,v,k]]^T g[b,v]`` in fp32.
- :func:`gather_conv_ids_dw` (K10, replaces ``_rows_kernel_idmatch`` and
  its packed twin): the same for a K3 conv.

Outputs keep the input dtype (bf16 or fp32); products accumulate in
fp32. The bf16 kernels run on the tensor cores and need 16-byte aligned
features, weights and cotangents; the fp32 kernels run exact fp32
products on the CUDA cores. The bf16 weight gradients take their row
chunking from :func:`dw_plan`. :class:`GatherConvFn` and
:class:`GatherConvIdsFn` give the convs the backward rules of
``sparse_conv_pallas.py`` (``_bwd``, ``_ids_bwd``), built from the same
kernels; the model calls the convs through them.
"""
from __future__ import annotations

import torch

from . import cost, cuda_lib


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
        raise RuntimeError(f"{name}: a kernel launch records no gradient; "
                           "differentiate through GatherConvFn or "
                           "GatherConvIdsFn")


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
    cost.record("match_positions", (site_ids, qids), out)
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
    and multiplied in fp32 (fp64 for fp64 features), as the JAX
    reference's dot with fp32 accumulation."""
    B, V, C = features.shape
    _, Vout, K = neighbor_idx.shape
    acc = torch.promote_types(features.dtype, torch.float32)
    padded = torch.cat([features, features.new_zeros(B, 1, C)], dim=1)
    bidx = torch.arange(B, device=features.device)[:, None, None]
    gathered = padded[bidx, neighbor_idx.long().clamp(0, V)]
    w = weights.to(features.dtype).reshape(K * C, -1).to(acc)
    out = gathered.reshape(B, Vout, K * C).to(acc) @ w
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


def _check_conv_alignment(name, features, *others):
    """The bf16 kernels stage rows, weights and cotangents with 16-byte
    cp.async copies: a view that starts inside an allocation can break
    that."""
    if features.dtype == torch.bfloat16:
        for t in (features, *others):
            _require(t.data_ptr() % 16 == 0,
                     f"{name}: bf16 tensors must start on a 16-byte "
                     "boundary (got a view with a storage offset)")


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
    _check_conv_alignment("gather_conv", features, w)
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
    cost.record("gather_conv", (features, neighbor_idx, w), out)
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
    _check_conv_alignment("gather_conv_ids", features, w)
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
    cost.record("gather_conv_ids", (features, site_ids, qids, w), out)
    return out


gather_conv_ids.launches = 0


# --------------------------------------------------------------------------
# K7 / K10: weight gradients
# --------------------------------------------------------------------------

# The bf16 dW kernel's blocking (csrc/sparse_conv.cu): a block owns TM
# columns of the flattened (k, c) axis, TN output channels (dw_tile) and a
# chunk of the flattened (B*Vout) row axis, which it walks in stages of
# DW_RS rows.
DW_RS = 64
# dw_plan's targets: blocks per SM (a few waves of the two resident a
# SM), at least DW_MIN_STAGES stages a block, and partials that stay well
# inside the H100's 50 MB L2 (the chunk sum reads them straight back)
DW_BLOCKS_PER_SM = 8
DW_MIN_STAGES = 4
DW_PARTIAL_BYTES = 16 * 2 ** 20
# the fp32 dW kernel takes its rows in stages of 32 and fixed chunks
DW_F32_CHUNK_ROWS = 1024


def dw_tile(Cout: int) -> tuple:
    """(TM, TN) block tile of the bf16 dW kernel for ``Cout`` output
    channels: 256 columns by the channels up to 64 (every cotangent row
    read by fewer column tiles), else 128 x 128 (the 64 fp32 sums a
    thread can hold)."""
    for tn in (16, 32, 64):
        if Cout <= tn:
            return 256, tn
    return 128, 128


def dw_plan(B: int, Vout: int, K: int, C: int, Cout: int, sms: int) -> dict:
    """Row chunking of the bf16 dW kernel (K7/K10) for one call.

    Blocks are (row chunk, column tile, channel tile) with the tiles of
    :func:`dw_tile`. The plan takes the fewest chunks that give
    ``DW_BLOCKS_PER_SM * sms`` blocks, but no more chunks than keep
    ``DW_MIN_STAGES`` stages of ``DW_RS`` rows in each, nor than keep the
    fp32 partials (one (K, C, Cout) tile a chunk) within
    ``DW_PARTIAL_BYTES``; at least one chunk. ``chunk_rows`` is a
    multiple of ``DW_RS``. Returns ``chunk_rows``, ``n_chunks`` (0 when
    there are no rows), ``blocks`` and ``partial_bytes``."""
    def cdiv(a, b):
        return -(-a // b)

    R = B * Vout
    tm, tn = dw_tile(Cout)
    tiles = cdiv(K * C, tm) * cdiv(Cout, tn)
    per_chunk = 4 * K * C * Cout
    want = cdiv(DW_BLOCKS_PER_SM * sms, tiles)
    by_rows = cdiv(R, DW_MIN_STAGES * DW_RS)
    by_bytes = DW_PARTIAL_BYTES // max(per_chunk, 1)
    n = max(1, min(want, by_rows, by_bytes))
    chunk_rows = max(1, cdiv(cdiv(R, n), DW_RS)) * DW_RS
    n_chunks = cdiv(R, chunk_rows)
    return dict(chunk_rows=chunk_rows, n_chunks=n_chunks,
                blocks=n_chunks * tiles, partial_bytes=n_chunks * per_chunk)


def gather_conv_dw_plain(features: torch.Tensor, neighbor_idx: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """features (B, V, C); neighbor_idx (B, Vout, K) with V = missing;
    g (B, Vout, Cout) -> dW (K, C, Cout) fp32 (fp64 for fp64 inputs).

    The gathered rows stay in the features' dtype and are widened to
    fp32 with the cotangent before the contraction, as the JAX backward
    (``_bwd``: rows and g cast to fp32 before the einsum)."""
    B, V, C = features.shape
    _, Vout, K = neighbor_idx.shape
    acc = torch.promote_types(features.dtype, torch.float32)
    padded = torch.cat([features, features.new_zeros(B, 1, C)], dim=1)
    bidx = torch.arange(B, device=features.device)[:, None, None]
    rows = padded[bidx, neighbor_idx.long().clamp(0, V)]
    dw = rows.reshape(B * Vout, K * C).to(acc).T @ \
        g.reshape(B * Vout, -1).to(acc)
    return dw.reshape(K, C, -1)


def gather_conv_ids_dw_plain(features: torch.Tensor, site_ids: torch.Tensor,
                             qids: torch.Tensor, g: torch.Tensor
                             ) -> torch.Tensor:
    """As :func:`gather_conv_dw_plain`, the neighbours found by id (see
    :func:`gather_conv_ids_plain`)."""
    nb = match_positions_plain(site_ids, qids, features.shape[1])
    return gather_conv_dw_plain(features, nb, g)


def _dw_launch(name, features, index_args, g, K):
    B, V, C = features.shape
    Vout, Cout = g.shape[1], g.shape[2]
    if features.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(
            features.device).multi_processor_count
        chunk_rows = dw_plan(B, Vout, K, C, Cout, sms)["chunk_rows"]
    else:
        chunk_rows = DW_F32_CHUNK_ROWS
    n_chunks = -(-(B * Vout) // chunk_rows)
    partial = torch.empty((max(n_chunks, 1), K, C, Cout),
                          dtype=torch.float32, device=features.device)
    dw = torch.empty((K, C, Cout), dtype=torch.float32,
                     device=features.device)
    name = f"{name}_{_conv_suffix(features.dtype)}"
    with torch.cuda.device(features.device):
        status = getattr(cuda_lib.library(), name)(
            features.data_ptr(), *[t.data_ptr() for t in index_args],
            g.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, V, C, Vout,
            K, Cout, chunk_rows, _stream(features))
    cuda_lib.check(status, name)
    return dw


def _dw_args(name, features, g, Vout):
    _require(features.dim() == 3 and g.dim() == 3
             and g.shape[0] == features.shape[0] and g.shape[1] == Vout,
             f"{name}: features (B, V, C), g (B, Vout, Cout)")
    _require(features.dtype in (torch.float32, torch.bfloat16)
             and g.dtype == features.dtype,
             f"{name}: features and g must share one dtype, float32 or "
             "bfloat16")


def gather_conv_dw(features: torch.Tensor, neighbor_idx: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """K7. See :func:`gather_conv_dw_plain` for the contract."""
    _require(neighbor_idx.dim() == 3 and neighbor_idx.dtype == torch.int32
             and neighbor_idx.shape[0] == features.shape[0],
             "gather_conv_dw: neighbor_idx (B, Vout, K) int32")
    _dw_args("gather_conv_dw", features, g, neighbor_idx.shape[1])
    if all(t.device.type == "cpu" for t in (features, neighbor_idx, g)):
        return gather_conv_dw_plain(features, neighbor_idx, g)
    _check_cuda_args("gather_conv_dw", (features, neighbor_idx, g))
    _check_conv_alignment("gather_conv_dw", features, g)
    dw = _dw_launch("u3d_gather_conv_dw", features, (neighbor_idx,), g,
                    neighbor_idx.shape[2])
    gather_conv_dw.launches += 1
    cost.record("gather_conv_dw", (features, neighbor_idx, g), dw)
    return dw


gather_conv_dw.launches = 0


def gather_conv_ids_dw(features: torch.Tensor, site_ids: torch.Tensor,
                       qids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K10. See :func:`gather_conv_ids_dw_plain` for the contract."""
    _require(site_ids.dtype == torch.int32 and qids.dtype == torch.int32
             and site_ids.shape == features.shape[:2] and qids.dim() == 3
             and qids.shape[0] == features.shape[0],
             "gather_conv_ids_dw: site_ids (B, V), qids (B, Vout, K) int32")
    _dw_args("gather_conv_ids_dw", features, g, qids.shape[1])
    if all(t.device.type == "cpu" for t in (features, site_ids, qids, g)):
        return gather_conv_ids_dw_plain(features, site_ids, qids, g)
    _check_cuda_args("gather_conv_ids_dw", (features, site_ids, qids, g))
    _check_conv_alignment("gather_conv_ids_dw", features, g)
    dw = _dw_launch("u3d_gather_conv_ids_dw", features, (site_ids, qids), g,
                    qids.shape[2])
    gather_conv_ids_dw.launches += 1
    cost.record("gather_conv_ids_dw", (features, site_ids, qids, g), dw)
    return dw


gather_conv_ids_dw.launches = 0


# --------------------------------------------------------------------------
# autograd: the backward rules of sparse_conv_pallas.py (_bwd, _ids_bwd)
# --------------------------------------------------------------------------

class GatherConvFn(torch.autograd.Function):
    """Submanifold conv ``gather_conv(features, nb, W)`` with its backward:
    the relation is symmetric (n(v, k) = u iff n(u, K-1-k) = v), so dfeats
    is K2 over the same rulebook with the kernel-flipped, transposed
    weights, and dW is K7. The weight gradient comes back in the weights'
    dtype; dfeats is skipped when the features need none."""

    @staticmethod
    def forward(ctx, features, neighbor_idx, weights):
        ctx.save_for_backward(features, neighbor_idx, weights)
        return gather_conv(features, neighbor_idx, weights)

    @staticmethod
    def backward(ctx, g):
        features, nb, weights = ctx.saved_tensors
        g = g.to(features.dtype).contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = gather_conv(g, nb, weights.flip(0).transpose(1, 2))
        if ctx.needs_input_grad[2]:
            dw = gather_conv_dw(features, nb, g).to(weights.dtype)
        return df, None, dw


class GatherConvIdsFn(torch.autograd.Function):
    """Strided conv ``gather_conv_ids(features, site_ids, qids, W)`` with
    its backward: dfeats is K3 from the output sites (``bwd_ids``, their
    sorted ids) over ``bwd_qids`` (``strided_inverse_query_ids``: the
    output-space id each input feeds at offset k) with the transposed,
    unflipped weights; dW is K10."""

    @staticmethod
    def forward(ctx, features, site_ids, qids, weights, bwd_qids, bwd_ids):
        ctx.save_for_backward(features, site_ids, qids, weights, bwd_qids,
                              bwd_ids)
        return gather_conv_ids(features, site_ids, qids, weights)

    @staticmethod
    def backward(ctx, g):
        features, site_ids, qids, weights, bwd_qids, bwd_ids = \
            ctx.saved_tensors
        g = g.to(features.dtype).contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            if bwd_qids is None or bwd_ids is None:
                raise RuntimeError("GatherConvIdsFn: dfeats needs bwd_qids "
                                   "and bwd_ids")
            df = gather_conv_ids(g, bwd_ids, bwd_qids, weights.transpose(1, 2))
        if ctx.needs_input_grad[3]:
            dw = gather_conv_ids_dw(features, site_ids, qids, g).to(
                weights.dtype)
        return df, None, None, dw, None, None
