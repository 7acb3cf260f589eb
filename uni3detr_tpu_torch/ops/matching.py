"""Grouped set matching of queries to ground truth (port of
``uni3detr_tpu/ops/matching.py`` and ``ops/matching_pallas.py``).

:func:`match_queries_to_gt` solves one assignment per (sample, query
group): the cost's ``num_query`` rows of a group are the items, the GT
columns (tiled ``gt_repeat`` times, padded columns at cost 0) the
bidders. ``method="auction"`` pads the instances as the TPU path does
(bidders to a multiple of 8 with jittered indifferent rows, items to a
multiple of 128 with -1e6 dummies) and solves all of them with one
:func:`auction_lap` (K12, replaces ``_auction_kernel``): the CUDA kernel
in ``csrc/matching.cu`` for CUDA tensors, :func:`auction_lap_plain` for
CPU tensors; its ``launches`` attribute counts kernel launches.
``method="scipy"`` solves each instance exactly on the host with
``scipy.optimize.linear_sum_assignment``, as the reference does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

NEG = -1e30  # the TPU kernel's "no value"


def auction_lap_plain(benefit: torch.Tensor, spread: torch.Tensor,
                      eps_div: float = 2048.0, max_iters: int = 20000
                      ) -> torch.Tensor:
    """benefit (G, M, N) fp32 (rows bidders, columns items, M <= N);
    spread (G,) fp32 -> item_of (G, M) int32, -1 where a bidder is left
    unassigned after ``max_iters`` rounds.

    The Jacobi rounds of ``_auction_kernel`` on all instances at once; an
    instance whose bidders all hold items is a fixed point of a round, so
    running it along with the others changes nothing."""
    G, M, N = benefit.shape
    dev = benefit.device
    eps = (spread.float() / eps_div)[:, None]                 # (G, 1)
    rows = torch.arange(M, device=dev)[None, :, None]
    cols = torch.arange(N, device=dev)[None, None, :]
    price = torch.zeros((G, N), dtype=torch.float32, device=dev)
    owner = torch.full((G, N), -1, dtype=torch.long, device=dev)
    item_of = torch.full((G, M), -1, dtype=torch.long, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        active = item_of < 0
        if not bool(active.any()):
            break
        value = benefit - price[:, None, :]                   # (G, M, N)
        v1 = value.amax(dim=2)
        idx1 = torch.where(value == v1[..., None], cols, N).amin(dim=2)
        top = cols == idx1[..., None]
        v2 = torch.where(top, neg, value).amax(dim=2)
        v2 = torch.where(v2 <= NEG / 2, v1, v2)
        p_top = torch.gather(price, 1, idx1)
        bid = p_top + (v1 - v2) + eps
        bid_mat = torch.where(top & active[..., None], bid[..., None], neg)
        best = bid_mat.amax(dim=1)                            # (G, N)
        has_bid = best > NEG / 2
        winner = torch.where(bid_mat == best[:, None, :], rows, M).amin(dim=1)
        evicted = ((owner[:, None, :] == rows) & has_bid[:, None, :]).any(2)
        item_of = torch.where(evicted, -1, item_of)
        new_item = torch.where((winner[:, None, :] == rows)
                               & has_bid[:, None, :], cols, -1).amax(dim=2)
        item_of = torch.where(new_item >= 0, new_item, item_of)
        owner = torch.where(has_bid, winner, owner)
        price = torch.where(has_bid, best, price)
    return item_of.to(torch.int32)


def auction_lap(benefit: torch.Tensor, spread: torch.Tensor,
                eps_div: float = 2048.0, max_iters: int = 20000
                ) -> torch.Tensor:
    """K12. See :func:`auction_lap_plain` for the contract."""
    if benefit.dim() != 3 or benefit.dtype != torch.float32 or \
            spread.shape != benefit.shape[:1] or \
            spread.dtype != torch.float32:
        raise ValueError("auction_lap: benefit (G, M, N) and spread (G,) "
                         "float32")
    G, M, N = benefit.shape
    if M > N:
        raise ValueError(f"auction_lap: needs M <= N, got {M} > {N}")
    if benefit.device.type == "cpu" and spread.device.type == "cpu":
        return auction_lap_plain(benefit, spread, eps_div, max_iters)
    if not (benefit.is_cuda and spread.device == benefit.device
            and benefit.is_contiguous() and spread.is_contiguous()):
        raise ValueError("auction_lap: contiguous tensors on one CUDA "
                         "device")
    out = torch.empty((G, M), dtype=torch.int32, device=benefit.device)
    in_smem = ctypes.c_int(0)
    with torch.cuda.device(benefit.device):
        status = cuda_lib.library().u3d_auction_lap(
            benefit.data_ptr(), spread.data_ptr(), out.data_ptr(), G, M, N,
            float(eps_div), int(max_iters), ctypes.addressof(in_smem),
            torch.cuda.current_stream(benefit.device).cuda_stream)
    cuda_lib.check(status, "u3d_auction_lap")
    auction_lap.launches += 1
    auction_lap.benefit_in_smem = bool(in_smem.value)
    return out


auction_lap.launches = 0
# whether the last launch kept the benefit matrix in shared memory (it
# does when the instance fits the opt-in limit, else reads global memory)
auction_lap.benefit_in_smem = None


def _auction_instances(grouped: torch.Tensor):
    """grouped (I, nq, M) cost -> (benefit (I, M8, N) fp32, spread (I,)):
    the padding of ``_match_groups_pallas``."""
    I, nq, M = grouped.shape
    N = -(-nq // 128) * 128
    M8 = -(-M // 8) * 8
    real = -grouped.transpose(1, 2).float()                  # (I, M, nq)
    flat = real.reshape(I, -1)
    spread = (flat.amax(dim=1) - flat.amin(dim=1)).clamp(min=1e-6)
    benefit = torch.cat([real, real.new_full((I, M, N - nq), -1e6)], dim=2)
    if M8 > M:
        d = torch.arange(M8 - M, dtype=torch.float32,
                         device=grouped.device)[:, None]
        i = torch.arange(N, dtype=torch.float32,
                         device=grouped.device)[None, :]
        jitter = torch.remainder(d * 131.0 + i * 31.0, 97.0) / 97.0
        pad_rows = spread[:, None, None] * 1e-4 * jitter[None]
        benefit = torch.cat([benefit, pad_rows], dim=1)
    return benefit.contiguous(), spread.contiguous()


def _rows_scipy(grouped: torch.Tensor) -> torch.Tensor:
    """Exact assignment per instance on the host: (I, nq, M) cost ->
    row_of_col (I, M)."""
    from scipy.optimize import linear_sum_assignment

    c = np.nan_to_num(grouped.detach().double().cpu().numpy(), posinf=1e9,
                      neginf=-1e9)
    out = np.zeros((c.shape[0], c.shape[2]), np.int64)
    for i in range(c.shape[0]):
        _, out[i] = linear_sum_assignment(c[i].T)   # rows = GT columns
    return torch.from_numpy(out).to(grouped.device)


def match_queries_to_gt(cost: torch.Tensor, gt_valid: torch.Tensor,
                        num_query: int, gt_repeat: int = 1,
                        method: str = "auction",
                        phases: int | None = None) -> torch.Tensor:
    """cost (B, G*nq, Gt); gt_valid (B, Gt) bool -> assigned GT per query
    (B, G*nq) int64, -1 for background.

    Groups of ``num_query`` rows are matched independently; padded GT
    columns get cost 0 and their matches are dropped; ``gt_repeat`` tiles
    the GT columns and the match is taken modulo the GT count. The
    auction's eps is spread / 2048, or spread / 8**phases."""
    B, R, Gt = cost.shape
    ng = R // num_query
    if Gt * gt_repeat > num_query:
        raise ValueError(f"need Gt * gt_repeat <= num_query ({Gt} * "
                         f"{gt_repeat} vs {num_query})")
    cost = torch.where(gt_valid[:, None, :], cost, torch.zeros_like(cost))
    if gt_repeat > 1:
        cost = cost.repeat(1, 1, gt_repeat)
    Mc = Gt * gt_repeat
    grouped = cost.reshape(B * ng, num_query, Mc)
    if method == "scipy":
        rows = _rows_scipy(grouped)
    elif method == "auction":
        benefit, spread = _auction_instances(grouped)
        eps_div = 2048.0 if phases is None else 8.0 ** phases
        rows = auction_lap(benefit, spread, eps_div)[:, :Mc].long()
    else:
        raise ValueError(f"unknown matcher {method!r}")
    col_ids = torch.arange(Mc, device=cost.device) % Gt
    real = gt_valid[:, col_ids].repeat_interleave(ng, dim=0)    # (B*ng, Mc)
    # unmatched (-1) and padded columns scatter into a dropped slot
    slot = torch.where(real & (rows >= 0), rows, num_query)
    assigned = torch.full((B * ng, num_query + 1), -1, dtype=torch.long,
                          device=cost.device)
    assigned.scatter_(1, slot, col_ids.expand(B * ng, -1))
    return assigned[:, :num_query].reshape(B, R)
