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
CPU tensors; its ``launches`` attribute counts kernel launches, its
``counts`` holds the last launch's rounds and bids per instance (a device
tensor, read without a sync) and its ``variant`` says where the kernel
kept the benefit matrix. ``method="scipy"`` solves each instance exactly
on the host with ``scipy.optimize.linear_sum_assignment``, as the
reference does. The training loss stacks the costs of all decoder layers
into one call, so one launch solves every instance of a step.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

NEG = -1e30  # the TPU kernel's "no value"


def auction_lap_plain(benefit: torch.Tensor, spread: torch.Tensor,
                      eps_div: float = 2048.0, max_iters: int = 20000,
                      return_counts: bool = False):
    """benefit (G, M, N) fp32 (rows bidders, columns items, M <= N);
    spread (G,) fp32 -> item_of (G, M) int32, -1 where a bidder is left
    unassigned after ``max_iters`` rounds. With ``return_counts`` also
    (G, 2) int32: the rounds each instance ran and the bids it placed
    (its open bidders summed over those rounds).

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
    counts = torch.zeros((G, 2), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        active = item_of < 0
        if not bool(active.any()):
            break
        counts += torch.stack([active.any(1), active.sum(1)], 1).int()
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
    item_of = item_of.to(torch.int32)
    return (item_of, counts) if return_counts else item_of


# where the kernel keeps the benefit matrix (csrc/matching.cu): in the
# shared memory of one block, alternate bidder rows in each block of a
# cluster of two, or in global memory (L2) with the state in one block
AUCTION_VARIANTS = ("cta", "cluster", "global")


def auction_lap(benefit: torch.Tensor, spread: torch.Tensor,
                eps_div: float = 2048.0, max_iters: int = 20000,
                return_counts: bool = False, variant: str | None = None):
    """K12. See :func:`auction_lap_plain` for the contract. ``variant``
    (CUDA only) forces one of ``AUCTION_VARIANTS``; by default the kernel
    takes the first whose shared memory fits the card."""
    if benefit.dim() != 3 or benefit.dtype != torch.float32 or \
            spread.shape != benefit.shape[:1] or \
            spread.dtype != torch.float32:
        raise ValueError("auction_lap: benefit (G, M, N) and spread (G,) "
                         "float32")
    G, M, N = benefit.shape
    if M > N:
        raise ValueError(f"auction_lap: needs M <= N, got {M} > {N}")
    if benefit.device.type == "cpu" and spread.device.type == "cpu":
        return auction_lap_plain(benefit, spread, eps_div, max_iters,
                                 return_counts)
    if not (benefit.is_cuda and spread.device == benefit.device
            and benefit.is_contiguous() and spread.is_contiguous()):
        raise ValueError("auction_lap: contiguous tensors on one CUDA "
                         "device")
    if variant is not None and variant not in AUCTION_VARIANTS:
        raise ValueError(f"auction_lap: variant {variant!r} not in "
                         f"{AUCTION_VARIANTS}")
    out = torch.empty((G, M), dtype=torch.int32, device=benefit.device)
    counts = torch.zeros((G, 2), dtype=torch.int32, device=benefit.device)
    ran = ctypes.c_int(-1)
    want = -1 if variant is None else AUCTION_VARIANTS.index(variant)
    with torch.cuda.device(benefit.device):
        status = cuda_lib.library().u3d_auction_lap(
            benefit.data_ptr(), spread.data_ptr(), out.data_ptr(),
            counts.data_ptr(), G, M, N, float(eps_div), int(max_iters), want,
            ctypes.addressof(ran),
            torch.cuda.current_stream(benefit.device).cuda_stream)
    if status != 0 and ran.value < 0 and variant is not None:
        raise ValueError(f"auction_lap: variant {variant!r} does not fit "
                         f"the card's shared memory at M={M}, N={N}")
    cuda_lib.check(status, "u3d_auction_lap")
    auction_lap.launches += 1
    auction_lap.counts = counts
    auction_lap.variant = AUCTION_VARIANTS[ran.value] if ran.value >= 0 \
        else None
    return (out, counts) if return_counts else out


auction_lap.launches = 0
# the last launch's (G, 2) rounds and bids per instance, on the device
auction_lap.counts = None
# where the last launch kept the benefit matrix (AUCTION_VARIANTS)
auction_lap.variant = None


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


def scatter_assignment(rows: torch.Tensor, real: torch.Tensor,
                       col_ids: torch.Tensor, num_query: int) -> torch.Tensor:
    """rows (I, Mc) the query of each bidder column (-1 when left
    unassigned), real (I, Mc) bool, col_ids (Mc,) -> (I, num_query) int64
    GT index per query, -1 for background.

    The JAX package's ``assigned.at[where(real, rows, num_query)].set(
    col_ids, mode="drop")``: a negative row wraps once (-1 is the last
    query), a row out of range after that is dropped, and where two
    columns name one query the later column wins, as XLA's scatter
    resolves it on the CPU. A scatter-max of the column position keeps
    that deterministic on every device."""
    I, Mc = rows.shape
    slot = torch.where(real, rows.long(), num_query)
    slot = torch.where(slot < 0, slot + num_query, slot)
    slot = torch.where((slot < 0) | (slot > num_query), num_query, slot)
    pos = torch.arange(Mc, device=rows.device).expand(I, -1)
    last = torch.full((I, num_query + 1), -1, dtype=torch.long,
                      device=rows.device).scatter_reduce_(1, slot, pos,
                                                          "amax")
    last = last[:, :num_query]
    return torch.where(last >= 0, col_ids.long()[last.clamp(min=0)], -1)


def auction_problem(cost: torch.Tensor, gt_valid: torch.Tensor,
                    num_query: int, gt_repeat: int = 1,
                    phases: int | None = None):
    """The auction instances of :func:`match_queries_to_gt`'s cost:
    (benefit (B*ng, M8, N), spread (B*ng,), eps_div)."""
    grouped = _grouped(cost, gt_valid, num_query, gt_repeat)
    benefit, spread = _auction_instances(grouped)
    return benefit, spread, 2048.0 if phases is None else 8.0 ** phases


def _grouped(cost, gt_valid, num_query, gt_repeat):
    """cost (B, G*nq, Gt) -> (B*G, nq, Gt*gt_repeat): padded columns at
    cost 0, the GT columns tiled ``gt_repeat`` times."""
    B, R, Gt = cost.shape
    if Gt * gt_repeat > num_query:
        raise ValueError(f"need Gt * gt_repeat <= num_query ({Gt} * "
                         f"{gt_repeat} vs {num_query})")
    cost = torch.where(gt_valid[:, None, :], cost, torch.zeros_like(cost))
    if gt_repeat > 1:
        cost = cost.repeat(1, 1, gt_repeat)
    return cost.reshape(B * (R // num_query), num_query, Gt * gt_repeat)


def match_queries_to_gt(cost: torch.Tensor, gt_valid: torch.Tensor,
                        num_query: int, gt_repeat: int = 1,
                        method: str = "auction",
                        phases: int | None = None) -> torch.Tensor:
    """cost (B, G*nq, Gt); gt_valid (B, Gt) bool -> assigned GT per query
    (B, G*nq) int64, -1 for background.

    Groups of ``num_query`` rows are matched independently; padded GT
    columns get cost 0 and their matches are dropped; ``gt_repeat`` tiles
    the GT columns and the match is taken modulo the GT count. The
    auction's eps is spread / 2048, or spread / 8**phases. A GT column
    left unassigned (-1, after the auction's ``max_iters``) lands on the
    last query, as in the JAX package (:func:`scatter_assignment`).
    Instances are independent, so the costs of several decoder layers
    stacked along B give each layer's assignment in one call."""
    B, R, Gt = cost.shape
    ng = R // num_query
    Mc = Gt * gt_repeat
    if method == "scipy":
        rows = _rows_scipy(_grouped(cost, gt_valid, num_query, gt_repeat))
    elif method == "auction":
        benefit, spread, eps_div = auction_problem(cost, gt_valid, num_query,
                                                   gt_repeat, phases)
        rows = auction_lap(benefit, spread, eps_div)[:, :Mc]
    else:
        raise ValueError(f"unknown matcher {method!r}")
    col_ids = torch.arange(Mc, device=cost.device) % Gt
    real = gt_valid[:, col_ids].repeat_interleave(ng, dim=0)    # (B*ng, Mc)
    return scatter_assignment(rows, real, col_ids, num_query).reshape(B, R)
