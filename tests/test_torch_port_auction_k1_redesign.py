"""The redesigned auction (K12) and rulebook search (K1) of the port, and
the matching around them, against the JAX package on the CPU.

- K12: a plain model of the kernel's round (open-bidder list, row passes
  split into parts and merged lane by lane, one packed 64-bit key per
  item taken by maximum, install by reading the key) equals
  ``auction_lap_plain`` (assignment, rounds and bids) and, through it,
  ``auction_lap_pallas`` in interpret mode: exact, on seeded inputs with
  exact ties, duplicated bidders and a ``max_iters`` that leaves bidders
  unassigned. The key packing orders every bid, with -0.0 equal to +0.0.
- K1: a plain model of the kernel's search (runs of three offsets of one
  row, a binary search bracketed by the row's own site id, then forward
  scans of at most two steps before a binary search of the rest) equals
  ``match_positions_plain`` and the
  JAX ``match_positions`` in interpret mode: exact, with V below and not
  a multiple of the kernel's 32-row tile, INT_MAX pads, -1 queries and
  queries out of order.
- The matching: a GT column left unassigned (-1) lands on the last query
  as in the JAX package, the later column winning a collision as XLA's
  scatter does on the CPU; the costs of all decoder layers matched in one
  call equal per-layer calls, and the loss, computed with that one call,
  equals the JAX loss within atol 1e-5 (as ``test_torch_port_train``).
"""
import bisect
import dataclasses
from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uni3detr_tpu.geom import boxes as jboxes
from uni3detr_tpu.ops import matching as jm
from uni3detr_tpu.ops import matching_pallas as jmp
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu.train import losses as jl
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.geom import boxes as tboxes
from uni3detr_tpu_torch.ops import matching as tm
from uni3detr_tpu_torch.ops import sparse_conv as tsc
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk
from uni3detr_tpu_torch.train import losses as tl
from test_torch_port_train import TINY, _gt, _head_outputs

NEG = np.float32(-1e30)
WARPS = 16      # csrc/matching.cu AUC_WARPS
INT_MAX = np.iinfo(np.int32).max


def _t(x):
    return torch.from_numpy(np.array(x))


# -- K12: a plain model of the kernel ----------------------------------------

def bid_key(bid, i, M):
    """csrc/matching.cu bid_key: the bid's order-preserving uint32 image
    above M-1-i."""
    b = np.float32(bid)
    if b == 0:
        b = np.float32(0.0)
    u = int(np.array(b, np.float32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | int(M - 1 - i)


def _merge(a, b):
    if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]):
        return (b[0], b[1], max(a[2], b[2], a[0]))
    return (a[0], a[1], max(a[2], b[2], b[0]))


def _warp_top2(vals, lo, hi, N):
    """One warp's pass over vals[lo:hi], 32 lanes strided, then the
    butterfly of ``__shfl_xor_sync``."""
    lanes = []
    for lane in range(32):
        v1, j1, v2 = np.float32(-np.inf), N, NEG
        for j in range(lo + lane, hi, 32):
            if vals[j] > v1:
                v1, j1, v2 = vals[j], j, max(v2, v1)
            else:
                v2 = max(v2, vals[j])
        lanes.append((v1, j1, v2))
    for o in (16, 8, 4, 2, 1):
        lanes = [_merge(lanes[l], lanes[l ^ o]) for l in range(32)]
    return lanes[0]


def _parts(n_open, N):
    P = 1
    while P < WARPS and n_open * P * 2 <= WARPS and N >= 64 * P:
        P *= 2
    return P


def auction_model(benefit, spread, eps_div=2048.0, max_iters=20000,
                  parts=None):
    """The kernel's rounds on each instance: -> (item_of (G, M) int32,
    counts (G, 2) int32 rounds and bids). ``parts`` forces the row split
    (else the kernel's rule)."""
    G, M, N = benefit.shape
    items = np.full((G, M), -1, np.int32)
    counts = np.zeros((G, 2), np.int32)
    for g in range(G):
        ben = benefit[g]
        eps = np.float32(spread[g]) / np.float32(eps_div)
        price = np.zeros(N, np.float32)
        owner = np.full(N, -1)
        item = items[g]
        open_list, it = list(range(M)), 0
        while open_list and it < max_iters:
            counts[g, 1] += len(open_list)
            P = parts or _parts(len(open_list), N)
            chunk = -(-N // P)
            key, bids = {}, []
            for i in open_list:
                vals = ben[i] - price
                top = (np.float32(-np.inf), N, NEG)
                for part in range(P):
                    top = _merge(top, _warp_top2(
                        vals, part * chunk, min(N, (part + 1) * chunk), N))
                v1, j1, v2 = top
                v2 = v1 if v2 <= NEG / 2 else v2
                bid = (price[j1] + (v1 - v2)) + eps
                bids.append((i, j1, bid))
                if bid > NEG / 2:
                    key[j1] = max(key.get(j1, 0), bid_key(bid, i, M))
            nxt = []
            for i, j, bid in bids:
                if bid > NEG / 2 and key[j] & 0xFFFFFFFF == M - 1 - i:
                    prev, owner[j], price[j] = owner[j], i, bid
                    item[i] = j
                    if prev >= 0:
                        item[prev] = -1
                        nxt.append(prev)
                else:
                    nxt.append(i)
            open_list, it = nxt, it + 1
        counts[g, 0] = it
    return items, counts


def _benefit(rng, kind, G, M, N, n_dummy=28):
    if kind == "ties":        # values on a 1/4 grid: exact ties everywhere
        b = np.round(rng.randn(G, M, N) * 2) / 4
    elif kind == "clustered":   # low rank: near ties
        b = rng.randn(G, M, 3) @ rng.randn(G, 3, N) \
            + 1e-4 * rng.randn(G, M, N)
    else:                     # gt_repeat=5: duplicated bidders
        b = np.tile(rng.randn(G, M // 5 + 1, N), (1, 5, 1))[:, :M]
    b[:, :, N - n_dummy:] = -1e6
    b = b.astype(np.float32)
    flat = b[:, :, :N - n_dummy].reshape(G, -1)
    return b, np.maximum(flat.max(1) - flat.min(1), 1e-6).astype(np.float32)


def test_bid_key_orders_bids_and_ties():
    bids = np.array([-3e38, -1.5, -1e-40, -0.0, 0.0, 1e-45, 1e-38, 0.25,
                     0.25, 7.0, 3e38], np.float32)
    M = 9
    keys = [bid_key(b, i % M, M) for i, b in enumerate(bids)]
    for a in range(len(bids)):
        for c in range(len(bids)):
            want = (bids[a], -(a % M)) > (bids[c], -(c % M))
            assert (keys[a] > keys[c]) == want, (bids[a], bids[c])
    assert bid_key(-0.0, 2, M) == bid_key(0.0, 2, M)
    assert all(k > 0 for k in keys)


@pytest.mark.parametrize("kind,parts", [("ties", None), ("duplicated", None),
                                        ("clustered", 8)])
def test_auction_model_equals_plain(kind, parts):
    b, spread = _benefit(np.random.RandomState(11), kind, 2, 16, 128)
    items, counts = auction_model(b, spread, 512.0, parts=parts)
    ref, ref_counts = tm.auction_lap_plain(_t(b), _t(spread), 512.0,
                                           return_counts=True)
    np.testing.assert_array_equal(items, ref.numpy())
    np.testing.assert_array_equal(counts, ref_counts.numpy())
    assert (items >= 0).all() and counts[:, 0].min() > 1


def test_auction_unassigned_equals_plain_and_pallas():
    """A max_iters that stops the duplicated bidders' price war: -1
    entries, equal in the model, the plain version and the TPU kernel."""
    b, spread = _benefit(np.random.RandomState(12), "duplicated", 2, 16,
                         128)
    items, counts = auction_model(b, spread, 2048.0, max_iters=3)
    ref, ref_counts = tm.auction_lap_plain(_t(b), _t(spread), 2048.0, 3,
                                           return_counts=True)
    tpu = np.asarray(jmp.auction_lap_pallas(jnp.asarray(b),
                                            jnp.asarray(spread),
                                            max_iters=3, interpret=True))
    np.testing.assert_array_equal(items, ref.numpy())
    np.testing.assert_array_equal(items, tpu)
    np.testing.assert_array_equal(counts, ref_counts.numpy())
    assert (items < 0).any() and (counts[:, 0] == 3).all()


def test_auction_ties_equal_pallas():
    b, spread = _benefit(np.random.RandomState(13), "ties", 2, 16, 128)
    tpu = np.asarray(jmp.auction_lap_pallas(jnp.asarray(b),
                                            jnp.asarray(spread),
                                            eps_div=512.0, interpret=True))
    items, _ = auction_model(b, spread, 512.0)
    np.testing.assert_array_equal(items, tpu)


def test_auction_wrapper_counts_on_cpu():
    b, spread = _benefit(np.random.RandomState(14), "ties", 3, 8, 128)
    before = tm.auction_lap.launches
    got, counts = tm.auction_lap(_t(b), _t(spread), return_counts=True,
                                 variant="cluster")
    ref, ref_counts = tm.auction_lap_plain(_t(b), _t(spread),
                                           return_counts=True)
    assert torch.equal(got, ref) and torch.equal(counts, ref_counts)
    assert counts.dtype == torch.int32 and counts.shape == (3, 2)
    assert tm.auction_lap.launches == before
    assert torch.equal(tm.auction_lap(_t(b), _t(spread)), ref)


# -- K1: a plain model of the kernel -----------------------------------------

def k1_model(ids, qids, n_sites, run=3, scan=2):
    """csrc/sparse_conv.cu u3d_match_positions_kernel, one run of ``run``
    offsets of a row at a time, the first search of a run bracketed by the
    row's own site id; returns (rows, branches taken)."""
    B, V = ids.shape
    out = np.empty_like(qids)
    taken = dict(first=0, bracket=0, back=0, scan=0, search=0)
    for b in range(B):
        row = ids[b].tolist()
        for r in range(qids.shape[1]):
            s = row[r] if r < V else INT_MAX
            for k0 in range(0, qids.shape[2], run):
                p, q_last = 0, -1
                for k in range(k0, min(qids.shape[2], k0 + run)):
                    q = int(qids[b, r, k])
                    if q < 0:
                        out[b, r, k] = n_sites
                        continue
                    if q_last < 0 and s != INT_MAX:
                        d = q - s
                        lo, hi = (max(0, r + d), r) if d <= 0 else \
                            (r + 1, min(V, r + d))
                        p, kind = bisect.bisect_left(row, q, lo, hi), \
                            "bracket"
                    elif q_last < 0:
                        p, kind = bisect.bisect_left(row, q, 0, V), "first"
                    elif q < q_last:
                        p, kind = bisect.bisect_left(row, q, 0, p), "back"
                    else:
                        step, kind = 0, "scan"
                        while p < V and row[p] < q:
                            step += 1
                            if step > scan:
                                p = bisect.bisect_left(row, q, p, V)
                                kind = "search"
                                break
                            p += 1
                    taken[kind] += 1
                    q_last = q
                    out[b, r, k] = p if p < V and row[p] == q else n_sites
    return out, taken


GRID = (6, 8, 10)


def _rulebook(rng, n, V, B=1, shuffled=0.0):
    """Submanifold query ids of n sorted sites padded to V rows (INT_MAX
    ids, -1 queries), B samples; a share ``shuffled`` of the rows gets
    random queries in random order (misses, -1, descending runs)."""
    D, H, W = GRID
    coords = np.full((B, V, 3), -1, np.int32)
    for b in range(B):
        lin = np.sort(rng.choice(D * H * W, size=n, replace=False))
        coords[b, :n] = np.stack([lin // (H * W), (lin // W) % H, lin % W],
                                 -1)
    mask = _t(np.arange(V) < n).expand(B, -1)
    ids = tsc.linear_ids(_t(coords), mask, GRID).numpy()
    qids = tsc.subm_query_ids(_t(coords), mask, GRID).numpy().copy()
    rows = rng.rand(B, V) < shuffled
    qids[rows] = rng.randint(-1, D * H * W + 5, (rows.sum(), qids.shape[2]))
    return ids.astype(np.int32), qids.astype(np.int32)


@pytest.mark.parametrize("n,V,B", [(1, 1, 1), (4, 5, 2), (25, 31, 1),
                                   (32, 32, 1), (60, 65, 2), (200, 211, 1)])
def test_k1_model_equals_plain(n, V, B):
    ids, qids = _rulebook(np.random.RandomState(V), n, V, B, shuffled=0.2)
    qids[:, 0, 1] = -1                  # a -1 inside a run
    if n < V:                           # queries on a pad row: no bracket
        qids[:, -1] = np.arange(qids.shape[2]) * 5
    assert (ids[:, n:] == INT_MAX).all()
    got, taken = k1_model(ids, qids, V)
    ref = tk.match_positions_plain(_t(ids), _t(qids), V).numpy()
    np.testing.assert_array_equal(got, ref)
    if n >= 60:
        assert min(taken.values()) > 0, taken
        assert (ref < V).any() and (ref == V).any()


def test_k1_model_equals_jax_interpret():
    ids, qids = _rulebook(np.random.RandomState(3), 60, 70, 1, shuffled=0.1)
    ref = np.asarray(jpl.match_positions(jnp.asarray(ids), jnp.asarray(qids),
                                         70, interpret=True))
    got, _ = k1_model(ids, qids, 70)
    np.testing.assert_array_equal(got, ref)


# -- matching: unassigned columns, one call for all layers --------------------

def _jax_scatter(rows, real, col_ids, nq):
    def one(r, re):
        a = jnp.full((nq,), -1, jnp.int32)
        return a.at[jnp.where(re, r, nq)].set(col_ids, mode="drop")
    return np.asarray(jax.vmap(one)(jnp.asarray(rows), jnp.asarray(real)))


@pytest.mark.parametrize("case", ["no-collision", "collision", "two-unset"])
def test_scatter_assignment_matches_jax(case):
    nq, Gt = 8, 4
    col_ids = np.arange(2 * Gt) % Gt                  # gt_repeat=2
    rows = np.array([[0, 3, -1, 5, 1, 2, 9, -1],     # 9: a dummy item
                     [2, -1, 0, 1, 4, 3, 5, 6]])
    real = np.ones(rows.shape, bool)
    real[0, 7] = False                               # a padded column
    if case == "collision":
        rows[1, 6] = nq - 1                          # -1 wraps onto it
    elif case == "two-unset":
        rows[1, 4] = -1
    got = tm.scatter_assignment(_t(rows), _t(real), _t(col_ids), nq)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_scatter(rows, real, col_ids, nq))
    assert got[:, nq - 1].ge(0).all()


def test_match_queries_to_gt_unassigned_matches_jax():
    """A solver that leaves GT columns at -1 (as the auction after
    max_iters): both packages put them on the last query."""
    nq, Gt, groups, B = 8, 4, 2, 2
    rows = np.array([3, -1, 7, -1], np.int32)        # column 3 collides
    cost = np.random.RandomState(5).rand(B, groups * nq, Gt).astype(
        np.float32)
    valid = np.ones((B, Gt), bool)
    valid[1, 2] = False
    with mock.patch.object(jm, "auction_lap",
                           lambda c, n_phases=None: jnp.asarray(rows)):
        ref = np.stack([np.asarray(jm.match_queries_to_gt(
            jnp.asarray(cost[b]), jnp.asarray(valid[b]), nq,
            use_pallas=False)) for b in range(B)])
    padded = np.full((B * groups, 8), -1, np.int32)
    padded[:, :Gt] = rows
    with mock.patch.object(tm, "auction_lap",
                           lambda *a, **k: _t(padded)):
        got = tm.match_queries_to_gt(_t(cost), _t(valid), nq)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:, nq - 1] == 3).all() and (ref[1, nq - 1::nq] == 3).all()


def _loss_inputs(rng, cfg, L=3, B=2):
    outs = _head_outputs(rng, cfg, L, B, 3 * cfg.num_query)
    gt, labels, mask = _gt(rng, cfg, B, 4, 3)
    return outs, gt, labels, mask


def test_all_layers_in_one_call_equal_per_layer_calls():
    cfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, num_query=8,
                              matcher="auction")
    outs, gt, labels, mask = _loss_inputs(np.random.RandomState(6), cfg)
    outs = {k: _t(v) for k, v in outs.items()}
    gtc = tboxes.gravity_center_boxes(_t(gt))
    one = tl.assign_layers(tl.all_layer_costs(outs, gtc, _t(labels), cfg),
                           _t(mask), cfg)
    for l in range(one.shape[0]):
        per = tl.hungarian_assign(outs["all_cls_scores"][l],
                                  outs["all_bbox_preds"][l], gtc,
                                  _t(labels), _t(mask), cfg)
        assert torch.equal(one[l], per)
    assert (one >= 0).sum() == 3 * 2 * 3 * 3


def test_loss_with_one_matching_call_matches_jax():
    cfg = dataclasses.replace(TINY, num_query=8, matcher="scipy")
    tcfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, num_query=8,
                               matcher="scipy")
    outs, gt, labels, mask = _loss_inputs(np.random.RandomState(7), cfg,
                                          L=2)
    gtj = jboxes.gravity_center_boxes(gt)
    jtotal, jlogs = jax.jit(lambda o: jl.uni3detr_loss(
        o, gtj, labels, mask, cfg))({k: jnp.asarray(a)
                                     for k, a in outs.items()})
    with mock.patch.object(tl, "match_queries_to_gt",
                           wraps=tl.match_queries_to_gt) as spy:
        ttotal, tlogs = tl.uni3detr_loss(
            {k: _t(a) for k, a in outs.items()},
            tboxes.gravity_center_boxes(_t(gt)), _t(labels), _t(mask), tcfg)
    assert spy.call_count == 1
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].numpy(), np.asarray(jlogs[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ttotal.numpy(), np.asarray(jtotal), rtol=0,
                               atol=1e-5)
