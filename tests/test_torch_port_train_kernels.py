"""The port's training kernels and backward rules against the JAX
package, on the CPU.

- K7 / K10 (weight gradients of the sparse convs): the plain versions
  against ``jnp.einsum`` over the rows that the JAX Pallas kernels
  (``_rows_unpacked``, ``_rows_packed``, ``_rows_idmatch``) gather in
  interpret mode, with misses, masked rows and C=4; atol 1e-5 in fp32
  (the same products summed in another order).
- K12 (auction): the plain version equals ``auction_lap_pallas`` in
  interpret mode assignment for assignment; ``match_queries_to_gt`` is
  within a relative total-cost gap of 1e-3 of scipy's exact assignment.
- ``GatherConvFn`` / ``GatherConvIdsFn``: dfeats and dW against
  ``jax.grad`` of the XLA reference conv on real submanifold and strided
  rulebooks, rtol/atol 1e-4 as the JAX package's own backward tests; a
  float64 ``gradcheck`` on a few sites.
- ``strided_inverse_query_ids`` equal to JAX's.
"""
from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

from uni3detr_tpu.ops import matching_pallas as jmp
from uni3detr_tpu.ops import sparse_conv as jsc
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu_torch.ops import matching as tm
from uni3detr_tpu_torch.ops import sparse_conv as tsc
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk

GRID = (6, 8, 10)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sites(rng, n, V):
    """n unique sites of GRID sorted by linear id, padded to V rows."""
    D, H, W = GRID
    lin = np.sort(rng.choice(D * H * W, size=n, replace=False))
    coords = np.full((V, 3), -1, np.int32)
    coords[:n] = np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)
    mask = np.zeros(V, bool)
    mask[:n] = True
    return coords, mask


def _subm(rng, n=150, V=160, C=8):
    coords, mask = _sites(rng, n, V)
    cj, mj = jnp.asarray(coords), jnp.asarray(mask)
    nb = np.array(jsc.subm_neighbor_idx(cj, mj, GRID))[None]
    ids = np.asarray(jsc.linear_ids(cj, mj, GRID))[None]
    qids = np.asarray(jsc.subm_query_ids(cj, mj, GRID))[None]
    feats = (rng.randn(1, V, C) * mask[None, :, None]).astype(np.float32)
    return coords, mask, nb, ids, qids, feats


def _strided(rng, padding=(0, 1, 1), n=40, V=64, C=4):
    coords, mask = _sites(rng, n, V)
    cj, mj = jnp.asarray(coords), jnp.asarray(mask)
    oc, om, og = jsc.downsample_sites(cj, mj, GRID, padding, V)
    d = dict(
        sidx=np.asarray(jsc.strided_neighbor_idx(oc, om, cj, mj, GRID,
                                                 padding))[None],
        in_ids=np.asarray(jsc.linear_ids(cj, mj, GRID))[None],
        out_ids=np.asarray(jsc.linear_ids(oc, om, og))[None],
        sq=np.asarray(jsc.strided_query_ids(oc, om, GRID, padding))[None],
        invq=np.asarray(jsc.strided_inverse_query_ids(cj, mj, og,
                                                      padding))[None],
        feats=(rng.randn(1, V, C) * mask[None, :, None]).astype(np.float32),
        coords=coords, mask=mask, out_grid=og)
    return d


def _einsum_dw(rows, g, K, C):
    return np.asarray(jnp.einsum("bvx,bvo->xo", rows.astype(jnp.float32),
                                 jnp.asarray(g))).reshape(K, C, -1)


# -- K7 / K10: weight gradients --------------------------------------------

@pytest.mark.parametrize("C,Cout", [(4, 16), (8, 8), (16, 24)])
@pytest.mark.parametrize("route", ["unpacked", "packed"])
def test_gather_conv_dw_matches_pallas_rows(C, Cout, route):
    """Submanifold rulebook with misses (nb == V) and masked rows."""
    rng = np.random.RandomState(C + Cout)
    _, _, nb, _, _, feats = _subm(rng, C=C)
    nb[0, ::7, 4] = 160                             # extra misses
    g = (0.1 * rng.randn(1, 160, Cout)).astype(np.float32)
    if route == "unpacked":
        rows = jpl._rows_unpacked(jnp.asarray(feats), jnp.asarray(nb),
                                  interpret=True)
    else:
        rows = jpl._rows_packed(jnp.asarray(feats), jnp.asarray(nb),
                                interpret=True, tile=256)
    ref = _einsum_dw(rows, g, 27, C)
    got = tk.gather_conv_dw_plain(_t(feats), _t(nb), _t(g)).numpy()
    assert got.dtype == np.float32 and got.shape == (27, C, Cout)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_gather_conv_ids_dw_matches_pallas_rows(kind):
    rng = np.random.RandomState(17)
    if kind == "subm":
        _, _, _, ids, q, feats = _subm(rng, C=4)
    else:
        d = _strided(rng, C=4)
        ids, q, feats = d["in_ids"], d["sq"], d["feats"]
    g = (0.1 * rng.randn(1, q.shape[1], 8)).astype(np.float32)
    rows = jpl._rows_idmatch(jnp.asarray(feats), jnp.asarray(ids),
                             jnp.asarray(q), interpret=True)
    ref = _einsum_dw(rows, g, 27, 4)
    got = tk.gather_conv_ids_dw_plain(_t(feats), _t(ids), _t(q),
                                      _t(g)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_dw_bf16_rows_widen_exactly():
    """bf16 features and cotangent: rows and g widen exactly to fp32, so
    the plain dW equals the fp32 contraction of the rounded inputs."""
    rng = np.random.RandomState(5)
    _, _, nb, _, _, feats = _subm(rng, C=8)
    g = rng.randn(1, 160, 8).astype(np.float32)
    fb, gb = _t(feats).bfloat16(), _t(g).bfloat16()
    got = tk.gather_conv_dw(fb, _t(nb), gb)
    ref = tk.gather_conv_dw_plain(fb.float(), _t(nb), gb.float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


# -- backward rules ---------------------------------------------------------

def test_gather_conv_fn_grads_match_jax_subm():
    rng = np.random.RandomState(7)
    _, _, nb, _, _, feats = _subm(rng, C=8)
    w = (rng.randn(27, 8, 16) * 0.1).astype(np.float32)
    gj = jax.grad(lambda f, w: (jpl._xla_gather_conv(f, jnp.asarray(nb), w)
                                ** 2).sum(), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    f, wt = _t(feats).requires_grad_(), _t(w).requires_grad_()
    (tk.GatherConvFn.apply(f, _t(nb), wt) ** 2).sum().backward()
    for got, ref in ((f.grad, gj[0]), (wt.grad, gj[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
    assert wt.grad.dtype == torch.float32


def test_gather_conv_ids_fn_grads_match_jax_strided():
    rng = np.random.RandomState(8)
    d = _strided(rng, C=4)
    w = (rng.randn(27, 4, 8) * 0.1).astype(np.float32)
    sidx = jnp.asarray(d["sidx"])
    gj = jax.grad(lambda f, w: (jpl._xla_gather_conv(f, sidx, w) ** 2).sum(),
                  argnums=(0, 1))(jnp.asarray(d["feats"]), jnp.asarray(w))
    f, wt = _t(d["feats"]).requires_grad_(), _t(w).requires_grad_()
    out = tk.GatherConvIdsFn.apply(f, _t(d["in_ids"]), _t(d["sq"]), wt,
                                   _t(d["invq"]), _t(d["out_ids"]))
    (out ** 2).sum().backward()
    for got, ref in ((f.grad, gj[0]), (wt.grad, gj[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
    assert np.abs(np.asarray(gj[0])).max() > 0


def test_gather_conv_fns_gradcheck_fp64():
    """The kernel wrappers take fp32/bf16 only, so the Functions run here
    on the plain versions, which compute fp64 inputs in fp64."""
    rng = np.random.RandomState(9)
    plain = {n: getattr(tk, n + "_plain") for n in (
        "gather_conv", "gather_conv_ids", "gather_conv_dw",
        "gather_conv_ids_dw")}
    _, _, nb, _, _, feats = _subm(rng, n=12, V=14, C=2)
    d = _strided(rng, n=10, V=12, C=2)
    with mock.patch.multiple(tk, **plain):
        f = _t(feats).double().requires_grad_()
        w = torch.from_numpy(rng.randn(27, 2, 3)).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda f, w: tk.GatherConvFn.apply(f, _t(nb), w), (f, w))
        f = _t(d["feats"]).double().requires_grad_()
        args = [_t(d[k]) for k in ("in_ids", "sq")]
        back = [_t(d[k]) for k in ("invq", "out_ids")]
        assert torch.autograd.gradcheck(
            lambda f, w: tk.GatherConvIdsFn.apply(f, *args, w, *back),
            (f, w))


def test_gather_conv_fn_skips_dfeats_without_need():
    rng = np.random.RandomState(10)
    _, _, nb, _, _, feats = _subm(rng, C=4)
    w = _t(rng.randn(27, 4, 8).astype(np.float32)).requires_grad_()
    tk.GatherConvFn.apply(_t(feats), _t(nb), w).sum().backward()
    assert w.grad is not None and w.grad.abs().max() > 0


@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)])
def test_strided_inverse_query_ids_matches_jax(padding):
    d = _strided(np.random.RandomState(11), padding=padding)
    got = tsc.strided_inverse_query_ids(
        _t(d["coords"])[None], _t(d["mask"])[None], d["out_grid"], padding)
    np.testing.assert_array_equal(got.numpy(), d["invq"])
    assert (got >= 0).any() and (got < 0).any()


# -- K12: auction ------------------------------------------------------------

def _benefit(rng, kind, G, M, N):
    if kind == "random":
        b = rng.randn(G, M, N) * 2.0
    elif kind == "clustered":           # low rank: near ties everywhere
        b = rng.randn(G, M, 3) @ rng.randn(G, 3, N) \
            + 1e-4 * rng.randn(G, M, N)
    else:                               # gt_repeat=5: duplicated bidders
        b = np.tile(rng.randn(G, M // 5 + 1, N), (1, 5, 1))[:, :M]
        b = b + 1e-6 * rng.randn(G, M, N)
    b[:, :, N - 28:] = -1e6             # dummy items, as the padding
    b = b.astype(np.float32)
    flat = b[:, :, :N - 28].reshape(G, -1)
    spread = np.maximum(flat.max(1) - flat.min(1), 1e-6).astype(np.float32)
    return b, spread


@pytest.mark.parametrize("kind", ["random", "clustered", "duplicated"])
def test_auction_lap_plain_equals_pallas(kind):
    rng = np.random.RandomState(3)
    b, spread = _benefit(rng, kind, 3, 16, 128)
    ref = np.asarray(jmp.auction_lap_pallas(jnp.asarray(b),
                                            jnp.asarray(spread),
                                            interpret=True))
    got = tm.auction_lap_plain(_t(b), _t(spread)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).all() and len(set(got[0].tolist())) == 16


def test_auction_wrapper_takes_plain_path_and_checks():
    b, spread = _benefit(np.random.RandomState(4), "random", 2, 8, 128)
    before = tm.auction_lap.launches
    assert torch.equal(tm.auction_lap(_t(b), _t(spread), 512.0),
                       tm.auction_lap_plain(_t(b), _t(spread), 512.0))
    assert tm.auction_lap.launches == before
    with pytest.raises(ValueError):
        tm.auction_lap(_t(b).double(), _t(spread))
    with pytest.raises(ValueError):
        tm.auction_lap(_t(b).transpose(1, 2).contiguous(), _t(spread))


def _detr_cost(rng, rows, n_real, Gt):
    cost = np.zeros((rows, Gt), np.float32)
    cost[:, :n_real] = (rng.randn(rows, n_real) * 2.0
                        + rng.rand(rows, n_real) * 2.0
                        + rng.rand(rows, n_real) * 1.2)
    return cost


@pytest.mark.parametrize("nq,Gt,n_real,rep,phases,dup", [
    (300, 50, 50, 5, 3, False),     # KITTI one-to-many
    (300, 50, 50, 5, 3, True),      # ... with duplicated GT columns
    (300, 64, 24, 1, None, False),  # SUN RGB-D with padded GT columns
])
def test_match_queries_to_gt_gap_vs_scipy(nq, Gt, n_real, rep, phases, dup):
    rng = np.random.RandomState(nq + Gt + rep)
    groups, B = 3, 2
    cost = np.stack([_detr_cost(rng, groups * nq, n_real, Gt)
                     for _ in range(B)])
    if dup:
        cost[..., :n_real] = np.tile(cost[..., :10], (1, 1, 5)) \
            + 1e-6 * rng.randn(B, groups * nq, n_real).astype(np.float32)
    valid = np.zeros((B, Gt), bool)
    valid[:, :n_real] = True
    got = tm.match_queries_to_gt(_t(cost), _t(valid), nq, rep,
                                 phases=phases).numpy()
    exact = tm.match_queries_to_gt(_t(cost), _t(valid), nq, rep,
                                   method="scipy").numpy()
    for b in range(B):
        for a in (got[b], exact[b]):
            assert (a < n_real).all()
            for g in range(groups):
                assert (a[g * nq:(g + 1) * nq] >= 0).sum() == n_real * rep
        auc = sum(cost[b, q, got[b, q]] for q in range(groups * nq)
                  if got[b, q] >= 0)
        sci = 0.0
        for g in range(groups):
            c = np.tile(cost[b, g * nq:(g + 1) * nq, :n_real].astype(
                np.float64), (1, rep))
            r, col = linear_sum_assignment(c)
            sci += c[r, col].sum()
        mine = sum(cost[b, q, exact[b, q]] for q in range(groups * nq)
                   if exact[b, q] >= 0)
        np.testing.assert_allclose(mine, sci, rtol=1e-6)
        gap = (auc - sci) / abs(sci)
        assert -1e-5 <= gap <= 1e-3, gap
