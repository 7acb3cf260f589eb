"""The port's kernel modules against the JAX package, on the CPU.

Each of K1-K4 has a plain PyTorch version in the port (the path a CPU
tensor takes); here it meets the JAX Pallas kernel it replaces, run in
interpret mode, and the JAX XLA reference, on the same inputs made with
numpy. Tolerances: rulebooks and FPS indices equal; fp32 convs within
atol 1e-5 (the same products summed in another order); bf16 convs
within one bf16 ulp of the output (both round one fp32 sum).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from uni3detr_tpu.ops import fps as jfps
from uni3detr_tpu.ops import sparse_conv as jsc
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu_torch.ops import fps as tfps
from uni3detr_tpu_torch.ops import sparse_conv as tsc
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk

GRID = (6, 8, 10)


def _sites(rng, n, V):
    """n unique sites of GRID sorted by linear id, padded to V rows."""
    D, H, W = GRID
    lin = np.sort(rng.choice(D * H * W, size=n, replace=False))
    coords = np.full((V, 3), -1, np.int32)
    coords[:n] = np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)
    mask = np.zeros(V, bool)
    mask[:n] = True
    return coords, mask


def _both(coords, mask):
    return ((jnp.asarray(coords), jnp.asarray(mask)),
            (torch.from_numpy(coords)[None], torch.from_numpy(mask)[None]))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_match_positions_matches_pallas(kind):
    rng = np.random.RandomState(31)
    coords, mask = _sites(rng, 150, 160)      # 10 INT_MAX pad rows
    (cj, mj), (ct, mt) = _both(coords, mask)
    ids = jsc.linear_ids(cj, mj, GRID)[None]
    if kind == "subm":
        q = np.array(jsc.subm_query_ids(cj, mj, GRID))
        q[::5, 2] = -1                          # extra missing queries
        ref_xla = np.asarray(jsc.subm_neighbor_idx(cj, mj, GRID))
        ref_xla = np.where(q < 0, 160, ref_xla)
    else:
        oc, om, _ = jsc.downsample_sites(cj, mj, GRID, (1, 1, 1), 96)
        q = np.asarray(jsc.strided_query_ids(oc, om, GRID, (1, 1, 1)))
        ref_xla = np.asarray(jsc.strided_neighbor_idx(
            oc, om, cj, mj, GRID, (1, 1, 1)))
    pallas = np.asarray(jpl.match_positions(ids, jnp.asarray(q)[None], 160,
                                            interpret=True))
    tids = tsc.linear_ids(ct, mt, GRID)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    got = tk.match_positions_plain(tids, _t(q)[None], 160).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got[0], ref_xla)
    assert (got == 160).any() and (got < 160).any()


@pytest.mark.parametrize("C,Cout", [(4, 16), (8, 8), (16, 24)])
def test_gather_conv_matches_pallas(C, Cout):
    """Submanifold rulebook incl. dummy rows; C=4 is the conv_input."""
    rng = np.random.RandomState(C)
    coords, mask = _sites(rng, 150, 160)
    (cj, mj), _ = _both(coords, mask)
    nb = jsc.subm_neighbor_idx(cj, mj, GRID)[None]
    feats = (rng.randn(1, 160, C) * mask[None, :, None]).astype(np.float32)
    w = (rng.randn(27, C, Cout) * 0.1).astype(np.float32)
    pallas = np.asarray(jpl._gather_conv_pallas_raw(
        jnp.asarray(feats), nb, jnp.asarray(w), interpret=True))
    xla = np.asarray(jpl._xla_gather_conv(jnp.asarray(feats), nb,
                                          jnp.asarray(w)))
    got = tk.gather_conv_plain(_t(feats), _t(nb), _t(w)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


def test_gather_conv_bf16_matches_xla():
    rng = np.random.RandomState(4)
    coords, mask = _sites(rng, 150, 160)
    (cj, mj), _ = _both(coords, mask)
    nb = jsc.subm_neighbor_idx(cj, mj, GRID)[None]
    feats = rng.randn(1, 160, 16).astype(np.float32)
    w = (rng.randn(27, 16, 16) * 0.1).astype(np.float32)
    xla = np.asarray(jpl._xla_gather_conv(
        jnp.asarray(feats, jnp.bfloat16), nb, jnp.asarray(w)
    ).astype(jnp.float32))
    got = tk.gather_conv_plain(_t(feats).bfloat16(), _t(nb), _t(w))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) of each output
    np.testing.assert_allclose(got.float().numpy(), xla, rtol=2.0 ** -8,
                               atol=1e-6)


@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)])
def test_gather_conv_ids_matches_pallas(padding):
    """Strided conv by id match (the encoder's downsample convs)."""
    rng = np.random.RandomState(13)
    coords, mask = _sites(rng, 120, 128)
    (cj, mj), (ct, mt) = _both(coords, mask)
    oc, om, _ = jsc.downsample_sites(cj, mj, GRID, padding, 96)
    ids = jsc.linear_ids(cj, mj, GRID)[None]
    sq = jsc.strided_query_ids(oc, om, GRID, padding)[None]
    sidx = jsc.strided_neighbor_idx(oc, om, cj, mj, GRID, padding)[None]
    feats = (rng.randn(1, 128, 4) * mask[None, :, None]).astype(np.float32)
    w = (rng.randn(27, 4, 8) * 0.1).astype(np.float32)
    pallas = np.asarray(jpl._raw_idmatch(jnp.asarray(feats), ids, sq,
                                         jnp.asarray(w), interpret=True))
    xla = np.asarray(jpl._xla_gather_conv(jnp.asarray(feats), sidx,
                                          jnp.asarray(w)))
    toc, tom, _ = tsc.downsample_sites(ct, mt, GRID, padding, 96)
    tsq = tsc.strided_query_ids(toc, tom, GRID, padding)
    np.testing.assert_array_equal(tsq.numpy(), np.asarray(sq))
    got = tk.gather_conv_ids_plain(_t(feats), _t(ids), tsq, _t(w)).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


def test_fps_pair_matches_pallas():
    """Masked points, a set with fewer valid points than samples
    (duplicates), and integer coordinates full of distance ties."""
    rng = np.random.RandomState(11)
    xa = rng.randn(2, 230, 3).astype(np.float32)
    ma = np.ones((2, 230), bool)
    ma[0, 200:] = False
    xb = rng.randint(0, 6, (2, 90, 3)).astype(np.float32)
    mb = np.zeros((2, 90), bool)
    mb[0, :60] = True
    mb[1, :10] = True                          # 10 valid, 16 samples
    ia, ib = jfps.farthest_point_sample_pair_pallas(
        jnp.asarray(xa), jnp.asarray(ma), jnp.asarray(xb), jnp.asarray(mb),
        16, interpret=True)
    ra = jfps.farthest_point_sample_xla(jnp.asarray(xa), jnp.asarray(ma), 16)
    ga, gb = tfps.farthest_point_sample_pair(_t(xa), _t(ma), _t(xb), _t(mb),
                                             16)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ia))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(ib))
    assert (gb[1].numpy() < 10).all()
    assert len(set(gb[1].tolist())) < 16         # exhausted -> duplicates


def test_cpu_wrappers_take_the_plain_path():
    rng = np.random.RandomState(2)
    coords, mask = _sites(rng, 60, 64)
    _, (ct, mt) = _both(coords, mask)
    ids = tsc.linear_ids(ct, mt, GRID)
    q = tsc.subm_query_ids(ct, mt, GRID)
    feats = torch.from_numpy(rng.randn(1, 64, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 4, 8).astype(np.float32))
    before = (tk.match_positions.launches, tk.gather_conv.launches,
              tk.gather_conv_ids.launches)
    nb = tk.match_positions(ids, q, 64)
    assert torch.equal(nb, tk.match_positions_plain(ids, q, 64))
    assert torch.equal(tk.gather_conv(feats, nb, w),
                       tk.gather_conv_plain(feats, nb, w))
    assert torch.equal(tk.gather_conv_ids(feats, ids, q, w),
                       tk.gather_conv_ids_plain(feats, ids, q, w))
    assert (tk.match_positions.launches, tk.gather_conv.launches,
            tk.gather_conv_ids.launches) == before
    with pytest.raises(ValueError):
        tk.gather_conv(feats.double(), nb, w)
    with pytest.raises(ValueError):
        tk.match_positions(ids.long(), q, 64)
