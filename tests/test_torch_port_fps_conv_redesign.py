"""The FPS (K4/K11) and gather-conv (K2/K3) kernels of the port as
redesigned for the H100, checked on the CPU.

- FPS: the kernel splits every set into contiguous slices, one per block
  of a grid that spans the card, takes each slice's argmax and merges
  the slices' candidates by (value descending, index ascending). A plain
  PyTorch model of that reduction, written here, must give the indices
  of the JAX package's XLA sampler and of its Pallas kernel (interpret
  mode) exactly, for any number of slices and any merge order.
- The roofline helper of ``chip_smoke.py`` against hand-worked values.
- The plain gather conv (what a CPU tensor runs) against the JAX
  package in bf16 at the widths the tensor-core kernel stages specially:
  4, 5 and 8 input channels and rows whose 27 neighbours are all
  missing. Tolerance: one bf16 ulp of each output (both sides round one
  fp32 sum of exact products).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from uni3detr_tpu.ops import fps as jfps
from uni3detr_tpu.ops import sparse_conv as jsc
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu_torch.ops import fps as tfps
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk

INT_MAX = 2 ** 31 - 1


def _beats(ov, oi, v, i):
    return ov > v or (ov == v and oi < i)


def sliced_fps(xyz, mask, num_samples, n_slices, order):
    """The kernel's reduction in plain PyTorch: each step updates the
    min distances, takes the first maximum of each of ``n_slices``
    contiguous slices, then merges the candidates in the slice order
    ``order`` by (value descending, index ascending)."""
    B, N, _ = xyz.shape
    L = -(-N // n_slices)
    mind = torch.where(mask, torch.tensor(1e10), torch.tensor(-1.0))
    idx = torch.zeros((B, num_samples), dtype=torch.int32)
    for b in range(B):
        last = 0
        for s in range(1, num_samples):
            diff = xyz[b] - xyz[b, last]
            d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
                + diff[:, 2] * diff[:, 2]
            mind[b] = torch.where(mask[b], torch.minimum(mind[b], d),
                                  mind[b])
            cands = []
            for p in range(n_slices):
                lo, hi = min(p * L, N), min(p * L + L, N)
                if lo == hi:
                    cands.append((float("-inf"), INT_MAX))
                    continue
                j = int(torch.argmax(mind[b, lo:hi]))   # first maximum
                cands.append((float(mind[b, lo + j]), lo + j))
            v, i = float("-inf"), INT_MAX
            for p in order:
                if _beats(*cands[p], v, i):
                    v, i = cands[p]
            idx[b, s] = last = i
    return idx


def _tie_set(rng, B, N, n_valid, span):
    """Integer coordinates in [0, span): distance ties everywhere, also
    between slices; the first n_valid[b] points valid."""
    xyz = rng.randint(0, span, (B, N, 3)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    for b, n in enumerate(n_valid):
        mask[b, :n] = True
    return xyz, mask


@pytest.mark.parametrize("n_slices", [1, 7, 132])
def test_sliced_fps_reduction_matches_jax(n_slices):
    """Ties across slice edges, a masked tail, a set with fewer valid
    points than samples (duplicates), and N not a multiple of the slice
    length; the merge runs in a shuffled slice order."""
    rng = np.random.RandomState(n_slices)
    S = 24
    xyz, mask = _tie_set(rng, 2, 301, [280, 15], 4)
    order = rng.permutation(n_slices)
    got = sliced_fps(torch.from_numpy(xyz), torch.from_numpy(mask), S,
                     n_slices, order)
    xla = np.asarray(jfps.farthest_point_sample_xla(
        jnp.asarray(xyz), jnp.asarray(mask), S))
    pallas = np.asarray(jfps.farthest_point_sample_pallas(
        jnp.asarray(xyz), jnp.asarray(mask), S, interpret=True))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    plain = tfps.farthest_point_sample_plain(torch.from_numpy(xyz),
                                             torch.from_numpy(mask), S)
    np.testing.assert_array_equal(plain.numpy(), xla)
    assert (got[0] < 280).all() and (got[1] < 15).all()
    assert len(set(got[1].tolist())) < S                 # duplicates


@pytest.mark.parametrize("sizes,batch,in_smem", [
    ((300000, 120000), 1, True),     # nuScenes eval: 51 KB a block
    ((300000, 90000), 4, True),      # nuScenes train B=4: 189 KB
    ((300000, 120000), 8, False),    # 407 KB: streamed slices
    ((100000, 40000), 1, True),      # SUN RGB-D
])
def test_fps_plan_picks_shared_or_streamed_slices(sizes, batch, in_smem):
    """One block per SM; the slices stay in shared memory when 16 bytes
    a point fit the 227,840 bytes a block of the H100 kernel may take."""
    grid, got = tfps.fps_plan(sizes, batch, 132, 232448 - 4608)
    assert grid == 132 and got == in_smem


@pytest.mark.parametrize("pair,B,launches", [
    (True, 5, 3), (True, 2, 1), (False, 5, 2), (False, 4, 1)])
def test_fps_wrappers_split_the_batch_by_problems_per_launch(
        monkeypatch, pair, B, launches):
    """With at most 4 problems (sets x batch elements) a launch, the
    wrappers run the batch in chunks, count each launch and put the
    chunks' indices back in batch order. The launch is replaced by one
    that runs the plain sampler on the chunk it is given."""
    def launch(name, sets, S):
        assert len(sets) * sets[0][0].shape[0] <= 4
        return torch.cat([tfps.farthest_point_sample_plain(x, m, S)
                          for x, m in sets])

    monkeypatch.setattr(tfps, "_device_limits", lambda index: (132, 0, 4))
    monkeypatch.setattr(tfps, "_check_sets", lambda name, sets: False)
    monkeypatch.setattr(tfps, "_fps_launch", launch)
    rng = np.random.RandomState(16)
    xa, ma = (torch.from_numpy(a) for a in _tie_set(
        rng, B, 97, [97 - 9 * b for b in range(B)], 5))
    xb, mb = (torch.from_numpy(a) for a in _tie_set(rng, B, 41, [41] * B, 4))
    S = 12
    if pair:
        wrapper = tfps.farthest_point_sample_pair
        before = wrapper.launches
        got = wrapper(xa, ma, xb, mb, S)
        want = (tfps.farthest_point_sample_plain(xa, ma, S),
                tfps.farthest_point_sample_plain(xb, mb, S))
    else:
        wrapper = tfps.farthest_point_sample
        before = wrapper.launches
        got = (wrapper(xa, ma, S),)
        want = (tfps.farthest_point_sample_plain(xa, ma, S),)
    assert wrapper.launches == before + launches
    for g, w in zip(got, want):
        assert g.shape == (B, S) and torch.equal(g, w)


@pytest.mark.parametrize("case,ops,nbytes,bound_ms,bound_by", [
    # K2 at 18000 sites, 128 -> 128, every offset present:
    # 2 * 18000 * 27 * 128 * 128 products; bf16 features in and out, the
    # weights, the int32 rulebook
    ("k2", 15_925_248_000, 2 * (2 * 18000 * 128 + 27 * 128 * 128)
     + 4 * 18000 * 27, 15_925_248_000 / 989e12 * 1e3, "operations"),
    # K2 at 120000 sites, 16 -> 16: the rulebook's bytes bind
    ("k2_narrow", 2 * 120000 * 27 * 16 * 16,
     2 * (2 * 120000 * 16 + 27 * 16 * 16) + 4 * 120000 * 27,
     20_653_824 / 3.35e12 * 1e3, "bytes"),
    # K4 at the nuScenes eval shapes: 9 fp32 operations per point and
    # step over 899 steps; 13 bytes a point, 900 indices per set
    ("k4", 9 * 420000 * 899, 13 * 420000 + 4 * 900 * 2,
     3_398_220_000 / 67e12 * 1e3, "operations"),
    # K7 at B=4 x 90000 sites, 16 -> 16, every offset present: bf16 rows
    # and cotangents are exact in fp32, so the bf16 tensor-core rate
    # bounds the products and the int32 index's bytes bind
    ("k7_bf16", 2 * 4 * 90000 * 27 * 16 * 16,
     2 * (2 * 4 * 90000 * 16) + 4 * 4 * 90000 * 27 + 4 * 27 * 16 * 16,
     61_947_648 / 3.35e12 * 1e3, "bytes"),
    # the same in fp32: the CUDA-core rate binds
    ("k7_fp32", 2 * 4 * 90000 * 27 * 16 * 16,
     4 * (2 * 4 * 90000 * 16) + 4 * 4 * 90000 * 27 + 4 * 27 * 16 * 16,
     4_976_640_000 / 67e12 * 1e3, "operations"),
])
def test_roofline_helper_hand_worked(case, ops, nbytes, bound_ms, bound_by):
    if case == "k2":
        r = chip_smoke.conv_roofline(18000 * 27, 18000, 128, 18000, 27, 128)
    elif case == "k2_narrow":
        r = chip_smoke.conv_roofline(120000 * 27, 120000, 16, 120000, 27,
                                     16)
    elif case == "k4":
        r = chip_smoke.fps_roofline([300000, 120000], [300000, 120000], 900)
    else:
        r = chip_smoke.dw_roofline(4 * 90000 * 27, 90000, 16, 90000, 27, 16,
                                   4, elem=2 if case == "k7_bf16" else 4)
    assert r["ops"] == ops and r["bytes"] == nbytes
    assert r["bound_ms"] == pytest.approx(bound_ms, rel=1e-12)
    assert r["bound_by"] == bound_by
    if case == "k2":
        assert r["bytes"] == 12_044_736 and 0.0160 < r["bound_ms"] < 0.0162
    if case == "k4":
        assert 0.0507 < r["bound_ms"] < 0.0508


GRID = (6, 8, 10)


@pytest.mark.parametrize("C", [4, 5, 8])
def test_gather_conv_plain_bf16_narrow_rows_match_jax(C):
    """bf16 gather conv at C in {4, 5, 8} -> 16 with missing neighbours,
    one row with all 27 missing and padded rows (all 27 missing), against
    the JAX package's XLA formulation."""
    rng = np.random.RandomState(40 + C)
    D, H, W = GRID
    lin = np.sort(rng.choice(D * H * W, size=150, replace=False))
    coords = np.full((160, 3), -1, np.int32)
    coords[:150] = np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)
    mask = np.zeros(160, bool)
    mask[:150] = True
    nb = np.array(jsc.subm_neighbor_idx(jnp.asarray(coords),
                                        jnp.asarray(mask), GRID))[None]
    nb[0, 3] = 160                       # a row with no neighbour at all
    feats = rng.randn(1, 160, C).astype(np.float32)
    w = (rng.randn(27, C, 16) * 0.2).astype(np.float32)
    xla = np.asarray(jpl._xla_gather_conv(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(nb), jnp.asarray(w)
    ).astype(jnp.float32))
    got = tk.gather_conv_plain(torch.from_numpy(feats).bfloat16(),
                               torch.from_numpy(nb), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of each output: 2^(e - 7) for |x| in [2^e, 2^(e+1))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(xla), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - xla) <= ulp).all()
    assert (got[0, 3] == 0).all() and (got[0, 150:] == 0).all()
    assert (nb[0, :150] == 160).sum() > 0
