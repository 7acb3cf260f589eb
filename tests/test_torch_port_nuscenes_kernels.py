"""The port's kernels against the TPU kernels that only big-voxel stages
reach (``uni3detr_nuscenes``: V=120000 at eval, 90000 in training), on
the CPU.

The TPU runs a lane-packed form of a conv kernel when its feature table
does not fit VMEM: K5 ``_raw_packed`` (K2's conv), K6 ``_rows_packed``
(K7's dW rows), K8 ``_raw_idmatch_packed`` (K3's conv) and K9
``_rows_idmatch_packed`` (K10's dW rows). On the card those fold into
K2/K3/K7/K10, whose plain versions are held here against the packed
Pallas kernels in interpret mode, at small sizes. K11, the single-set
FPS, is held against both JAX versions.

Tolerances: fp32 convs within atol 1e-5 (the same products summed in
another order); dW within 1e-5 of its largest entry (fp32 sums over all
rows); FPS indices equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from uni3detr_tpu.ops import fps as jfps
from uni3detr_tpu.ops import sparse_conv as jsc
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu_torch.ops import fps as tfps
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk
from test_torch_port_kernels import GRID, _both, _sites, _t


def _subm(rng, C):
    coords, mask = _sites(rng, 150, 160)
    (cj, mj), _ = _both(coords, mask)
    nb = jsc.subm_neighbor_idx(cj, mj, GRID)[None]
    feats = (rng.randn(1, 160, C) * mask[None, :, None]).astype(np.float32)
    return nb, feats


def _strided(rng, C):
    coords, mask = _sites(rng, 120, 128)
    (cj, mj), _ = _both(coords, mask)
    oc, om, _ = jsc.downsample_sites(cj, mj, GRID, (1, 1, 1), 96)
    ids = jsc.linear_ids(cj, mj, GRID)[None]
    sq = jsc.strided_query_ids(oc, om, GRID, (1, 1, 1))[None]
    feats = (rng.randn(1, 128, C) * mask[None, :, None]).astype(np.float32)
    return ids, sq, feats


def _dw_from_rows(rows, g):
    """dW (K, C, Cout) from gathered rows (B, Vout, K*C), fp32."""
    r = np.asarray(rows, np.float32).reshape(-1, rows.shape[-1])
    return (r.T @ g.reshape(-1, g.shape[-1])).reshape(27, -1, g.shape[-1])


def _dw_close(got, ref):
    scale = max(np.abs(ref).max(), 1e-6)
    assert np.abs(np.asarray(got) - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("C", [4, 16])
def test_gather_conv_matches_packed_pallas(C):
    """K2's plain version against K5."""
    rng = np.random.RandomState(40 + C)
    nb, feats = _subm(rng, C)
    w = (rng.randn(27, C, 16) * 0.1).astype(np.float32)
    packed = np.asarray(jpl._raw_packed(jnp.asarray(feats), nb,
                                        jnp.asarray(w), interpret=True))
    got = tk.gather_conv_plain(_t(feats), _t(nb), _t(w)).numpy()
    np.testing.assert_allclose(got, packed, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [4, 16])
def test_gather_conv_dw_matches_packed_rows(C):
    """K7's plain version against the dW of K6's gathered rows."""
    rng = np.random.RandomState(50 + C)
    nb, feats = _subm(rng, C)
    g = rng.randn(1, 160, 8).astype(np.float32)
    rows = jpl._rows_packed(jnp.asarray(feats), nb, interpret=True)
    got = tk.gather_conv_dw_plain(_t(feats), _t(nb), _t(g))
    _dw_close(got, _dw_from_rows(rows, g))


@pytest.mark.parametrize("C", [4, 16])
def test_gather_conv_ids_matches_packed_pallas(C):
    """K3's plain version against K8, on a strided conv's query ids."""
    rng = np.random.RandomState(60 + C)
    ids, sq, feats = _strided(rng, C)
    w = (rng.randn(27, C, 8) * 0.1).astype(np.float32)
    packed = np.asarray(jpl._raw_idmatch_packed(
        jnp.asarray(feats), ids, sq, jnp.asarray(w), interpret=True))
    got = tk.gather_conv_ids_plain(_t(feats), _t(ids), _t(sq), _t(w))
    np.testing.assert_allclose(got.numpy(), packed, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [4, 16])
def test_gather_conv_ids_dw_matches_packed_rows(C):
    """K10's plain version against the dW of K9's gathered rows."""
    rng = np.random.RandomState(70 + C)
    ids, sq, feats = _strided(rng, C)
    g = rng.randn(1, sq.shape[1], 8).astype(np.float32)
    rows = jpl._rows_idmatch_packed(jnp.asarray(feats), ids, sq,
                                    interpret=True)
    got = tk.gather_conv_ids_dw_plain(_t(feats), _t(ids), _t(sq), _t(g))
    _dw_close(got, _dw_from_rows(rows, g))


def test_fps_matches_pallas_and_xla():
    """K11: masked points, a set with fewer valid points than samples
    (duplicates), and integer coordinates full of distance ties."""
    rng = np.random.RandomState(12)
    xyz = rng.randint(0, 8, (3, 200, 3)).astype(np.float32)
    xyz[0] = rng.randn(200, 3)
    mask = np.ones((3, 200), bool)
    mask[1, 150:] = False
    mask[2, 9:] = False                        # 9 valid, 16 samples
    args = (jnp.asarray(xyz), jnp.asarray(mask), 16)
    pallas = np.asarray(jfps.farthest_point_sample_pallas(*args,
                                                          interpret=True))
    xla = np.asarray(jfps.farthest_point_sample_xla(*args))
    before = tfps.farthest_point_sample.launches
    got = tfps.farthest_point_sample(_t(xyz), _t(mask), 16)
    assert tfps.farthest_point_sample.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    assert (got[2] < 9).all() and len(set(got[2].tolist())) < 16
    with pytest.raises(ValueError):
        tfps.farthest_point_sample(_t(xyz), _t(mask[:, :10]), 16)
