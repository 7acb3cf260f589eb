"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip without a CUDA device.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: rulebooks and FPS indices must be equal; fp32 convs within
1e-4 relative of the largest output (the kernel and the plain matmul sum
27*C products in different orders); bf16 convs within 2 bf16 ulps of the
largest output (both round one fp32 sum to bf16).
"""
import numpy as np
import pytest
import torch

from uni3detr_tpu_torch.ops import fps, sparse_conv_cuda as sc
from uni3detr_tpu_torch.ops.sparse_conv import (
    downsample_sites, linear_ids, strided_query_ids, subm_query_ids)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sites(rng, grid, n, V):
    """n distinct sorted sites in a V-row list (invalid rows last)."""
    D, H, W = grid
    lin = np.sort(rng.choice(D * H * W, size=n, replace=False))
    coords = np.full((V, 3), -1, np.int64)
    coords[:n] = np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)
    mask = np.zeros(V, bool)
    mask[:n] = True
    return (torch.from_numpy(coords).int()[None],
            torch.from_numpy(mask)[None])


def _conv_close(out, ref, dtype):
    scale = ref.float().abs().max().item() + 1e-6
    tol = 1e-4 if dtype == torch.float32 else 2 * 2.0 ** -8
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("n,V", [(300, 320), (5000, 6000)])
def test_match_positions_kernel(dev, n, V):
    grid = (16, 40, 40)
    coords, mask = _sites(np.random.RandomState(n), grid, n, V)
    ids = linear_ids(coords, mask, grid)
    q = subm_query_ids(coords, mask, grid)
    q[0, ::7, 3] = -1
    ref = sc.match_positions_plain(ids, q, V)
    got = sc.match_positions(ids.to(dev), q.to(dev), V)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert (ref == V).any() and (ref < V).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout", [(4, 16), (16, 16), (32, 32),
                                    (128, 128), (5, 70)])
def test_gather_conv_kernel(dev, dtype, C, Cout):
    rng = np.random.RandomState(C + Cout)
    grid = (16, 40, 40)
    V = 2000
    coords, mask = _sites(rng, grid, 1800, V)
    ids = linear_ids(coords, mask, grid)
    nb = sc.match_positions_plain(ids, subm_query_ids(coords, mask, grid), V)
    feats = (torch.from_numpy(rng.randn(1, V, C).astype(np.float32))
             * mask[..., None]).to(dtype)
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    ref = sc.gather_conv_plain(feats.to(dev), nb.to(dev), w.to(dev))
    got = sc.gather_conv(feats.to(dev), nb.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _conv_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_ids_kernel(dev, dtype):
    rng = np.random.RandomState(3)
    grid = (16, 40, 40)
    V, C, Cout = 3000, 16, 32
    coords, mask = _sites(rng, grid, 2500, V)
    oc, om, og = downsample_sites(coords, mask, grid, (0, 1, 1), 1024)
    ids = linear_ids(coords, mask, grid)
    sq = strided_query_ids(oc, om, grid, (0, 1, 1))
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    args = [t.to(dev) for t in (feats, ids, sq, w)]
    ref = sc.gather_conv_ids_plain(*args)
    got = sc.gather_conv_ids(*args)
    torch.cuda.synchronize()
    _conv_close(got, ref, dtype)


def test_fps_pair_kernel(dev):
    rng = np.random.RandomState(5)
    xa = torch.from_numpy(rng.randn(2, 3000, 3).astype(np.float32))
    ma = torch.ones(2, 3000, dtype=torch.bool)
    ma[1, 2000:] = False
    xb = torch.from_numpy(rng.randint(0, 20, (2, 500, 3)).astype(np.float32))
    mb = torch.zeros(2, 500, dtype=torch.bool)
    mb[:, :40] = True                    # 40 valid points, 64 samples
    ra = fps.farthest_point_sample_plain(xa, ma, 64)
    rb = fps.farthest_point_sample_plain(xb, mb, 64)
    ga, gb = fps.farthest_point_sample_pair(xa.to(dev), ma.to(dev),
                                            xb.to(dev), mb.to(dev), 64)
    torch.cuda.synchronize()
    assert torch.equal(ga.cpu(), ra) and torch.equal(gb.cpu(), rb)
    assert (ra[1] < 2000).all() and (rb < 40).all()


def test_cuda_wrappers_reject_cpu_mix(dev):
    ids = torch.zeros(1, 8, dtype=torch.int32)
    q = torch.zeros(1, 8, 27, dtype=torch.int32)
    with pytest.raises(ValueError):
        sc.match_positions(ids.to(dev), q, 8)
