"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip without a CUDA device.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: rulebooks, FPS indices and auction assignments must be
equal; fp32 convs within 1e-4 relative of the largest output (the kernel
and the plain matmul sum 27*C products in different orders); bf16 convs
within 2 bf16 ulps of the largest output (both round one fp32 sum to
bf16); weight gradients (fp32 sums over all rows, in another order)
within 1e-4 relative of the largest entry, for bf16 and fp32 inputs
alike, since bf16 rows and cotangents widen to fp32 exactly.
"""
import os

import numpy as np
import pytest
import torch

from uni3detr_tpu_torch.ops import fps, matching, sparse_conv_cuda as sc
from uni3detr_tpu_torch.ops.sparse_conv import (
    downsample_sites, linear_ids, strided_inverse_query_ids,
    strided_query_ids, subm_query_ids)

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
    with pytest.raises(ValueError):
        sc.gather_conv_ids_dw(torch.zeros(1, 8, 4, device=dev), ids.to(dev),
                              q, torch.zeros(1, 8, 4, device=dev))


def _dw_close(out, ref):
    scale = ref.abs().max().item() + 1e-6
    err = (out - ref).abs().max().item()
    assert out.dtype == torch.float32 and err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout,B", [(4, 16, 2), (16, 16, 1), (32, 32, 2),
                                      (128, 128, 1), (5, 70, 1)])
def test_gather_conv_dw_kernel(dev, dtype, C, Cout, B):
    rng = np.random.RandomState(C + 7 * Cout)
    grid = (16, 40, 40)
    V = 2500
    parts = [_sites(rng, grid, 2300, V) for _ in range(B)]
    coords = torch.cat([p[0] for p in parts])
    mask = torch.cat([p[1] for p in parts])
    nb = sc.match_positions_plain(linear_ids(coords, mask, grid),
                                  subm_query_ids(coords, mask, grid), V)
    feats = torch.from_numpy(rng.randn(B, V, C).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(B, V, Cout).astype(np.float32)).to(dtype)
    args = [t.to(dev) for t in (feats, nb, g)]
    ref = sc.gather_conv_dw_plain(*args)
    got = sc.gather_conv_dw(*args)
    torch.cuda.synchronize()
    _dw_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_ids_dw_kernel(dev, dtype):
    rng = np.random.RandomState(4)
    grid = (16, 40, 40)
    V, C, Cout = 3000, 32, 64
    coords, mask = _sites(rng, grid, 2500, V)
    oc, om, og = downsample_sites(coords, mask, grid, (1, 1, 1), 1024)
    ids = linear_ids(coords, mask, grid)
    sq = strided_query_ids(oc, om, grid, (1, 1, 1))
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(1, 1024, Cout).astype(np.float32)
                         ).to(dtype)
    args = [t.to(dev) for t in (feats, ids, sq, g)]
    ref = sc.gather_conv_ids_dw_plain(*args)
    got = sc.gather_conv_ids_dw(*args)
    torch.cuda.synchronize()
    _dw_close(got, ref)


def test_conv_fns_backward_on_card_match_cpu(dev):
    """GatherConvFn / GatherConvIdsFn on the card (K2/K3 for dfeats,
    K7/K10 for dW) against the same Functions on the CPU (plain)."""
    rng = np.random.RandomState(6)
    grid = (16, 40, 40)
    V = 2000
    coords, mask = _sites(rng, grid, 1800, V)
    ids = linear_ids(coords, mask, grid)
    nb = sc.match_positions_plain(ids, subm_query_ids(coords, mask, grid), V)
    oc, om, og = downsample_sites(coords, mask, grid, (0, 1, 1), 800)
    sq = strided_query_ids(oc, om, grid, (0, 1, 1))
    invq = strided_inverse_query_ids(coords, mask, og, (0, 1, 1))
    oids = linear_ids(oc, om, og)
    feats = torch.from_numpy(rng.randn(1, V, 16).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(27, 16, 16).astype(np.float32) * 0.1)
    w2 = torch.from_numpy(rng.randn(27, 16, 32).astype(np.float32) * 0.1)
    grads = {}
    for where in ("cpu", dev):
        f, a, b = (t.to(where, copy=True).requires_grad_()
                   for t in (feats, w1, w2))
        y = sc.GatherConvFn.apply(f, nb.to(where), a)
        z = sc.GatherConvIdsFn.apply(y, ids.to(where), sq.to(where), b,
                                     invq.to(where), oids.to(where))
        (z.float() ** 2).sum().backward()
        grads[str(where)] = [t.grad.cpu() for t in (f, a, b)]
    torch.cuda.synchronize()
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        _dw_close(got, ref)


def _duplicated_benefit(rng, G, M, N, n_real):
    """KITTI-like instances: gt_repeat=5 duplicated bidders, -1e6 dummy
    items, as match_queries_to_gt pads them."""
    base = rng.randn(G, M // 5 + 1, n_real)
    b = np.full((G, M, N), -1e6)
    b[:, :, :n_real] = np.tile(base, (1, 5, 1))[:, :M] \
        + 1e-6 * rng.randn(G, M, n_real)
    b = torch.from_numpy(b.astype(np.float32))
    flat = b[:, :, :n_real].reshape(G, -1)
    return b, (flat.amax(1) - flat.amin(1)).clamp(min=1e-6)


@pytest.mark.parametrize("G,M,N,eps_div", [(12, 64, 384, 2048.0),
                                           (10, 256, 384, 512.0)])
def test_auction_kernel_equals_plain(dev, G, M, N, eps_div):
    """SUN RGB-D (benefit in shared memory) and KITTI (benefit in global
    memory) instance shapes."""
    b, spread = _duplicated_benefit(np.random.RandomState(M), G, M, N, 300)
    ref = matching.auction_lap_plain(b.to(dev), spread.to(dev), eps_div)
    got = matching.auction_lap(b.to(dev), spread.to(dev), eps_div)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.cpu())
    assert (ref >= 0).all()


# -- big voxel sets (uni3detr_nuscenes): where the TPU runs K5/K6/K8/K9 ------

BIG_GRID = (16, 200, 200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout", [(5, 16), (16, 16), (32, 32)])
def test_gather_conv_kernel_big_v(dev, dtype, C, Cout):
    """K2 at V=60000 (the TPU's K5 above ~48.5k sites)."""
    rng = np.random.RandomState(C + 3 * Cout)
    V = 60000
    coords, mask = _sites(rng, BIG_GRID, 55000, V)
    ids = linear_ids(coords, mask, BIG_GRID)
    nb = sc.match_positions_plain(ids, subm_query_ids(coords, mask,
                                                      BIG_GRID), V)
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    args = [t.to(dev) for t in (feats, nb, w)]
    ref = sc.gather_conv_plain(*args)
    got = sc.gather_conv(*args)
    torch.cuda.synchronize()
    _conv_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_ids_kernels_big_v(dev, dtype):
    """K3 and K10 from V_in=60000 (the TPU's K8/K9 territory)."""
    rng = np.random.RandomState(8)
    V, C, Cout = 60000, 16, 32
    coords, mask = _sites(rng, BIG_GRID, 55000, V)
    oc, om, og = downsample_sites(coords, mask, BIG_GRID, (1, 1, 1), 50000)
    ids = linear_ids(coords, mask, BIG_GRID)
    sq = strided_query_ids(oc, om, BIG_GRID, (1, 1, 1))
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    g = torch.from_numpy(rng.randn(1, 50000, Cout).astype(np.float32)
                         ).to(dtype)
    f, i, q, w, g = (t.to(dev) for t in (feats, ids, sq, w, g))
    _conv_close(sc.gather_conv_ids(f, i, q, w),
                sc.gather_conv_ids_plain(f, i, q, w), dtype)
    _dw_close(sc.gather_conv_ids_dw(f, i, q, g),
              sc.gather_conv_ids_dw_plain(f, i, q, g))
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,Cout", [(5, 16), (16, 16)])
def test_gather_conv_dw_kernel_big_v(dev, C, Cout):
    """K7 at B=2, V=60000 (the TPU's K6 above ~48.5k sites)."""
    rng = np.random.RandomState(C + 5 * Cout)
    V = 60000
    parts = [_sites(rng, BIG_GRID, 55000, V) for _ in range(2)]
    coords = torch.cat([p[0] for p in parts])
    mask = torch.cat([p[1] for p in parts])
    nb = sc.match_positions_plain(linear_ids(coords, mask, BIG_GRID),
                                  subm_query_ids(coords, mask, BIG_GRID), V)
    feats = torch.from_numpy(rng.randn(2, V, C).astype(np.float32)
                             ).bfloat16()
    g = torch.from_numpy(rng.randn(2, V, Cout).astype(np.float32)).bfloat16()
    args = [t.to(dev) for t in (feats, nb, g)]
    _dw_close(sc.gather_conv_dw(*args), sc.gather_conv_dw_plain(*args))
    torch.cuda.synchronize()


def test_fps_kernel(dev):
    """K11: masked points and an exhausted set (duplicates)."""
    rng = np.random.RandomState(9)
    xyz = torch.from_numpy(rng.randn(3, 20000, 3).astype(np.float32))
    xyz[2, :50] = torch.from_numpy(rng.randint(0, 4, (50, 3)).astype(
        np.float32))
    mask = torch.ones(3, 20000, dtype=torch.bool)
    mask[1, 15000:] = False
    mask[2, 50:] = False                   # 50 valid points, 128 samples
    ref = fps.farthest_point_sample_plain(xyz, mask, 128)
    before = fps.farthest_point_sample.launches
    got = fps.farthest_point_sample(xyz.to(dev), mask.to(dev), 128)
    torch.cuda.synchronize()
    assert fps.farthest_point_sample.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    assert (ref[1] < 15000).all() and (ref[2] < 50).all()


def test_tiny_nuscenes_forward_on_card_matches_cpu(dev):
    """The nuScenes grid, budgets, point features, 900 queries and
    10-dim code at tiny widths, fp32, TF32 off: voxels and FPS equal;
    the first decoder layer's outputs within 1e-3 (sums in another order
    through ~20 convs), and 99% of all layers' outputs: under random
    weights the later layers amplify such differences through their
    reference-point updates (see chip_smoke.py, fp32_phase)."""
    import dataclasses
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import NUSCENES, TINY_SYNTHETIC
    from uni3detr_tpu_torch.synthetic import clustered_scene
    from uni3detr_tpu_torch.weights import random_state_dict

    widths = ("encoder_base_channels", "encoder_out_channels",
              "encoder_channels", "backbone_channels", "backbone_layers",
              "neck_channels", "embed_dim", "num_heads", "ffn_dim")
    cfg = dataclasses.replace(
        NUSCENES, compute_dtype="float32",
        **{k: getattr(TINY_SYNTHETIC, k) for k in widths})
    torch.backends.cudnn.allow_tf32 = False
    model = Uni3DETR(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 1).items()})
    pts, rnd = (torch.from_numpy(a) for a in clustered_scene(2, cfg))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    res = []
    try:
        for where in ("cpu", dev):
            model.to(where)
            outs, inter = model(pts.to(where), mask.to(where),
                                rnd.to(where), return_intermediates=True)
            res.append(({k: v.cpu() for k, v in outs.items()},
                        inter["coords"].cpu(),
                        [i.cpu() for i in inter["fps_idx"]]))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    (oc, cc, fc), (og, cg, fg) = res
    assert torch.equal(cc, cg)
    assert all(torch.equal(a, b) for a, b in zip(fc, fg))
    assert tuple(og["all_bbox_preds"].shape) == (3, 1, 3600, 10)
    for k in oc:
        err = (og[k] - oc[k]).abs()
        assert err[0].max().item() <= 1e-3, k
        assert (err <= 1e-3).float().mean().item() >= 0.99, k


def test_voxelize_cell_edges_on_card_match_cpu(dev):
    """Points within an ulp of a cell edge at the nuScenes cell sizes
    land in the same voxels on the card and on the CPU (the voxelizer
    multiplies by the fp32 reciprocal of the cell size, as XLA does for
    the JAX package, on every device)."""
    from uni3detr_tpu_torch.ops.voxelize import hard_voxelize
    from uni3detr_tpu_torch.presets import NUSCENES as cfg

    rng = np.random.RandomState(0)
    x = rng.uniform(-54, 54, (2_000_000, 3)).astype(np.float32)
    d = x - np.float32(-54)
    vs = np.float32(0.075)
    on_edge = np.floor(d / vs) != np.floor(d * (np.float32(1) / vs))
    edge = x[on_edge[:, 0], :1][:64]
    n = len(edge)
    pts = np.concatenate([edge, rng.uniform(-50, 50, (n, 1)),
                          rng.uniform(-4, 2, (n, 3))], -1)
    pts = torch.from_numpy(pts.astype(np.float32))[None]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    kw = dict(pc_range=cfg.pc_range, voxel_size=cfg.voxel_size,
              grid_size=cfg.grid_size, max_points=10, max_voxels=96)
    ref = hard_voxelize(pts, mask, **kw)
    got = hard_voxelize(pts.to(dev), mask.to(dev), **kw)
    torch.cuda.synchronize()
    assert int(ref[2].sum()) > 16
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(),
                                                              ref[2])


# -- the redesigned kernels: K4/K11 over the whole card, K2/K3 on tensor cores

def _tie_sets(rng, B, N, n_valid, span):
    """Integer coordinates in [0, span) (distance ties everywhere, also
    across block slices) with the first n_valid[b] points valid."""
    xyz = torch.from_numpy(rng.randint(0, span, (B, N, 3)).astype(
        np.float32))
    mask = torch.zeros(B, N, dtype=torch.bool)
    for b, n in enumerate(n_valid):
        mask[b, :n] = True
    return xyz, mask


@pytest.mark.parametrize("B,Na,Nb,S", [
    (1, 20000, 7000, 256),      # N not a multiple of the slice size
    (4, 30011, 9001, 200),      # the train batch
    (1, 131, 50, 80),           # fewer points than blocks; 50 < S
])
def test_fps_pair_kernel_ties_masks_exhaustion(dev, B, Na, Nb, S):
    rng = np.random.RandomState(Na + B)
    xa, ma = _tie_sets(rng, B, Na, [Na - 7 * b for b in range(B)], 8)
    xb, mb = _tie_sets(rng, B, Nb, [min(Nb, 60)] + [Nb // 2] * (B - 1), 5)
    ra = fps.farthest_point_sample_plain(xa, ma, S)
    rb = fps.farthest_point_sample_plain(xb, mb, S)
    before = fps.farthest_point_sample_pair.launches
    ga, gb = fps.farthest_point_sample_pair(xa.to(dev), ma.to(dev),
                                            xb.to(dev), mb.to(dev), S)
    torch.cuda.synchronize()
    assert fps.farthest_point_sample_pair.launches == before + 1
    assert torch.equal(ga.cpu(), ra) and torch.equal(gb.cpu(), rb)
    assert (rb[0] < 60).all()


def test_fps_kernels_batch_beyond_one_launch(dev):
    """More problems (sets x batch elements) than one launch takes: the
    wrappers split the batch and count each launch."""
    max_problems = fps._device_limits(torch.cuda.current_device())[2]
    B, S = max_problems // 2 + 2, 40
    rng = np.random.RandomState(15)
    xa, ma = _tie_sets(rng, B, 3001, [3001 - 11 * b for b in range(B)], 8)
    xb, mb = _tie_sets(rng, B, 700, [30] + [700] * (B - 1), 5)
    ra = fps.farthest_point_sample_plain(xa, ma, S)
    rb = fps.farthest_point_sample_plain(xb, mb, S)
    pair0, one0 = (fps.farthest_point_sample_pair.launches,
                   fps.farthest_point_sample.launches)
    ga, gb = fps.farthest_point_sample_pair(xa.to(dev), ma.to(dev),
                                            xb.to(dev), mb.to(dev), S)
    xs = torch.cat([xa, xa[:max_problems + 1 - B]])
    ms = torch.cat([ma, ma[:max_problems + 1 - B]])
    g1 = fps.farthest_point_sample(xs.to(dev), ms.to(dev), S)
    torch.cuda.synchronize()
    assert fps.farthest_point_sample_pair.launches == pair0 + 2
    assert fps.farthest_point_sample.launches == one0 + 2
    assert torch.equal(ga.cpu(), ra) and torch.equal(gb.cpu(), rb)
    assert torch.equal(g1.cpu()[:B], ra) and torch.equal(
        g1.cpu()[B:], ra[:max_problems + 1 - B])


def test_fps_kernels_streamed_slices(dev):
    """Sets too large for the blocks' shared memory take the streamed
    variant of the same kernel."""
    sms, smem_limit, _ = fps._device_limits(torch.cuda.current_device())
    B, Na, Nb, S = 8, 300000, 120000, 48
    assert fps.fps_plan([Na, Nb], B, sms, smem_limit) == (sms, False)
    assert fps.fps_plan([Na, Nb], 1, sms, smem_limit) == (sms, True)
    rng = np.random.RandomState(12)
    xa, ma = _tie_sets(rng, B, Na, [Na - 1000 * b for b in range(B)], 64)
    xb, mb = _tie_sets(rng, B, Nb, [Nb] * B, 16)
    xa, ma, xb, mb = (t.to(dev) for t in (xa, ma, xb, mb))
    ra = fps.farthest_point_sample_plain(xa, ma, S)
    rb = fps.farthest_point_sample_plain(xb, mb, S)
    ga, gb = fps.farthest_point_sample_pair(xa, ma, xb, mb, S)
    g1 = fps.farthest_point_sample(xa, ma, S)
    torch.cuda.synchronize()
    assert torch.equal(ga, ra) and torch.equal(gb, rb) and torch.equal(g1, ra)


def test_fps_kernel_single_set_ties(dev):
    """K11 on the same kernel: integer ties, a masked tail, exhaustion."""
    rng = np.random.RandomState(14)
    xyz, mask = _tie_sets(rng, 2, 50021, [50021, 90], 6)
    ref = fps.farthest_point_sample_plain(xyz, mask, 128)
    got = fps.farthest_point_sample(xyz.to(dev), mask.to(dev), 128)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert len(set(ref[1].tolist())) < 128          # duplicates


@pytest.mark.parametrize("C,Cout", [(4, 16), (5, 16), (8, 16), (16, 16),
                                    (64, 128), (128, 128), (136, 24)])
def test_gather_conv_bf16_tensor_core_widths(dev, C, Cout):
    """bf16 K2 at the widths the tensor-core body treats specially: rows
    staged by element (C % 8 != 0), a half-empty 16-column tile (C=8),
    two channel chunks (C=136); Vout=2000 is not a multiple of the
    64-row tile, and row 0 has all 27 neighbours missing."""
    rng = np.random.RandomState(C * Cout)
    grid = (16, 40, 40)
    V = 2000
    coords, mask = _sites(rng, grid, 1800, V)
    ids = linear_ids(coords, mask, grid)
    nb = sc.match_positions_plain(ids, subm_query_ids(coords, mask, grid), V)
    nb[0, 0] = V
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)
                             ).bfloat16()
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    args = [t.to(dev) for t in (feats, nb, w)]
    ref = sc.gather_conv_plain(*args)
    got = sc.gather_conv(*args)
    torch.cuda.synchronize()
    _conv_close(got, ref, torch.bfloat16)
    assert (got[0, 0] == 0).all()


@pytest.mark.parametrize("C,Cout", [(4, 16), (5, 16), (16, 16), (64, 128),
                                    (128, 128)])
def test_gather_conv_ids_bf16_tensor_core_widths(dev, C, Cout):
    """bf16 K3 at the same widths; 1000 output sites (not a multiple of
    the 64-row tile)."""
    rng = np.random.RandomState(C + Cout)
    grid = (16, 40, 40)
    V = 3000
    coords, mask = _sites(rng, grid, 2500, V)
    oc, om, og = downsample_sites(coords, mask, grid, (1, 1, 1), 1000)
    ids = linear_ids(coords, mask, grid)
    sq = strided_query_ids(oc, om, grid, (1, 1, 1))
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)
                             ).bfloat16()
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.1)
    args = [t.to(dev) for t in (feats, ids, sq, w)]
    ref = sc.gather_conv_ids_plain(*args)
    got = sc.gather_conv_ids(*args)
    torch.cuda.synchronize()
    _conv_close(got, ref, torch.bfloat16)


def test_gather_conv_bf16_rejects_misaligned_view(dev):
    """A bf16 view that starts 2 bytes into its allocation cannot feed
    the kernel's 16-byte copies: the wrapper raises."""
    V, C = 64, 16
    base = torch.zeros(V * C + 1, dtype=torch.bfloat16, device=dev)
    feats = base[1:].view(1, V, C)
    nb = torch.full((1, V, 27), V, dtype=torch.int32, device=dev)
    w = torch.zeros(27, C, 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        sc.gather_conv(feats, nb, w)
    sites = torch.arange(V, dtype=torch.int32, device=dev)[None]
    with pytest.raises(ValueError, match="16-byte"):
        sc.gather_conv_ids(feats, sites, nb, w)
    assert sc.gather_conv(feats.clone(), nb, w).abs().max().item() == 0


# -- K7/K10 bf16 on the tensor cores, and their fp32 twins ------------------

def _dw_inputs(rng, kind, B, V, n, grid, C, Cout, dtype):
    """(kernel, plain, args) of a K7 (submanifold rulebook) or K10
    (strided query ids) call with an all-miss row and an all-miss offset
    (11); B * Vout is no multiple of the 64-row stage or of the chunk."""
    parts = [_sites(rng, grid, n, V) for _ in range(B)]
    coords = torch.cat([p[0] for p in parts])
    mask = torch.cat([p[1] for p in parts])
    ids = linear_ids(coords, mask, grid)
    if kind == "K7":
        idx = sc.match_positions_plain(ids, subm_query_ids(coords, mask,
                                                           grid), V)
        miss, index = V, (idx,)
        kern, plain = sc.gather_conv_dw, sc.gather_conv_dw_plain
    else:
        oc, om, _ = downsample_sites(coords, mask, grid, (1, 1, 1),
                                     n // 2 + 3)
        idx = strided_query_ids(oc, om, grid, (1, 1, 1))
        miss, index = -1, (ids, idx)
        kern, plain = sc.gather_conv_ids_dw, sc.gather_conv_ids_dw_plain
    idx[:, 3] = miss
    idx[:, :, 11] = miss
    feats = torch.from_numpy(rng.randn(B, V, C).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, idx.shape[1], Cout).astype(
        np.float32))
    return kern, plain, (feats.to(dtype), *index, g.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("Cout", [16, 32, 64, 128])
@pytest.mark.parametrize("C", [4, 5, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["K7", "K10"])
def test_dw_kernels_widths(dev, kind, C, Cout, B, dtype):
    """K7/K10 at every width the presets use and beyond, B in {1, 4}:
    (k, c) tiles spanning several offsets (C < 128) or half of one
    (C=128), element-staged rows (C=4/5)."""
    rng = np.random.RandomState(C * 1000 + Cout * 10 + B)
    V = 1501 if B == 1 else 701
    kern, plain, args = _dw_inputs(rng, kind, B, V, V - 37, (16, 40, 40),
                                   C, Cout, dtype)
    args = [t.to(dev) for t in args]
    before = kern.launches
    got = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _dw_close(got, ref)
    assert not got[11].any() and ref.abs().max().item() > 1.0


@pytest.mark.parametrize("C,Cout", [(8, 136), (136, 24), (5, 70)])
@pytest.mark.parametrize("kind", ["K7", "K10"])
def test_dw_bf16_ragged_widths(dev, kind, C, Cout):
    """Two channel tiles (Cout > 128), a half-empty 16-column staging
    (C=8), more than 128 input channels, cotangents staged by element
    (Cout % 8 != 0)."""
    rng = np.random.RandomState(C + Cout)
    kern, plain, args = _dw_inputs(rng, kind, 2, 1200, 1100, (16, 40, 40),
                                   C, Cout, torch.bfloat16)
    args = [t.to(dev) for t in args]
    _dw_close(kern(*args), plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout", [(5, 16), (32, 32), (64, 128),
                                    (128, 128)])
@pytest.mark.parametrize("kind", ["K7", "K10"])
def test_dw_kernels_big_v_batch4(dev, kind, C, Cout, dtype):
    """K7/K10 at B=4, V=60000 (the TPU's K6/K9 territory): many row
    chunks, the last one partial."""
    rng = np.random.RandomState(C + 7 * Cout)
    kern, plain, args = _dw_inputs(rng, kind, 4, 60000, 55000, BIG_GRID,
                                   C, Cout, dtype)
    args = [t.to(dev) for t in args]
    _dw_close(kern(*args), plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["K7", "K10"])
def test_dw_bf16_repeat_is_bit_equal(dev, kind):
    """Fixed-order chunk sums and no float atomics: two calls give the
    same dW bit for bit."""
    rng = np.random.RandomState(21)
    kern, _, args = _dw_inputs(rng, kind, 4, 30000, 28000, BIG_GRID, 32,
                               32, torch.bfloat16)
    args = [t.to(dev) for t in args]
    first = kern(*args)
    assert all(torch.equal(kern(*args), first) for _ in range(3))


def test_dw_bf16_rejects_misaligned_view(dev):
    """A bf16 features or cotangent view that starts 2 bytes into its
    allocation cannot feed the kernel's 16-byte copies: the wrappers
    raise."""
    V, C = 64, 16
    base = torch.zeros(V * C + 1, dtype=torch.bfloat16, device=dev)
    bad = base[1:].view(1, V, C)
    good = torch.zeros(1, V, C, dtype=torch.bfloat16, device=dev)
    nb = torch.full((1, V, 27), V, dtype=torch.int32, device=dev)
    sites = torch.arange(V, dtype=torch.int32, device=dev)[None]
    for f, g in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            sc.gather_conv_dw(f, nb, g)
        with pytest.raises(ValueError, match="16-byte"):
            sc.gather_conv_ids_dw(f, sites, nb, g)
    assert sc.gather_conv_dw(bad.clone(), nb, good).abs().max().item() == 0


# -- K12 redesign: every variant, rounds and bids, ties, max_iters ----------

# (M, N) of the presets' instances and the variants whose shared memory
# fits each on an H100 (227 KB a block)
AUCTION_SHAPES = {"sunrgbd": ((64, 384), ("cta", "cluster", "global")),
                  "nuscenes": ((96, 1024), ("cluster", "global")),
                  "kitti": ((256, 384), ("cluster", "global"))}


def _tied_benefit(rng, G, M, N, n_dummy=28):
    """Values on a 1/4 grid (exact ties in values and bids), every third
    bidder a copy of the one before, -1e6 dummy items last."""
    b = np.round(rng.randn(G, M, N) * 2) / 4
    b[:, 1::3] = b[:, 0:-1:3][:, :b[:, 1::3].shape[1]]
    b[:, :, N - n_dummy:] = -1e6
    b = torch.from_numpy(b.astype(np.float32))
    flat = b[:, :, :N - n_dummy].reshape(G, -1)
    return b, (flat.amax(1) - flat.amin(1)).clamp(min=1e-6)


@pytest.mark.parametrize("G", [12, 36])
@pytest.mark.parametrize("shape,variant", [
    (s, v) for s, (_, vs) in AUCTION_SHAPES.items() for v in vs])
def test_auction_variants_equal_plain(dev, shape, variant, G):
    (M, N), _ = AUCTION_SHAPES[shape]
    b, spread = _tied_benefit(np.random.RandomState(G + M), G, M, N)
    b, spread = b.to(dev), spread.to(dev)
    ref, ref_counts = matching.auction_lap_plain(b, spread, 512.0,
                                                 return_counts=True)
    got, counts = matching.auction_lap(b, spread, 512.0, return_counts=True,
                                       variant=variant)
    torch.cuda.synchronize()
    assert matching.auction_lap.variant == variant
    assert torch.equal(got, ref) and torch.equal(counts, ref_counts)
    assert (ref >= 0).all() and int(ref_counts[:, 0].max()) > 1


@pytest.mark.parametrize("shape,variant", [
    (s, v) for s, (_, vs) in AUCTION_SHAPES.items() for v in vs])
def test_auction_variants_small_max_iters(dev, shape, variant):
    """Stopped after 3 rounds: the same -1 entries, rounds and bids."""
    (M, N), _ = AUCTION_SHAPES[shape]
    b, spread = _duplicated_benefit(np.random.RandomState(M), 12, M, N, 300)
    b, spread = b.to(dev), spread.to(dev)
    ref, ref_counts = matching.auction_lap_plain(b, spread, 2048.0, 3,
                                                 return_counts=True)
    got, counts = matching.auction_lap(b, spread, 2048.0, 3,
                                       return_counts=True, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(counts, ref_counts)
    assert (ref < 0).any() and (ref_counts[:, 0] == 3).all()


def test_auction_default_variant_and_refusal(dev):
    for shape, ((M, N), fits) in AUCTION_SHAPES.items():
        b, spread = _tied_benefit(np.random.RandomState(1), 2, M, N)
        matching.auction_lap(b.to(dev), spread.to(dev))
        assert matching.auction_lap.variant == fits[0], shape
    b, spread = _tied_benefit(np.random.RandomState(1), 2, 96, 1024)
    with pytest.raises(ValueError, match="does not fit"):
        matching.auction_lap(b.to(dev), spread.to(dev), variant="cta")


# -- K1 redesign: sizes around the kernel's tile, batches ---------------------

@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("V", [1, 31, 32, 33, 40000, 120000])
def test_match_positions_kernel_sizes(dev, V, B):
    """Submanifold rulebooks (with INT_MAX pads and -1 queries) and, on a
    tenth of the rows, random queries in random order."""
    grid = (41, 200, 200)
    rng = np.random.RandomState(V + B)
    n = max(1, V - V // 10)
    sites = [_sites(rng, grid, n, V) for _ in range(B)]
    coords = torch.cat([c for c, _ in sites])
    mask = torch.cat([m for _, m in sites])
    ids = linear_ids(coords, mask, grid)
    q = subm_query_ids(coords, mask, grid)
    rows = torch.from_numpy(rng.rand(B, V) < 0.1)
    q[rows] = torch.from_numpy(rng.randint(
        -1, 41 * 200 * 200 + 5, (int(rows.sum()), q.shape[2]))).int()
    ref = sc.match_positions_plain(ids, q, V)
    got = sc.match_positions(ids.to(dev), q.to(dev), V)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    if V > 1000:
        assert (ref == V).any() and (ref < V).any()


# -- N1 (rotated IoU) and N2 (greedy NMS scan), the ScanNet widths ----------

IOU_ATOL = 1e-4   # N1 vs the plain IoU: fp32 rounding (sin/cos, the
                  # shoelace sum's order) of an area up to ~100x smaller
                  # than the products it cancels at scene-scale coordinates


def _nms_scenes(B, N, seed=0):
    """B clustered box sets of N boxes (ScanNet's 18 labels), as tensors."""
    from nms_cases import clustered_boxes

    parts = [clustered_boxes(seed * 10 + b, n=N) for b in range(B)]
    return [torch.from_numpy(np.stack(a)) for a in zip(*parts)]


def _plain_iou_rows(boxes, z_origin="bottom", rows=500):
    """The plain pairwise IoU of (B, N, 7) on its device, in row blocks
    so its (pairs, 16, 2) buffers stay bounded."""
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated

    return torch.cat([iou3d_rotated(boxes[:, r:r + rows], boxes, z_origin)
                      for r in range(0, boxes.shape[1], rows)], dim=1)


@pytest.mark.parametrize("z_origin", ["bottom", "center"])
def test_iou3d_kernel_degenerate_pairs(dev, z_origin):
    from nms_cases import degenerate_pairs
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise

    boxes = torch.from_numpy(np.concatenate(
        [np.stack(p) for p in degenerate_pairs()]))[None]
    ref = _plain_iou_rows(boxes.to(dev), z_origin)
    before = iou3d_rotated_pairwise.launches
    got = iou3d_rotated_pairwise(boxes.to(dev), z_origin)
    torch.cuda.synchronize()
    assert iou3d_rotated_pairwise.launches == before + 1
    assert (got - ref).abs().max().item() <= IOU_ATOL
    np.testing.assert_allclose(got.diagonal(dim1=1, dim2=2).cpu().numpy()[
        :, [0, 1]], 1.0, atol=IOU_ATOL)


@pytest.mark.parametrize("N", [1, 63, 64, 65, 1000, 5000])
def test_iou3d_kernel_random_sets(dev, N):
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise

    boxes, _, _, _ = _nms_scenes(2, N, seed=N)
    boxes = boxes.to(dev)
    got = iou3d_rotated_pairwise(boxes)
    ref = _plain_iou_rows(boxes)
    torch.cuda.synchronize()
    assert got.shape == (2, N, N)
    assert (got - ref).abs().max().item() <= IOU_ATOL
    if N > 64:
        assert (ref > 0.3).sum() > N


def _serial_per_class(iou, scores, labels, valid, thr):
    """``_greedy_suppress_serial`` on each class of each scene (CPU)."""
    from uni3detr_tpu_torch.ops.nms import _greedy_suppress_serial

    out = torch.zeros(valid.shape, dtype=torch.bool)
    for b in range(valid.shape[0]):
        for c in labels[b][valid[b]].unique().tolist():
            out[b] |= _greedy_suppress_serial(
                iou[b], scores[b], valid[b] & (labels[b] == c), thr)
    return out


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 1000, 5000])
def test_nms_kernels_equal_serial(dev, N, B):
    """N1 (bitmask) + N2 on the card keep what the serial greedy pass
    keeps per class on N1's own IoU matrix; one launch of each."""
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = _nms_scenes(B, N, seed=N + B)
    args = [t.to(dev) for t in (boxes, scores, labels, valid)]
    n1, n2 = nms.overlap_mask.launches, nms.greedy_scan.launches
    keep = nms.nms_keep(*args, 0.5, 18)
    torch.cuda.synchronize()
    assert (nms.overlap_mask.launches, nms.greedy_scan.launches) == \
        (n1 + 1, n2 + 1)
    iou = iou3d_rotated_pairwise(args[0]).cpu()
    want = _serial_per_class(iou, scores, labels, valid, 0.5)
    assert torch.equal(keep.cpu(), want)
    if N >= 1000:
        assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.parametrize("case", ["all invalid", "one class"])
def test_nms_kernels_edge_cases(dev, case):
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = _nms_scenes(2, 1000, seed=3)
    if case == "all invalid":
        valid = torch.zeros_like(valid)
    else:
        labels = torch.zeros_like(labels)
    args = [t.to(dev) for t in (boxes, scores, labels, valid)]
    keep = nms.nms_keep(*args, 0.5, 18).cpu()
    iou = iou3d_rotated_pairwise(args[0]).cpu()
    assert torch.equal(keep, _serial_per_class(iou, scores, labels, valid,
                                               0.5))
    assert (keep.sum() == 0) == (case == "all invalid")


def test_nms_scan_kernel_equals_plain_on_one_bitmask(dev):
    """N2 alone: the plain model's bitmask (CPU) scanned on the card and
    on the host; and N1's bitmask equals the plain one except on pairs
    whose IoU lies within IOU_ATOL of the threshold."""
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = _nms_scenes(3, 700, seed=5)
    order, lab = nms.nms_order(scores, labels, valid)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    mask = nms.overlap_mask_plain(bx, lab, 0.5)
    want = nms.greedy_scan_plain(mask, lab, order)
    got = nms.greedy_scan(mask.to(dev), lab.to(dev), order.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    bits = nms.overlap_mask(bx.to(dev), lab.to(dev), 0.5).cpu()
    differ = nms._unpack_bits((bits ^ mask).transpose(1, 2), 700)
    if differ.any():
        from uni3detr_tpu_torch.geom.iou import iou3d_rotated
        iou = iou3d_rotated(bx, bx, "bottom")
        assert ((iou[differ] - 0.5).abs() <= IOU_ATOL).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout", [(256, 256), (128, 256)])
def test_conv_kernels_scannet_large_widths(dev, dtype, C, Cout):
    """K2 (submanifold), K3 (strided), K7 and K10 at the 256-channel
    stage of uni3detr_scannet_large and at its 128 -> 256 downsample."""
    rng = np.random.RandomState(C + Cout)
    grid = (16, 40, 40)
    V = 3000
    coords, mask = _sites(rng, grid, 2600, V)
    ids = linear_ids(coords, mask, grid)
    nb = sc.match_positions_plain(ids, subm_query_ids(coords, mask, grid), V)
    oc, om, _ = downsample_sites(coords, mask, grid, (1, 1, 1), 1200)
    sq = strided_query_ids(oc, om, grid, (1, 1, 1))
    feats = torch.from_numpy(rng.randn(1, V, C).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(27, C, Cout).astype(np.float32) * 0.05)
    a = [t.to(dev) for t in (feats, nb, w)]
    _conv_close(sc.gather_conv(*a), sc.gather_conv_plain(*a), dtype)
    a = [t.to(dev) for t in (feats, ids, sq, w)]
    _conv_close(sc.gather_conv_ids(*a), sc.gather_conv_ids_plain(*a), dtype)
    for kind in ("K7", "K10"):
        kern, plain, args = _dw_inputs(rng, kind, 2, 2000, 1800, grid, C,
                                       Cout, dtype)
        args = [t.to(dev) for t in args]
        _dw_close(kern(*args), plain(*args))
    torch.cuda.synchronize()


def test_dynamic_voxelize_on_card_matches_cpu(dev):
    """uni3detr_scannet_large's dynamic voxelization of a clustered
    100k-point scene: coords and mask equal, means within 1e-5 (fp64
    sums, one fp32 rounding)."""
    from uni3detr_tpu_torch.ops.voxelize import dynamic_voxelize
    from uni3detr_tpu_torch.presets import SCANNET_LARGE as cfg
    from uni3detr_tpu_torch.synthetic import clustered_scene

    pts = torch.from_numpy(clustered_scene(0, cfg)[0])
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    kw = dict(pc_range=cfg.pc_range, voxel_size=cfg.voxel_size,
              grid_size=cfg.grid_size, max_voxels=cfg.max_voxels_test)
    ref = dynamic_voxelize(pts, mask, **kw)
    got = dynamic_voxelize(pts.to(dev), mask.to(dev), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(),
                                                              ref[2])
    assert (got[0].cpu() - ref[0]).abs().max().item() <= 1e-5
    assert int(ref[2].sum()) > 1000


# -- N1's two-set and BEV forms, box merging and the metrics (KITTI) --------

def _two_sets(M, N, B=2, seed=0):
    """(B, M, 7) and (B, N, 7) clustered boxes of three labels (the second
    set shares a few boxes with the first)."""
    from nms_cases import clustered_boxes

    out = []
    for n, s in ((M, seed), (N, seed + 1)):
        sets = [clustered_boxes(s * 10 + b, n=max(n, 1), ncls=3)[0][:n]
                for b in range(B)]
        out.append(torch.from_numpy(np.stack(sets)))
    k = min(M, N, 5)
    out[1][:, :k] = out[0][:, :k]
    return out


def _set_form(form):
    """The N1 two-set wrapper of ``form`` and a call of it."""
    from uni3detr_tpu_torch.geom import iou as tiou

    if form == "bev":
        return tiou.iou_bev_rotated_sets, tiou.iou_bev_rotated_sets
    z = form.split("-")[1]
    return tiou.iou3d_rotated_sets, \
        lambda a, b: tiou.iou3d_rotated_sets(a, b, z)


@pytest.mark.parametrize("form", ["3d-bottom", "3d-center", "bev"])
@pytest.mark.parametrize("M,N", [(0, 5), (5, 0), (1, 1), (1, 70), (70, 1),
                                 (150, 50), (300, 37)])
def test_iou_two_set_kernels(dev, form, M, N):
    """N1's two-set forms against their plain versions (CPU) within
    IOU_ATOL; one launch, none for an empty set."""
    wrapper, fn = _set_form(form)
    a, b = _two_sets(M, N, seed=M + N)
    before = wrapper.launches
    got = fn(a.to(dev), b.to(dev))
    torch.cuda.synchronize()
    ref = fn(a, b)
    assert got.shape == ref.shape == (2, M, N)
    assert wrapper.launches == before + (1 if M * N else 0)
    if M * N:
        assert (got.cpu() - ref).abs().max().item() <= IOU_ATOL
    if M * N >= 1000:
        assert (ref > 0.1).sum() >= 5


@pytest.mark.parametrize("form", ["3d-bottom", "3d-center", "bev"])
def test_iou_two_set_kernels_degenerate(dev, form):
    """Every box of the degenerate pairs against every other: identical,
    touching, nested, rotated by 45/90/180 degrees, zero height, tiny."""
    from nms_cases import degenerate_pairs

    _, fn = _set_form(form)
    pairs = degenerate_pairs()
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))[None]
    b = torch.from_numpy(np.stack([p[1] for p in pairs[:-2]]))[None]
    got = fn(a.to(dev), b.to(dev)).cpu()
    assert (got - fn(a, b)).abs().max().item() <= IOU_ATOL


def test_merge_boxes_card_equals_cpu(dev):
    """Box merging with N1's matrix on the card against the plain IoU on
    the CPU: the same kept indices and labels, boxes within 1e-6; and the
    batch path (one launch for two scenes) against the CPU's."""
    import dataclasses

    from nms_cases import clustered_boxes
    from uni3detr_tpu_torch.eval import box_merging, postprocess
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.presets import KITTI_3CLASSES

    parts = [clustered_boxes(40 + b, n=150, ncls=3, thr=0.1)
             for b in range(2)]
    boxes, scores, labels, valid = (np.stack(a) for a in zip(*parts))
    for b in range(2):
        v = valid[b]
        args = (labels[b][v], boxes[b][v], scores[b][v])
        want = box_merging.merge_boxes_3d(*args, device="cpu")
        got = box_merging.merge_boxes_3d(*args, device=dev)
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
        assert 0 < len(want[3]) < v.sum()
    cfg = dataclasses.replace(KITTI_3CLASSES, max_num=150)
    t = [torch.from_numpy(x) for x in (boxes, scores, labels, valid)]
    before = iou3d_rotated_pairwise.launches
    got = postprocess.postprocess_batch(*[x.to(dev) for x in t], cfg)
    assert iou3d_rotated_pairwise.launches == before + 1
    want = postprocess.postprocess_batch(*t, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-6)


def test_kitti_and_indoor_eval_card_equals_cpu(dev):
    """The metrics with N1's two-set overlaps on the card against the
    plain overlaps on the CPU: every key equal (no overlap of these
    scenes lies within IOU_ATOL of a threshold); two launches a scene for
    KITTI, one for indoor."""
    from nms_cases import KITTI_CLASSES, indoor_scenes, random_kitti_scenes
    from uni3detr_tpu_torch.eval import indoor_eval, kitti_eval
    from uni3detr_tpu_torch.geom import iou as tiou

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k

    gts, dets = random_kitti_scenes(0)
    n3, nb = tiou.iou3d_rotated_sets.launches, \
        tiou.iou_bev_rotated_sets.launches
    got = kitti_eval.kitti_eval(gts, dets, KITTI_CLASSES, device=dev)
    assert (tiou.iou3d_rotated_sets.launches - n3,
            tiou.iou_bev_rotated_sets.launches - nb) == (len(gts), len(gts))
    same(got, kitti_eval.kitti_eval(gts, dets, KITTI_CLASSES, device="cpu"))
    classes = [f"c{i}" for i in range(10)]
    gts, dets = indoor_scenes(5)
    same(indoor_eval.indoor_eval(gts, dets, classes, device=dev),
         indoor_eval.indoor_eval(gts, dets, classes, device="cpu"))


@pytest.mark.parametrize("variant", [None, "cta", "cluster", "global"])
def test_auction_one_to_many_kitti_shape(dev, variant):
    """K12 on KITTI's instances: 50 GT columns tiled 5 times (250 bidders,
    padded to 256) over 300 queries (384 items), eps = spread / 8**3.
    The 393 KB benefit matrix is over one block's shared memory: the
    default takes the cluster of two; every variant that fits is
    bit-equal to the plain version, rounds and bids too."""
    gen = torch.Generator().manual_seed(8)
    G = 6
    c = (2 * torch.randn((G, 300, 50), generator=gen)
         + 1.2 * torch.rand((G, 300, 50), generator=gen))
    benefit, spread = matching._auction_instances(c.repeat(1, 1, 5))
    assert benefit.shape == (G, 256, 384)
    benefit, spread = benefit.to(dev), spread.to(dev)
    if variant == "cta":
        with pytest.raises(ValueError):
            matching.auction_lap(benefit, spread, 512.0, variant=variant)
        return
    ref, rc = matching.auction_lap_plain(benefit, spread, 512.0,
                                         return_counts=True)
    got, counts = matching.auction_lap(benefit, spread, 512.0,
                                       return_counts=True, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(counts, rc)
    assert bool((got >= 0).all())
    assert matching.auction_lap.variant == (variant or "cluster")


# -- OV-Uni3DETR ------------------------------------------------------------

@pytest.mark.parametrize("N", [1000, 5000])
def test_nms_kernels_46_classes_equal_serial(dev, N):
    """The OV presets' 46 classes in one label-folded bitmask: N1 + N2
    keep what the serial pass keeps per class on N1's matrix."""
    from nms_cases import clustered_boxes
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = (torch.from_numpy(a)[None] for a in
                                    clustered_boxes(N + 46, n=N, ncls=46))
    args = [t.to(dev) for t in (boxes, scores, labels, valid)]
    keep = nms.nms_keep(*args, 0.5, 46)
    iou = iou3d_rotated_pairwise(args[0]).cpu()
    want = _serial_per_class(iou, scores, labels, valid, 0.5)
    assert torch.equal(keep.cpu(), want)
    assert len(labels[valid].unique()) >= 40
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.fixture
def no_tf32():
    """fp32 convs and matmuls in full precision on the card."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = old


def test_grid_sample_2d_card_equals_cpu(dev):
    from uni3detr_tpu_torch.ops.sample import grid_sample_2d

    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 30, 40, 64).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5000, 2)).astype(
        np.float32))
    ref = grid_sample_2d(img, pts)
    got = grid_sample_2d(img.to(dev), pts.to(dev)).cpu()
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_card_equals_cpu(dev, no_tf32, stride):
    """Offsets of several pixels (taps between pixels, outside the
    image): fp32, 1e-4 of the largest output."""
    from uni3detr_tpu_torch.models.dcn import DeformConv2dV2

    torch.manual_seed(stride)
    mod = DeformConv2dV2(64, 64, 3, stride)
    torch.nn.init.normal_(mod.conv_offset.weight, std=0.1)
    x = torch.randn(1, 64, 30, 40)
    with torch.no_grad():
        off, _ = mod.offsets_and_mask(x)
        ref = mod(x)
        mod.to(dev)
        got = mod(x.to(dev)).cpu()
    assert off.abs().max().item() > 2.0
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _ov_tiny(mode, seed=1):
    import dataclasses
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    from uni3detr_tpu_torch.presets import OV_TINY_SYNTHETIC
    from uni3detr_tpu_torch.weights import random_state_dict

    cfg = OV_TINY_SYNTHETIC
    if mode == "pc":
        cfg = dataclasses.replace(cfg, use_camera=False, multimodal=False)
    elif mode == "rgb":
        cfg = dataclasses.replace(cfg, use_lidar=False, multimodal=False)
    model = OV_Uni3DETR(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, seed).items()})
    return model


def _ov_batch(model, dev):
    from uni3detr_tpu_torch.synthetic import ov_scene

    batch, rnd = ov_scene(2, model.cfg)
    return ({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            torch.from_numpy(rnd).to(dev))


@pytest.mark.parametrize("mode", ["mm", "pc", "rgb"])
def test_ov_tiny_forward_card_equals_cpu(dev, no_tf32, mode):
    """The tiny OV model (full-width ResNet-50 + DCN) in fp32: voxels and
    FPS equal, all four output stacks within 1e-3."""
    model = _ov_tiny(mode)
    res = []
    for where in ("cpu", dev):
        model.to(where)
        outs, inter = model(*_ov_batch(model, where),
                            return_intermediates=True)
        res.append(({k: v.cpu() for k, v in outs.items()},
                    {k: v.cpu() for k, v in inter.items()
                     if isinstance(v, torch.Tensor)}))
    (oc, ic), (og, ig) = res
    assert sorted(ic) == sorted(ig)
    if "coords" in ic:
        assert torch.equal(ic["coords"], ig["coords"])
    for k in ("image_volume", "fused_volume"):
        if k in ic:
            assert (ig[k] - ic[k]).abs().max().item() <= 1e-3, k
    assert len(oc) == 4
    for k in oc:
        assert (og[k] - oc[k]).abs().max().item() <= 1e-3, k


def test_ov_tiny_mm_launch_counts(dev):
    """One multimodal scene to boxes: K1 4, K2 17, K3 3, K4 1, N1 1, N2 1
    (the camera-only model: K1-K4 0)."""
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.train.coder import (decode_predictions,
                                                post_process)

    wrappers = {"K1": sc.match_positions, "K2": sc.gather_conv,
                "K3": sc.gather_conv_ids,
                "K4": fps.farthest_point_sample_pair,
                "N1": nms.overlap_mask, "N2": nms.greedy_scan}
    for mode, k14 in (("mm", (4, 17, 3, 1)), ("rgb", (0, 0, 0, 0))):
        model = _ov_tiny(mode).to(dev)
        for fn in wrappers.values():
            fn.launches = 0
        with torch.no_grad():
            out = post_process(*decode_predictions(
                model(*_ov_batch(model, dev)), model.cfg), model.cfg)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in wrappers.items()}
        assert got == dict(zip(wrappers, k14 + (1, 1))), (mode, got)
        assert int(out[3].sum()) > 0


# -- OV training ---------------------------------------------------------------

def _ov_train_model(mode, **changes):
    """The tiny OV model for training: a 64x64 image (at 32x32 the last
    ResNet stage is 1x1 and its train-mode BN normalizes one value a
    channel per scene), 2048 points, 8 GT rows."""
    import dataclasses
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    from uni3detr_tpu_torch.weights import random_state_dict

    cfg = dataclasses.replace(_ov_tiny(mode).cfg, img_size=(64, 64),
                              num_points=2048, max_gt=8, **changes)
    model = OV_Uni3DETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 1).items()})
    return model


def _ov_train_batch(model, dev, B=2):
    from uni3detr_tpu_torch.synthetic import (clustered_train_batch,
                                              ov_train_batch)

    batch, _ = ov_train_batch(3, model.cfg, B)
    gt = clustered_train_batch(3, model.cfg, B)
    batch.update({k: gt[k] for k in ("gt_boxes", "gt_labels", "gt_mask")})
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("mode,ri", [("mm", 0), ("mm", 1), ("mm", 2),
                                     ("pc", None), ("rgb", None)])
def test_ov_tiny_train_step_launches(dev, mode, ri):
    """One train step's launches: with the point branch's backward (pc,
    mm under ri 1 and 2) K1 4, K2 2 x 17 - 1, K3 6, K4 1, K7 17, K10 3
    and K12 1 for the tiny encoder's 17 submanifold convs; under ri 0 the
    forward's alone (K1 4, K2 17, K3 3, K4 1) and K12 1; camera-only K12
    alone. The frozen ResNet stages do not move."""
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    model = _ov_train_model(mode).to(dev)
    opt = make_optimizer(model, 1e-4)
    wrappers = {"K1": sc.match_positions, "K2": sc.gather_conv,
                "K3": sc.gather_conv_ids,
                "K4": fps.farthest_point_sample_pair,
                "K7": sc.gather_conv_dw, "K10": sc.gather_conv_ids_dw,
                "K12": matching.auction_lap}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    batch = _ov_train_batch(model, dev)
    for fn in wrappers.values():
        fn.launches = 0
    logs = train_step(model, opt, batch, modality=ri)
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in wrappers.items()}
    if mode == "rgb":
        want = (0, 0, 0, 0, 0, 0, 1)
    elif ri == 0:
        want = (4, 17, 3, 1, 0, 0, 1)
    else:
        want = (4, 33, 6, 1, 17, 3, 1)
    assert got == dict(zip(wrappers, want)), (mode, ri, got)
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    assert (len(frozen) > 0) == (mode != "pc")


def test_ov_tiny_train_step_card_equals_cpu(dev, no_tf32):
    """One fp32 mm step (ri 2, dropout 0, scipy matching) on the card and
    on the CPU: every loss term within 1e-3 relative, the gradient norm
    within 2e-2 (the ReLU masks of the random ResNet differ at a few
    entries between the two, see ``tests/test_torch_port_ov_train.py``),
    the head's gradients within 1e-2 of their largest entry."""
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    res = []
    for where in ("cpu", dev):
        model = _ov_train_model("mm", dropout=0.0, matcher="scipy").to(where)
        opt = make_optimizer(model, 1e-4)
        logs = train_step(model, opt, _ov_train_batch(model, where),
                          modality=2)
        mu = {n: opt.adamw.state[p]["exp_avg"].cpu()
              for n, p in model.named_parameters()
              if n.startswith("pts_bbox_head")}
        res.append(({k: float(v) for k, v in logs.items()}, mu))
    (lc, mc), (lg, mg) = res
    for k in lc:
        rtol = 2e-2 if k == "grad_norm" else 1e-3
        assert abs(lg[k] - lc[k]) <= rtol * max(abs(lc[k]), 1e-3), k
    scale = max(v.abs().max().item() for v in mc.values())
    err = max((mg[n] - mc[n]).abs().max().item() for n in mc)
    assert err <= 1e-2 * scale, (err, scale)


def test_ov_tiny_backward_dw_kernels_equal_plain(dev):
    """K7 and K10 on the features and cotangents of one bf16 train
    step's backward (mm, ri 2), recorded at the wrappers: within 1e-3 of
    the largest entry of the plain versions (bf16 rows and cotangents
    widen to fp32 exactly; sums in another order)."""
    from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes
    from uni3detr_tpu_torch.train.losses import uni3detr_loss

    model = _ov_train_model("mm", compute_dtype="bfloat16").to(dev).train()
    calls = []
    saved = (sc.gather_conv_dw, sc.gather_conv_ids_dw)

    def record(name, fn):
        def call(*a):
            calls.append((name, tuple(t.detach() for t in a)))
            return fn(*a)
        call.launches = fn.launches     # the wrapper counts by its name
        return call

    sc.gather_conv_dw = record("K7", saved[0])
    sc.gather_conv_ids_dw = record("K10", saved[1])
    try:
        batch = _ov_train_batch(model, dev)
        total, _ = uni3detr_loss(model(batch, modality=2),
                                 gravity_center_boxes(batch["gt_boxes"]),
                                 batch["gt_labels"], batch["gt_mask"],
                                 model.cfg)
        total.backward()
    finally:
        saved[0].launches = sc.gather_conv_dw.launches
        saved[1].launches = sc.gather_conv_ids_dw.launches
        sc.gather_conv_dw, sc.gather_conv_ids_dw = saved
    assert [n for n, _ in calls].count("K7") == 17
    assert [n for n, _ in calls].count("K10") == 3
    for name, a in calls:
        assert a[0].dtype == torch.bfloat16
        kern, plain = ((sc.gather_conv_dw, sc.gather_conv_dw_plain)
                       if name == "K7" else
                       (sc.gather_conv_ids_dw, sc.gather_conv_ids_dw_plain))
        got, ref = kern(*a), plain(*a)
        assert (got - ref).abs().max().item() <= \
            1e-3 * max(ref.abs().max().item(), 1e-6), name


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_grads_card_equals_cpu(dev, no_tf32, stride):
    """The DCN's backward (to the input, the weight and the offset conv)
    with offsets of several pixels: fp32, 1e-4 of each gradient's
    largest entry."""
    from uni3detr_tpu_torch.models.dcn import DeformConv2dV2

    torch.manual_seed(10 + stride)
    mod = DeformConv2dV2(32, 32, 3, stride)
    torch.nn.init.normal_(mod.conv_offset.weight, std=0.1)
    x = torch.randn(2, 32, 24, 30)
    res = []
    for where in ("cpu", dev):
        mod.to(where).zero_grad()
        xi = x.detach().to(where).requires_grad_()
        out = mod(xi)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).to(where)
        (out * cot).sum().backward()
        # copies: moving the module moves its gradients' storage too
        res.append([t.detach().cpu().clone() for t in (
            xi.grad, mod.weight.grad, mod.conv_offset.weight.grad,
            mod.conv_offset.bias.grad)])
    for c, g in zip(*res):
        assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item()


def test_flax_batchnorm2d_train_card_equals_cpu(dev):
    """The ResNet's train-mode BN on a channels-last input: output and
    running statistics (the biased variance) within 1e-5 relative."""
    from uni3detr_tpu_torch.models.resnet import BatchNorm2d

    x = torch.randn(4, 64, 30, 40) * 3 + 1
    res = []
    for where in ("cpu", dev):
        bn = BatchNorm2d(64).to(where).train()
        xi = x.to(where)
        if xi.is_cuda:
            xi = xi.contiguous(memory_format=torch.channels_last)
        out = bn(xi)
        res.append((out.cpu(), bn.running_mean.cpu(), bn.running_var.cpu()))
    for c, g in zip(*res):
        assert (g - c).abs().max().item() <= 1e-5 * c.abs().max().item()


def test_ov_checkpoint_round_trip_on_card(dev, tmp_path):
    """Train two steps on the card (ri from a generator), save, restore
    into a fresh model, optimizer and generator: every tensor, every
    AdamW group's state and the step equal bit for bit, and the next
    draw of ri equal."""
    from uni3detr_tpu_torch.presets import OV_SUNRGBD_MM_LR_MULT
    from uni3detr_tpu_torch.train import checkpoint
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    model = _ov_train_model("mm").to(dev)
    opt = make_optimizer(model, 1e-4, lr_mult=OV_SUNRGBD_MM_LR_MULT)
    gen = torch.Generator().manual_seed(3)
    batch = _ov_train_batch(model, dev)
    for _ in range(2):
        train_step(model, opt, batch, modality_generator=gen)
    checkpoint.save_checkpoint(str(tmp_path), model, opt, generator=gen)
    tree, _ = checkpoint.load_checkpoint(str(tmp_path))
    fresh = _ov_train_model("mm").to(dev)
    fopt = make_optimizer(fresh, 1e-4, lr_mult=OV_SUNRGBD_MM_LR_MULT)
    fgen = torch.Generator()
    checkpoint.restore(fresh, tree, fopt, fgen)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    for p, q in zip(opt.params, fopt.params):
        for key, v in opt.adamw.state[p].items():
            assert torch.equal(v, fopt.adamw.state[q][key]), key
    assert fopt.steps == opt.steps == 2
    assert fresh.draw_modality(generator=fgen) == \
        model.draw_modality(generator=gen)


def _two_views(B, N, seed):
    """B scenes of N clustered boxes (18 labels) and their copies 5 m
    higher with the same scores: in bird's-eye view each copy lies on its
    box (IoU 1, a tie broken by index), in 3D the two never overlap, as
    two TTA views of one object at different heights."""
    boxes, scores, labels, valid = _nms_scenes(B, N, seed=seed)
    up = boxes.clone()
    up[..., 2] += 5.0
    return (torch.cat([boxes, up], 1), torch.cat([scores, scores], 1),
            torch.cat([labels, labels], 1), torch.cat([valid, valid], 1))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("N", [1, 32, 33, 500, 1000])
def test_nms_bev_kernels_equal_serial(dev, N, B):
    """N1's BEV bitmask + N2 (``nms_bev_keep``, one launch each) keep
    what the serial greedy pass keeps per class on the BEV matrix
    kernel's own IoU; the bitmask equals the plain BEV IoU thresholded at
    0.1 except on pairs within IOU_ATOL of it; the 3D NMS of the same
    boxes keeps both views."""
    from uni3detr_tpu_torch.geom.iou import iou_bev_rotated_sets
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = _two_views(B, N, seed=N + B)
    args = [t.to(dev) for t in (boxes, scores, labels, valid)]
    n1, n2 = nms.overlap_mask_bev.launches, nms.greedy_scan.launches
    keep = nms.nms_bev_keep(*args, 0.1, 18)
    torch.cuda.synchronize()
    assert (nms.overlap_mask_bev.launches, nms.greedy_scan.launches) == \
        (n1 + 1, n2 + 1)
    iou = iou_bev_rotated_sets(args[0], args[0]).cpu()
    want = _serial_per_class(iou, scores, labels, valid, 0.1)
    assert torch.equal(keep.cpu(), want)
    # no box and its copy both kept; the 3D NMS keeps both of each pair
    assert not (keep[:, :N] & keep[:, N:]).any()
    keep3d = nms.nms_keep(*args, 0.1, 18).cpu()
    assert torch.equal(keep3d[:, :N], keep3d[:, N:])
    order, lab = nms.nms_order(scores, labels, valid)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    bits = nms.overlap_mask_bev(bx.to(dev), lab.to(dev), 0.1).cpu()
    plain = nms.overlap_mask_plain(bx, lab, 0.1, bev=True)
    differ = nms._unpack_bits((bits ^ plain).transpose(1, 2), 2 * N)
    if differ.any():
        from uni3detr_tpu_torch.geom.iou import iou_bev_rotated
        ref = iou_bev_rotated(bx, bx)
        assert ((ref[differ] - 0.1).abs() <= IOU_ATOL).all()


def test_nms_bev_plain_on_card_equals_cpu(dev):
    """``nms_bev_keep``'s plain version (the CPU path) and the kernels
    keep the same boxes on the same scenes."""
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = _two_views(2, 300, seed=7)
    want = nms.nms_bev_keep(boxes, scores, labels, valid, 0.1, 18)
    got = nms.nms_bev_keep(*[t.to(dev) for t in (boxes, scores, labels,
                                                 valid)], 0.1, 18)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("tta", [False, True])
def test_tiny_cli_on_card(dev, tmp_path, tta, monkeypatch):
    """``cli.test`` on the synthetic tiny config on the card (5 scenes
    at batch 2, decoding, post-processing and the TTA merge under
    ``set_sync_debug_mode("error")``): finite detections, N1 (3D
    bitmask) and N2 once a batch and view, with TTA the BEV bitmask and
    one more N2 once a batch; ``cli.eval_metric`` on the written pkl
    gives the CLI's metric."""
    import functools
    import os
    from uni3detr_tpu_torch.cli import eval_metric, test as cli_test
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.train import evaluator

    monkeypatch.setattr(evaluator, "run_inference", functools.partial(
        evaluator.run_inference, sync_debug_mode="error"))
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "configs", "uni3detr", "uni3detr_synthetic_tiny.py")
    out = str(tmp_path / "dets.pkl")
    counters = (nms.overlap_mask, nms.overlap_mask_bev, nms.greedy_scan)
    before = [f.launches for f in counters]
    r = cli_test.main([cfg, "--eval", "bbox", "--max-samples", "5",
                       "--out", out]
                      + (["--tta"] if tta else []))
    views = 2 if tta else 1
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [3 * views, 3 * tta, 3 * views + 3 * tta]
    assert len(r["dets"]) == 5
    for d in r["dets"]:
        assert len(d["scores"]) > 0 and np.isfinite(d["boxes"]).all()
        assert len(d["scores"]) <= (500 if tta else 32)
    assert eval_metric.main([cfg, out]) == r["metrics"]


def test_tiny_train_cli_on_card(dev, tmp_path, monkeypatch):
    """``cli.train`` on the synthetic tiny config on the card (4 scenes
    at batch 2, an eval after each epoch, ``--max-steps 3``, then a
    resume from ``latest``): K12 once and K7 in every step, N1's NMS
    bitmask once an eval batch, finite losses, the eval lines in
    ``train.log`` and the steps counted on across the resume."""
    import os
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.ops import nms
    from uni3detr_tpu_torch.train import step

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "configs", "uni3detr", "uni3detr_synthetic_tiny.py")
    wd = str(tmp_path / "wd")
    opts = ["--cfg-options", "data.length=4", "evaluation.interval=1",
            "evaluation.max_samples=2", "log_config.interval=1"]
    per_step, real = [], step.train_step

    def watched(model, opt, batch, **kw):
        before = (matching.auction_lap.launches, sc.gather_conv_dw.launches)
        logs = real(model, opt, batch, **kw)
        per_step.append((matching.auction_lap.launches - before[0],
                         sc.gather_conv_dw.launches - before[1],
                         float(logs["total_loss"])))
        return logs

    monkeypatch.setattr(step, "train_step", watched)
    masks = nms.overlap_mask.launches
    r1 = cli_train.main([cfg, "--work-dir", wd, "--max-steps", "3", *opts])
    r2 = cli_train.main([cfg, "--work-dir", wd, "--resume-from",
                         os.path.join(wd, "latest"), *opts])
    assert (r1["step"], r2["step"]) == (3, 5)
    assert sorted(r1["evals"]) == [1] and sorted(r2["evals"]) == [2]
    assert nms.overlap_mask.launches - masks == 2
    assert len(per_step) == 5
    for k12, k7, loss in per_step:
        assert k12 == 1 and k7 > 0 and np.isfinite(loss)
    with open(os.path.join(wd, "train.log")) as f:
        text = f.read()
    assert "eval epoch 1 | " in text and "eval epoch 2 | " in text


def test_two_ranks_share_the_card(dev):
    """Data parallelism on one card: two ranks over gloo on CUDA tensors
    (``parallel.launch.spawn``), one fp32 step of the tiny model at 2
    scenes a rank (TF32 off, dropout 0, scipy's matcher) against one
    process at 4: losses within rtol 1e-5, the gradient norm within rtol
    1e-3 (JAX's DP tolerances), each rank's kernel launches those of the
    one process's step, and both ranks holding the same weights after.
    The weights are seed 1's: with seed 0's the batch sits on a near-tie
    of the matching (on the CPU a 3e-6 relative nudge of the points moves
    the loss to the value two ranks reached on the card, beyond rtol
    1e-5), with seed 1's nudges of 1e-6 and 3e-6 leave it unchanged."""
    import dataclasses
    import os
    import torch_ddp_workers as w
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.parallel.launch import spawn
    from uni3detr_tpu_torch.presets import TINY_SYNTHETIC
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.weights import random_state_dict

    cfg = dataclasses.replace(TINY_SYNTHETIC, dropout=0.0, matcher="scipy")
    sd = random_state_dict(Uni3DETR(cfg), 1)
    batch = clustered_train_batch(5, cfg, 4)
    ranks = spawn("torch_ddp_workers:train_step", 2, (cfg, sd, batch, 1e-4),
                  {"device": "cuda"}, device="cuda", timeout=300)
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        one = w.train_step(cfg, sd, batch, 1e-4, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for logs, state, _, launches in ranks:
        np.testing.assert_allclose(logs["total_loss"],
                                   one[0]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(logs["grad_norm"], one[0]["grad_norm"],
                                   rtol=1e-3)
        assert launches == one[3] and launches["gather_conv_dw"] > 0
        for k, v in state.items():
            np.testing.assert_array_equal(v, ranks[0][1][k], err_msg=k)


_TINY_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "configs", "uni3detr",
                            "uni3detr_synthetic_tiny.py")


def test_get_flops_card_count_equals_cpu_count(dev):
    """``cli.get_flops`` on the tiny config: the card's FLOPs (cuDNN,
    flash attention, the kernels' records) equal the CPU's (the plain
    versions under ``FlopCounterMode``); the kernels' records name K1-K4
    with one launch each as the launch counters."""
    from uni3detr_tpu_torch.cli import get_flops
    from uni3detr_tpu_torch.ops import kernel_wrappers

    before = {k: f.launches for k, f in kernel_wrappers().items()}
    card = get_flops.main([_TINY_CONFIG])
    launched = {k: f.launches - before[k]
                for k, f in kernel_wrappers().items()}
    cpu = get_flops.main([_TINY_CONFIG, "--device", "cpu"])
    assert card["flops"] == cpu["flops"] > 0
    assert card["peak_memory_bytes"] > 0 and cpu["peak_memory_bytes"] == -1
    assert {k: v["launches"] for k, v in card["kernels"].items()} == \
        {k: v for k, v in launched.items() if v}
    assert set(card["kernels"]) == {"match_positions", "gather_conv",
                                    "gather_conv_ids", "fps_pair"}
    assert cpu["kernels"] == {}


def test_spconv_v2_pth_imports_and_runs(dev, tmp_path):
    """A reference ``.pth`` of the tiny preset's seed-0 weights with its
    sparse convs in spconv-v2's layout: ``cli.import_ckpt``, then
    ``cli.test`` on the card gives the detections of the seed-0 weights
    bit for bit."""
    from uni3detr_tpu_torch.cli import import_ckpt, test as cli_test
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import TINY_SYNTHETIC
    from uni3detr_tpu_torch.weights import random_state_dict

    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(
        Uni3DETR(TINY_SYNTHETIC), 0).items()}
    for k, v in sd.items():
        if k.startswith("pts_middle_encoder.") and v.dim() == 5:
            sd[k] = v.permute(4, 0, 1, 2, 3).contiguous()
    pth = str(tmp_path / "ref.pth")
    torch.save({"meta": {"epoch": 1}, "state_dict": sd}, pth)
    out = str(tmp_path / "ckpt")
    import_ckpt.main([pth, out, "--preset", "uni3detr_tiny_synthetic"])
    args = ["--eval", "bbox", "--max-samples", "3"]
    a = cli_test.main([_TINY_CONFIG, out] + args)["dets"]
    b = cli_test.main([_TINY_CONFIG] + args)["dets"]
    for da, db in zip(a, b):
        for k in ("boxes", "scores", "labels"):
            assert np.array_equal(da[k], db[k])


def test_trace_context_names_the_kernels(dev, tmp_path):
    """``trace_context`` over one tiny forward on the card writes a trace
    whose port kernels, by wrapper, are the launch counters'."""
    from uni3detr_tpu_torch import synthetic
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.ops import kernel_wrappers
    from uni3detr_tpu_torch.ops.cuda_lib import forward_launches
    from uni3detr_tpu_torch.presets import TINY_SYNTHETIC
    from uni3detr_tpu_torch.utils.profiling import (trace_context,
                                                    trace_kernel_counts)

    model = Uni3DETR(TINY_SYNTHETIC).eval().to(dev)
    pts, rnd = synthetic.clustered_scene(0, TINY_SYNTHETIC)
    pts = torch.from_numpy(pts).to(dev)
    args = (pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev),
            torch.from_numpy(rnd).to(dev))
    with torch.no_grad():
        model(*args)
        before = {k: f.launches for k, f in kernel_wrappers().items()}
        with trace_context(str(tmp_path)):
            model(*args)
            torch.cuda.synchronize()
    launched = {k: f.launches - before[k]
                for k, f in kernel_wrappers().items()}
    _, counts = trace_kernel_counts(str(tmp_path))
    traced = forward_launches(counts)
    assert traced == {k: launched[k] for k in traced}
    assert traced["gather_conv"] > 0 and traced["fps_pair"] == 1


@pytest.mark.parametrize("N,C", [(1, 3), (65, 3), (1000, 10), (5000, 18)])
def test_soft_nms_kernel_equals_plain(dev, N, C):
    """N3 against ``soft_nms_plain`` on the card on N1's matrix: equal
    keep masks and steps, scores bit-equal (the same fp32 operations in
    the same order), one launch for every scene and class; scores
    rounded to 1/8 so that many ties break by index."""
    from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
    from uni3detr_tpu_torch.ops import nms

    boxes, scores, labels, valid = (t.to(dev) for t in _nms_scenes(2, N))
    labels = labels % C
    for sc in (scores, torch.round(scores * 8) / 8):
        iou = iou3d_rotated_pairwise(boxes)
        before = nms.soft_nms.launches
        got = nms.soft_nms(iou, sc, labels, valid, C, 0.3, 1e-3, N)
        torch.cuda.synchronize()
        assert nms.soft_nms.launches == before + 1
        ref = nms.soft_nms_plain(iou, sc, labels, valid, C, 0.3, 1e-3, N)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert got[1].sum() > 0
