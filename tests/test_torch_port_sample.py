"""The volume sampler N4 (``uni3detr_tpu_torch/ops/sample.py``) on the CPU:
the plain backward that the kernel's gradient follows against autograd
of the plain forward, at corners outside every face of the volume, on
the OV view transformer's non-contiguous C = 1 depth volume, and the
wrappers' launch counts (the plain path launches nothing; the backward
wrapper takes CUDA tensors only). The kernel itself is held to these
plain versions on the card (``tests/test_torch_port_cuda.py``), and the
plain backward to ``jax.grad`` of the JAX package's sampler in
``tests/test_torch_port_modules.py``. No JAX here.

Tolerances: where no voxel takes terms from two points (``_lattice``),
every voxel's gradient is one product in both versions and must be
equal; where points share voxels the sums run in another order (the
plain backward adds corner after corner into one volume, autograd adds
eight per-corner volumes), within 4 ulps of the dtype at the largest
entry. The coordinates' gradient: the plain backward sums in fp32, while
autograd of a bf16 forward rounds every step of the chain to bf16, so
within 2^-5 of the largest entry under bf16 (measured: 2^-7.4), 1e-5 in
fp32.
"""
import numpy as np
import pytest
import torch

from uni3detr_tpu_torch.ops import sample

SIZES = (9, 13, 17)         # D, H, W
SPACING = 4                 # cells between two points' lower corners


def _coord(cell, frac, size):
    """The normalized coordinate of position ``cell + frac`` (voxel
    units) on an axis of ``size`` voxels (align_corners=False)."""
    return (2.0 * (cell + frac) + 1.0) / size - 1.0


def _lattice(rng, B, face=None):
    """(B, N, 3) points whose 2 x 2 x 2 neighbourhoods are disjoint: lower
    corners on a lattice of spacing SPACING (a bf16 rounding of the
    coordinate moves a corner by at most one voxel). ``face`` ("x-" ...
    "z+") puts every point across that face of the volume instead: the
    lower corner at -1 or at the last voxel, so half of its corners lie
    outside."""
    D, H, W = SIZES
    sizes = (W, H, D)
    cells = [np.arange(0, s - 1, SPACING) for s in sizes]
    if face is not None:
        axis = "xyz".index(face[0])
        cells[axis] = np.array([-1 if face[1] == "-" else sizes[axis] - 1])
    grid = np.stack(np.meshgrid(*cells, indexing="ij"), -1).reshape(-1, 3)
    n = min(len(grid), 12)
    out = np.empty((B, n, 3), np.float32)
    for b in range(B):
        pick = grid[rng.choice(len(grid), n, replace=False)]
        frac = rng.uniform(0.05, 0.95, (n, 3))
        out[b] = _coord(pick, frac, np.array(sizes))
    return torch.from_numpy(out)


def _points(rng, B, case):
    if case == "dense":        # points sharing voxels, some outside
        return torch.from_numpy(
            rng.uniform(-1.2, 1.2, (B, 200, 3)).astype(np.float32))
    if case == "outside":      # every corner outside
        return torch.from_numpy(
            rng.uniform(1.3, 2.0, (B, 20, 3)).astype(np.float32))
    return _lattice(rng, B, None if case == "lattice" else case)


def _ulp(dtype):
    return 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23


CASES = ["lattice", "x-", "x+", "y-", "y+", "z-", "z+", "outside", "dense"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_grid_sample_3d_backward_plain_matches_autograd(dtype, case):
    rng = np.random.RandomState(CASES.index(case))
    B, C = 2, 8
    vol = torch.from_numpy(rng.randn(B, *SIZES, C).astype(np.float32)).to(
        dtype).requires_grad_()
    pts = _points(rng, B, case).requires_grad_()
    out = sample.grid_sample_3d_plain(vol, pts)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dtype)
    want_v, want_c = torch.autograd.grad(out, (vol, pts), g)
    got_v, got_c = sample.grid_sample_3d_backward_plain(
        vol.detach(), pts.detach(), g, True, True)
    assert got_v.dtype == dtype and got_c.dtype == torch.float32
    if case == "dense":
        tol = 4 * _ulp(dtype) * want_v.float().abs().max().item()
        assert (got_v.float() - want_v.float()).abs().max().item() <= tol
    else:
        assert torch.equal(got_v, want_v)
    if case == "outside":
        assert not out.any() and not got_v.any() and not got_c.any()
    elif case != "lattice" and case != "dense":
        # the corners across the face take no gradient; the ones inside do
        assert out.abs().sum() > 0 and got_v.abs().sum() > 0
    rtol = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5
    scale = want_c.abs().max().item()
    assert (got_c - want_c).abs().max().item() <= rtol * scale + 1e-6


@pytest.mark.parametrize("which", [(True, False), (False, True),
                                   (False, False)])
def test_grid_sample_3d_backward_plain_asked_gradients(which):
    rng = np.random.RandomState(3)
    vol = torch.from_numpy(rng.randn(1, *SIZES, 4).astype(np.float32))
    pts = _points(rng, 1, "dense")
    g = torch.ones(1, pts.shape[1], 4)
    gv, gc = sample.grid_sample_3d_backward_plain(vol, pts, g, *which)
    full = sample.grid_sample_3d_backward_plain(vol, pts, g, True, True)
    for got, asked, ref in zip((gv, gc), which, full):
        assert (got is None) == (not asked)
        if asked:
            assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_3d_ov_depth_volume(dtype):
    """OV's view transformer samples a (B*N, DD, Hl, Wl, 1) depth volume
    that is a permuted view of the depth net's (B*N, Hl, Wl, DD) output
    (``models/view_trans.py``), at camera-frustum points partly outside."""
    rng = np.random.RandomState(5)
    depth = torch.from_numpy(rng.rand(3, 6, 10, 12).astype(np.float32)).to(
        dtype).requires_grad_()
    dvol = depth.permute(0, 3, 1, 2)[..., None]
    assert not dvol.is_contiguous()
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (3, 150, 3)).astype(
        np.float32))
    got = sample.grid_sample_3d(dvol, pts)
    assert torch.equal(got, sample.grid_sample_3d_plain(
        dvol.detach().contiguous(), pts))
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(dtype)
    (want,) = torch.autograd.grad(got, depth, g)
    gv, _ = sample.grid_sample_3d_backward_plain(dvol.detach(), pts, g)
    tol = 4 * _ulp(dtype) * want.float().abs().max().item()
    assert gv.shape == dvol.shape
    assert (gv.permute(0, 2, 3, 1, 4)[..., 0].float()
            - want.float()).abs().max().item() <= tol


def test_grid_sample_3d_cpu_launches_nothing():
    """CPU tensors take the plain version, with autograd: neither
    wrapper's launch count moves, and the backward wrapper, which is the
    kernel's alone, refuses them."""
    before = (sample.grid_sample_3d.launches,
              sample.grid_sample_3d_backward.launches)
    rng = np.random.RandomState(7)
    vol = torch.from_numpy(rng.randn(2, *SIZES, 8).astype(np.float32)) \
        .requires_grad_()
    pts = _points(rng, 2, "dense").requires_grad_()
    out = sample.grid_sample_3d(vol, pts)
    assert torch.equal(out, sample.grid_sample_3d_plain(vol, pts))
    out.sum().backward()
    assert vol.grad is not None and pts.grad is not None
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sample.grid_sample_3d_backward(vol.detach(), pts.detach(),
                                       torch.ones_like(out), True, True)
    assert (sample.grid_sample_3d.launches,
            sample.grid_sample_3d_backward.launches) == before


def test_grid_sample_3d_refuses_bad_shapes():
    vol = torch.zeros(1, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        sample.grid_sample_3d(vol, torch.zeros(1, 7, 2))
    with pytest.raises(ValueError):
        sample.grid_sample_3d(vol[0], torch.zeros(1, 7, 3))
    with pytest.raises(ValueError):
        sample.grid_sample_3d_backward(vol, torch.zeros(2, 7, 3),
                                       torch.zeros(2, 7, 5))
