"""The port's whole flagship slice against the JAX package, on the CPU.

``uni3detr_tiny_synthetic`` in fp32 (narrow widths, two decoder layers,
the same layer structure as the SUN RGB-D flagship): points -> voxels ->
sparse encoder -> backbone/neck -> paired FPS -> 4-group head ->
decode -> per-class NMS. JAX runs ``Uni3DETR.apply`` (its CPU route: XLA
gathers and XLA FPS); the port runs its plain kernel versions, with the
weights brought over by ``state_dict_from_jax``.

Tolerances: voxel coords, FPS indices, labels and keep masks equal; the
three output stacks within atol 1e-4 (fp32 sums in another order
through ~20 convs and the decoder; observed ~1e-6); decoded boxes
within 1e-4.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.models.detector import Uni3DETR as JModel
from uni3detr_tpu.ops.fps import farthest_point_sample_xla
from uni3detr_tpu.ops.voxelize import hard_voxelize
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.weights import state_dict_from_jax
from test_torch_import import clustered_cloud, make_state_dict

CFG = jpresets.TINY_SYNTHETIC
ATOL = 1e-4


def _scene(seed):
    rng = np.random.RandomState(seed)
    pts = clustered_cloud(rng, CFG, n_clusters=8, max_cells=5)
    pts = np.concatenate([pts, pts + 0.01]).astype(np.float32)[None]
    mask = np.ones(pts.shape[:2], bool)
    mask[0, -7:] = False
    rnd = rng.rand(1, CFG.num_query, 3).astype(np.float32)
    return pts, mask, rnd


@pytest.fixture(scope="module")
def runs():
    v = import_torch_state_dict(
        make_state_dict(CFG, np.random.RandomState(3)), CFG)
    model = TModel(tpresets.TINY_SYNTHETIC).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, CFG).items()}, strict=True)
    out = []
    for seed in (0, 1):
        pts, mask, rnd = _scene(seed)
        jout = JModel(CFG).apply(v, jnp.asarray(pts), jnp.asarray(mask),
                                 train=False, random_points=jnp.asarray(rnd))
        tout, inter = model(torch.from_numpy(pts), torch.from_numpy(mask),
                            torch.from_numpy(rnd), return_intermediates=True)
        out.append(((pts, mask), jout, tout, inter))
    return out


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_detector_outputs_match_jax(runs, scene):
    _, jout, tout, _ = runs[scene]
    for k in ("all_cls_scores", "all_bbox_preds", "all_iou_preds"):
        assert tout[k].shape == jout[k].shape
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_detector_voxels_and_fps_match_jax(runs, scene):
    (pts, mask), _, _, inter = runs[scene]
    feats, coords, vmask = hard_voxelize(
        jnp.asarray(pts), jnp.asarray(mask), pc_range=CFG.pc_range,
        voxel_size=CFG.voxel_size, grid_size=CFG.grid_size,
        max_points=CFG.max_points_per_voxel, max_voxels=CFG.max_voxels_test)
    np.testing.assert_array_equal(inter["vmask"].numpy(), np.asarray(vmask))
    np.testing.assert_array_equal(inter["coords"].numpy(), np.asarray(coords))
    vc = jnp.where(vmask[..., None], coords[..., ::-1].astype(jnp.float32),
                   0.0)
    idx1 = farthest_point_sample_xla(jnp.asarray(pts[..., :3]),
                                     jnp.asarray(mask), CFG.num_query)
    idx2 = farthest_point_sample_xla(vc, vmask, CFG.num_query)
    np.testing.assert_array_equal(inter["fps_idx"][0].numpy(),
                                  np.asarray(idx1))
    np.testing.assert_array_equal(inter["fps_idx"][1].numpy(),
                                  np.asarray(idx2))


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_detector_boxes_match_jax(runs, scene):
    _, jout, tout, _ = runs[scene]
    jb, js, jl, jv = map(np.asarray, jcoder.post_process(
        *jcoder.decode_predictions(jout, CFG), CFG))
    tb, ts, tl, tv = tcoder.post_process(
        *tcoder.decode_predictions(tout, CFG), CFG)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb.numpy()[jv], jb[jv], rtol=0, atol=ATOL)
    assert jv.sum() > 0


def test_port_train_mode_forward_shapes():
    """Train mode (``model.train()``): three query groups per layer (no
    random group), finite outputs with a graph back to the weights, the
    train voxel budget and batch statistics."""
    model = TModel(tpresets.TINY_SYNTHETIC).train()
    pts, mask, _ = _scene(2)
    outs, inter = model(torch.from_numpy(pts), torch.from_numpy(mask),
                        return_intermediates=True)
    L, nq = CFG.num_decoder_layers, 3 * CFG.num_query
    assert tuple(outs["all_cls_scores"].shape) == (L, 1, nq, CFG.num_classes)
    assert tuple(outs["all_bbox_preds"].shape) == (L, 1, nq, CFG.code_size)
    assert tuple(outs["all_iou_preds"].shape) == (L, 1, nq)
    for v in outs.values():
        assert v.requires_grad and bool(torch.isfinite(v).all())
    assert inter["vmask"].shape[1] == CFG.max_voxels
    bn = model.pts_middle_encoder.conv_input[1]
    assert int(bn.num_batches_tracked) == 1
