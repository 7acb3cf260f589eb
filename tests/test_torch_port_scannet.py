"""The port's ScanNet slice (``uni3detr_scannet`` and
``uni3detr_scannet_large``) and its NMS against the JAX package, on the
CPU.

- Both presets equal the JAX presets; the wide ``scannet_large`` weights
  (32..256 sparse widths, ``conv_out`` to 512) carry across from JAX
  parameters leaf for leaf and load into the port's model.
- A tiny config with ``dynamic_voxelization=True``: the voxels equal the
  JAX ``dynamic_voxelize``'s (every point of a voxel in its mean, not the
  first ``max_points``), and the forward's three output stacks are within
  atol 1e-4 of JAX's, as in ``test_torch_port_slice.py`` (fp32 sums in
  another order through ~20 convs and the decoder), weights carried
  across by ``weights.state_dict_from_jax``.
- NMS at ScanNet's 18 classes on 512 clustered boxes (chains of overlaps,
  IoUs within 2e-4 relative of ``nms_thr``): the port's ``post_process``
  (its plain path on the CPU) keeps the set JAX's keeps, exactly; a
  plain PyTorch model of the card's algorithm (one label-folded bitmask
  in rank order, ``ops.nms.overlap_mask_plain``, and the serial scan,
  ``ops.nms.greedy_scan_plain``) keeps what JAX's per-class
  ``_greedy_suppress`` keeps, exactly.
- The plain rotated IoU against JAX on degenerate pairs (identical boxes,
  touching edges, one box inside another, 90 and 45 degree rotations,
  zero height) within atol 1e-6 (fp32 rounding of one clip; the values
  are O(1)).
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.geom.iou import iou3d_rotated as j_iou3d
from uni3detr_tpu.models.detector import Uni3DETR as JModel
from uni3detr_tpu.ops import nms as jnms
from uni3detr_tpu.ops.voxelize import dynamic_voxelize as j_dynamic
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.geom.iou import (iou3d_rotated as t_iou3d,
                                         iou3d_rotated_pairwise)
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.ops import nms as tnms
from uni3detr_tpu_torch.ops.voxelize import (dynamic_voxelize as t_dynamic,
                                             hard_voxelize as t_hard)
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.weights import state_dict_from_jax
from nms_cases import clustered_boxes, degenerate_pairs
from test_torch_import import clustered_cloud, make_state_dict

SCANNET_NAMES = ("uni3detr_scannet", "uni3detr_scannet_large")
ATOL = 1e-4          # tiny forward, fp32 (as test_torch_port_slice.py)
IOU_ATOL = 1e-6      # one pair's clip in fp32
NMS_THR = jpresets.SCANNET.nms_thr


def _t(x):
    return torch.from_numpy(np.array(x))


# -- presets and weights -----------------------------------------------------

@pytest.mark.parametrize("name", SCANNET_NAMES)
def test_scannet_presets_equal_jax(name):
    assert dataclasses.asdict(tpresets.PRESETS[name]) == \
        dataclasses.asdict(jpresets.PRESETS[name])


def test_scannet_large_weights_carry_across_from_jax():
    """The 32..256 sparse widths and the 512-wide conv_out build, and a
    JAX parameter tree of the preset comes across leaf for leaf."""
    cfg = jpresets.SCANNET_LARGE
    sd = make_state_dict(cfg, np.random.RandomState(0))
    sd.pop("pts_bbox_head.code_weights")
    ours = state_dict_from_jax(import_torch_state_dict(sd, cfg), cfg)
    assert sorted(ours) == sorted(sd)
    for k, a in sd.items():
        if not k.endswith("num_batches_tracked"):   # JAX keeps no count
            np.testing.assert_array_equal(ours[k], np.asarray(a), err_msg=k)
    model = TModel(tpresets.SCANNET_LARGE)
    model.load_state_dict({k: torch.from_numpy(np.asarray(a))
                           for k, a in ours.items()}, strict=True)
    w = model.pts_middle_encoder.conv_out[0].weight
    assert w.shape[-2:] == (256, 512)


# -- dynamic voxelization ----------------------------------------------------

JCFG_DYN = dataclasses.replace(jpresets.TINY_SYNTHETIC,
                               dynamic_voxelization=True)
TCFG_DYN = dataclasses.replace(tpresets.TINY_SYNTHETIC,
                               dynamic_voxelization=True)


DENSE_POINTS = 1200


def _dense_scene(seed):
    """Clustered points, each repeated with small offsets so most voxels
    hold more than ``max_points_per_voxel`` points; a few masked."""
    rng = np.random.RandomState(seed)
    pts = clustered_cloud(rng, JCFG_DYN, n_clusters=8, max_cells=5)
    jitter = (rng.rand(5, *pts.shape) - 0.5) * 0.05
    pts = np.concatenate([pts] + [pts + j for j in jitter]).astype(
        np.float32)
    rng.shuffle(pts)
    pts = pts[:DENSE_POINTS]      # one shape: one JAX compile for both
    mask = rng.rand(len(pts)) > 0.05
    rnd = rng.rand(1, JCFG_DYN.num_query, 3).astype(np.float32)
    return pts[None], mask[None], rnd


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_voxelize_matches_jax(seed):
    pts, mask, _ = _dense_scene(seed)
    kw = dict(pc_range=JCFG_DYN.pc_range, voxel_size=JCFG_DYN.voxel_size,
              grid_size=JCFG_DYN.grid_size,
              max_voxels=JCFG_DYN.max_voxels_test)
    jf, jc, jm = map(np.asarray, j_dynamic(jnp.asarray(pts),
                                           jnp.asarray(mask), **kw))
    tf, tc, tm = t_dynamic(_t(pts), _t(mask), **kw)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-5)
    # the cap of the hard path changes the means: dynamic took every point
    hf, _, _ = t_hard(_t(pts), _t(mask), max_points=4, **kw)
    assert (hf - tf).abs().max() > 1e-3


@pytest.fixture(scope="module")
def dynamic_runs():
    v = import_torch_state_dict(
        make_state_dict(JCFG_DYN, np.random.RandomState(3)), JCFG_DYN)
    model = TModel(TCFG_DYN).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, JCFG_DYN).items()},
                          strict=True)
    japply = jax.jit(functools.partial(JModel(JCFG_DYN).apply, train=False))
    out = []
    for seed in (0, 1):
        pts, mask, rnd = _dense_scene(seed)
        jout = japply(v, jnp.asarray(pts), jnp.asarray(mask),
                      random_points=jnp.asarray(rnd))
        with torch.no_grad():
            tout = model(_t(pts), _t(mask), _t(rnd))
        out.append((jout, tout))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_dynamic_detector_matches_jax(dynamic_runs, seed):
    jout, tout = dynamic_runs[seed]
    for k in ("all_cls_scores", "all_bbox_preds", "all_iou_preds"):
        assert tout[k].shape == jout[k].shape
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    jb, js, jl, jv = map(np.asarray, jcoder.post_process(
        *jcoder.decode_predictions(jout, JCFG_DYN), JCFG_DYN))
    tb, ts, tl, tv = tcoder.post_process(
        *tcoder.decode_predictions(tout, TCFG_DYN), TCFG_DYN)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert jv.sum() > 0


# -- NMS at ScanNet's class count --------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_post_process_scannet_nms_matches_jax(seed):
    """512 boxes a scene, two scenes, 18 labels; keep sets equal."""
    scenes = [clustered_boxes(seed * 2 + k) for k in range(2)]
    boxes, scores, labels, valid = (np.stack(a) for a in zip(*scenes))
    cfg_j = dataclasses.replace(jpresets.SCANNET, max_num=512)
    cfg_t = dataclasses.replace(tpresets.SCANNET, max_num=512)
    jb, js, jl, jv = map(np.asarray, jcoder.post_process(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid), cfg_j))
    tb, ts, tl, tv = tcoder.post_process(_t(boxes), _t(scores), _t(labels),
                                         _t(valid), cfg_t)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-6)
    # the scenes exercise the threshold: suppression happens, and some
    # same-label pairs lie within 1e-3 of nms_thr
    assert 0 < jv.sum() < valid.sum()
    iou = t_iou3d(tb, tb, "bottom").numpy()
    same = labels[:, :, None] == labels[:, None, :]
    assert (same & (np.abs(iou - NMS_THR) < 1e-3)).sum() > 10


def _model_keep(boxes, scores, labels, valid, thr):
    """The card's algorithm in plain PyTorch: the scan order (by class,
    by rank within a class), the label-folded bitmask, the serial scan."""
    order, lab = tnms.nms_order(_t(scores), _t(labels), _t(valid))
    bx = torch.gather(_t(boxes), 1, order[..., None].expand(-1, -1, 7))
    mask = tnms.overlap_mask(bx, lab, thr)
    return tnms.greedy_scan(mask, lab, order).numpy()


@jax.jit
def _jax_per_class_keep(iou, scores, labels, valid, thr):
    """The JAX coder's NMS: ``_greedy_suppress`` per class, any class."""
    def one(c):
        return jnms._greedy_suppress(iou, scores, valid & (labels == c), thr)
    return jnp.any(jax.vmap(one)(jnp.arange(18)), axis=0)


@pytest.mark.parametrize("thr", [0.25, NMS_THR])
@pytest.mark.parametrize("n", [512, 300])
def test_bitmask_scan_model_matches_jax_per_class(thr, n):
    """The label-folded bitmask and its serial scan keep what JAX's
    per-class wavefront keeps on the same IoU matrix (the port's plain
    one; the IoU itself is held to JAX's above and below), over N = 512
    (8 full words) and 300 (a ragged last word)."""
    scenes = [clustered_boxes(10 + k, n=n) for k in range(2)]
    boxes, scores, labels, valid = (np.stack(a) for a in zip(*scenes))
    ref = np.stack([np.asarray(_jax_per_class_keep(
        jnp.asarray(t_iou3d(_t(boxes[b]), _t(boxes[b]), "bottom").numpy()),
        jnp.asarray(scores[b]), jnp.asarray(labels[b]),
        jnp.asarray(valid[b]), thr)) for b in range(2)])
    got = _model_keep(boxes, scores, labels, valid, thr)
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < valid.sum()
    # and the plain per-class path that nms_keep takes on the CPU
    plain = tnms.nms_keep(_t(boxes), _t(scores), _t(labels), _t(valid),
                          thr, 18)
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_bitmask_words_round_trip_and_layout():
    rng = np.random.RandomState(0)
    for m in (1, 63, 64, 65, 200):
        bits = torch.from_numpy(rng.rand(3, m) > 0.5)
        words = tnms._pack_bits(bits)
        assert words.shape == (3, -(-m // 64)) and words.dtype == torch.int64
        assert torch.equal(tnms._unpack_bits(words, m), bits)
    one = torch.zeros(1, 64, dtype=torch.bool)
    one[0, 63] = True
    assert int(tnms._pack_bits(one)) == -2 ** 63     # bit 63: the sign bit


def test_nms_edge_cases_model_matches_serial():
    """One box; all boxes invalid; all boxes of one class at N = 65: the
    model's keep set equals the serial oracle's."""
    boxes, scores, labels, valid = clustered_boxes(7, n=65)
    cases = [(boxes[:1], scores[:1], labels[:1], np.ones(1, bool)),
             (boxes, scores, labels, np.zeros(65, bool)),
             (boxes, scores, np.zeros(65, np.int32), valid)]
    for b, s, lab, v in cases:
        got = _model_keep(b[None], s[None], lab[None], v[None], NMS_THR)[0]
        iou = t_iou3d(_t(b), _t(b), "bottom")
        want = np.zeros(len(b), bool)
        for c in np.unique(lab):
            want |= tnms._greedy_suppress_serial(
                iou, _t(s), _t(v & (lab == c)), NMS_THR).numpy()
        np.testing.assert_array_equal(got, want)


# -- plain rotated IoU on degenerate pairs -----------------------------------

@pytest.mark.parametrize("z_origin", ["center", "bottom"])
def test_plain_iou_degenerate_pairs_match_jax(z_origin):
    pairs = degenerate_pairs()
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    ref = np.asarray(j_iou3d(jnp.asarray(a), jnp.asarray(b), z_origin))
    got = t_iou3d(_t(a), _t(b), z_origin).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)
    np.testing.assert_allclose(np.diag(ref)[0], 1.0, atol=IOU_ATOL)
    # the wrapper's CPU path is the plain version
    both = np.concatenate([a, b])[None]
    np.testing.assert_array_equal(
        iou3d_rotated_pairwise(_t(both), z_origin)[0].numpy(),
        t_iou3d(_t(both[0]), _t(both[0]), z_origin).numpy())
