"""The port's modules against the JAX package, one at a time, on the CPU.

Inputs are made with numpy and fed to both; weights come from one set
of reference-layout random weights (``make_state_dict``), imported into
JAX with ``import_torch_state_dict`` and into the port with
``state_dict_from_jax``. Tolerances are fp32 unless stated: integer and
boolean results (voxel coords, site sets, keep masks) must be equal.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.geom.iou import iou3d_rotated as j_iou3d
from uni3detr_tpu.models.head import Uni3DETRHead as JHead
from uni3detr_tpu.models.layers import sine_pos_embed as j_sine
from uni3detr_tpu.models.second3d import SECOND3D as JBackbone
from uni3detr_tpu.models.second3d import SECOND3DFPN as JNeck
from uni3detr_tpu.models.sparse_encoder import SparseEncoderHD as JEncoder
from uni3detr_tpu.ops import nms as jnms
from uni3detr_tpu.ops.sample import grid_sample_3d as j_grid_sample
from uni3detr_tpu.ops.sparse_conv import downsample_sites as j_downsample
from uni3detr_tpu.ops.voxelize import hard_voxelize as j_voxelize
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.geom.iou import iou3d_rotated as t_iou3d
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.models.layers import sine_pos_embed as t_sine
from uni3detr_tpu_torch.ops import nms as tnms
from uni3detr_tpu_torch.ops import sample as t_sample
from uni3detr_tpu_torch.ops.sample import grid_sample_3d as t_grid_sample
from uni3detr_tpu_torch.ops.sparse_conv import downsample_sites as t_downsample
from uni3detr_tpu_torch.ops.voxelize import hard_voxelize as t_voxelize
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.weights import state_dict_from_jax
from test_torch_import import clustered_cloud, make_state_dict

TINY = jpresets.TINY_SYNTHETIC


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny():
    """(JAX variables, port model) sharing one set of random weights."""
    v = import_torch_state_dict(
        make_state_dict(TINY, np.random.RandomState(0)), TINY)
    model = TModel(tpresets.TINY_SYNTHETIC).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, TINY).items()}, strict=True)
    return v, model


# -- config, weights, package rules ---------------------------------------

@pytest.mark.parametrize("name", sorted(tpresets.PRESETS))
def test_presets_equal_jax_presets(name):
    assert dataclasses.asdict(tpresets.PRESETS[name]) == \
        dataclasses.asdict(jpresets.PRESETS[name])


def test_config_fields_equal_jax_config():
    from uni3detr_tpu.models.config import Uni3DETRConfig as JCfg
    from uni3detr_tpu_torch.config import Uni3DETRConfig as TCfg
    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(JCfg())
    assert tpresets.SUNRGBD.torch_dtype == torch.bfloat16
    assert TCfg().torch_dtype == torch.float32


def test_port_imports_no_jax():
    """Every module of the port, ``chip_smoke.py``, the port's train,
    inference and evaluation profile tools and ``tools/ddp_cards.py``
    import no JAX, flax or JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pkgutil, importlib, importlib.util\n"
            f"sys.path[:0] = [{root!r}, {os.path.join(root, 'tools')!r}]\n"
            "import uni3detr_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "for name in ('chip_smoke', 'profile_torch_train', "
            "'profile_torch_flagship', 'profile_torch_eval', "
            "'ddp_cards'):\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'uni3detr_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_weights_round_trip_leaf_for_leaf(tiny):
    v, model = tiny
    sd = state_dict_from_jax(v, TINY)
    back = import_torch_state_dict(sd, TINY)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    # the port's own state_dict imports to the same variables
    back2 = import_torch_state_dict(model.state_dict(), TINY)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back2, v)


@pytest.mark.parametrize("name", sorted(tpresets.PRESETS))
def test_state_dict_has_reference_layout(name):
    """Keys and shapes equal the reference checkpoint layout (sparse conv
    weights in the mmcv (kd, kh, kw, in, out) layout); the OV presets
    build the OV model, against the OV layout of their mode."""
    cfg = jpresets.PRESETS[name]
    if name.startswith("ov_"):
        from test_torch_port_ov import reference_layout
        from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
        ref = reference_layout(cfg, np.random.RandomState(1))
        ours = OV_Uni3DETR(tpresets.PRESETS[name]).state_dict()
    else:
        ref = make_state_dict(cfg, np.random.RandomState(1))
        ref.pop("pts_bbox_head.code_weights")
        ours = TModel(tpresets.PRESETS[name]).state_dict()
    assert sorted(ours) == sorted(ref)
    for k, a in ref.items():
        assert tuple(ours[k].shape) == tuple(np.shape(a)), k


# -- voxelizer and site sets ----------------------------------------------

def _points(seed):
    rng = np.random.RandomState(seed)
    pts = clustered_cloud(rng, TINY, n_clusters=6, max_cells=4)
    # several points per voxel (max_points cut) + points out of range
    jitter = (rng.rand(3, *pts.shape) - 0.5) * 0.1
    pts = np.concatenate([pts] + [pts + j.astype(np.float32)
                                  for j in jitter])
    pts = np.concatenate([pts, np.full((5, 3), 9.0, np.float32)])
    rng.shuffle(pts)
    mask = rng.rand(len(pts)) > 0.1
    return pts[None], mask[None]


@pytest.mark.parametrize("max_voxels", [256, 64])
def test_hard_voxelize_matches_jax(max_voxels):
    pts, mask = _points(3)
    kw = dict(pc_range=TINY.pc_range, voxel_size=TINY.voxel_size,
              grid_size=TINY.grid_size, max_points=TINY.max_points_per_voxel,
              max_voxels=max_voxels)
    jf, jc, jm = j_voxelize(jnp.asarray(pts), jnp.asarray(mask), **kw)
    tf, tc, tm = t_voxelize(_t(pts), _t(mask), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-5)
    if max_voxels == 64:                        # the budget cut applies
        assert int(tm.sum()) == 64


@pytest.mark.parametrize("padding,budget", [((1, 1, 1), 256),
                                            ((0, 1, 1), 40)])
def test_downsample_sites_matches_jax(padding, budget):
    pts, mask = _points(5)
    _, jc, jm = j_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                           pc_range=TINY.pc_range,
                           voxel_size=TINY.voxel_size,
                           grid_size=TINY.grid_size, max_points=4,
                           max_voxels=256)
    joc, jom, jg = j_downsample(jc[0], jm[0], TINY.grid_size, padding,
                                budget)
    toc, tom, tg = t_downsample(_t(jc), _t(jm), TINY.grid_size, padding,
                                budget)
    assert tg == jg
    np.testing.assert_array_equal(tom[0].numpy(), np.asarray(jom))
    np.testing.assert_array_equal(toc[0].numpy(), np.asarray(joc))


# -- encoder, backbone, neck ----------------------------------------------

def test_sparse_encoder_matches_jax(tiny):
    v, model = tiny
    pts, mask = _points(7)
    feats, coords, vmask = j_voxelize(
        jnp.asarray(pts), jnp.asarray(mask), pc_range=TINY.pc_range,
        voxel_size=TINY.voxel_size, grid_size=TINY.grid_size,
        max_points=4, max_voxels=256)
    enc = JEncoder(sparse_shape=TINY.grid_size,
                   base_channels=TINY.encoder_base_channels,
                   output_channels=TINY.encoder_out_channels,
                   encoder_channels=TINY.encoder_channels,
                   downsample_paddings=TINY.encoder_downsample_paddings,
                   budget_shrink=TINY.encoder_budget_shrink)
    jvol, jgrid = enc.apply(
        {"params": v["params"]["pts_middle_encoder"],
         "batch_stats": v["batch_stats"]["pts_middle_encoder"]},
        feats, coords, vmask, False)
    with torch.no_grad():
        tvol, tgrid = model.pts_middle_encoder(_t(feats), _t(coords),
                                               _t(vmask))
    assert tgrid == jgrid
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), rtol=0,
                               atol=1e-4)
    assert np.abs(np.asarray(jvol)).max() > 0


def test_backbone_and_neck_match_jax(tiny):
    v, model = tiny
    rng = np.random.RandomState(2)
    D, H, W = 2, 8, 8
    vol = rng.randn(1, D, H, W, TINY.encoder_out_channels).astype(np.float32)
    bb = JBackbone(out_channels=TINY.backbone_channels,
                   layer_nums=TINY.backbone_layers,
                   layer_strides=TINY.backbone_strides)
    neck = JNeck(out_channels=TINY.neck_channels,
                 upsample_strides=TINY.neck_upsample_strides)
    pv = lambda n: {"params": v["params"][n],
                    "batch_stats": v["batch_stats"][n]}
    jms = bb.apply(pv("pts_backbone"), jnp.asarray(vol), False)
    jout = neck.apply(pv("pts_neck"), jms, False)
    with torch.no_grad():
        tms = model.pts_backbone(_t(vol).permute(0, 4, 1, 2, 3))
        tout = model.pts_neck(tms).permute(0, 2, 3, 4, 1)
    for a, b in zip(tms, jms):
        np.testing.assert_allclose(a.permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4)


# -- decoder side ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_3d_matches_jax(dtype):
    rng = np.random.RandomState(9)
    vol = rng.randn(2, 3, 5, 6, 8).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 40, 3)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_grid_sample(jnp.asarray(vol, jd), jnp.asarray(coords))
    got = t_grid_sample(_t(vol).to(td), _t(coords))
    assert got.dtype == td
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    else:
        # coords, weights and the 8-term sum in bf16 on both sides; XLA
        # may keep fused intermediates in fp32, so allow a few bf16 ulps
        # of the largest value
        tol = 4 * 2.0 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("spread", [1.2, 1.02])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_3d_backward_plain_matches_jax_grad(dtype, spread):
    """The port's plain backward of the sampler, which its card kernel
    follows, against ``jax.vjp`` of the JAX package's sampler on the same
    volume, points (corners across every face; ``spread`` 1.2 puts some
    points wholly outside) and cotangent. The volume's gradient: the same
    products summed in another order, within 4 ulps of the dtype at the
    largest entry. The coordinates': the port sums each point's C-channel
    dot products and the weights' factors in fp32, where JAX's chain
    rounds every step to the volume's dtype, so within 2^-5 of the largest
    entry under bf16 and 1e-5 in fp32."""
    rng = np.random.RandomState(11)
    vol = rng.randn(2, 4, 6, 7, 16).astype(np.float32)
    coords = rng.uniform(-spread, spread, (2, 120, 3)).astype(np.float32)
    g = rng.randn(2, 120, 16).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(j_grid_sample, jnp.asarray(vol, jd),
                       jnp.asarray(coords))
    ref_v, ref_c = vjp(jnp.asarray(g, jd))
    got_v, got_c = t_sample.grid_sample_3d_backward_plain(
        _t(vol).to(td), _t(coords), _t(g).to(td), True, True)
    assert got_v.dtype == td and got_c.dtype == torch.float32
    ref_v = np.asarray(ref_v.astype(jnp.float32))
    ref_c = np.asarray(ref_c.astype(jnp.float32))
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23
    np.testing.assert_allclose(got_v.float().numpy(), ref_v, rtol=0,
                               atol=4 * ulp * np.abs(ref_v).max())
    rtol = 2.0 ** -5 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=0,
                               atol=rtol * np.abs(ref_c).max())
    assert np.abs(ref_c).max() > 0 and (ref_v == 0).any()


def test_sine_pos_embed_matches_jax():
    pos = np.random.RandomState(0).rand(2, 7, 3).astype(np.float32)
    np.testing.assert_allclose(t_sine(_t(pos)).numpy(),
                               np.asarray(j_sine(jnp.asarray(pos))),
                               rtol=0, atol=1e-5)


def test_head_matches_jax(tiny):
    v, model = tiny
    rng = np.random.RandomState(4)
    nq = TINY.num_query
    vol = rng.randn(1, 3, 6, 6, TINY.embed_dim).astype(np.float32)
    fps = rng.rand(1, 2 * nq, 3).astype(np.float32)
    rnd = rng.rand(1, nq, 3).astype(np.float32)
    head = JHead(num_classes=TINY.num_classes, num_query=nq,
                 code_size=TINY.code_size, embed_dim=TINY.embed_dim,
                 num_decoder_layers=TINY.num_decoder_layers,
                 num_heads=TINY.num_heads, ffn_dim=TINY.ffn_dim,
                 pc_range=TINY.pc_range)
    jout = head.apply({"params": v["params"]["pts_bbox_head"]},
                      jnp.asarray(vol), jnp.asarray(fps), train=False,
                      random_points=jnp.asarray(rnd))
    with torch.no_grad():
        tout = model.pts_bbox_head(_t(vol), _t(fps), _t(rnd))
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4)


# -- IoU, NMS, decode ------------------------------------------------------

def _boxes(rng, n):
    b = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                        rng.uniform(0.3, 1.5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b[5] = b[4]                                   # identical pair
    b[7] = b[6] + [0, 0, 0, 0, 0, 0, np.pi / 2]   # square-ish rotations
    b[9, :2] = b[8, :2] + b[8, 3:5]               # touching corners
    b[9, 6] = b[8, 6] = 0.0
    return b.astype(np.float32)


@pytest.mark.parametrize("z_origin", ["center", "bottom"])
def test_iou3d_rotated_matches_jax(z_origin):
    rng = np.random.RandomState(12)
    b1, b2 = _boxes(rng, 30), _boxes(rng, 20)
    ref = np.asarray(j_iou3d(jnp.asarray(b1), jnp.asarray(b2), z_origin))
    got = t_iou3d(_t(b1), _t(b2), z_origin).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (ref > 0.1).sum() > 5


def test_greedy_suppress_matches_jax():
    """Keep masks on a shared IoU matrix, with tied scores."""
    rng = np.random.RandomState(21)
    b = _boxes(rng, 60)
    b[:, :2] *= 0.3                               # many overlaps
    iou = np.asarray(j_iou3d(jnp.asarray(b), jnp.asarray(b), "bottom"))
    scores = np.round(rng.rand(60), 1).astype(np.float32)   # ties
    valid = rng.rand(3, 60) > 0.2
    for thr in (0.1, 0.5):
        ref = np.stack([np.asarray(jnms._greedy_suppress(
            jnp.asarray(iou), jnp.asarray(scores), jnp.asarray(v), thr))
            for v in valid])
        got = tnms._greedy_suppress(_t(iou), _t(scores), _t(valid), thr)
        np.testing.assert_array_equal(got.numpy(), ref)
        for c in range(3):
            serial = tnms._greedy_suppress_serial(_t(iou), _t(scores),
                                                  _t(valid[c]), thr)
            np.testing.assert_array_equal(serial.numpy(), ref[c])
        assert 0 < ref.sum() < valid.sum()


def test_decode_and_nms_match_jax():
    cfg = dataclasses.replace(TINY, max_num=40, nms_thr=0.3)
    rng = np.random.RandomState(5)
    L, B, Q, ncls = TINY.num_decoder_layers, 2, 24, TINY.num_classes
    cls = np.round(rng.randn(L, B, Q, ncls), 1)     # tied scores
    box = np.concatenate([rng.uniform(-0.6, 0.6, (L, B, Q, 2)),
                          rng.uniform(-1, 0.3, (L, B, Q, 2)),
                          rng.uniform(-0.9, 0.9, (L, B, Q, 1)),
                          rng.uniform(-1, 0.3, (L, B, Q, 1)),
                          rng.uniform(-1, 1, (L, B, Q, 2))], -1)
    box[..., 0] *= 3.0                              # some out of range
    outs = {"all_cls_scores": cls, "all_bbox_preds": box,
            "all_iou_preds": rng.randn(L, B, Q)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    jdec = jcoder.decode_predictions(
        {k: jnp.asarray(v) for k, v in outs.items()}, cfg)
    jpost = jcoder.post_process(*jdec, cfg)
    tdec = tcoder.decode_predictions({k: _t(v) for k, v in outs.items()},
                                     cfg)
    tpost = tcoder.post_process(*tdec, cfg)
    for stage_j, stage_t in ((jdec, tdec), (jpost, tpost)):
        boxes_j, scores_j, labels_j, valid_j = map(np.asarray, stage_j)
        np.testing.assert_array_equal(stage_t[2].numpy(), labels_j)
        np.testing.assert_array_equal(stage_t[3].numpy(), valid_j)
        np.testing.assert_allclose(stage_t[0].numpy(), boxes_j, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(stage_t[1].numpy(), scores_j, rtol=0,
                                   atol=1e-6)
    assert 0 < np.asarray(jpost[3]).sum() < np.asarray(jdec[3]).sum()
