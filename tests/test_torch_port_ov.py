"""The port's OV-Uni3DETR inference against the JAX package on the CPU.

At ``OV_TINY`` (``tests/test_ov.py``: the tiny Lidar model with a
full-width ResNet-50 + DCNv2, a 32x32 image, 8 depth bins, one view
conv, two FPN levels and a 16-d CLIP space): the config, the weight
layout and bridge, ``grid_sample_2d``, DCN (non-zero offsets, taps
between pixels and outside the image), the bottleneck, ResNet + FPN
(one input size off the exact 2x ratio), the lift and the view
transformer in its three sweep modes, the CLIP head in both group modes,
and the whole eval forward in multimodal, Lidar-only and camera-only
mode, then decoding and per-class NMS. Each JAX function runs under one
``jax.jit`` (module-scoped fixtures compile each mode once). Weights come
from the reference-layout generator ``make_ov_state_dict``, imported into
JAX with ``import_torch_state_dict_ov`` and into the port with
``state_dict_from_jax_ov``. fp32 tolerances are stated beside each check.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uni3detr_tpu.data.eval.indoor_eval import indoor_eval as j_indoor_eval
from uni3detr_tpu.models.config import OVUni3DETRConfig as JOVConfig
from uni3detr_tpu.models.dcn import DeformConv2dV2 as JDCN
from uni3detr_tpu.models.head_clip import Uni3DETRHeadCLIP as JHeadCLIP
from uni3detr_tpu.models.ov_detector import OV_Uni3DETR as JOV
from uni3detr_tpu.models.resnet import FPN as JFPN
from uni3detr_tpu.models.resnet import ResNet as JResNet
from uni3detr_tpu.models.resnet import _Bottleneck as JBottleneck
from uni3detr_tpu.models.view_trans import Uni3DViewTrans as JViewTrans
from uni3detr_tpu.models.view_trans import make_reference_voxels as j_ref
from uni3detr_tpu.models.view_trans import sample_camera_features as j_lift
from uni3detr_tpu.ops.sample import grid_sample_2d as j_grid_sample_2d
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train.torch_import import (check_structure,
                                             import_torch_state_dict_ov)
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.config import OVUni3DETRConfig as TOVConfig
from uni3detr_tpu_torch.eval.indoor_eval import indoor_eval as t_indoor_eval
from uni3detr_tpu_torch.models.dcn import DeformConv2dV2 as TDCN
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR as TOV
from uni3detr_tpu_torch.models.resnet import Bottleneck as TBottleneck
from uni3detr_tpu_torch.models.view_trans import Uni3DViewTrans as TViewTrans
from uni3detr_tpu_torch.models.view_trans import make_reference_voxels as t_ref
from uni3detr_tpu_torch.models.view_trans import (
    sample_camera_features as t_lift)
from uni3detr_tpu_torch.ops.sample import grid_sample_2d as t_grid_sample_2d
from uni3detr_tpu_torch.synthetic import ov_scene
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.weights import state_dict_from_jax_ov
from test_ov import OV_TINY, _ov_batch
from test_torch_import_ov import make_ov_state_dict

T_OV_TINY = TOVConfig(**dataclasses.asdict(OV_TINY))
MODES = {
    "mm": OV_TINY,
    "pc": dataclasses.replace(OV_TINY, use_camera=False, multimodal=False),
    "rgb": dataclasses.replace(OV_TINY, use_lidar=False, multimodal=False),
}
# the reference's dead modules (never called in its forward), which the
# JAX importer drops and the port does not build
DEAD = ("pts_conv.", "img_conv.")
PTS_KEYS = ("pts_middle_encoder.", "pts_backbone.", "pts_neck.")
IMG_KEYS = ("img_backbone.", "img_neck.", "input_proj.", "depth_net.",
            "view_trans.")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def reference_layout(cfg, rng):
    """The reference checkpoint of ``cfg``'s mode: the multimodal layout
    without the branches the mode has no use for, the fusion without both
    branches, and no dead module."""
    sd = make_ov_state_dict(cfg, rng)
    drop = DEAD + ("pts_bbox_head.code_weights",)
    if not cfg.use_lidar:
        drop += PTS_KEYS
    if not cfg.use_camera:
        drop += IMG_KEYS
    if not (cfg.use_lidar and cfg.use_camera):
        drop += ("conv_trans_head_1.",)
    return {k: v for k, v in sd.items() if not k.startswith(drop)}


def port_model(cfg, variables):
    model = TOV(TOVConfig(**dataclasses.asdict(cfg))).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax_ov(variables, cfg).items()},
                          strict=True)
    return model


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the multimodal tiny model (the other modes take
    their part of them)."""
    sd = make_ov_state_dict(OV_TINY, np.random.RandomState(0))
    return import_torch_state_dict_ov(sd, OV_TINY)


def _mode_variables(v, cfg):
    p = dict(v["params"])
    s = dict(v["batch_stats"])
    for tree in (p, s):
        for k in list(tree):
            if (not cfg.use_lidar and k.startswith("pts_") and
                    k != "pts_bbox_head") or (
                    not cfg.use_camera and k in ("img_backbone", "img_neck",
                                                 "input_proj", "depth_net",
                                                 "view_trans")) or (
                    not (cfg.use_lidar and cfg.use_camera)
                    and k.startswith("fusion_")):
                del tree[k]
    return {"params": p, "batch_stats": s, "constants": v["constants"]}


@pytest.fixture(scope="module")
def forwards(weights):
    """Per mode: (JAX outputs, JAX intermediates, port outputs, port
    intermediates) of one eval forward."""
    res = {}
    for mode, cfg in MODES.items():
        batch, _ = _ov_batch(with_img=cfg.use_camera,
                             with_pts=cfg.use_lidar)
        rp = np.random.RandomState(7).rand(1, cfg.num_query, 3).astype(
            np.float32)
        v = _mode_variables(weights, cfg)
        model = JOV(cfg)
        fn = jax.jit(lambda v, b, r: model.apply(
            v, b, train=False, random_points=r, capture_intermediates=True))
        jout, state = fn(v, batch, jnp.asarray(rp))
        tmodel = port_model(cfg, v)
        tbatch = {k: _t(a) for k, a in batch.items()}
        tout, tinter = tmodel(tbatch, _t(rp), return_intermediates=True)
        res[mode] = (jout, state["intermediates"], tout, tinter)
        del tmodel
    return res


# -- config, presets, weights ----------------------------------------------

def test_ov_config_fields_equal_jax_config():
    assert dataclasses.asdict(TOVConfig()) == dataclasses.asdict(JOVConfig())
    assert tpresets.OV_SUNRGBD_MM.torch_dtype == torch.bfloat16


def test_ov_class_names_equal_the_config():
    import runpy
    import os
    cfg = runpy.run_path(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "ov_uni3detr", "ov_uni3detr_sunrgbd_pc.py"))
    assert tpresets.OV_SUNRGBD_CLASSES == tuple(cfg["class_names"])
    assert tpresets.OV_SUNRGBD_SEEN == tuple(cfg["seen_classes"])
    assert len(tpresets.OV_SUNRGBD_CLASSES) == \
        tpresets.OV_SUNRGBD_MM.num_classes


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ov_state_dict_layout_and_strict_import(mode):
    """The port's keys and shapes are the reference checkpoint's, and its
    own state_dict imports into JAX strictly, to the structure of
    ``OV_Uni3DETR(cfg).init``."""
    cfg = MODES[mode]
    model = TOV(TOVConfig(**dataclasses.asdict(cfg)))
    ref = reference_layout(cfg, np.random.RandomState(1))
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, a in ref.items():
        assert tuple(ours[k].shape) == tuple(np.shape(a)), k
    imported = import_torch_state_dict_ov(
        {k: t.numpy() for k, t in ours.items()}, cfg, strict=True)
    batch, _ = _ov_batch(with_img=cfg.use_camera, with_pts=cfg.use_lidar)
    rp = jnp.full((1, cfg.num_query, 3), 0.5)
    shapes = jax.eval_shape(lambda: JOV(cfg).init(
        {"params": jax.random.PRNGKey(0), "modality": jax.random.PRNGKey(1)},
        batch, train=False, random_points=rp))
    missing, extra, mismatched = check_structure(
        {k: imported[k] for k in ("params", "batch_stats")}, shapes)
    assert not (missing or extra or mismatched), (missing[:4], extra[:4],
                                                  mismatched[:4])
    assert imported["constants"]["pts_bbox_head"]["zs_weights"].shape == \
        shapes["constants"]["pts_bbox_head"]["zs_weights"].shape


def test_ov_weights_round_trip_leaf_for_leaf(weights):
    v = weights
    back = import_torch_state_dict_ov(state_dict_from_jax_ov(v, OV_TINY),
                                      OV_TINY)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    assert any("constants" in str(p[0]) for p, _ in flat_v)


# -- ops -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_2d_matches_jax(dtype):
    """Leading batch axes, points up to 20% outside the image (corners
    outside weigh zero)."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, 3, 7, 9, 5).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 3, 50, 2)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(j_grid_sample_2d(jnp.asarray(img, jd),
                                      jnp.asarray(coords)).astype(jnp.float32))
    got = t_grid_sample_2d(_t(img).to(td), _t(coords))
    assert got.dtype == td and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    else:
        # coordinates, weights and the 4-term sum in bf16 on both sides;
        # XLA may keep fused intermediates in fp32: a few bf16 ulps of
        # the largest value
        tol = 4 * 2.0 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)
    assert (np.abs(coords) > 1).any()


def _conv_params(rng, cout, cin, k, bias=True, scale=1.0):
    w = rng.randn(k, k, cin, cout).astype(np.float32) * scale / np.sqrt(
        k * k * cin)
    p = {"kernel": w}
    if bias:
        p["bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
    return p


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_matches_jax(stride):
    """Offsets of a few pixels (the offset conv scaled up): taps between
    pixels and outside the image; the masks away from 0.5."""
    rng = np.random.RandomState(10 + stride)
    C, O, H, W = 6, 5, 11, 13
    x = rng.randn(2, H, W, C).astype(np.float32)
    params = {"kernel": (rng.randn(9, C, O) * 0.3).astype(np.float32),
              "offset_conv": _conv_params(rng, 27, C, 3, scale=4.0)}
    ref = jax.jit(lambda p, x: JDCN(O, 3, stride).apply({"params": p}, x))(
        params, jnp.asarray(x))
    mod = TDCN(C, O, 3, stride)
    w = params["kernel"].reshape(3, 3, C, O).transpose(3, 2, 0, 1)
    oc = params["offset_conv"]
    mod.load_state_dict({
        "weight": _t(w), "conv_offset.weight": _t(
            oc["kernel"].transpose(3, 2, 0, 1)),
        "conv_offset.bias": _t(oc["bias"])})
    xt = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        off, mask = mod.offsets_and_mask(xt)
        got = mod(xt).permute(0, 2, 3, 1)
    big = off.abs().max().item()
    print(f"DCN stride {stride}: largest |offset| {big:.2f} px, masks "
          f"{mask.min().item():.3f}..{mask.max().item():.3f}")
    assert big > 2.0 and (off.abs() > 1e-3).float().mean() > 0.9
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# -- image branch ------------------------------------------------------------

def _bottleneck_params(rng, inplanes, planes, use_dcn):
    p = {"conv1": _conv_params(rng, planes, inplanes, 1, bias=False),
         "conv3": _conv_params(rng, planes * 4, planes, 1, bias=False),
         "ds_conv": _conv_params(rng, planes * 4, inplanes, 1, bias=False)}
    if use_dcn:
        p["conv2"] = {"kernel": (rng.randn(9, planes, planes) / np.sqrt(
            9 * planes)).astype(np.float32),
            "offset_conv": _conv_params(rng, 27, planes, 3, scale=2.0)}
    else:
        p["conv2"] = _conv_params(rng, planes, planes, 3, bias=False)
    s = {}
    for name, c in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4),
                    ("ds_bn", planes * 4)):
        p[name] = {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32)}
        s[name] = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return p, s


@pytest.mark.parametrize("use_dcn,stride", [(False, 1), (False, 2),
                                            (True, 1), (True, 2)])
def test_bottleneck_matches_jax(use_dcn, stride):
    from uni3detr_tpu_torch.weights import _Out, _conv2d
    rng = np.random.RandomState(20 + 2 * use_dcn + stride)
    inplanes, planes = 16, 8
    p, s = _bottleneck_params(rng, inplanes, planes, use_dcn)
    x = rng.randn(1, 9, 11, inplanes).astype(np.float32)
    ref = jax.jit(lambda v, x: JBottleneck(
        planes, strides=stride, use_dcn=use_dcn, downsample=True).apply(
            v, x, False))({"params": p, "batch_stats": s}, jnp.asarray(x))
    o = _Out()
    _conv2d(o, "conv1", p["conv1"])
    _conv2d(o, "conv3", p["conv3"])
    _conv2d(o, "downsample.0", p["ds_conv"])
    if use_dcn:
        w = p["conv2"]["kernel"].reshape(3, 3, planes, planes)
        o.sd["conv2.weight"] = w.transpose(3, 2, 0, 1).copy()
        _conv2d(o, "conv2.conv_offset", p["conv2"]["offset_conv"])
    else:
        _conv2d(o, "conv2", p["conv2"])
    for name, key in (("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3"),
                      ("ds_bn", "downsample.1")):
        o.bn(key, p[name], s[name])
    mod = TBottleneck(inplanes, planes, stride, use_dcn, True).eval()
    mod.load_state_dict({k: _t(a) for k, a in o.sd.items()}, strict=True)
    with torch.no_grad():
        got = mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("size", [(32, 32), (36, 52)])
def test_resnet_fpn_matches_jax(weights, size):
    """The full-width ResNet-50 + DCN of OV_TINY and its FPN (5 levels).
    At 36 x 52 the stages are 9x13, 5x7, 3x4 and 2x2: the top-down
    upsampling runs at ratios 5/3 and 3/2, where JAX's half-pixel
    nearest rule and ``F.interpolate(mode="nearest")`` pick different
    pixels. Tolerance: fp32, 2e-5 of each level's largest value (50
    convs deep, activations to ~1e2)."""
    rng = np.random.RandomState(5)
    img = rng.rand(1, *size, 3).astype(np.float32)
    p, s = weights["params"], weights["batch_stats"]

    def jfn(v, x):
        feats = JResNet(stage_with_dcn=OV_TINY.stage_with_dcn,
                        frozen_stages=OV_TINY.frozen_stages).apply(
            {"params": v[0], "batch_stats": v[1]}, x, False)
        return feats, JFPN(out_channels=OV_TINY.embed_dim, num_outs=5).apply(
            {"params": v[2]}, feats)
    jfeats, jfpn = jax.jit(jfn)((p["img_backbone"], s["img_backbone"],
                                 p["img_neck"]), jnp.asarray(img))
    model = port_model(OV_TINY, weights)
    with torch.no_grad():
        tfeats = model.img_backbone(_t(img).permute(0, 3, 1, 2))
        tfpn = model.img_neck(tfeats, 5)
    for a, b in zip(tfeats + tfpn, tuple(jfeats) + tuple(jfpn)):
        b = np.asarray(b)
        a = a.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-5 * max(np.abs(b).max(), 1.0))
    assert [f.shape[2:] for f in tfeats] == [
        (9, 13), (5, 7), (3, 4), (2, 2)] or size == (32, 32)


def test_fpn_nearest_follows_jax_not_torch_default():
    """Pins the port's nearest rule: at 3 -> 5 JAX (half-pixel) takes
    rows 0, 0, 1, 2, 2; ``F.interpolate`` "nearest" 0, 0, 1, 1, 2."""
    from uni3detr_tpu_torch.models.resnet import resize_nearest
    x = torch.arange(3.0).reshape(1, 1, 3, 1)
    got = resize_nearest(x, (5, 1)).flatten().tolist()
    ref = np.asarray(jax.image.resize(jnp.arange(3.0), (5,), "nearest"))
    assert got == ref.tolist() == [0, 0, 1, 2, 2]
    assert torch.nn.functional.interpolate(
        x, size=(5, 1), mode="nearest").flatten().tolist() != got


def test_batchnorm_constants_follow_jax():
    """ResNet BN eps 1e-5 / torch momentum 0.1 (flax 0.9); the view
    convs' and the fusion's eps 1e-3 / 0.01 (flax 0.99)."""
    model = TOV(T_OV_TINY)
    assert (model.img_backbone.bn1.eps, model.img_backbone.bn1.momentum) \
        == (1e-5, 0.1)
    for bn in (model.view_trans.conv_trans_head_1[1],
               model.conv_trans_head_1[1]):
        assert (bn.eps, bn.momentum) == (1e-3, 0.01)


# -- lift ------------------------------------------------------------------

def test_reference_voxels_match_jax():
    """The same grid to an ulp: XLA contracts ``ref * span + lo`` into a
    fused multiply-add, torch rounds the product first (positions to
    6.2 m: an ulp is 4.8e-7)."""
    for shape, pr in (((40, 40, 15), tpresets.OV_SUNRGBD_MM.pc_range),
                      ((4, 4, 1), OV_TINY.pc_range), ((3, 5, 2),
                                                     (-1, 0, 2, 1, 4, 3))):
        ref = np.asarray(j_ref(shape, pr))
        got = t_ref(shape, pr).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[[0, -1]], ref[[0, -1]])


def _lift_inputs(rng, B=1, N=2, C=6, DD=5, levels=((8, 10), (4, 5))):
    feats = [rng.randn(B, N, h, w, C).astype(np.float32)
             for h, w in levels]
    depths = []
    for h, w in levels:
        d = rng.rand(B, N, h, w, DD).astype(np.float32)
        depths.append(d / d.sum(-1, keepdims=True))
    K = np.array([[9.0, 0, 5, 0], [0, 9.0, 4, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    T = np.array([[1, 0, 0, 0.3], [0, 0, -1, 0.2], [0, 1, 0, 0.5],
                  [0, 0, 0, 1]], np.float32)
    l2i = np.stack([K @ T, K @ np.diag([-1, 1, 1, 1]).astype(np.float32)
                    @ T])[None].repeat(B, 0)[:, :N]
    return feats, depths, l2i


def test_sample_camera_features_matches_jax():
    """Two cameras (the second mirrored), two levels, image augmentation;
    voxels behind the cameras and outside the frustum (a partly hidden
    set): fp32 1e-5."""
    rng = np.random.RandomState(8)
    feats, depths, l2i = _lift_inputs(rng)
    ref = rng.uniform([-3, -1, -2], [3, 6, 2], (1, 300, 3)).astype(
        np.float32)
    rot = np.array([[[0.9, -0.1], [0.1, 0.9]]], np.float32)
    trans = np.array([[0.5, -0.25]], np.float32)
    args = dict(img_shape=(8, 10))
    jout = np.asarray(jax.jit(lambda f, d, r, l, ra, ta: j_lift(
        f, d, r, l, img_rot_aug=ra, img_trans_aug=ta, **args))(
            [jnp.asarray(f) for f in feats], [jnp.asarray(d) for d in depths],
            jnp.asarray(ref), jnp.asarray(l2i), jnp.asarray(rot),
            jnp.asarray(trans)))
    tout = t_lift([_t(f) for f in feats], [_t(d) for d in depths], _t(ref),
                  _t(l2i), img_rot_aug=_t(rot), img_trans_aug=_t(trans),
                  **args).numpy()
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)
    kept = (np.abs(jout).sum(-1) > 0).mean()
    assert 0.05 < kept < 0.9, kept


@pytest.mark.parametrize("fusion", ["sweep_sum", "sweep_cat", "with_time"])
def test_view_trans_sweep_modes_match_jax(fusion):
    """Two sweeps of one camera, a rotated point cloud (``uni_rot_aug``),
    each sweep mode; the JAX Dense of ``trans_conv`` / ``time_conv``
    goes through the weight bridge to the port's 1x1 conv ``.0`` and
    back (through the reference layout's BN ``.1``, given as the
    identity, which the JAX importer folds): fp32 1e-5."""
    from uni3detr_tpu_torch.weights import _Out, _view_trans
    from uni3detr_tpu.train.torch_import import _SD, _import_view_trans
    rng = np.random.RandomState(30)
    S, C = 2, 6
    feats, depths, l2i = _lift_inputs(rng, N=S, C=C)
    c, s_ = np.cos(0.3), np.sin(0.3)
    ura = np.array([[[c, -s_, 0], [s_, c, 0], [0, 0, 1]]], np.float32)
    times = np.array([[0.0, 0.083]], np.float32)
    pr = (-2.0, 0.0, -1.0, 2.0, 4.0, 1.0)
    jvt = JViewTrans(voxel_shape=(5, 4, 3), pc_range=pr, embed_dims=C,
                     num_convs=1, num_sweeps=S, sweep_fusion=fusion)
    jargs = ([jnp.asarray(f) for f in feats],
             [jnp.asarray(d) for d in depths], jnp.asarray(l2i),
             jnp.asarray(ura), (8, 10))
    v = jvt.init(jax.random.PRNGKey(0), *jargs,
                 sweep_times=jnp.asarray(times))
    # BN statistics away from the identity
    stats = {bn: {"mean": rng.uniform(-0.1, 0.1, C).astype(np.float32),
                  "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
             for bn in v["batch_stats"]}
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": stats}
    jout = np.asarray(jax.jit(lambda v, *a: jvt.apply(
        v, *a, sweep_times=jnp.asarray(times)), static_argnums=5)(v, *jargs))
    o = _Out()
    cfg = dataclasses.replace(OV_TINY, num_view_convs=1)
    _view_trans(o, cfg, v["params"], v["batch_stats"], "vt")
    # the bridge is the importer's inverse here too, given the
    # reference's BN after each sweep conv as the identity
    ref_sd = dict(o.sd)
    for name in ("trans_conv", "time_conv"):
        if f"vt.{name}.0.bias" in ref_sd:
            assert not any(k.startswith(f"vt.{name}.1.") for k in o.sd)
            ones = np.ones(C, np.float32)
            ref_sd.update({
                f"vt.{name}.1.weight": ones, f"vt.{name}.1.bias": ones * 0,
                f"vt.{name}.1.running_mean": ones * 0,
                f"vt.{name}.1.running_var": ones * (
                    np.float32(1.0) - np.float32(1e-5))})
    p_back, s_back = _import_view_trans(_SD(ref_sd), cfg, "vt")
    for a, b in ((p_back, v["params"]), (s_back, v["batch_stats"])):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    tvt = TViewTrans((5, 4, 3), pr, embed_dims=C, num_convs=1,
                     num_sweeps=S, sweep_fusion=fusion).eval()
    tvt.load_state_dict({k[3:]: _t(a) for k, a in o.sd.items()},
                        strict=True)
    with torch.no_grad():
        tout = tvt([_t(f) for f in feats], [_t(d) for d in depths],
                   _t(l2i), _t(ura), (8, 10), sweep_times=_t(times))
    assert tout.shape == (1, 3, 4, 5, C)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=1e-5)
    assert np.abs(jout).max() > 0


# -- head ------------------------------------------------------------------

@pytest.mark.parametrize("camera_only", [False, True])
def test_head_clip_matches_jax(weights, camera_only):
    """4 query groups with FPS seeds, the learned group alone in
    camera-only mode; all four output stacks: fp32 1e-5."""
    rng = np.random.RandomState(40)
    cfg = OV_TINY
    nq = cfg.num_query
    vol = rng.randn(1, 2, 5, 6, cfg.embed_dim).astype(np.float32)
    fps = None if camera_only else rng.rand(1, 2 * nq, 3).astype(np.float32)
    rnd = rng.rand(1, nq, 3).astype(np.float32)
    head = JHeadCLIP(num_classes=cfg.num_classes, num_query=nq,
                     code_size=cfg.code_size, embed_dim=cfg.embed_dim,
                     num_decoder_layers=cfg.num_decoder_layers,
                     num_heads=cfg.num_heads, ffn_dim=cfg.ffn_dim,
                     dropout=cfg.dropout, clip_dim=cfg.clip_dim,
                     pc_range=cfg.pc_range)
    hv = {"params": weights["params"]["pts_bbox_head"],
          "constants": weights["constants"]["pts_bbox_head"]}
    jout = jax.jit(lambda v, a, f, r: head.apply(
        v, a, f, train=False, random_points=r))(
            hv, jnp.asarray(vol), None if fps is None else jnp.asarray(fps),
            jnp.asarray(rnd))
    model = port_model(cfg, weights)
    with torch.no_grad():
        tout = model.pts_bbox_head(_t(vol), None if fps is None else _t(fps),
                                   _t(rnd))
    assert sorted(tout) == sorted(jout)
    groups = 1 if camera_only else 4
    assert tout["all_uncertainty_preds"].shape == (
        cfg.num_decoder_layers, 1, groups * nq, cfg.num_classes + 1)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-5)


# -- the whole model ------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_ov_forward_matches_jax(forwards, mode):
    """Eval forward, all four output stacks, fp32 1e-4 (end to end:
    ResNet-50, the lift, the encoder, fusion and two decoder layers)."""
    jout, jinter, tout, tinter = forwards[mode]
    cfg = MODES[mode]
    groups = 4 if cfg.use_lidar else 1
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].shape[2] == groups * cfg.num_query
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4)


def test_ov_intermediates_match_jax(forwards):
    """Multimodal: the view transformer's volume (fp32), then the fused
    volume (fusion conv, BN, ReLU), 1e-5 of their largest values; the
    lift keeps voxels (the camera sees the grid)."""
    _, jinter, _, tinter = forwards["mm"]
    jvol = np.asarray(jinter["view_trans"]["__call__"][0])
    np.testing.assert_allclose(_np(tinter["image_volume"]), jvol, rtol=0,
                               atol=1e-5 * max(np.abs(jvol).max(), 1.0))
    jfused = np.maximum(np.asarray(jinter["fusion_bn"]["__call__"][0]), 0)
    np.testing.assert_allclose(_np(tinter["fused_volume"]), jfused, rtol=0,
                               atol=1e-5 * max(np.abs(jfused).max(), 1.0))
    kept = (tinter["lifted"].abs().sum(-1) > 0).float().mean().item()
    assert kept > 0.1, kept


def test_ov_decode_and_nms_match_jax(forwards):
    """Decoding passes the uncertainty stack through; decode + per-class
    NMS on the same (JAX) head outputs give the same boxes, and the
    port's own outputs give the same labels and keep set."""
    cfg = dataclasses.replace(T_OV_TINY, nms_thr=0.3)
    jcfg = dataclasses.replace(OV_TINY, nms_thr=0.3)
    jout, _, tout, _ = forwards["mm"]
    jpost = jcoder.post_process(*jcoder.decode_predictions(jout, jcfg), jcfg)
    same = tcoder.post_process(*tcoder.decode_predictions(
        {k: _t(v) for k, v in jout.items()}, cfg), cfg)
    own = tcoder.post_process(*tcoder.decode_predictions(tout, cfg), cfg)
    for got in (same, own):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jpost[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(jpost[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jpost[0]),
                                   rtol=0, atol=1e-4)
    assert 0 < int(np.asarray(jpost[3]).sum()) < jpost[3].size


def test_decode_and_nms_at_46_classes_match_jax():
    """The OV presets' 46 classes in one per-class NMS (tied scores)."""
    jcfg = dataclasses.replace(OV_TINY, num_classes=46, max_num=300,
                               nms_thr=0.3)
    cfg = TOVConfig(**dataclasses.asdict(jcfg))
    rng = np.random.RandomState(46)
    L, B, Q = 2, 1, 64
    outs = {"all_cls_scores": np.round(rng.randn(L, B, Q, 46), 1),
            "all_bbox_preds": np.concatenate([
                rng.uniform(-1.2, 1.2, (L, B, Q, 2)),
                rng.uniform(-1.5, -0.5, (L, B, Q, 2)),
                rng.uniform(-0.5, 0.5, (L, B, Q, 1)),
                rng.uniform(-1.5, -0.5, (L, B, Q, 1)),
                rng.uniform(-1, 1, (L, B, Q, 2))], -1),
            "all_iou_preds": rng.randn(L, B, Q),
            "all_uncertainty_preds": rng.randn(L, B, Q, 47)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    jpost = jcoder.post_process(*jcoder.decode_predictions(
        {k: jnp.asarray(v) for k, v in outs.items()}, jcfg), jcfg)
    tpost = tcoder.post_process(*tcoder.decode_predictions(
        {k: _t(v) for k, v in outs.items()}, cfg), cfg)
    np.testing.assert_array_equal(tpost[2].numpy(), np.asarray(jpost[2]))
    np.testing.assert_array_equal(tpost[3].numpy(), np.asarray(jpost[3]))
    np.testing.assert_allclose(tpost[0].numpy(), np.asarray(jpost[0]),
                               rtol=0, atol=1e-5)
    kept = np.asarray(jpost[3])
    assert 0 < kept.sum() < 300 and len(np.unique(np.asarray(
        jpost[2])[kept])) > 20


def test_indoor_eval_46_classes_seen_unseen_matches_jax():
    """The 46-class indoor AP with the seen / unseen split on OV-shaped
    detections: the port (plain overlaps on the CPU) equals JAX."""
    rng = np.random.RandomState(9)
    names = tpresets.OV_SUNRGBD_CLASSES
    gts, dets = [], []
    for _ in range(3):
        n = 30
        g = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                            rng.uniform(0.3, 1.5, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], -1)
        gl = rng.randint(0, 46, n)
        d = g[rng.randint(0, n, 60)] + rng.normal(0, 0.1, (60, 7))
        dl = np.where(rng.rand(60) < 0.8, gl[rng.randint(0, n, 60)],
                      rng.randint(0, 46, 60))
        gts.append({"boxes": g.astype(np.float32), "labels": gl})
        dets.append({"boxes": d.astype(np.float32), "labels": dl,
                     "scores": rng.rand(60).astype(np.float32)})
    ref = j_indoor_eval(gts, dets, names,
                        seen_classes=tpresets.OV_SUNRGBD_SEEN)
    got = t_indoor_eval(gts, dets, names,
                        seen_classes=tpresets.OV_SUNRGBD_SEEN, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):            # the per-class tables
            assert list(got[k]) == list(ref[k])
            np.testing.assert_allclose(list(got[k].values()),
                                       list(ref[k].values()), rtol=0,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    assert ref["mAP_unseen_0.25"] > 0 and ref["mAP_seen_0.25"] > 0


def test_ov_scene_camera_sees_the_scene():
    """The synthetic camera of ``ov_scene``: a real share of the
    multimodal preset's 40 x 40 x 15 voxel grid projects in front of it
    and inside the frame."""
    from uni3detr_tpu_torch.models.ov_detector import encoder_grid
    from uni3detr_tpu_torch.models.view_trans import project_voxels
    cfg = tpresets.OV_SUNRGBD_MM
    batch, rnd = ov_scene(0, cfg)
    assert batch["images"].shape == (1, 1, 480, 640, 3)
    assert batch["points"].shape == (1, cfg.num_points, 4)
    D, H, W = encoder_grid(cfg)
    assert (D, H, W) == (15, 40, 40)
    ref = t_ref((W, H, D), cfg.pc_range)[None]
    _, _, mask = project_voxels(ref, _t(batch["lidar2img"]), cfg.img_size,
                                cfg.depth_dim)
    assert mask.float().mean().item() > 0.3
    rgb, _ = ov_scene(0, tpresets.OV_SUNRGBD_RGB)
    assert "points" not in rgb and "images" in rgb
