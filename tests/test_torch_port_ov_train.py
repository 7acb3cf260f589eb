"""The port's OV-Uni3DETR training against the JAX package on the CPU.

At ``OV_TINY`` (``tests/test_ov.py``: two decoder layers, the full-width
ResNet-50 + DCNv2, a 16-d CLIP space) with a 64x64 image, fp32, dropout
0 and scipy's exact matching on both sides; inputs from a seed with
numpy. (At OV_TINY's 32x32 image the last ResNet stage is 1x1, and its
train-mode BN normalizes two values a channel: the image volume then
differs by 3% between two correct implementations.) Each JAX function is compiled once (module-scoped fixtures); the
modality draw ri, which the JAX model takes from ``make_rng("modality")``,
is pinned for the JAX side by replacing ``jax.random.randint`` while the
function is traced, with ri a traced argument, so one compile serves all
three values. Tolerances (fp32):

- the uncertainty loss on the same head outputs: every term within 1e-5
  relative, its gradients within 1e-5 absolute;
- the flax-style BatchNorm2d in train mode: output and running
  statistics within rtol 1e-5 (atol 1e-6);
- the ResNet in train mode (frozen_stages 1, two 64x64 images): the
  stage outputs within 1e-4 of each stage's largest value; each
  unfrozen parameter's gradient within 2e-2 of its norm (the L2 norm of
  the difference): the ReLU masks of a 50-layer network differ at a few
  entries under fp32 rounding, and each flip moves a gradient by a
  finite step (the port against itself, the input moved by 1e-7
  relative, differs by up to 5.6% of a tensor's largest entry at 128 x
  128); the updated running statistics within rtol 1e-4 (atol 1e-5 of
  the tensor's largest value); the frozen stages' gradients 0 in JAX and
  absent in the port, their statistics unchanged on both;
- DCN and ``grid_sample_2d`` gradients (offsets of a few pixels) within
  1e-5 of each gradient's largest value;
- the train forward (mm under each ri, pc, rgb): the output stacks
  within 1e-4 and the batch statistics within rtol 1e-4 (atol 1e-5 of
  the tensor's largest value);
- one train step in mm mode under each ri against ``make_train_step``
  with the JAX CLI's ``lr_mult`` function: losses within rtol 1e-4,
  gradients (the first moments) within 1e-3 of each leaf's largest
  entry, the parameters and statistics after the step as in
  ``tests/test_torch_port_train.py`` (rtol 1e-4, and at most one lr
  step where a gradient is too near 0 for Adam's sign), the frozen
  parameters equal in the port and decayed by 0.1 lr wd in JAX;
- ``load_branch``: the copied parameters equal JAX's, bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uni3detr_tpu.geom import boxes as jboxes
from uni3detr_tpu.models.dcn import DeformConv2dV2 as JDCN
from uni3detr_tpu.models.ov_detector import OV_Uni3DETR as JOV
from uni3detr_tpu.models.resnet import ResNet as JResNet
from uni3detr_tpu.ops.sample import grid_sample_2d as j_grid_sample_2d
from uni3detr_tpu.train import checkpoint as jckpt
from uni3detr_tpu.train import losses as jl
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu.train.torch_import import import_torch_state_dict_ov
from flax import linen as fnn
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.config import OVUni3DETRConfig as TOVConfig
from uni3detr_tpu_torch.geom import boxes as tboxes
from uni3detr_tpu_torch.models.dcn import DeformConv2dV2 as TDCN
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR as TOV
from uni3detr_tpu_torch.models.resnet import BatchNorm2d as TBatchNorm2d
from uni3detr_tpu_torch.models.resnet import ResNet as TResNet
from uni3detr_tpu_torch.ops.sample import grid_sample_2d as t_grid_sample_2d
from uni3detr_tpu_torch.synthetic import ov_train_batch
from uni3detr_tpu_torch.train import checkpoint as tckpt
from uni3detr_tpu_torch.train import losses as tl
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import _Out, _resnet, state_dict_from_jax_ov
from test_ov import OV_TINY
from test_torch_import_ov import make_ov_state_dict
from test_torch_port_ov import _mode_variables

BASE = dataclasses.replace(OV_TINY, dropout=0.0, matcher="scipy",
                           img_size=(64, 64))
MODES = {
    "mm": BASE,
    "pc": dataclasses.replace(BASE, use_camera=False, multimodal=False),
    "rgb": dataclasses.replace(BASE, use_lidar=False, multimodal=False),
}
TRAIN_B = 2
LR, WD = 1e-3, 0.01
PTS_BRANCH = ("pts_middle_encoder", "pts_backbone", "pts_neck")
IMG_BRANCH = ("img_backbone", "img_neck", "input_proj", "depth_net",
              "view_trans")
MM_LR_MULT = tpresets.OV_SUNRGBD_MM_LR_MULT


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _stats_close(got, ref):
    """BN statistics: rtol 1e-4, atol 1e-5 of the tensor's largest value
    (running means near 0 take sums of many fp32 terms)."""
    ref = np.asarray(ref)
    _close(got, ref, rtol=1e-4, atol=1e-5 * max(np.abs(ref).max(), 1.0))


def tcfg(cfg):
    return TOVConfig(**dataclasses.asdict(cfg))


def port_model(cfg, variables):
    model = TOV(tcfg(cfg))
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax_ov(variables, cfg).items()},
                          strict=True)
    return model


def pinned(fn):
    """``fn(*args, ri)`` with JAX's modality draw replaced by the traced
    ``ri``: ``jax.random.randint(key, (), 0, 3)`` (the one draw of
    ``OV_Uni3DETR``) returns it while ``fn`` is traced."""
    orig = jax.random.randint

    def body(*args):
        *rest, ri = args

        def randint(key, shape, minval, maxval, *a, **kw):
            if tuple(shape) == () and (minval, maxval) == (0, 3):
                return ri
            return orig(key, shape, minval, maxval, *a, **kw)

        jax.random.randint = randint
        try:
            return fn(*rest)
        finally:
            jax.random.randint = orig

    return jax.jit(body)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this module's CPU work, restored after:
    the full-width ResNet-50 runs in several test processes at once, and
    torch's default of one thread a core oversubscribes the machine."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the multimodal tiny model, with each bottleneck's
    last BN scale at 0.1 of its draw: the residual branches small, as in
    a trained ResNet. At full scale the random 50-layer network in train
    mode turns a 1e-7 relative change of its input into up to 9% of a
    gradient tensor (the port against itself), far above what a
    comparison with JAX can resolve. The DCN offset convs keep their
    full-size draw: in train mode BN normalizes their input, and the
    offsets come to a few pixels (inference scales them down for the
    unnormalized eval activations, ``weights.DCN_OFFSET_SCALE``)."""
    sd = make_ov_state_dict(OV_TINY, np.random.RandomState(0))
    for k in sd:
        if k.startswith("img_backbone.") and k.endswith("bn3.weight"):
            sd[k] = sd[k] * np.float32(0.1)
    return import_torch_state_dict_ov(sd, OV_TINY)


# -- the uncertainty loss ----------------------------------------------------

def _head_outputs(rng, cfg, L, B, Q):
    ncls = cfg.num_classes
    box = np.concatenate([rng.uniform(-1.5, 1.5, (L, B, Q, 2)),
                          rng.uniform(-1.2, 0.0, (L, B, Q, 2)),
                          rng.uniform(-0.8, 0.8, (L, B, Q, 1)),
                          rng.uniform(-1.2, 0.0, (L, B, Q, 1)),
                          rng.uniform(-1, 1, (L, B, Q, 2))], -1)
    return {"all_cls_scores": rng.randn(L, B, Q, ncls) * 2,
            "all_bbox_preds": box,
            "all_iou_preds": rng.randn(L, B, Q),
            # sigma on both sides of the 0.01 clip
            "all_uncertainty_preds": rng.uniform(-0.5, 1.5,
                                                 (L, B, Q, ncls + 1))}


def _gt(rng, cfg, B, G, n):
    gt = np.concatenate([rng.uniform(-1.5, 1.5, (B, G, 3)),
                         rng.uniform(0.3, 1.2, (B, G, 3)),
                         rng.uniform(-np.pi, np.pi, (B, G, 1))], -1)
    labels = rng.randint(0, cfg.num_classes, (B, G)).astype(np.int32)
    mask = np.zeros((B, G), bool)
    mask[:, :n] = True
    return gt.astype(np.float32), labels, mask


@pytest.mark.parametrize("consistency_weight", [1.0, 5.0])
def test_uncertainty_loss_matches_jax(consistency_weight):
    """Every ``d{i}.loss_*`` term, consistency included, and the
    gradients with respect to all four stacks. The JAX loss does not read
    ``uncertainty_consistency_weight``; the port follows it, so the
    terms at 5.0 equal those at 1.0."""
    cfg = dataclasses.replace(BASE, num_query=8,
                              uncertainty_consistency_weight=
                              consistency_weight)
    rng = np.random.RandomState(1)
    L, B, Q = 2, 2, 3 * cfg.num_query
    outs = {k: v.astype(np.float32) for k, v in
            _head_outputs(rng, cfg, L, B, Q).items()}
    gt, labels, mask = _gt(rng, cfg, B, 4, 3)
    gtj = jboxes.gravity_center_boxes(gt)
    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(
        lambda o: jl.uni3detr_loss(o, gtj, labels, mask, cfg),
        has_aux=True))({k: jnp.asarray(a) for k, a in outs.items()})
    tout = {k: _t(a).requires_grad_() for k, a in outs.items()}
    ttotal, tlogs = tl.uni3detr_loss(
        tout, tboxes.gravity_center_boxes(_t(gt)), _t(labels), _t(mask),
        tcfg(cfg))
    ttotal.backward()
    assert sorted(tlogs) == sorted(jlogs)
    assert {"loss_consistency", "d0.loss_consistency"} <= set(tlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-5, atol=0, msg=k)
    _close(ttotal, jtotal, rtol=1e-5, atol=0)
    for k in outs:
        _close(tout[k].grad, jgrad[k], rtol=0, atol=1e-5, msg=k)
    # the clip: sigma below 0.01 passes no gradient
    assert (tout["all_uncertainty_preds"].grad[
        tout["all_uncertainty_preds"] < 0.01] == 0).all()
    ref = tl.uni3detr_loss({k: v.detach() for k, v in tout.items()},
                           tboxes.gravity_center_boxes(_t(gt)), _t(labels),
                           _t(mask), tcfg(dataclasses.replace(cfg, uncertainty_consistency_weight=1.0)))[0]
    assert float(ttotal.detach()) == float(ref)


# -- BatchNorm and the ResNet in train mode -----------------------------------

@pytest.mark.parametrize("shape", [(2, 6, 5, 7), (1, 6, 1, 1)])
def test_flax_batchnorm2d_train_matches_flax(shape):
    """eps 1e-5, flax momentum 0.9: the output and the running statistics
    (the biased variance; one value per channel normalizes to the bias)."""
    rng = np.random.RandomState(2)
    C = shape[1]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    p = {"scale": rng.rand(C).astype(np.float32) + 0.5,
         "bias": rng.randn(C).astype(np.float32)}
    s = {"mean": rng.randn(C).astype(np.float32),
         "var": rng.rand(C).astype(np.float32) + 0.5}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    ref, upd = bn.apply({"params": p, "batch_stats": s},
                        jnp.asarray(x.transpose(0, 2, 3, 1)),
                        mutable=["batch_stats"])
    tbn = TBatchNorm2d(C).train()
    tbn.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                         "running_mean": _t(s["mean"]),
                         "running_var": _t(s["var"]),
                         "num_batches_tracked": torch.tensor(0)})
    got = tbn(_t(x))
    _close(got.permute(0, 2, 3, 1), ref)
    _close(tbn.running_mean, upd["batch_stats"]["mean"])
    _close(tbn.running_var, upd["batch_stats"]["var"])


@pytest.fixture(scope="module")
def resnet_train(weights):
    """One train-mode ResNet forward and backward (frozen_stages 1) of a
    scalar sum of the stage outputs times fixed cotangents, on both
    sides. Returns (JAX outputs, grads, updated statistics, port outputs,
    port backbone, input statistics)."""
    rng = np.random.RandomState(3)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    shapes = [(2, 16, 16, 256), (2, 8, 8, 512), (2, 4, 4, 1024),
              (2, 2, 2, 2048)]
    cots = [rng.randn(*s).astype(np.float32) for s in shapes]
    p = weights["params"]["img_backbone"]
    s = weights["batch_stats"]["img_backbone"]
    net = JResNet(stage_with_dcn=OV_TINY.stage_with_dcn,
                  frozen_stages=OV_TINY.frozen_stages)

    def f(params, stats, x, cots):
        def loss(pp):
            outs, upd = net.apply({"params": pp, "batch_stats": stats}, x,
                                  True, mutable=["batch_stats"])
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (
                outs, upd["batch_stats"])
        (_, aux), g = jax.value_and_grad(loss, has_aux=True)(params)
        return aux, g

    (jouts, jstats), jgrad = jax.jit(f)(p, s, jnp.asarray(img),
                                        [jnp.asarray(c) for c in cots])
    model = port_model(OV_TINY, weights)
    bb = model.img_backbone.train()
    touts = bb(_t(img).permute(0, 3, 1, 2))
    sum((o.permute(0, 2, 3, 1) * _t(c)).sum()
        for o, c in zip(touts, cots)).backward()
    return jouts, jgrad, jstats, touts, bb, (p, s)


def _torch_layout(p, s):
    """JAX ResNet params and stats -> the port's keys (numpy)."""
    o = _Out()
    _resnet(o, OV_TINY, p, s, "bb")
    return {k[3:]: v for k, v in o.sd.items()}


def test_resnet_train_outputs_match_jax(resnet_train):
    jouts, _, _, touts, _, _ = resnet_train
    for a, b in zip(touts, jouts):
        b = np.asarray(b)
        _close(a.permute(0, 2, 3, 1), b, rtol=0,
               atol=1e-4 * max(np.abs(b).max(), 1.0))


def test_resnet_train_grads_match_jax(resnet_train):
    """The unfrozen stages' gradients; the stem and stage 1 get none in
    the port (requires_grad False) and exactly 0 in JAX."""
    _, jgrad, _, _, bb, (p, s) = resnet_train
    ref = _torch_layout(jgrad, s)
    frozen = tuple(k.split(".", 1)[1] for k in
                   TResNet.frozen_param_prefixes(OV_TINY.frozen_stages))
    n_free = 0
    for name, prm in bb.named_parameters():
        g = ref[name]
        if name.startswith(frozen):
            assert not prm.requires_grad and prm.grad is None, name
            assert not np.any(g), name
            continue
        n_free += 1
        err = np.linalg.norm(_np(prm.grad) - g) / max(np.linalg.norm(g),
                                                       1e-6)
        assert err <= 2e-2, (name, err)
    assert n_free > 100


def test_resnet_train_statistics_match_jax(resnet_train):
    """The updated running statistics (torch's unbiased running variance
    would differ here: stage 4 normalizes over 2 values a channel); the
    frozen stages' statistics are unchanged on both sides."""
    _, _, jstats, _, bb, (p, s) = resnet_train
    ref = _torch_layout(p, jstats)
    before = _torch_layout(p, s)
    frozen = tuple(k.split(".", 1)[1] for k in
                   TResNet.frozen_param_prefixes(OV_TINY.frozen_stages))
    n_moved = 0
    for name, buf in bb.named_buffers():
        if not name.endswith(("running_mean", "running_var")):
            continue
        _close(buf, ref[name], rtol=1e-4,
               atol=1e-5 * np.abs(ref[name]).max(), msg=name)
        if name.startswith(frozen):
            np.testing.assert_array_equal(_np(buf), before[name])
            np.testing.assert_array_equal(ref[name], before[name])
        else:
            n_moved += int(not np.array_equal(ref[name], before[name]))
    assert n_moved == 2 * (3 * 13 + 3)     # every BN of stages 2-4


# -- gradients of the image branch's plain sampling ----------------------------

def test_grid_sample_2d_grads_match_jax():
    """Gradients to the image and to the coordinates (through the
    bilinear weights; ``floor`` passes none), points up to 20% outside
    the image."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 7, 9, 5).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 60, 2)).astype(np.float32)
    cot = rng.randn(2, 60, 5).astype(np.float32)
    jg = jax.jit(jax.grad(lambda i, c: jnp.sum(j_grid_sample_2d(i, c) * cot),
                          argnums=(0, 1)))(jnp.asarray(img),
                                           jnp.asarray(coords))
    ti, tc = _t(img).requires_grad_(), _t(coords).requires_grad_()
    (t_grid_sample_2d(ti, tc) * _t(cot)).sum().backward()
    for got, ref in ((ti.grad, jg[0]), (tc.grad, jg[1])):
        ref = np.asarray(ref)
        _close(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(np.asarray(jg[1])).max() > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_grads_match_jax(stride):
    """Offsets of a few pixels: the gradients to the input, the weight,
    and the offset conv (through the bilinear weights and the masks)."""
    rng = np.random.RandomState(5 + stride)
    C, O, H, W = 6, 5, 11, 13
    x = rng.randn(2, H, W, C).astype(np.float32)
    params = {"kernel": (rng.randn(9, C, O) * 0.3).astype(np.float32),
              "offset_conv": {
                  "kernel": (rng.randn(3, 3, C, 27) * 4.0 / np.sqrt(9 * C)
                             ).astype(np.float32),
                  "bias": (0.1 * rng.randn(27)).astype(np.float32)}}
    dcn = JDCN(O, 3, stride)
    Ho = (H - 1) // stride + 1
    Wo = (W - 1) // stride + 1
    cot = rng.randn(2, Ho, Wo, O).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        dcn.apply({"params": p}, x) * cot), argnums=(0, 1)))(
            params, jnp.asarray(x))
    mod = TDCN(C, O, 3, stride)
    oc = params["offset_conv"]
    mod.load_state_dict({
        "weight": _t(params["kernel"].reshape(3, 3, C, O).transpose(
            3, 2, 0, 1)),
        "conv_offset.weight": _t(oc["kernel"].transpose(3, 2, 0, 1)),
        "conv_offset.bias": _t(oc["bias"])})
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    (mod(xt).permute(0, 2, 3, 1) * _t(cot)).sum().backward()
    with torch.no_grad():
        off = mod.offsets_and_mask(xt)[0]
    assert off.abs().max() > 2.0
    jp, jx = jg
    pairs = [
        (xt.grad.permute(0, 2, 3, 1), jx),
        (mod.weight.grad, np.asarray(jp["kernel"]).reshape(
            3, 3, C, O).transpose(3, 2, 0, 1)),
        (mod.conv_offset.weight.grad, np.asarray(
            jp["offset_conv"]["kernel"]).transpose(3, 2, 0, 1)),
        (mod.conv_offset.bias.grad, jp["offset_conv"]["bias"])]
    for i, (got, ref) in enumerate(pairs):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, i
        _close(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(), msg=str(i))


# -- the train forward and the train step -------------------------------------

def _train_batch(cfg):
    """The tiny OV train batch (numpy): 2048 points and an image a scene
    from ``ov_train_batch``, and all of the scenes' GT boxes (6 a scene in
    8 rows; the tiny grid's camera frame keeps few)."""
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    t = dataclasses.replace(tcfg(cfg), num_points=2048, max_gt=8)
    batch, _ = ov_train_batch(4, t, TRAIN_B)
    gt = clustered_train_batch(4, t, TRAIN_B)
    batch.update({k: gt[k] for k in ("gt_boxes", "gt_labels", "gt_mask")})
    return batch


def _model_inputs(batch):
    return {k: v for k, v in batch.items() if not k.startswith("gt_")}


@pytest.fixture(scope="module")
def train_forwards(weights):
    """Per case (mm under ri 0, 1, 2; pc; rgb): (JAX outputs, JAX
    batch_stats after the forward, port outputs, port model)."""
    res = {}
    for mode, cfg in MODES.items():
        v = _mode_variables(weights, cfg)
        batch = _model_inputs(_train_batch(cfg))
        model = JOV(cfg)
        fn = pinned(lambda v, b: model.apply(
            v, b, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1),
                  "modality": jax.random.PRNGKey(2)}))
        for ri in ((0, 1, 2) if mode == "mm" else (None,)):
            jout, upd = fn(v, {k: jnp.asarray(a) for k, a in batch.items()},
                           jnp.int32(0 if ri is None else ri))
            tmodel = port_model(cfg, v).train()
            tout = tmodel({k: _t(a) for k, a in batch.items()}, modality=ri)
            res[mode if ri is None else f"mm-{ri}"] = (
                jout, upd["batch_stats"], tout, tmodel)
    return res


@pytest.mark.parametrize("case", ["mm-0", "mm-1", "mm-2", "pc", "rgb"])
def test_ov_train_forward_matches_jax(train_forwards, case):
    """The output stacks (3 query groups with points, 1 camera-only) and
    the batch statistics after the forward: every branch's BN updates
    whatever ri is."""
    jout, jstats, tout, tmodel = train_forwards[case]
    cfg = MODES[case.split("-")[0]]
    groups = 3 if cfg.use_lidar else 1
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].shape[2] == groups * cfg.num_query
        _close(tout[k], jout[k], rtol=0, atol=1e-4, msg=k)
    back = import_torch_state_dict_ov(
        {k: v.detach().numpy() for k, v in tmodel.state_dict().items()},
        cfg)["batch_stats"]
    assert sorted(back) == sorted(jstats)
    jax.tree_util.tree_map(_stats_close, back, jstats)
    if case.startswith("mm"):
        assert tmodel.last_modality == int(case[-1])


def _jax_lr_mult_fn(cfg):
    """``uni3detr_tpu/cli/train.py``'s multiplier lookup for the mm
    config: its ``lr_mult`` first, then the frozen stages at 0 (which
    the first match, ``img_backbone``, shadows)."""
    lr_mult = dict(MM_LR_MULT)
    for p in JResNet.frozen_param_prefixes(cfg.frozen_stages):
        lr_mult[p] = 0.0

    def fn(path):
        for prefix, m in lr_mult.items():
            if path.startswith(prefix):
                return m
        return 1.0
    return fn


def _mu(opt_state):
    """The Adam first moment of an optax state tree."""
    found = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def train_steps(weights):
    """One mm train step from the same weights under each ri, through
    ``make_train_step`` (the CLI's ``lr_mult``) and the port's
    ``train_step`` (``make_optimizer(lr_mult=...)``)."""
    cfg = BASE
    v = _mode_variables(weights, cfg)
    batch = _train_batch(cfg)
    tx = jstep.make_optimizer(LR, WD, lr_mult_fn=_jax_lr_mult_fn(cfg))
    step = pinned(jstep.make_train_step(cfg, donate=False).__wrapped__)
    res = {}
    for ri in (0, 1, 2):
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]),
                                 constants=v["constants"], tx=tx)
        state, jlogs = step(state, {k: jnp.asarray(a) for k, a in
                                    batch.items()}, jax.random.PRNGKey(0),
                            jnp.int32(ri))
        model = port_model(cfg, v)
        opt = tstep.make_optimizer(model, LR, weight_decay=WD,
                                   lr_mult=MM_LR_MULT)
        tlogs = tstep.train_step(model, opt, {k: _t(a) for k, a in
                                              batch.items()}, modality=ri)
        res[ri] = (state, jlogs, model, opt, tlogs)
    return cfg, v, res


def _port_tree(cfg, model, opt=None):
    """The port's params and batch_stats (or, with ``opt``, its first
    moments in the params' places: 0 for the frozen parameters) as JAX
    trees."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if opt is not None:
        for name, p in model.named_parameters():
            st = opt.adamw.state.get(p)
            sd[name] = np.zeros_like(sd[name]) if st is None \
                else st["exp_avg"].numpy()
    return import_torch_state_dict_ov(sd, cfg)


@pytest.mark.parametrize("ri", [0, 1, 2])
def test_ov_train_step_losses_match_jax(train_steps, ri):
    _, _, res = train_steps
    _, jlogs, model, _, tlogs = res[ri]
    assert sorted(tlogs) == sorted(jlogs)
    assert "loss_consistency" in tlogs
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)
    assert model.last_modality == ri


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("ri", [0, 1, 2])
def test_ov_train_step_grads_match_jax(train_steps, ri):
    """The first moments (0.1 x the clipped gradient on both sides):
    within 1e-3 of each leaf's largest entry, or, in the ResNet, within
    5e-2 of the leaf's norm (the L2 norm of the difference): there the
    fp32 result itself sits up to 1.2% from an fp64 evaluation of the
    same port (ReLU masks, see the module docstring), and the port
    against itself with the image moved by 1e-7 relative differs by up
    to 2.1%. The unused branch of ri gets exactly 0."""
    cfg, _, res = train_steps
    state, _, model, opt, _ = res[ri]
    tmu = _flat(_port_tree(cfg, model, opt)["params"])
    jmu = _flat(_mu(state.opt_state))
    assert sorted(map(str, tmu)) == sorted(map(str, jmu))
    unused = {0: PTS_BRANCH, 1: IMG_BRANCH, 2: ()}[ri]
    for path, ref in jmu.items():
        name = jax.tree_util.keystr(path)
        ref, got = np.asarray(ref), np.asarray(tmu[path])
        if path[0].key in unused:
            assert not ref.any() and not got.any(), name
        elif path[0].key == "img_backbone":
            err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-9)
            assert err <= 5e-2, (name, err)
        else:
            err = np.abs(got - ref).max()
            assert err <= 1e-3 * max(np.abs(ref).max(), 1e-5), (name, err)


@pytest.mark.parametrize("ri", [0, 1, 2])
def test_ov_train_step_updates_match_jax(train_steps, ri):
    """The parameters and batch statistics after the step. Frozen
    parameters: equal to their initial values in the port; JAX's CLI
    gives them the 0.1 of ``img_backbone`` (its frozen-stage mask is
    shadowed), so AdamW's decay takes 0.1 lr wd of them. Elsewhere as
    ``tests/test_torch_port_train.py``: rtol 1e-4, except the entries
    whose two gradients differ by more than 0.5% (Adam's first step
    g / (|g| + eps) turns that into a step difference of over 1% of lr,
    up to a full lr): there both sides move by at most 1.1 lr (decay
    included), and such entries stay under 1% of all."""
    cfg, v, res = train_steps
    state, _, model, opt, _ = res[ri]
    back = _port_tree(cfg, model)
    jax.tree_util.tree_map(_stats_close, back["batch_stats"],
                           state.batch_stats)
    leaves = [_flat(t) for t in (back["params"], state.params, v["params"],
                                 _mu(state.opt_state),
                                 _port_tree(cfg, model, opt)["params"])]
    frozen = tuple(p.split("/", 1)[1] for p in
                   JResNet.frozen_param_prefixes(cfg.frozen_stages))
    n_free, n_all = {True: 0, False: 0}, {True: 0, False: 0}
    n_frozen = 0
    for path in leaves[0]:
        got, ref, init, mu, mu_t = (np.asarray(t[path]) for t in leaves)
        name = jax.tree_util.keystr(path)
        if path[0].key == "img_backbone" and path[1].key.startswith(frozen):
            n_frozen += 1
            np.testing.assert_array_equal(got, init, err_msg=name)
            np.testing.assert_allclose(ref, init * (1 - 0.1 * LR * WD),
                                       rtol=1e-6, atol=1e-12, err_msg=name)
            continue
        # the first moments are 0.1 x the gradient g
        steps = [m / (np.abs(m) + 1e-9) for m in (mu, mu_t)]
        free = np.abs(steps[0] - steps[1]) > 1e-4
        resnet = path[0].key == "img_backbone"
        n_free[resnet] += int(free.sum())
        n_all[resnet] += free.size
        _close(got[~free], ref[~free], rtol=1e-4, atol=1e-6, msg=name)
        for a in (got, ref):
            assert (np.abs(a - init)[free] <= 1.1 * LR).all(), name
    # the stem's conv and BN, stage 1's 3 x (3 convs, 3 BNs) + downsample
    assert n_frozen == 3 + 3 * 9 + 3
    assert n_free[False] < 0.01 * n_all[False]
    assert n_free[True] < 0.1 * n_all[True]


# -- the optimizer, the branches, checkpoints ---------------------------------

def test_mm_training_settings_equal_the_config():
    """The multipliers and branch prefixes of ``presets`` are those of
    ``configs/ov_uni3detr/ov_uni3detr_sunrgbd_mm.py``."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "ov_uni3detr", "ov_uni3detr_sunrgbd_mm.py"))
    assert list(tpresets.OV_SUNRGBD_MM_LR_MULT.items()) == list(
        cfg["lr_mult"].items())
    assert list(tpresets.OV_SUNRGBD_MM_LOAD_IMG) == cfg["load_img"]
    assert list(tpresets.OV_SUNRGBD_MM_LOAD_PTS) == cfg["load_pts"]


def test_make_optimizer_lr_mult_groups():
    """One AdamW group a multiplier, lr = schedule x multiplier, the
    first prefix that matches wins, the frozen stages in no group."""
    model = TOV(tcfg(BASE))
    sched = tstep.step_lr_schedule(LR, 2, [1])
    opt = tstep.make_optimizer(model, sched, lr_mult=MM_LR_MULT)
    groups = {g["lr_mult"]: g for g in opt.adamw.param_groups}
    assert sorted(groups) == [0.1, 1.0]
    names = {p: n for n, p in model.named_parameters()}
    slow = {names[p].split(".")[0] for p in groups[0.1]["params"]}
    fast = {names[p].split(".")[0] for p in groups[1.0]["params"]}
    assert slow == set(MM_LR_MULT)
    assert fast == {"pts_bbox_head", "conv_trans_head_1"}
    frozen = TResNet.frozen_param_prefixes(BASE.frozen_stages)
    in_opt = {id(p) for p in opt.params}
    for n, p in model.named_parameters():
        assert (id(p) in in_opt) != n.startswith(frozen), n
    for g in opt.adamw.param_groups:
        g["params"][0].grad = torch.zeros_like(g["params"][0])
    for step in range(3):
        opt.step()
        for g in opt.adamw.param_groups:
            assert g["lr"] == pytest.approx(sched(step) * g["lr_mult"])
    # the first prefix that matches wins, in the mapping's order
    over = tstep.lr_mult_groups(model, {"pts_bbox_head.transformer": 0.5,
                                        "pts_bbox_head": 2.0})
    assert [g["lr_mult"] for g in over] == [1.0, 2.0, 0.5]
    half = {names[p] for p in over[2]["params"]}
    assert half and all(n.startswith("pts_bbox_head.transformer.")
                        for n in half)


def test_modality_draw_is_seeded_and_covers_all():
    model = TOV(tcfg(BASE))
    draws = [model.draw_modality(generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert draws[0] == draws[1]
    gen = torch.Generator().manual_seed(5)
    seen = {model.draw_modality(generator=gen) for _ in range(40)}
    assert seen == {0, 1, 2}
    assert model.draw_modality(modality=1) == 1
    with pytest.raises(ValueError):
        model.draw_modality(modality=3)


def test_load_branch_matches_jax(tmp_path):
    """Staged init from a checkpoint written here: the mm config's
    ``load_img`` and ``load_pts`` prefixes. The parameters equal JAX's
    ``load_branch``; the port also takes the branches' BN statistics
    from the checkpoint (JAX keeps its own)."""
    load = tpresets.OV_SUNRGBD_MM_LOAD_IMG + tpresets.OV_SUNRGBD_MM_LOAD_PTS
    va, vb = (import_torch_state_dict_ov(make_ov_state_dict(
        OV_TINY, np.random.RandomState(seed)), OV_TINY) for seed in (11, 12))
    src = port_model(OV_TINY, va)
    tckpt.save_checkpoint(str(tmp_path / "pre"), src)
    tree, _ = tckpt.load_checkpoint(str(tmp_path / "pre"))
    model = port_model(OV_TINY, vb)
    jparams = vb["params"]
    n_port = n_jax = 0
    for k in load:
        n_port += tckpt.load_branch(model, tree["model"], k, k)
        jparams, n = jckpt.load_branch(jparams, va["params"], k, k)
        n_jax += n
    back = _port_tree(OV_TINY, model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           jparams)
    n_buffers = 0
    untouched = port_model(OV_TINY, vb).state_dict()
    for key, value in model.state_dict().items():
        if key.startswith(tuple(load)) and "running_" in key:
            np.testing.assert_array_equal(value.numpy(),
                                          tree["model"][key].numpy())
            n_buffers += 1
        elif not key.startswith(tuple(load)):
            np.testing.assert_array_equal(value.numpy(),
                                          untouched[key].numpy())
    n_tracked = sum(k.startswith(tuple(load)) and
                    k.endswith("num_batches_tracked") for k in tree["model"])
    assert n_buffers > 50 and n_port == n_jax + n_buffers + n_tracked
    assert tckpt.load_branch(model, {"img_backbone.conv1.weight":
                                     torch.zeros(1)}, "img_backbone",
                             "img_backbone") == 0


def test_ov_checkpoint_resumes_bit_exact(weights, tmp_path):
    """Train two steps (ri from a seeded generator, dropout 0.1), save,
    then two more steps in the kept run and in a run restored from the
    checkpoint into a fresh model, optimizer and generator: parameters,
    buffers (``zs_weights`` too), every AdamW group's state, the step
    and the losses bit for bit."""
    cfg = dataclasses.replace(BASE, dropout=0.1)
    v = _mode_variables(weights, cfg)
    batch = {k: _t(a) for k, a in _train_batch(cfg).items()}
    sched = tstep.step_lr_schedule(LR, 1, [3])

    def fresh():
        model = port_model(cfg, v)
        return model, tstep.make_optimizer(model, sched, lr_mult=MM_LR_MULT)

    # the CPU's index_put (the sampling's backward) accumulates in
    # parallel in no fixed order unless asked to
    torch.use_deterministic_algorithms(True)
    try:
        _resume(cfg, fresh, batch, tmp_path)
    finally:
        torch.use_deterministic_algorithms(False)


def _resume(cfg, fresh, batch, tmp_path):
    model, opt = fresh()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tstep.train_step(model, opt, batch, modality_generator=gen)
    tckpt.save_checkpoint(str(tmp_path / "ck"), model, opt,
                          meta={"config": str(cfg)}, generator=gen)
    tree, meta = tckpt.load_checkpoint(str(tmp_path / "ck"))
    model2, opt2 = fresh()
    gen2 = torch.Generator()
    tckpt.restore(model2, tree, opt2, gen2)
    assert opt2.steps == opt.steps == tree["step"] == 2
    assert "zs_weights" in "".join(tree["model"])
    runs = []
    for m, o, g in ((model, opt, gen), (model2, opt2, gen2)):
        torch.manual_seed(7)
        logs = [tstep.train_step(m, o, batch, modality_generator=g)
                for _ in range(2)]
        runs.append(([float(l["total_loss"]) for l in logs],
                     m.last_modality, m.state_dict(), o))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    for k, t in runs[0][2].items():
        assert torch.equal(t, runs[1][2][k]), k
    for ga, gb in zip(opt.adamw.param_groups, opt2.adamw.param_groups):
        assert ga["lr"] == gb["lr"] and ga["lr_mult"] == gb["lr_mult"]
        for p, q in zip(ga["params"], gb["params"]):
            for key, val in opt.adamw.state[p].items():
                assert torch.equal(val, opt2.adamw.state[q][key])


@pytest.mark.parametrize("fusion", ["sweep_sum", "sweep_cat", "with_time"])
def test_sweep_modes_train_or_refuse(fusion):
    """Every sweep fusion trains, and matches JAX: the view transformer
    with two sweeps in train mode (``sweep_cat`` / ``with_time``: the 1x1
    conv + ReLU, JAX's Dense) against JAX's, on the same weights: the
    volume within 1e-5 of its largest value, the gradients of a weighted
    sum of it with respect to every parameter within 1e-5 of the largest
    gradient entry (the conv bias before the train-mode BN has gradient
    0 in theory and rounding noise on both sides), and the BN batch
    statistics within rtol 1e-5."""
    from uni3detr_tpu.models.view_trans import Uni3DViewTrans as JVT
    from uni3detr_tpu_torch.models.view_trans import Uni3DViewTrans
    from uni3detr_tpu_torch.weights import _view_trans
    rng = np.random.RandomState(6)
    C, S = 6, 2
    pr = (-2.0, 0.0, -1.0, 2.0, 4.0, 1.0)
    feats = [rng.randn(1, S, 8, 10, C).astype(np.float32)]
    d = rng.randn(1, S, 8, 10, 5).astype(np.float32)
    depths = [np.exp(d) / np.exp(d).sum(-1, keepdims=True)]
    l2i = np.broadcast_to(np.array(
        [[9.0, 0, 5, 0], [0, 0, -9.0, 4], [0, 1, 0, 0.5], [0, 0, 0, 1]],
        np.float32), (1, S, 4, 4)).copy()
    times = np.array([[0.0, 0.05]], np.float32)
    args = (feats, depths, l2i, np.eye(3, dtype=np.float32)[None], (8, 10))
    jvt = JVT(voxel_shape=(5, 4, 3), pc_range=pr, embed_dims=C, num_convs=1,
              num_sweeps=S, sweep_fusion=fusion)
    jargs = ([jnp.asarray(f) for f in feats],
             [jnp.asarray(x) for x in depths], jnp.asarray(l2i),
             jnp.asarray(args[3]), args[4])
    v = jvt.init(jax.random.PRNGKey(0), *jargs, sweep_times=times)
    w = rng.randn(1, 3, 4, 5, C).astype(np.float32)

    def jfn(params):
        out, upd = jvt.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, *jargs,
                             train=True, sweep_times=times,
                             mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    jgrad, (jout, jstats) = jax.grad(jfn, has_aux=True)(v["params"])
    o = _Out()
    _view_trans(o, dataclasses.replace(OV_TINY, num_view_convs=1),
                v["params"], v["batch_stats"], "vt")
    vt = Uni3DViewTrans((5, 4, 3), pr, embed_dims=C, num_convs=1,
                        num_sweeps=S, sweep_fusion=fusion).train()
    vt.load_state_dict({k[3:]: _t(a) for k, a in o.sd.items()}, strict=True)
    out = vt([_t(f) for f in feats], [_t(x) for x in depths], _t(l2i),
             _t(args[3]), args[4], sweep_times=_t(times))
    assert out.shape == (1, 3, 4, 5, C)
    _close(out, jout, rtol=0, atol=1e-5 * np.abs(np.asarray(jout)).max())
    (out * _t(w)).sum().backward()
    back = _Out()
    grads = {k: v_ for k, v_ in jgrad.items()}
    _view_trans(back, dataclasses.replace(OV_TINY, num_view_convs=1), grads,
                jstats, "vt")
    scale = max(np.abs(back.sd[f"vt.{n}"]).max()
                for n, _ in vt.named_parameters())
    for name, p in vt.named_parameters():
        _close(p.grad, back.sd[f"vt.{name}"], rtol=0, atol=1e-5 * scale,
               msg=name)
    sd = vt.state_dict()
    for k in ("running_mean", "running_var"):
        _close(sd[f"conv_trans_head_1.1.{k}"],
               back.sd[f"vt.conv_trans_head_1.1.{k}"])
    if fusion != "sweep_sum":
        assert not any(".1." in k and k.startswith(("trans", "time"))
                       for k in sd)


def test_ov_train_batch_keeps_the_boxes_the_camera_sees():
    """``ov_train_batch`` at the multimodal preset: 100k points and one
    480x640 image a scene, the GT boxes whose centre is in the camera's
    frame, packed to the front (printed: the share kept)."""
    from uni3detr_tpu_torch.synthetic import in_camera_frame, lidar2img
    cfg = tpresets.OV_SUNRGBD_MM
    batch, share = ov_train_batch(0, cfg, 2)
    print(f"GT centres in the camera's frame: {share:.3f}")
    assert batch["points"].shape == (2, cfg.num_points, 4)
    assert batch["images"].shape == (2, 1, 480, 640, 3)
    assert batch["gt_boxes"].shape == (2, cfg.max_gt, 7)
    assert 0.3 < share < 1.0
    for b in range(2):
        m = batch["gt_mask"][b]
        n = int(m.sum())
        assert n > 5 and m[:n].all() and not m[n:].any()
        box = batch["gt_boxes"][b, :n]
        centre = box[:, :3] + np.stack([0 * box[:, 0], 0 * box[:, 0],
                                        box[:, 5] / 2], -1)
        assert in_camera_frame(centre, lidar2img(cfg.img_size),
                               cfg.img_size).all()
    rgb, _ = ov_train_batch(0, tpresets.OV_SUNRGBD_RGB, 2)
    pc, _ = ov_train_batch(0, tpresets.OV_SUNRGBD_PC, 2)
    assert "points" not in rgb and "images" in rgb
    assert "images" not in pc and "points" in pc
