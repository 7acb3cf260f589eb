"""The port's training path against the JAX package, on the CPU.

Inputs are made with numpy and fed to both. Tolerances (fp32):

- BatchNorm in train mode (the sparse encoder's masked BN and the dense
  backbone's BN): outputs and updated running statistics within rtol
  1e-5 (plus atol 1e-6 for values near 0);
- box codes and IoUs within atol 1e-5; each loss term, its total and its
  gradient with respect to the head outputs within atol 1e-5 (the
  assignment is scipy's exact one on both sides, and equal);
- one AdamW + global-norm clip step against optax on the same gradients
  within 1e-6;
- the slice: one ``uni3detr_tiny_synthetic`` train step (fp32, dropout 0,
  ``matcher="scipy"``, the same weights and batch) through the JAX
  package's ``make_train_step`` and the port's ``train_step``: total and
  per-layer losses and the gradient norm within rtol 1e-4; the gradients
  (read from the optimizers' first moments, 0.1 x the clipped gradient
  in both after one step) within 1e-3 of each leaf's largest entry (fp32
  sums in another order through the whole network; the floor of the
  scale, 1e-5, covers leaves whose gradient is zero in theory, such as
  the self-attention key bias, where both sides hold ~1e-10 of rounding
  noise); the updated parameters and batch statistics within rtol 1e-4
  (atol 1e-6), except the few parameter entries whose gradient is so
  near zero that the two differ by more than 0.5% of it: Adam's first
  step g / (|g| + eps) turns that into a step difference of more than 1%
  of lr, up to a full lr either way when the signs differ, so both sides
  are held to one step there (1.1 lr, weight decay included), and such
  entries must stay under 1% of all.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.geom import boxes as jboxes
from uni3detr_tpu.geom import iou as jiou
from uni3detr_tpu.models.layers import MaskedBatchNorm as JMaskedBN
from uni3detr_tpu.models.second3d import SECOND3D as JBackbone
from uni3detr_tpu.models.second3d import SECOND3DFPN as JNeck
from uni3detr_tpu.train import losses as jl
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.geom import boxes as tboxes
from uni3detr_tpu_torch.geom import iou as tiou
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.models.layers import MaskedBatchNorm as TMaskedBN
from uni3detr_tpu_torch.synthetic import clustered_train_batch
from uni3detr_tpu_torch.train import losses as tl
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import state_dict_from_jax
from test_torch_import import make_state_dict

TINY = jpresets.TINY_SYNTHETIC


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _port_model(cfg, v):
    model = TModel(cfg)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, cfg).items()}, strict=True)
    return model


# -- BatchNorm in train mode ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batchnorm_train_matches_jax(dtype):
    rng = np.random.RandomState(0)
    B, V, C = 2, 50, 8
    x = (rng.randn(B, V, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(B, V) > 0.3
    p = {"scale": rng.rand(C).astype(np.float32) + 0.5,
         "bias": rng.randn(C).astype(np.float32)}
    s = {"mean": rng.randn(C).astype(np.float32),
         "var": rng.rand(C).astype(np.float32) + 0.5}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref, upd = JMaskedBN().apply({"params": p, "batch_stats": s},
                                 jnp.asarray(x, jd), jnp.asarray(mask), True,
                                 mutable=["batch_stats"])
    bn = TMaskedBN(C).train()
    bn.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                        "running_mean": _t(s["mean"]),
                        "running_var": _t(s["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(_t(x).to(td), _t(mask))
    assert got.dtype == td
    if dtype == "float32":
        _close(got.detach(), ref)
    else:   # both round one fp32 value to bf16: one bf16 ulp
        _close(got.detach().float(), ref.astype(jnp.float32), rtol=2 ** -7,
               atol=1e-6)
    _close(bn.running_mean, upd["batch_stats"]["mean"])
    _close(bn.running_var, upd["batch_stats"]["var"])


def test_dense_batchnorm_train_matches_flax():
    """SECOND3D / FPN in train mode on a tiny volume: the deeper stages
    normalize over 8 values per channel, where torch's unbiased running
    variance would differ from flax's biased one by 8/7."""
    v = import_torch_state_dict(
        make_state_dict(TINY, np.random.RandomState(1)), TINY)
    model = _port_model(tpresets.TINY_SYNTHETIC, v).train()
    vol = np.random.RandomState(2).randn(
        1, 2, 8, 8, TINY.encoder_out_channels).astype(np.float32)
    pv = lambda n: {"params": v["params"][n],
                    "batch_stats": v["batch_stats"][n]}
    bb = JBackbone(out_channels=TINY.backbone_channels,
                   layer_nums=TINY.backbone_layers,
                   layer_strides=TINY.backbone_strides)
    neck = JNeck(out_channels=TINY.neck_channels,
                 upsample_strides=TINY.neck_upsample_strides)
    jms, s_bb = bb.apply(pv("pts_backbone"), jnp.asarray(vol), True,
                         mutable=["batch_stats"])
    jout, s_neck = neck.apply(pv("pts_neck"), jms, True,
                              mutable=["batch_stats"])
    tout = model.pts_neck(model.pts_backbone(
        _t(vol).permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
    _close(tout.detach(), jout, rtol=1e-5, atol=1e-5)
    back = import_torch_state_dict(model.state_dict(), TINY)["batch_stats"]
    for name, upd in (("pts_backbone", s_bb), ("pts_neck", s_neck)):
        jax.tree_util.tree_map(lambda a, b: _close(a, b), back[name],
                               upd["batch_stats"])


# -- geometry and losses ----------------------------------------------------

def _boxes(rng, shape, spread=1.0):
    return np.concatenate([
        rng.uniform(-1, 1, shape + (3,)) * spread,
        rng.uniform(0.3, 1.2, shape + (3,)),
        rng.uniform(-np.pi, np.pi, shape + (1,))], -1).astype(np.float32)


def test_box_codes_and_ious_match_jax():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, (2, 7), 0.5), _boxes(rng, (2, 5), 0.5)
    aa, bb = _boxes(rng, (2, 9), 0.3), _boxes(rng, (2, 9), 0.3)
    aa[0, 0] = bb[0, 0]                       # an identical pair
    pairs = [
        (tboxes.gravity_center_boxes(_t(a)), jboxes.gravity_center_boxes(a)),
        (tboxes.encode_boxes(_t(a)), jboxes.encode_boxes(jnp.asarray(a))),
        (tiou.nearest_bev_iou(_t(a), _t(b)),
         jax.vmap(jiou.nearest_bev_iou)(a, b)),
        (tiou.nearest_bev_iou_aligned(_t(aa), _t(bb)),
         jiou.nearest_bev_iou_aligned(aa, bb)),
        (tiou.z_interval_iou_aligned(_t(aa), _t(bb)),
         jiou.z_interval_iou_aligned(aa, bb)),
        (tiou.iou3d_rotated(_t(a), _t(b)),
         jax.vmap(lambda x, y: jiou.iou3d_rotated(x, y, "center"))(a, b))]
    for z in ("center", "bottom"):
        pairs.append((tiou.iou3d_rotated_aligned(_t(aa), _t(bb), z),
                      jiou.iou3d_rotated_aligned(aa, bb, z_origin=z)))
    for i, (got, ref) in enumerate(pairs):
        assert tuple(got.shape) == tuple(np.shape(ref)), i
        _close(got, ref, rtol=0, atol=1e-5, msg=str(i))
    assert np.asarray(pairs[-1][1]).max() > 0.99


def _head_outputs(rng, cfg, L, B, Q):
    cls = rng.randn(L, B, Q, cfg.num_classes) * 2
    box = np.concatenate([rng.uniform(-1.5, 1.5, (L, B, Q, 2)),
                          rng.uniform(-1.2, 0.0, (L, B, Q, 2)),
                          rng.uniform(-0.8, 0.8, (L, B, Q, 1)),
                          rng.uniform(-1.2, 0.0, (L, B, Q, 1)),
                          rng.uniform(-1, 1, (L, B, Q, 2))], -1)
    return {"all_cls_scores": cls.astype(np.float32),
            "all_bbox_preds": box.astype(np.float32),
            "all_iou_preds": rng.randn(L, B, Q).astype(np.float32)}


def _gt(rng, cfg, B, G, n):
    gt = _boxes(rng, (B, G), 1.5)
    labels = rng.randint(0, cfg.num_classes, (B, G)).astype(np.int32)
    mask = np.zeros((B, G), bool)
    mask[:, :n] = True
    return gt, labels, mask


def test_cost_and_focal_terms_match_jax():
    rng = np.random.RandomState(4)
    logits = (rng.randn(12, 3) * 3).astype(np.float32)
    labels = np.array([0, 2, 1, 1], np.int32)
    iou = rng.rand(12, 4).astype(np.float32)
    q_lab = rng.randint(0, 4, 12).astype(np.int32)
    qual = rng.rand(12).astype(np.float32)
    pairs = [
        (tl.focal_cls_cost(_t(logits), _t(labels)),
         jl.focal_cls_cost(logits, labels)),
        (tl.soft_focal_cls_cost(_t(logits), _t(labels), _t(iou)),
         jl.soft_focal_cls_cost(logits, labels, iou)),
        (tl.soft_focal_loss(_t(logits), _t(q_lab), _t(qual), 3),
         jl.soft_focal_loss(logits, q_lab, qual, 3))]
    for got, ref in pairs:
        _close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("types", [
    ("focal", "iou3d", "iou3d", 1),
    ("soft_focal", "rotated_iou3d", "rotated_iou3d", 1),
    ("focal", "iou3d", "rotated_iou3d", 2)])
def test_uni3detr_loss_and_grads_match_jax(types):
    cls_cost, iou_cost, iou_loss, repeat = types
    cfg = dataclasses.replace(TINY, num_query=8, matcher="scipy",
                              cls_cost_type=cls_cost,
                              iou_cost_type=iou_cost,
                              iou_loss_type=iou_loss, gt_repeattimes=repeat)
    tcfg = dataclasses.replace(tpresets.TINY_SYNTHETIC,
                               **{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    rng = np.random.RandomState(5)
    L, B, Q = 2, 2, 3 * cfg.num_query
    outs = _head_outputs(rng, cfg, L, B, Q)
    gt, labels, mask = _gt(rng, cfg, B, 4, 3)
    gtj = jboxes.gravity_center_boxes(gt)

    def jloss(o):
        return jl.uni3detr_loss(o, gtj, labels, mask, cfg)

    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(a) for k, a in outs.items()})
    tout = {k: _t(a).requires_grad_() for k, a in outs.items()}
    ttotal, tlogs = tl.uni3detr_loss(tout, tboxes.gravity_center_boxes(
        _t(gt)), _t(labels), _t(mask), tcfg)
    ttotal.backward()
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k].detach(), jlogs[k], rtol=0, atol=1e-5, msg=k)
    _close(ttotal.detach(), jtotal, rtol=0, atol=1e-5)
    for k in outs:
        _close(tout[k].grad, jgrad[k], rtol=0, atol=1e-5, msg=k)
    # the assignment itself: equal (scipy on both sides)
    ja = jax.jit(jax.vmap(lambda c, b, g, l, m: jl.hungarian_assign(
        c, b, g, l, m, cfg)))(outs["all_cls_scores"][0],
                              outs["all_bbox_preds"][0], gtj, labels, mask)
    ta = tl.hungarian_assign(_t(outs["all_cls_scores"][0]),
                             _t(outs["all_bbox_preds"][0]),
                             _t(np.asarray(gtj)), _t(labels), _t(mask),
                             tcfg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta >= 0).sum() == B * 3 * 3 * repeat


@pytest.mark.parametrize("name", ["rdiou", "axis_aligned_iou3d"])
def test_unported_iou_types_raise(name):
    cfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, num_query=8,
                              matcher="scipy", iou_cost_type=name)
    rng = np.random.RandomState(6)
    outs = {k: _t(v[0]) for k, v in _head_outputs(rng, cfg, 1, 1, 8).items()}
    gt, labels, mask = _gt(rng, cfg, 1, 4, 3)
    with pytest.raises(NotImplementedError):
        tl.hungarian_assign(outs["all_cls_scores"], outs["all_bbox_preds"],
                            _t(gt), _t(labels), _t(mask), cfg)


# -- optimizer ---------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.01, 30.0])
def test_adamw_clip_step_matches_optax(grad_scale):
    """One step on the same gradients, clipped (global norm > 10) or not;
    then a second step to cover the bias corrections."""
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * grad_scale).astype(np.float32)
              for s in shapes] for _ in range(2)]
    tx = jstep.make_optimizer(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = tstep.Optimizer(tp, 1e-3)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
    for a, b in zip(tp, jp):
        _close(a.detach(), b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("warmup", [0, 5])
def test_step_lr_schedule_matches_optax(warmup):
    j = jstep.step_lr_schedule(1e-3, 4, [2, 3], warmup_steps=warmup)
    t = tstep.step_lr_schedule(1e-3, 4, [2, 3], warmup_steps=warmup)
    for step in range(20):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


# -- the slice: one tiny train step -----------------------------------------

@pytest.fixture(scope="module")
def tiny_steps():
    cfg = dataclasses.replace(TINY, dropout=0.0, matcher="scipy")
    tcfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, dropout=0.0,
                               matcher="scipy")
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)
    batch = clustered_train_batch(3, tcfg, 2)
    lr = 1e-4
    tx = jstep.make_optimizer(lr)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"],
                             batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]), tx=tx)
    state, jlogs = jstep.make_train_step(cfg, donate=False)(
        state, {k: jnp.asarray(a) for k, a in batch.items()},
        jax.random.PRNGKey(0))
    model = _port_model(tcfg, v)
    opt = tstep.make_optimizer(model, lr)
    tlogs = tstep.train_step(model, opt, {k: _t(a) for k, a in
                                          batch.items()})
    return cfg, state, jlogs, model, opt, tlogs


def test_tiny_train_step_losses_match_jax(tiny_steps):
    _, _, jlogs, _, _, tlogs = tiny_steps
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)
    assert np.isfinite(float(tlogs["total_loss"]))


def _grad_tol(mu):
    return 1e-3 * max(np.abs(mu).max(), 1e-5)


def test_tiny_train_step_grads_match_jax(tiny_steps):
    cfg, state, _, model, opt, _ = tiny_steps
    sd = model.state_dict()
    for name, p in model.named_parameters():
        sd[name] = opt.adamw.state[p]["exp_avg"]
    tmu = import_torch_state_dict(sd, cfg)["params"]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tmu)[0])
    flat_j = jax.tree_util.tree_flatten_with_path(state.opt_state[1][0].mu)[0]
    assert len(flat_t) == len(flat_j)
    for path, ref in flat_j:
        ref, got = np.asarray(ref), np.asarray(flat_t[path])
        err = np.abs(got - ref).max()
        assert err <= _grad_tol(ref), (jax.tree_util.keystr(path), err)


def test_tiny_train_step_updates_match_jax(tiny_steps):
    cfg, state, _, model, opt, _ = tiny_steps
    lr = opt.schedule(0)
    v0 = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)["params"]
    back = import_torch_state_dict(model.state_dict(), cfg)
    jax.tree_util.tree_map(lambda a, b: _close(a, b, rtol=1e-4, atol=1e-6),
                           back["batch_stats"], state.batch_stats)
    sd = model.state_dict()
    for name, p in model.named_parameters():
        sd[name] = opt.adamw.state[p]["exp_avg"]
    tmu = import_torch_state_dict(sd, cfg)["params"]
    leaves = [dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in
              (back["params"], state.params, v0, state.opt_state[1][0].mu,
               tmu)]
    n_free = 0
    for path in leaves[0]:
        got, ref, init, mu, mu_t = (np.asarray(t[path]) for t in leaves)
        free = np.abs(mu_t - mu) > 0.005 * (np.abs(mu) + 1e-9)
        n_free += int(free.sum())
        _close(got[~free], ref[~free], rtol=1e-4, atol=1e-6,
               msg=jax.tree_util.keystr(path))
        for a in (got, ref):
            assert (np.abs(a - init)[free] <= 1.1 * lr).all()
    assert n_free < 0.01 * sum(a.size for a in leaves[0].values())
