"""The config options that no shipped preset uses, port against the JAX
package on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances
(fp32):

- ``axis_aligned_iou3d``, ``rdiou`` and ``rdiou_penalty``: values within
  1e-6 (rtol and atol), gradients within 1e-5. The predicted log sizes
  lie in [-1, 1.5] (``exp`` well under the clip at 10) except one row at
  3.0 (inside the clip, where both gradients are 0); centres and
  extents put the intersections and ``rd - u`` away from their clips;
- ``iou_match_cost`` of both types within 1e-5 and the assignment on it
  equal (scipy on both sides); the loss with the ``rdiou`` cost and loss
  and with the ``axis_aligned_iou3d`` cost, its terms and its gradients
  within 1e-5, as ``tests/test_torch_port_train.py`` holds the others;
- one ``uni3detr_tiny_synthetic`` train step with the ``rdiou`` cost and
  loss against JAX's ``make_train_step``: losses and the gradient norm
  within rtol 1e-4, the gradients within 1e-3 of each leaf's largest
  entry (the tolerances of ``test_torch_port_train.py``'s step);
- ``soft_nms_plain`` against ``soft_nms3d`` per class (overlapping boxes,
  a prune that stops the loop early, equal scores): identical ``idxs``
  and ``ok``, ``outs`` within 1e-6; ``post_process`` with ``soft_nms``
  equal to JAX's on every box but index 0 (JAX's keep-mask scatter drops
  box 0, see ``test_soft_nms_keeps_box_zero``);
- the dense sparse encoder against JAX's ``impl="dense"`` with carried
  weights, eval and train (outputs and running statistics within 1e-4 of
  the largest value), and against the port's gather route at its active
  sites (rtol 2e-2, atol 2e-3, as ``tests/test_sparse_conv.py`` holds
  JAX's two routes);
- VoVNet against JAX on an odd and an even input size (``"SAME"``
  padding): eval outputs within 1e-4 of the largest value, train-mode
  running statistics within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.geom import boxes as jboxes
from uni3detr_tpu.geom import iou as jiou
from uni3detr_tpu.ops.nms import soft_nms3d
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train import losses as jl
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.geom import boxes as tboxes
from uni3detr_tpu_torch.geom import iou as tiou
from uni3detr_tpu_torch.ops import nms as tnms
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.train import losses as tl

TINY = jpresets.TINY_SYNTHETIC


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _tcfg(cfg):
    return dataclasses.replace(tpresets.TINY_SYNTHETIC, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


# -- the IoUs ---------------------------------------------------------------

def _iou_boxes(rng, n, log_sizes):
    """(n, 7) boxes near each other: centres in [-0.6, 0.6], sizes as log
    sizes (``rdiou``'s input) or as extents."""
    lo, hi = (-1.0, 1.5) if log_sizes else (0.3, 1.5)
    return np.concatenate([rng.uniform(-0.6, 0.6, (n, 3)),
                           rng.uniform(lo, hi, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["axis_aligned_iou3d", "rdiou",
                                "rdiou_penalty"])
def test_iou_values_and_grads_match_jax(fn):
    rng = np.random.RandomState(0)
    if fn == "axis_aligned_iou3d":
        a, b = _iou_boxes(rng, 9, False), _iou_boxes(rng, 6, False)
        jf = lambda x, y: jiou.axis_aligned_iou3d(x, y)
        tf = lambda x, y: tiou.axis_aligned_iou3d(x, y)
        shape = (9, 6)
    else:
        a, b = _iou_boxes(rng, 12, True), _iou_boxes(rng, 12, True)
        a[3, 3:6] = 3.0               # a prediction inside exp's clip
        if fn == "rdiou":
            jf = lambda x, y: jnp.stack(jiou.rdiou(x, y))
            tf = lambda x, y: torch.stack(tiou.rdiou(x, y))
            shape = (2, 12)
        else:
            jf, tf, shape = jl.rdiou_penalty, tl.rdiou_penalty, (12,)
    w = rng.randn(*shape).astype(np.float32)
    jv, (ga, gb) = jax.value_and_grad(
        lambda x, y: jnp.sum(jf(x, y) * w), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    tv = tf(ta, tb)
    assert tuple(tv.shape) == shape
    _close(tv, jf(jnp.asarray(a), jnp.asarray(b)), rtol=1e-6, atol=1e-6)
    (tv * _t(w)).sum().backward()
    _close(ta.grad, ga, rtol=1e-5, atol=1e-5)
    _close(tb.grad, gb, rtol=1e-5, atol=1e-5)
    if fn != "axis_aligned_iou3d":
        assert not ta.grad[3, 3:6].any() and not np.asarray(ga)[3, 3:6].any()
    else:
        assert np.asarray(jf(a, b)).max() > 0.1


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
    gt = np.concatenate([rng.uniform(-1.5, 1.5, (B, G, 3)),
                         rng.uniform(0.3, 1.2, (B, G, 3)),
                         rng.uniform(-np.pi, np.pi, (B, G, 1))],
                        -1).astype(np.float32)
    labels = rng.randint(0, cfg.num_classes, (B, G)).astype(np.int32)
    mask = np.zeros((B, G), bool)
    mask[:, :n] = True
    return gt, labels, mask


@pytest.mark.parametrize("types", [("axis_aligned_iou3d", "iou3d"),
                                   ("rdiou", "rdiou"),
                                   ("iou3d", "rdiou")])
def test_loss_and_assignment_on_new_types_match_jax(types):
    """The cost of both new types, the assignment on it and the loss,
    its terms and its gradients with respect to the head outputs."""
    iou_cost, iou_loss = types
    cfg = dataclasses.replace(TINY, num_query=8, matcher="scipy",
                              iou_cost_type=iou_cost,
                              iou_loss_type=iou_loss)
    tcfg = _tcfg(cfg)
    rng = np.random.RandomState(5)
    L, B, Q = 2, 2, 3 * cfg.num_query
    outs = _head_outputs(rng, cfg, L, B, Q)
    gt, labels, mask = _gt(rng, cfg, B, 4, 3)
    gtj = np.asarray(jboxes.gravity_center_boxes(gt))
    dec = jboxes.decode_boxes(jnp.asarray(outs["all_bbox_preds"][0]))
    jc = jax.vmap(lambda d, g: jl.iou_match_cost(d, None, g, None, cfg))(
        dec, gtj)
    tc = tl.iou_match_cost(tboxes.decode_boxes(_t(
        outs["all_bbox_preds"][0])), _t(gtj), tcfg)
    _close(tc, jc, rtol=0, atol=1e-5)

    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(
        lambda o: jl.uni3detr_loss(o, gtj, labels, mask, cfg),
        has_aux=True))({k: jnp.asarray(a) for k, a in outs.items()})
    tout = {k: _t(a).requires_grad_() for k, a in outs.items()}
    ttotal, tlogs = tl.uni3detr_loss(tout, _t(gtj), _t(labels), _t(mask),
                                     tcfg)
    ttotal.backward()
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=0, atol=1e-5, msg=k)
    _close(ttotal, jtotal, rtol=0, atol=1e-5)
    for k in outs:
        _close(tout[k].grad, jgrad[k], rtol=0, atol=1e-5, msg=k)
    ja = jax.jit(jax.vmap(lambda c, b, g, l, m: jl.hungarian_assign(
        c, b, g, l, m, cfg)))(outs["all_cls_scores"][0],
                              outs["all_bbox_preds"][0], gtj, labels, mask)
    ta = tl.hungarian_assign(_t(outs["all_cls_scores"][0]),
                             _t(outs["all_bbox_preds"][0]), _t(gtj),
                             _t(labels), _t(mask), tcfg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta >= 0).sum() == B * 3 * 3


# -- soft-NMS ---------------------------------------------------------------

def _scene_boxes(rng, N, spread):
    """(N, 7) bottom-z boxes crowded in a small area, so that many pairs
    overlap."""
    return np.concatenate([rng.uniform(-spread, spread, (N, 2)),
                           rng.uniform(-0.2, 0.2, (N, 1)),
                           rng.uniform(0.4, 1.2, (N, 3)),
                           rng.uniform(-np.pi, np.pi, (N, 1))],
                          -1).astype(np.float32)


def _soft_case(case):
    """(boxes (B, N, 7), scores, labels, valid, num_classes, prune)."""
    rng = np.random.RandomState({"overlap": 1, "prune": 2, "ties": 3}[case])
    B, N, C = 2, 40, 3
    boxes = np.stack([_scene_boxes(rng, N, 1.5) for _ in range(B)])
    scores = rng.uniform(0.05, 1.0, (B, N)).astype(np.float32)
    labels = rng.randint(0, C, (B, N)).astype(np.int32)
    valid = rng.rand(B, N) > 0.15
    prune = 1e-3
    if case == "prune":
        prune = 0.4                   # most loops stop well before the end
    elif case == "ties":
        scores = np.round(scores * 4) / 4   # many equal scores
        # and pairs of one class with equal boxes and scores
        for a in (boxes, scores, labels):
            a[:, 0:39:3] = a[:, 1::3]
    return boxes, scores, labels, valid, C, prune


@pytest.mark.parametrize("case", ["overlap", "prune", "ties"])
def test_soft_nms_plain_matches_jax(case):
    boxes, scores, labels, valid, C, prune = _soft_case(case)
    B, N = scores.shape
    iou = tiou.iou3d_rotated_pairwise(_t(boxes))
    out, keep, step = tnms.soft_nms_plain(iou, _t(scores), _t(labels),
                                          _t(valid), C, 0.3, prune, N)
    n_kept = n_short = 0
    for b in range(B):
        for c in range(C):
            jidx, jouts, jok = soft_nms3d(
                boxes[b], scores[b], valid[b] & (labels[b] == c),
                gaussian_sigma=0.3, prune_threshold=prune, max_out=N)
            jidx, jouts, jok = (np.asarray(a) for a in (jidx, jouts, jok))
            mine = (labels[b] == c) & keep[b].numpy()
            order = np.argsort(step[b].numpy()[mine], kind="stable")
            idx = np.flatnonzero(mine)[order]
            k = len(idx)
            np.testing.assert_array_equal(idx, jidx[:k], err_msg=str((b, c)))
            assert jok[:k].all() and not jok[k:].any()
            np.testing.assert_array_equal(step[b].numpy()[idx], np.arange(k))
            _close(out[b].numpy()[idx], jouts[:k], rtol=1e-6, atol=1e-6)
            n_kept += k
            n_short += k < ((labels[b] == c) & valid[b]).sum()
    assert not (out[~keep]).any() and (step[~keep] == -1).all()
    assert not (keep & ~_t(valid)).any()
    assert n_kept > 10
    if case == "prune":
        assert n_short == B * C       # every loop stopped early


def _post_inputs(rng, cfg, B):
    K = cfg.max_num
    boxes = np.stack([_scene_boxes(rng, K, 1.2) for _ in range(B)])
    boxes[..., 2] += boxes[..., 5] * 0.5          # gravity-centred
    scores = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    labels = rng.randint(0, cfg.num_classes, (B, K)).astype(np.int32)
    valid = rng.rand(B, K) > 0.1
    return boxes, scores, labels, valid


@pytest.mark.parametrize("thr", [(None, None), (0.05, 12)])
def test_post_process_soft_nms_matches_jax(thr):
    """Every box but index 0 (see ``test_soft_nms_keeps_box_zero``), with
    and without the score and count thresholds."""
    cfg = dataclasses.replace(TINY, post_processing="soft_nms",
                              score_thr=thr[0], num_thr=thr[1])
    args = _post_inputs(np.random.RandomState(11), cfg, 2)
    jb, js, jlab, jv = (np.asarray(a) for a in jcoder.post_process(
        *(jnp.asarray(a) for a in args), cfg))
    tb, ts, tlab, tv = tcoder.post_process(*(_t(a) for a in args),
                                           _tcfg(cfg))
    _close(tb, jb, rtol=0, atol=1e-6)
    _close(ts[:, 1:], js[:, 1:], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    np.testing.assert_array_equal(tv[:, 1:].numpy(), jv[:, 1:])
    assert 0 < int(tv.sum()) < tv.numel()
    assert (ts[~tv] == 0).all() if thr[0] is None else True


def test_soft_nms_keeps_box_zero():
    """Three far-apart class-0 boxes at score 0.5 (``max_num`` 32, the
    rest invalid): JAX's ``soft_nms3d`` keeps all three, box 0 first,
    but JAX's ``post_process`` marks box 0 invalid (each loop step that
    keeps nothing writes False to index 0); the port keeps it."""
    cfg = dataclasses.replace(TINY, post_processing="soft_nms")
    K = cfg.max_num
    boxes = np.zeros((1, K, 7), np.float32)
    boxes[0, :, 3:6] = 1.0
    boxes[0, :3, 0] = [-1.5, 0.0, 1.5]
    scores = np.zeros((1, K), np.float32)
    scores[0, :3] = 0.5
    labels = np.zeros((1, K), np.int32)
    valid = np.zeros((1, K), bool)
    valid[0, :3] = True
    idx, outs, ok = soft_nms3d(jboxes.bottom_center_boxes(boxes[0])[:, :7],
                               scores[0], valid[0], max_out=K)
    assert list(np.asarray(idx)[:3]) == [0, 1, 2] and np.asarray(ok).sum() == 3
    _, js, _, jv = jcoder.post_process(boxes, scores, labels, valid, cfg)
    assert list(np.asarray(jv)[0, :3]) == [False, True, True]
    assert list(np.asarray(js)[0, :3]) == [0.5, 0.5, 0.5]
    _, ts, _, tv = tcoder.post_process(_t(boxes), _t(scores), _t(labels),
                                       _t(valid), _tcfg(cfg))
    assert tv[0].tolist() == [True] * 3 + [False] * (K - 3)
    assert ts[0, :3].tolist() == [0.5, 0.5, 0.5]


# -- the dense sparse encoder -------------------------------------------------

ENC = dict(base_channels=8, output_channels=16,
           encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
           downsample_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)))
ENC_GRID = (16, 24, 24)
ENC_CFG = dataclasses.replace(TINY, encoder_channels=ENC["encoder_channels"],
                              encoder_out_channels=16)


def _voxels(rng, B, V, n):
    """Clustered voxels of ``ENC_GRID`` sorted by linear id, invalid rows
    last: (feats (B, V, 4), coords (B, V, 3) int32, mask (B, V))."""
    D, H, W = ENC_GRID
    feats = np.zeros((B, V, 4), np.float32)
    coords = -np.ones((B, V, 3), np.int32)
    mask = np.zeros((B, V), bool)
    for b in range(B):
        centres = rng.randint(0, [D, H, W], (6, 3))
        pts = centres[rng.randint(0, 6, 4 * n)] + rng.randint(-2, 3,
                                                              (4 * n, 3))
        pts = np.clip(pts, 0, [D - 1, H - 1, W - 1])
        lin = np.unique((pts[:, 0] * H + pts[:, 1]) * W + pts[:, 2])[:n]
        k = len(lin)
        coords[b, :k] = np.stack([lin // (H * W), (lin // W) % H, lin % W],
                                 -1)
        mask[b, :k] = True
        feats[b, :k] = rng.randn(k, 4)
    return feats, coords, mask


def _encoders(rng):
    """The JAX dense encoder with drawn variables (BN statistics and
    scales away from the identity) and the port's with the same weights."""
    from uni3detr_tpu.models.sparse_encoder import SparseEncoderHD as JEnc
    from uni3detr_tpu_torch.models.sparse_encoder import (
        SparseEncoderHD as TEnc)
    from uni3detr_tpu_torch.weights import _Out, _encoder

    jenc = JEnc(sparse_shape=ENC_GRID, impl="dense", **ENC)
    f, c, m = _voxels(rng, 1, 64, 40)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(c),
                  jnp.asarray(m), False)
    leaf = lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if
                            jax.tree_util.keystr(path).endswith(
                                ("'var']", "'scale']")) else
                            np.asarray(a) + rng.uniform(-0.1, 0.1, a.shape)
                            ).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(leaf, v)
    o = _Out()
    _encoder(o, ENC_CFG, v["params"], v["batch_stats"], "enc")
    outs = []
    for impl in ("dense", "gather"):
        tenc = TEnc(4, ENC_GRID, impl=impl, budget_shrink=(1.0, 1.0, 1.0),
                    **ENC)
        tenc.load_state_dict({k[4:]: _t(a) for k, a in o.sd.items()},
                             strict=True)
        outs.append(tenc)
    return jenc, v, outs


@pytest.mark.parametrize("train", [False, True])
def test_dense_encoder_matches_jax(train):
    """Eval, and train: the volume, the running statistics after the
    forward and the parameter gradients of a weighted sum of the volume,
    each within 1e-4 of its largest value."""
    from uni3detr_tpu.train.torch_import import _import_sparse_encoder, _SD
    rng = np.random.RandomState(20)
    jenc, v, (tenc, _) = _encoders(rng)
    f, c, m = _voxels(rng, 2, 300, 260)
    args = [jnp.asarray(a) for a in (f, c, m)]
    wsum = None

    def jfn(params):
        (vol, grid), upd = jenc.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            train, mutable=["batch_stats"])
        return jnp.sum(vol * wsum), (vol, grid, upd)

    jvol = jenc.apply(v, *args, False)[0]
    wsum = jnp.asarray(rng.randn(*jvol.shape).astype(np.float32))
    jgrad, (jvol, jgrid, upd) = jax.grad(jfn, has_aux=True)(v["params"])
    tenc.train(train)
    tvol, tgrid = tenc(*(_t(a) for a in (f, c, m)))
    assert tgrid == jgrid and tvol.shape == jvol.shape
    scale = np.abs(np.asarray(jvol)).max()
    _close(tvol, jvol, rtol=0, atol=1e-4 * scale)
    (tvol * _t(np.asarray(wsum))).sum().backward()
    cfg = ENC_CFG
    sd = {k: a.detach().numpy() for k, a in tenc.state_dict().items()}
    tstats = _import_sparse_encoder(_SD({f"e.{k}": a for k, a in sd.items()}),
                             cfg, "e")[1]
    jstats = upd["batch_stats"]
    for path, ref in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        got = dict(jax.tree_util.tree_flatten_with_path(tstats)[0])[path]
        ref = np.asarray(ref)
        _close(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
               msg=jax.tree_util.keystr(path))
    for name, p in tenc.named_parameters():
        sd[name] = p.grad.numpy()
    tg = dict(jax.tree_util.tree_flatten_with_path(_import_sparse_encoder(
        _SD({f"e.{k}": a for k, a in sd.items()}), cfg, "e")[0])[0])
    for path, ref in jax.tree_util.tree_flatten_with_path(jgrad)[0]:
        ref = np.asarray(ref)
        _close(tg[path], ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
               msg=jax.tree_util.keystr(path))
    assert scale > 0


def test_dense_encoder_matches_gather_at_active_sites():
    """The port's two routes on the same weights, eval: equal wherever
    the gather route wrote (no budget cuts a site here); the dense route
    also fills the strided sites its occupancy max-pool covers."""
    rng = np.random.RandomState(21)
    _, _, (dense, gather) = _encoders(rng)
    f, c, m = (_t(a) for a in _voxels(rng, 2, 300, 260))
    with torch.no_grad():
        vd, gd = dense.eval()(f, c, m)
        vg, gg = gather.eval()(f, c, m)
    assert gd == gg and vd.shape == vg.shape
    active = vg.abs().sum(-1) > 0
    assert active.any()
    _close(vd[active], vg[active].numpy(), rtol=2e-2, atol=2e-3)


# -- VoVNet -------------------------------------------------------------------

@pytest.mark.parametrize("size", [(65, 47), (64, 48)])
def test_vovnet_matches_jax(size):
    """V2-39's layout at narrow widths, two images: the eval outputs of
    the four stages and the running statistics after a train-mode
    forward."""
    from uni3detr_tpu.models.vovnet import VoVNet as JVoV
    from uni3detr_tpu_torch.models.vovnet import VoVNet as TVoV
    from uni3detr_tpu_torch.weights import state_dict_from_jax_vovnet
    kw = dict(stage_ch=(8, 8, 12, 12), concat_ch=(16, 16, 24, 24))
    rng = np.random.RandomState(30)
    x = rng.randn(2, *size, 3).astype(np.float32)
    jm = JVoV(**kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if "var" in
                      jax.tree_util.keystr(p) else rng.uniform(
                          -0.1, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])}
    tm = TVoV(**kw)
    tm.load_state_dict({k: _t(a) for k, a in
                        state_dict_from_jax_vovnet(v).items()}, strict=True)
    xt = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        touts = tm.eval()(xt)
    jouts = jm.apply(v, jnp.asarray(x))
    assert len(touts) == len(jouts) == 4
    for t, j in zip(touts, jouts):
        j = np.asarray(j)
        assert t.permute(0, 2, 3, 1).shape == j.shape
        _close(t.permute(0, 2, 3, 1), j, rtol=0,
               atol=1e-4 * np.abs(j).max())
    _, upd = jm.apply(v, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    with torch.no_grad():
        tm.train()(xt)
    want = state_dict_from_jax_vovnet({"params": v["params"],
                                       "batch_stats": upd["batch_stats"]})
    got = tm.state_dict()
    keys = [k for k in want if "running" in k]
    assert len(keys) == 2 * (3 + 6 * 6)
    for k in keys:
        _close(got[k], want[k], rtol=1e-5, atol=1e-5, msg=k)


# -- train steps ----------------------------------------------------------------

def _grads_close(jmu, tmu, resnet_prefix=None):
    """First moments (0.1 x the clipped gradient on both sides), leaf by
    leaf: within 1e-3 of the leaf's largest entry, or, under
    ``resnet_prefix``, within 5e-2 of its norm (the L2 norm of the
    difference; ``tests/test_torch_port_ov_train.py``)."""
    jf = dict(jax.tree_util.tree_flatten_with_path(jmu)[0])
    tf = dict(jax.tree_util.tree_flatten_with_path(tmu)[0])
    assert sorted(map(str, jf)) == sorted(map(str, tf))
    for path, ref in jf.items():
        name = jax.tree_util.keystr(path)
        ref, got = np.asarray(ref), np.asarray(tf[path])
        if resnet_prefix and path[0].key == resnet_prefix:
            err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-9)
            assert err <= 5e-2, (name, err)
        else:
            err = np.abs(got - ref).max()
            assert err <= 1e-3 * max(np.abs(ref).max(), 1e-5), (name, err)


def test_tiny_train_step_rdiou_matches_jax():
    """One ``uni3detr_tiny_synthetic`` step with the ``rdiou`` cost and
    loss (fp32, dropout 0, scipy matching) through JAX's
    ``make_train_step`` and the port's ``train_step``."""
    from uni3detr_tpu.train import step as jstep
    from uni3detr_tpu.train.torch_import import import_torch_state_dict
    from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.train import step as tstep
    from uni3detr_tpu_torch.weights import state_dict_from_jax
    from test_torch_import import make_state_dict
    cfg = dataclasses.replace(TINY, dropout=0.0, matcher="scipy",
                              iou_cost_type="rdiou", iou_loss_type="rdiou")
    tcfg = _tcfg(cfg)
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)
    batch = clustered_train_batch(3, tcfg, 2)
    tx = jstep.make_optimizer(1e-4)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"],
                             batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]), tx=tx)
    state, jlogs = jstep.make_train_step(cfg, donate=False)(
        state, {k: jnp.asarray(a) for k, a in batch.items()},
        jax.random.PRNGKey(0))
    model = TModel(tcfg)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, cfg).items()})
    opt = tstep.make_optimizer(model, 1e-4)
    tlogs = tstep.train_step(model, opt, {k: _t(a) for k, a in
                                          batch.items()})
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)
    assert np.isfinite(float(tlogs["total_loss"]))
    sd = model.state_dict()
    for name, p in model.named_parameters():
        sd[name] = opt.adamw.state[p]["exp_avg"]
    _grads_close(state.opt_state[1][0].mu,
                 import_torch_state_dict(sd, cfg)["params"])


def _identity_sweep_bn(sd):
    """The port's ``state_dict`` in the reference layout the JAX importer
    reads: an identity eval BN ``.1`` after each sweep conv (scale 1,
    shift 0, mean 0 and the variance that makes 1 / sqrt(var + 1e-5)
    exactly 1 in fp32), which the importer folds into its Dense as it
    is."""
    sd = dict(sd)
    for name in ("trans_conv", "time_conv"):
        k = f"view_trans.{name}"
        if f"{k}.0.bias" in sd:
            c = sd[f"{k}.0.bias"].shape[0]
            sd[f"{k}.1.weight"] = np.ones(c, np.float32)
            sd[f"{k}.1.bias"] = np.zeros(c, np.float32)
            sd[f"{k}.1.running_mean"] = np.zeros(c, np.float32)
            sd[f"{k}.1.running_var"] = np.full(
                c, np.float32(1.0) - np.float32(1e-5), np.float32)
    return sd


@pytest.mark.parametrize("fusion", ["sweep_cat", "with_time"])
def test_ov_sweep_train_step_matches_jax(fusion):
    """One multimodal OV train step with two sweeps (two 64x64 images a
    scene, ``sweep_times``), ri 2, B=1, against ``make_train_step``: the
    losses within rtol 1e-4, the gradients as
    ``test_torch_port_ov_train.py``'s (the ResNet by the L2 norm), the
    sweep conv's gradient non-zero."""
    from uni3detr_tpu.train import step as jstep
    from uni3detr_tpu.train.torch_import import import_torch_state_dict_ov
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.synthetic import ov_train_batch
    from uni3detr_tpu_torch.train import step as tstep
    from test_torch_import_ov import _bn, _conv3, make_ov_state_dict
    from test_torch_port_ov_train import BASE, pinned, port_model, tcfg
    cfg = dataclasses.replace(BASE, num_sweeps=2, sweep_fusion=fusion)
    rng = np.random.RandomState(40)
    sd = make_ov_state_dict(BASE, rng)
    for k in sd:
        if k.startswith("img_backbone.") and k.endswith("bn3.weight"):
            sd[k] = sd[k] * np.float32(0.1)
    C = cfg.embed_dim
    name = "trans_conv" if fusion == "sweep_cat" else "time_conv"
    _conv3(sd, rng, f"view_trans.{name}.0", C,
           2 * C if fusion == "sweep_cat" else C + 1, 1, 1, 1)
    _bn(sd, rng, f"view_trans.{name}.1", C)
    v = import_torch_state_dict_ov(sd, cfg)
    t = dataclasses.replace(tcfg(cfg), num_points=2048, max_gt=8)
    batch, _ = ov_train_batch(4, t, 1)
    gt = clustered_train_batch(4, t, 1)
    batch.update({k: gt[k] for k in ("gt_boxes", "gt_labels", "gt_mask")})
    assert batch["images"].shape[1] == 2 and batch["sweep_times"].shape == \
        (1, 2)
    tx = jstep.make_optimizer(1e-3, 0.01)
    step = pinned(jstep.make_train_step(cfg, donate=False).__wrapped__)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"], batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]),
                             constants=v["constants"], tx=tx)
    state, jlogs = step(state, {k: jnp.asarray(a) for k, a in batch.items()},
                        jax.random.PRNGKey(0), jnp.int32(2))
    model = port_model(cfg, v)
    opt = tstep.make_optimizer(model, 1e-3, weight_decay=0.01)
    tlogs = tstep.train_step(model, opt, {k: _t(a) for k, a in
                                          batch.items()}, modality=2)
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)
    conv = getattr(model.view_trans, name)[0]
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
    tsd = {k: a.detach().numpy() for k, a in model.state_dict().items()}
    for n, p in model.named_parameters():
        st = opt.adamw.state.get(p)
        tsd[n] = np.zeros_like(tsd[n]) if st is None \
            else st["exp_avg"].numpy()
    found = [s.mu for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    _grads_close(found[0], import_torch_state_dict_ov(
        _identity_sweep_bn(tsd), cfg)["params"], "img_backbone")
