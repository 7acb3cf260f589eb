"""The port's ``uni3detr_nuscenes`` slice against the JAX package, on the
CPU, at a tiny width.

The tiny config is ``uni3detr_tiny_synthetic`` with the nuScenes
differences: a 10-dim box code with velocity, 5 point features, 10
points per voxel, ``nms_thr`` 0.2, a ``num_thr`` cut and 10 code
weights. Inputs are made with numpy and fed to both packages; weights
come from ``make_state_dict`` through the JAX importer and
``state_dict_from_jax``.

Tolerances (fp32): voxel coords, FPS indices, labels and keep masks
equal; the three output stacks, the decoded boxes (velocity included)
and scores within atol 1e-4 (fp32 sums in another order through ~20
convs and the decoder); the train step's losses within rtol 1e-4 and its
gradients within 1e-3 of each leaf's largest entry, as in
``test_torch_port_train.py``; schedules within 1e-6 relative (optax
evaluates them in fp32), the lr with an absolute floor of 1e-6 of its
peak where fp32 cancels in the cosine's tail; AdamW with a momentum
schedule within 1e-6; a resumed run bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.models.detector import Uni3DETR as JModel
from uni3detr_tpu.ops.fps import farthest_point_sample_xla
from uni3detr_tpu.ops.voxelize import hard_voxelize
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.ops.voxelize import hard_voxelize as tvoxelize
from uni3detr_tpu_torch.synthetic import clustered_train_batch
from uni3detr_tpu_torch.train import checkpoint as tckpt
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import random_state_dict, state_dict_from_jax
from test_torch_import import clustered_cloud, make_state_dict

_NUSCENES_TINY = dict(code_size=10, in_point_features=5,
                      max_points_per_voxel=10, nms_thr=0.2, num_thr=6,
                      code_weights=(1.0,) * 8 + (0.2, 0.2))
JCFG = dataclasses.replace(jpresets.TINY_SYNTHETIC, **_NUSCENES_TINY)
TCFG = dataclasses.replace(tpresets.TINY_SYNTHETIC, **_NUSCENES_TINY)
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _port_model(cfg, v):
    model = TModel(cfg)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, JCFG).items()}, strict=True)
    return model


def _scene(seed):
    """12 jittered points in every occupied cell (the voxelizer keeps the
    first 10 of each, in input order), shuffled, 5 features."""
    rng = np.random.RandomState(seed)
    cells = clustered_cloud(rng, JCFG, n_clusters=8, max_cells=5)[:, :3]
    pts = np.concatenate([cells + (rng.rand(*cells.shape) - 0.5) * 0.1
                          for _ in range(12)])
    pts = np.concatenate([pts, rng.rand(len(pts), 2)], -1).astype(np.float32)
    rng.shuffle(pts)
    mask = np.ones((1, len(pts)), bool)
    mask[0, -9:] = False
    rnd = rng.rand(1, JCFG.num_query, 3).astype(np.float32)
    return pts[None], mask, rnd


def test_tiny_nuscenes_config_equal():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)


# -- the slice: points -> boxes ---------------------------------------------

@pytest.fixture(scope="module")
def runs():
    v = import_torch_state_dict(
        make_state_dict(JCFG, np.random.RandomState(3)), JCFG)
    model = _port_model(TCFG, v).eval()
    out = []
    for seed in (0, 1):
        pts, mask, rnd = _scene(seed)
        jout = JModel(JCFG).apply(v, jnp.asarray(pts), jnp.asarray(mask),
                                  train=False, random_points=jnp.asarray(rnd))
        tout, inter = model(_t(pts), _t(mask), _t(rnd),
                            return_intermediates=True)
        out.append(((pts, mask), jout, tout, inter))
    return out


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_nuscenes_outputs_match_jax(runs, scene):
    _, jout, tout, _ = runs[scene]
    L, nq = JCFG.num_decoder_layers, 4 * JCFG.num_query
    assert tuple(tout["all_bbox_preds"].shape) == (L, 1, nq, 10)
    for k in ("all_cls_scores", "all_bbox_preds", "all_iou_preds"):
        assert tout[k].shape == jout[k].shape
        _close(tout[k], jout[k], rtol=0, atol=ATOL, msg=k)


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_nuscenes_voxels_and_fps_match_jax(runs, scene):
    (pts, mask), _, _, inter = runs[scene]
    feats, coords, vmask = hard_voxelize(
        jnp.asarray(pts), jnp.asarray(mask), pc_range=JCFG.pc_range,
        voxel_size=JCFG.voxel_size, grid_size=JCFG.grid_size,
        max_points=JCFG.max_points_per_voxel,
        max_voxels=JCFG.max_voxels_test)
    np.testing.assert_array_equal(inter["vmask"].numpy(), np.asarray(vmask))
    np.testing.assert_array_equal(inter["coords"].numpy(), np.asarray(coords))
    assert inter["feats"].shape[-1] == 5
    # mean VFE: differences of prefix sums, as test_torch_port_modules
    _close(inter["feats"], feats, rtol=0, atol=1e-5)
    vc = jnp.where(vmask[..., None], coords[..., ::-1].astype(jnp.float32),
                   0.0)
    idx1 = farthest_point_sample_xla(jnp.asarray(pts[..., :3]),
                                     jnp.asarray(mask), JCFG.num_query)
    idx2 = farthest_point_sample_xla(vc, vmask, JCFG.num_query)
    np.testing.assert_array_equal(inter["fps_idx"][0].numpy(), idx1)
    np.testing.assert_array_equal(inter["fps_idx"][1].numpy(), idx2)


@pytest.mark.parametrize("scene", [0, 1])
def test_tiny_nuscenes_boxes_match_jax(runs, scene):
    """Decode + per-class NMS + the num_thr cut; the velocity columns
    pass through decode, the bottom-z shift and NMS."""
    _, jout, tout, _ = runs[scene]
    jb, js, jl, jv = map(np.asarray, jcoder.post_process(
        *jcoder.decode_predictions(jout, JCFG), JCFG))
    tb, ts, tl, tv = tcoder.post_process(
        *tcoder.decode_predictions(tout, TCFG), TCFG)
    assert tb.shape[-1] == 9
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), jl)
    _close(ts, js, rtol=0, atol=ATOL)
    _close(tb.numpy()[jv], jb[jv], rtol=0, atol=ATOL)
    _close(tb.numpy()[jv][:, 7:9], jb[jv][:, 7:9], rtol=0, atol=ATOL)
    # the count cut binds: without it more boxes survive NMS
    free = tcoder.post_process(*tcoder.decode_predictions(tout, TCFG),
                               dataclasses.replace(TCFG, num_thr=None))[3]
    assert 0 < tv.sum() == JCFG.num_thr < free.sum()


@pytest.mark.parametrize("thr", [
    dict(score_thr=0.4),
    dict(score_thr=(0.2, 0.5, 0.35)),
    dict(num_thr=5),
    dict(score_thr=(0.2, 0.5, 0.35), num_thr=4)])
def test_post_process_thresholds_match_jax(thr):
    """Scalar and per-class score thresholds (strictly above) and the
    num_thr rank cut, on scores full of ties (multiples of 0.05): the
    cut keeps the lower index among equal scores, as jnp.argsort."""
    thr = {"num_thr": None, **thr}
    jcfg = dataclasses.replace(JCFG, **thr)
    tcfg = dataclasses.replace(TCFG, **thr)
    rng = np.random.RandomState(9)
    B, K = 2, 40
    boxes = np.concatenate([
        rng.uniform(-1.5, 1.5, (B, K, 3)), rng.uniform(0.2, 0.8, (B, K, 3)),
        rng.uniform(-np.pi, np.pi, (B, K, 1)),
        rng.uniform(-2, 2, (B, K, 2))], -1).astype(np.float32)
    scores = (rng.randint(0, 20, (B, K)) * 0.05).astype(np.float32)
    labels = rng.randint(0, 3, (B, K)).astype(np.int32)
    valid = rng.rand(B, K) > 0.15
    ref = [np.asarray(a) for a in jcoder.post_process(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid), jcfg)]
    got = tcoder.post_process(_t(boxes), _t(scores), _t(labels), _t(valid),
                              tcfg)
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    _close(got[0], ref[0], rtol=0, atol=1e-6)
    _close(got[1], ref[1], rtol=0, atol=0)
    if thr["num_thr"]:
        assert (got[3].sum(-1) == thr["num_thr"]).all()


def _cell_edge_points(cfg, n=48, seed=0):
    """Points whose cell on an axis differs between a division by the
    fp32 cell size and a product with its fp32 reciprocal (uniform on an
    axis that has no such coordinates)."""
    rng = np.random.RandomState(seed)
    cols = []
    for ax in range(3):
        lo, hi = cfg.pc_range[ax], cfg.pc_range[ax + 3]
        vs = np.float32(cfg.voxel_size[ax])
        x = rng.uniform(lo, hi, 2_000_000).astype(np.float32)
        d = x - np.float32(lo)
        edge = x[np.floor(d / vs) != np.floor(d * (np.float32(1) / vs))]
        cols.append(rng.choice(edge if len(edge) else x, n))
    extra = rng.rand(n, cfg.in_point_features - 3)
    return np.concatenate([np.stack(cols, -1), extra], -1).astype(
        np.float32)[None]


def test_voxelize_cell_edges_match_jax():
    """At the nuScenes cell sizes (0.075, 0.075, 0.2) the JAX voxelizer
    puts a point within an ulp of a cell edge where XLA's product with
    the fp32 reciprocal of the cell size puts it, not where a division
    would (a Queue 3 fault of the port, fixed in ops/voxelize.py)."""
    cfg = tpresets.NUSCENES
    pts = _cell_edge_points(cfg)
    mask = np.ones(pts.shape[:2], bool)
    kw = dict(pc_range=cfg.pc_range, voxel_size=cfg.voxel_size,
              grid_size=cfg.grid_size, max_points=cfg.max_points_per_voxel,
              max_voxels=64)
    jf, jc, jm = hard_voxelize(jnp.asarray(pts), jnp.asarray(mask), **kw)
    tf, tc, tm = tvoxelize(_t(pts), _t(mask), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # coordinates up to 54 m: a few fp32 ulps of the prefix sums
    _close(tf, jf, rtol=1e-6, atol=1e-5)
    assert int(tm.sum()) > 40


def test_weights_round_trip_at_code_size_10():
    v = import_torch_state_dict(
        make_state_dict(JCFG, np.random.RandomState(4)), JCFG)
    model = _port_model(TCFG, v)
    sd = model.state_dict()
    assert tuple(sd["pts_bbox_head.reg_branches.0.4.weight"].shape) == (
        10, JCFG.embed_dim)
    assert sd["pts_middle_encoder.conv_input.0.weight"].shape[3] == 5
    back = import_torch_state_dict(sd, JCFG)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    # seeded random weights load into the same layout
    TModel(TCFG).load_state_dict(
        {k: torch.from_numpy(a) for k, a in
         random_state_dict(model, 0).items()}, strict=True)


# -- training with velocity ground truth ---------------------------------------

@pytest.fixture(scope="module")
def tiny_steps():
    cfg = dataclasses.replace(JCFG, dropout=0.0, matcher="scipy")
    tcfg = dataclasses.replace(TCFG, dropout=0.0, matcher="scipy")
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)
    batch = clustered_train_batch(3, tcfg, 2)
    assert batch["gt_boxes"].shape[-1] == 9
    assert np.abs(batch["gt_boxes"][batch["gt_mask"]][:, 7:]).max() > 0.5
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


def test_tiny_nuscenes_train_step_losses_match_jax(tiny_steps):
    _, _, jlogs, _, _, tlogs = tiny_steps
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _close(tlogs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)
    assert np.isfinite(float(tlogs["total_loss"]))


def test_tiny_nuscenes_train_step_grads_match_jax(tiny_steps):
    """Gradients read from the first moments (0.1 x the clipped
    gradient on both sides), the velocity rows of the reg branches
    included."""
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
        assert err <= 1e-3 * max(np.abs(ref).max(), 1e-5), (
            jax.tree_util.keystr(path), err)
    vel = np.asarray(opt.adamw.state[
        model.pts_bbox_head.reg_branches[-1][-1].weight]["exp_avg"])[8:]
    assert np.abs(vel).max() > 0


# -- schedules, optimizer and checkpoints --------------------------------------

@pytest.mark.parametrize("total", [10, 37, 200])
def test_cyclic_schedules_match_optax(total):
    """The nuScenes lr_config / momentum_config (uni3detr_nuscenes.py:
    cyclic, target ratios (10, 1e-4) and (0.85/0.95, 1), up ratio 0.4),
    past the end of the run too."""
    base_lr = 2e-5
    jl = jstep.cyclic_lr_schedule(base_lr, total, (10, 1e-4), 0.4)
    tl = tstep.cyclic_lr_schedule(base_lr, total, (10, 1e-4), 0.4)
    jm = jstep.cyclic_momentum_schedule(0.95, total, (0.85 / 0.95, 1.0), 0.4)
    tm = tstep.cyclic_momentum_schedule(0.95, total, (0.85 / 0.95, 1.0), 0.4)
    for step in range(total + 3):
        _close(tl(step), float(jl(step)), rtol=1e-6, atol=1e-6 * base_lr * 10,
               msg=f"lr {step}")
        _close(tm(step), float(jm(step)), rtol=1e-6, atol=0,
               msg=f"momentum {step}")
    assert tl(int(total * 0.4)) == pytest.approx(base_lr * 10)
    assert tm(int(total * 0.4)) == pytest.approx(0.85)


def test_adamw_momentum_schedule_matches_inject_hyperparams():
    """Three clipped AdamW steps whose lr and beta1 change every step,
    against optax ``inject_hyperparams(adamw)``."""
    rng = np.random.RandomState(10)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * sc).astype(np.float32) for s in shapes]
             for sc in (0.5, 30.0, 2.0)]
    args = (1e-3, 5)
    tx = jstep.make_optimizer(
        jstep.cyclic_lr_schedule(*args),
        momentum_schedule=jstep.cyclic_momentum_schedule(0.95, 5))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = tstep.Optimizer(tp, tstep.cyclic_lr_schedule(*args),
                          momentum_schedule=tstep.cyclic_momentum_schedule(
                              0.95, 5))
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x)
        opt.step()
    assert opt.adamw.param_groups[0]["betas"][0] == pytest.approx(
        float(jstep.cyclic_momentum_schedule(0.95, 5)(2)))
    for a, b in zip(tp, jp):
        _close(a.detach(), b, rtol=0, atol=1e-6)


def _train_setup(cfg, sd, steps):
    model = TModel(cfg)
    model.load_state_dict(sd, strict=True)
    opt = tstep.make_optimizer(
        model, tstep.cyclic_lr_schedule(1e-3, steps),
        momentum_schedule=tstep.cyclic_momentum_schedule(0.95, steps))
    return model, opt


def test_checkpoint_round_trip(tmp_path):
    """Two steps, save, load into a fresh model and optimizer: every
    tensor and the step equal, and step 3 (dropout seeded alike) gives
    the uninterrupted run's losses and weights bit for bit."""
    sd = {k: torch.from_numpy(a) for k, a in
          random_state_dict(TModel(TCFG), 5).items()}
    batch = {k: _t(a) for k, a in clustered_train_batch(6, TCFG, 2).items()}
    model, opt = _train_setup(TCFG, sd, 6)
    for _ in range(2):
        tstep.train_step(model, opt, batch)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), model, opt,
                          meta={"config": TCFG, "classes": ["a", "b", "c"]})
    tree, meta = tckpt.load_checkpoint(str(tmp_path / "ckpt"))
    assert tree["step"] == 2 and meta["classes"] == ["a", "b", "c"]
    fresh, fopt = _train_setup(TCFG, sd, 6)
    tckpt.restore(fresh, tree, fopt)
    assert fopt.steps == opt.steps == 2
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(opt.params, fopt.params):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.adamw.state[p][key],
                               fopt.adamw.state[q][key])
    logs = []
    for m, o in ((model, opt), (fresh, fopt)):
        torch.manual_seed(11)
        logs.append(tstep.train_step(m, o, batch))
    for k in logs[0]:
        assert torch.equal(logs[0][k], logs[1][k]), k
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    # eval restores the model alone
    only = TModel(TCFG)
    tckpt.restore(only, tree)
    for (k, a), b in zip(only.state_dict().items(), tree["model"].values()):
        assert torch.equal(a, b), k
