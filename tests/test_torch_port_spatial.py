"""The port's spatial sharding (``uni3detr_tpu_torch.parallel.spatial``,
the (data, spatial) layout of ``parallel.dist``) against the JAX package
and against the port's own one-process forms, on the CPU.

Ranks run as fresh processes that import no JAX (``parallel.launch.spawn``
of ``tests/torch_spatial_workers.py`` and ``tests/torch_ddp_workers.py``)
over gloo, torch on two threads a rank (one for four ranks), every group
under a timeout:

- ``shard``, ``halo`` and ``gather`` at S = 2 and 4: values, and each
  rank's cotangents routed to the rows' owners (H = S is one row a rank);
  ``divides`` false where H does not divide (the volume stays whole);
- SECOND3D + SECOND3DFPN on H slices against the whole volume in one
  process: the gathered fused volume within 2e-5 (JAX's spatial test,
  ``tests/test_parallel.py``), every gradient within ``_grad_tol``, the
  BN statistics; at the tiny's H = 4 the stride-4 stage (H = 1) runs
  whole, at S = 4 the stride-2 one too;
- the dense encoder at S = 2 against JAX's ``impl="dense"`` on the whole
  batch: the volume (cut in slices, or whole after a stage whose H does
  not divide), the BN statistics and the gradients summed over the ranks;
- one tiny train step at 2 x 1 and at 2 x 2 (data x spatial) against
  JAX's step on the whole global batch (``_run_step(None, ...)``:
  ``state_dict_from_jax`` weights, scipy's matcher, dropout 0): losses at
  rtol 1e-4, gradients within ``_grad_tol``, the updated parameters and
  BN statistics at rtol 1e-4 (atol 1e-6); and against the port's
  one-process step at loss rtol 1e-5, gradient norm rtol 1e-3;
- OV under ``--spatial-shard 2``: its point branch runs whole on each
  rank of the group (no halo, no gather), so two ranks of one group step
  as one process does, bit for bit (ROADMAP Queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.parallel import dist
from uni3detr_tpu_torch.parallel.launch import spawn

import torch_spatial_workers as sw

TIMEOUT = 300
BATCH_SEED = 5      # test_torch_port_ddp.py's: no near-tie in the matching


def _spawn(target, n, S, *args, module="torch_spatial_workers"):
    return spawn(f"{module}:{target}", n, args, device="cpu",
                 threads=2 if n <= 2 else 1, timeout=TIMEOUT, spatial=S)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _grad_tol(mu):
    return 1e-3 * max(np.abs(mu).max(), 1e-5)


# -- shard, halo, gather -----------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4])
def ops_ranks(request):
    S = request.param
    return S, _spawn("ops", S, S)


def _cotangents(seed, shape, S):
    return [np.random.RandomState(seed + 100 * r).randn(*shape).astype(
        np.float32) for r in range(S)]


def test_layout_and_divides(ops_ranks):
    S, ranks = ops_ranks
    assert [r["layout"] for r in ranks] == [(0, s) for s in range(S)]
    assert all(r["divides"] == [True, False] for r in ranks)
    assert dist.spatial_size() == 1 and dist.data_size() == 1


def test_halo_values_and_cotangents(ops_ranks):
    S, ranks = ops_ranks
    for i, (h, before, after) in enumerate(sw.halo_cases(S)):
        x = sw.volume(i, h)
        L = h // S
        padded = np.concatenate([np.zeros_like(x[:, :, :, :before]), x,
                                 np.zeros_like(x[:, :, :, :after])], 3)
        n = before + L + after
        cts = _cotangents(i, x.shape[:3] + (n,) + x.shape[4:], S)
        # each global row's cotangent: the sum of every rank's over the
        # positions that read it
        total = np.zeros_like(padded)
        for s in range(S):
            total[:, :, :, s * L:s * L + n] += cts[s]
        total = total[:, :, :, before:before + h]
        for s, r in enumerate(ranks):
            y, dx = r["halo"][i]
            _close(y, padded[:, :, :, s * L:s * L + n], rtol=0, atol=0,
                   msg=f"case {i} rank {s}")
            want = np.zeros_like(x)
            want[:, :, :, s * L:(s + 1) * L] = \
                total[:, :, :, s * L:(s + 1) * L]
            _close(dx, want, rtol=1e-6, atol=1e-6, msg=f"case {i} rank {s}")


def test_gather_values_and_cotangents(ops_ranks):
    S, ranks = ops_ranks
    x = sw.volume(9, 2 * S)
    L = 2
    cts = _cotangents(9, x.shape, S)
    for s, r in enumerate(ranks):
        z, dx = r["gather"]
        np.testing.assert_array_equal(z, x)
        want = np.zeros_like(x)
        want[:, :, :, s * L:(s + 1) * L] = sum(cts)[:, :, :, s * L:(s + 1) * L]
        _close(dx, want, rtol=1e-6, atol=1e-6, msg=f"rank {s}")


# -- SECOND3D + FPN ------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
def test_second3d_fpn_sharded_matches_whole(S):
    from uni3detr_tpu_torch.models.second3d import SECOND3D, SECOND3DFPN
    from uni3detr_tpu_torch.weights import random_state_dict
    cfg = tpresets.TINY_SYNTHETIC
    mods = torch.nn.ModuleDict({
        "pts_backbone": SECOND3D(cfg.encoder_out_channels,
                                 cfg.backbone_channels, cfg.backbone_layers,
                                 cfg.backbone_strides),
        "pts_neck": SECOND3DFPN(cfg.backbone_channels, cfg.neck_channels,
                                cfg.neck_upsample_strides)})
    sd = random_state_dict(mods, 3)
    rng = np.random.RandomState(4)
    # the tiny encoder's output volume: H = 4
    x = rng.randn(2, cfg.encoder_out_channels, 2, 4, 4).astype(np.float32)
    ct = rng.randn(2, cfg.neck_channels[-1], 2, 4, 4).astype(np.float32)
    whole = sw.second3d_fpn(cfg, sd, x, ct)
    assert not whole["sliced"]
    ranks = _spawn("second3d_fpn", S, S, cfg, sd, x, ct)
    for r in ranks:
        assert r["sliced"]
        _close(r["fused"], whole["fused"], rtol=0, atol=2e-5)
        for k, v in whole["state"].items():
            _close(r["state"][k], v, rtol=1e-4, atol=1e-6, msg=k)
    _close(sum(r["dx"] for r in ranks), whole["dx"], rtol=0,
           atol=_grad_tol(whole["dx"]))
    for k, v in whole["grads"].items():
        _close(sum(r["grads"][k] for r in ranks), v, rtol=0,
               atol=_grad_tol(v), msg=k)


# -- the dense encoder ---------------------------------------------------------

ENC = dict(base_channels=8, output_channels=16,
           encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
           downsample_paddings=((1, 1, 1), (1, 1, 1), (0, 1, 1)))


def _voxels(rng, grid, B, V, n):
    """Clustered voxels of ``grid`` sorted by linear id, invalid rows
    last (test_torch_port_options.py's)."""
    D, H, W = grid
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


@pytest.mark.parametrize("grid", [(16, 32, 24), (16, 24, 24)])
def test_dense_encoder_sharded_matches_jax(grid):
    """H = 32 stays split to the end (4 rows of 8 over 2 ranks); H = 24
    ends at 3 rows, gathered whole before the last strided conv (6 rows
    do not split into stride-2 halves over 2 ranks)."""
    import jax
    import jax.numpy as jnp
    from uni3detr_tpu.models.sparse_encoder import SparseEncoderHD as JEnc
    from uni3detr_tpu.train.torch_import import _import_sparse_encoder, _SD
    from uni3detr_tpu_torch.weights import _Out, _encoder

    rng = np.random.RandomState(20)
    jenc = JEnc(sparse_shape=grid, impl="dense", **ENC)
    f, c, m = _voxels(rng, grid, 1, 64, 40)
    v = jax.jit(jenc.init, static_argnums=4)(
        jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(c),
        jnp.asarray(m), False)
    leaf = lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if
                            jax.tree_util.keystr(path).endswith(
                                ("'var']", "'scale']")) else
                            np.asarray(a) + rng.uniform(-0.1, 0.1, a.shape)
                            ).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(leaf, v)
    cfg = dataclasses.replace(tpresets.TINY_SYNTHETIC,
                              encoder_channels=ENC["encoder_channels"],
                              encoder_out_channels=16)
    o = _Out()
    _encoder(o, cfg, v["params"], v["batch_stats"], "enc")
    sd = {k[4:]: np.asarray(a) for k, a in o.sd.items()}
    voxels = _voxels(rng, grid, 2, 300, 260)
    args = [jnp.asarray(a) for a in voxels]
    shape = jax.eval_shape(lambda *a: jenc.apply(v, *a, False)[0],
                           *args).shape
    wsum = rng.randn(*shape).astype(np.float32)

    def jfn(params):
        (vol, _), upd = jenc.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            True, mutable=["batch_stats"])
        return jnp.sum(vol * wsum), (vol, upd)

    jgrad, (jvol, upd) = jax.jit(jax.grad(jfn, has_aux=True))(v["params"])
    jgrid = shape[1:4]
    kw = dict(in_channels=4, sparse_shape=grid, impl="dense",
              budget_shrink=(1.0, 1.0, 1.0), **ENC)
    ranks = _spawn("dense_encoder", 2, 2, kw, sd, voxels, wsum)
    assert all(tuple(r["grid"]) == tuple(jgrid) for r in ranks)
    sliced = ranks[0]["vol"].shape[2] != jgrid[1]
    assert sliced == (grid[1] == 32)
    vol = np.concatenate([r["vol"] for r in ranks], 2) if sliced \
        else ranks[0]["vol"]
    scale = np.abs(np.asarray(jvol)).max()
    assert scale > 0
    _close(vol, jvol, rtol=0, atol=1e-4 * scale)

    def tree(d):
        return _import_sparse_encoder(
            _SD({f"e.{k}": a for k, a in d.items()}), cfg, "e")

    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    for r in ranks:
        got = flat(tree(r["state"])[1])
        for path, ref in flat(upd["batch_stats"]).items():
            ref = np.asarray(ref)
            _close(got[path], ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                   msg=jax.tree_util.keystr(path))
    grads = dict(ranks[0]["state"])
    grads.update({k: sum(r["grads"][k] for r in ranks)
                  for k in ranks[0]["grads"]})
    got = flat(tree(grads)[0])
    for path, ref in flat(jgrad).items():
        ref = np.asarray(ref)
        _close(got[path], ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
               msg=jax.tree_util.keystr(path))


# -- one tiny train step --------------------------------------------------------

@pytest.fixture(scope="module")
def spatial_steps():
    import jax
    import jax.numpy as jnp
    import uni3detr_tpu.presets as jpresets
    from uni3detr_tpu.train import step as jstep
    from uni3detr_tpu.train.torch_import import import_torch_state_dict
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.weights import state_dict_from_jax
    from test_torch_import import make_state_dict
    import torch_ddp_workers

    cfg = dataclasses.replace(jpresets.TINY_SYNTHETIC, dropout=0.0,
                              matcher="scipy")
    tcfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, dropout=0.0,
                               matcher="scipy")
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)
    batch = clustered_train_batch(BATCH_SEED, tcfg, 8)
    lr = 1e-4
    tx = jstep.make_optimizer(lr)
    # tests/test_parallel.py::_run_step(None, ...): one device, the whole
    # global batch
    state = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    state, jlogs = jstep.make_train_step(cfg, donate=False)(
        state, {k: np.asarray(a) for k, a in batch.items()},
        jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(np.asarray, state)
    sd = state_dict_from_jax(v, cfg)
    one = torch_ddp_workers.train_step(tcfg, sd, batch, lr)
    layouts = {
        (1, 2): _spawn("train_step", 2, 2, tcfg, sd, batch, lr,
                       module="torch_ddp_workers"),
        (2, 2): _spawn("train_step", 4, 2, tcfg, sd, batch, lr,
                       module="torch_ddp_workers")}
    return dict(cfg=cfg, v=v, state=state,
                jlogs={k: float(a) for k, a in jlogs.items()},
                one=one, layouts=layouts)


LAYOUTS = [(1, 2), (2, 2)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_step_losses_match_jax(spatial_steps, layout):
    jlogs = spatial_steps["jlogs"]
    for logs, _, _, _ in spatial_steps["layouts"][layout]:
        assert sorted(logs) == sorted(jlogs)
        for k in jlogs:
            _close(logs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_step_grads_and_updates_match_jax(spatial_steps, layout):
    from test_torch_port_ddp import check_step_against_jax
    check_step_against_jax(spatial_steps["cfg"], spatial_steps["v"],
                           spatial_steps["state"],
                           spatial_steps["layouts"][layout])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_step_matches_one_process(spatial_steps, layout):
    logs1 = spatial_steps["one"][0]
    for logs, _, _, _ in spatial_steps["layouts"][layout]:
        _close(logs["total_loss"], logs1["total_loss"], rtol=1e-5, atol=0)
        _close(logs["grad_norm"], logs1["grad_norm"], rtol=1e-3, atol=0)


# -- OV: the point branch whole in the group ----------------------------------

def test_ov_runs_whole_in_the_spatial_group():
    """Two ranks of one data group (``--spatial-shard 2``) step the OV
    tiny model (mm, ri 2: both branches) exactly as one process: each
    backpropagates half the loss and the sum of the halves is the whole
    gradient, so OV under spatial sharding is data parallelism over the
    groups."""
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    from uni3detr_tpu_torch.synthetic import clustered_train_batch, \
        ov_train_batch
    from uni3detr_tpu_torch.weights import random_state_dict

    cfg = dataclasses.replace(tpresets.OV_TINY_SYNTHETIC, dropout=0.0,
                              matcher="scipy", num_points=2048, max_gt=8)
    batch, _ = ov_train_batch(4, cfg, 2)
    gt = clustered_train_batch(4, cfg, 2)
    batch.update({k: gt[k] for k in ("gt_boxes", "gt_labels", "gt_mask")})
    sd = random_state_dict(OV_Uni3DETR(cfg), 6)
    one = sw.ov_step(cfg, sd, batch, 2, 1e-4)
    ranks = _spawn("ov_step", 2, 2, cfg, sd, batch, 2, 1e-4)
    for logs, state, mu in ranks:
        assert logs == one[0]
        for k in one[1]:
            np.testing.assert_array_equal(state[k], one[1][k], err_msg=k)
        for k in one[2]:
            np.testing.assert_array_equal(mu[k], one[2][k], err_msg=k)
