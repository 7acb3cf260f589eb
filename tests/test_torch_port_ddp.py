"""The port's data parallelism (``uni3detr_tpu_torch.parallel``) against
the JAX package's sharded programs, on the CPU.

Ranks run as fresh processes that import no JAX
(``parallel.launch.spawn`` of ``tests/torch_ddp_workers.py``), two of
them over gloo with a ``file://`` rendezvous in a temporary directory,
torch on two threads each, every group under a timeout. What each rank
computes is held against the JAX function on the whole global batch,
which is what JAX's one jit over the sharded batch computes:

- ``local_slice``; ``gather_objects`` under the collective and the
  shared-directory transports; ``_DatasetShard``;
- ``MaskedBatchNorm`` and ``BatchNorm3d`` in train mode over 2 ranks with
  unequal valid counts: outputs, running statistics and input gradients
  within rtol 1e-5 (atol 1e-6) of JAX's layer on the global batch, the
  parameter gradients summed over the ranks likewise, inside
  ``dist.sharded_batch()``; outside it each rank's BN equals a
  one-process BN on its own slice;
- one tiny train step (2 ranks x 4 scenes, fp32, dropout 0, scipy's
  matcher, the weights of ``state_dict_from_jax``) against JAX's step
  over ``make_mesh(2)`` built as ``tests/test_parallel.py::_run_step``
  builds it: losses within rtol 1e-4, gradients (AdamW's first moments)
  within ``_grad_tol`` and the updated parameters and BN statistics
  within rtol 1e-4 (atol 1e-6), with ``test_torch_port_train.py``'s
  rule for entries whose gradient is near zero; and against the port's
  one-process step at 8 scenes within JAX's DP tolerances (loss rtol
  1e-5, gradient norm rtol 1e-3); both ranks hold the same weights after;
- ``run_inference_distributed`` over 2n + 1 scenes with random points
  keyed by scene, equal to ``run_inference``'s detections bit for bit at
  batch 1 and within ATOL at batch 2 (other batch companions);
- ``cli.train`` with a resume and ``cli.test --num-processes 2 --device
  cpu`` end to end: rank 0 alone writes checkpoints, metrics and the
  pkl, rank 1 its ``train.rank1.log``; the gathered GT in dataset order;
- ``graft_entry.entry(device="cpu")`` against JAX's ``entry()`` on the
  same zero weights (both at the tiny preset); ``dryrun_multichip(2,
  device="cpu")`` in the (1, 2) layout and its (2, 2) on four ranks;
  ``cli.train --spatial-shard 2`` on two ranks
  (``tests/torch_spatial_workers.py``; the parity of the spatially
  sharded step is ``test_torch_port_spatial.py``'s).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from uni3detr_tpu_torch import graft_entry
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.cli import test as cli_test
from uni3detr_tpu_torch.cli import train as cli_train
from uni3detr_tpu_torch.parallel import dist
from uni3detr_tpu_torch.parallel.launch import spawn
from uni3detr_tpu_torch.train import evaluator as tevaluator

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "..", "configs/uni3detr/uni3detr_synthetic_tiny.py")
TIMEOUT = 300
ATOL = 1e-5
# The train step's batch. At seeds 3 and 4 the 8 scenes hold a near-tie
# of the layer-0 matching: a 1e-7 relative nudge of the points swaps two
# queries between two GT boxes (seed 3: scene 7, queries 25 and 31), and
# JAX's own one- and two-device steps differ there beyond rtol 1e-4 in
# d0.loss_cls, as the port's one- and two-rank steps do. Seed 5 holds no
# such tie: JAX's two programs agree on it within the tolerances here.
BATCH_SEED = 5


def _spawn(target, *args, **kw):
    return spawn(f"torch_ddp_workers:{target}", 2, args, kw, device="cpu",
                 threads=2, timeout=TIMEOUT)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """torch on two threads: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- helpers and BatchNorm ---------------------------------------------------

@pytest.fixture(scope="module")
def bn_case(tmp_path_factory):
    rng = np.random.RandomState(0)
    B, V, C = 4, 40, 6
    x = (rng.randn(B, V, C) * 2 + 1).astype(np.float32)
    # rank 0's rows mostly invalid, rank 1's mostly valid
    mask = rng.rand(B, V) < np.array([0.2, 0.3, 0.8, 0.9])[:, None]
    stats = lambda: {"mean": rng.randn(C).astype(np.float32),
                     "var": rng.rand(C).astype(np.float32) + 0.5}
    params = lambda: {"scale": rng.rand(C).astype(np.float32) + 0.5,
                      "bias": rng.randn(C).astype(np.float32)}
    masked = (x, mask, params(), stats(),
              rng.randn(B, V, C).astype(np.float32))
    xd = (rng.randn(4, C, 2, 3, 5) * 3 - 1).astype(np.float32)
    dense = (xd, params(), stats(), rng.randn(*xd.shape).astype(np.float32))
    tmp = tmp_path_factory.mktemp("gather")
    ranks = _spawn("basics", masked, dense, str(tmp))
    return masked, dense, ranks


def test_local_slice(bn_case):
    ranks = bn_case[2]
    assert dist.local_slice(6) == slice(0, 6)        # no process group
    assert [r["slice"] for r in ranks] == [slice(0, 4), slice(4, 8)]
    assert all("must divide" in r["odd"] for r in ranks)


@pytest.mark.parametrize("transport", ["collective", "file"])
def test_gather_objects(bn_case, transport):
    ranks = bn_case[2]
    if transport == "collective":
        got = ranks[0]["gather"]
        assert [g["rank"] for g in got] == [0, 1]
        np.testing.assert_array_equal(got[1]["arr"], np.arange(4))
        assert ranks[1]["gather"] is None
    else:
        assert ranks[0]["gather_file"] == [[0], [1, 1]]
        assert ranks[1]["gather_file"] is None
        assert ranks[0]["left"] == []     # rank 0 removed every part
    assert dist.gather_objects("x") == ["x"]          # no process group


def test_dataset_shard():
    shard = tevaluator._DatasetShard(list("abcdefg"), range(1, 7, 2))
    assert len(shard) == 3 and [shard[i] for i in range(3)] == list("bdf")


def _jax_bn(module, x, p, s, ct, *extra):
    import jax
    import jax.numpy as jnp

    def f(xx, pp):
        y, upd = module.apply({"params": pp, "batch_stats": s}, xx, *extra,
                              mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (y, upd)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    return dict(y=y, dx=dx, mean=upd["mean"], var=upd["var"],
                dscale=dp["scale"], dbias=dp["bias"])


def _check_bn(ranks, key, ref, axis):
    for k in ("y", "dx"):
        got = np.concatenate([r[key][k] for r in ranks], axis=0)
        _close(got, np.moveaxis(np.asarray(ref[k]), -1, axis)
               if axis != -1 else ref[k], msg=f"{key} {k}")
    for k in ("mean", "var"):
        for r in ranks:
            _close(r[key][k], ref[k], msg=f"{key} {k}")
    for k in ("dscale", "dbias"):
        _close(sum(r[key][k] for r in ranks), ref[k], rtol=1e-5, atol=1e-5,
               msg=f"{key} {k}")


def test_masked_batchnorm_global_statistics(bn_case):
    from uni3detr_tpu.models.layers import MaskedBatchNorm as JMaskedBN
    (x, mask, p, s, ct), _, ranks = bn_case
    # the ranks' valid counts differ
    assert mask[:2].sum() < mask[2:].sum() / 2
    ref = _jax_bn(JMaskedBN(), x, p, s, ct, mask, True)
    _check_bn(ranks, "masked", ref, -1)


def test_batchnorm3d_global_statistics(bn_case):
    from flax import linen as nn
    _, (x, p, s, ct), ranks = bn_case
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                      epsilon=1e-3)
    # flax normalizes the last axis: channels-last copies of the inputs
    ref = _jax_bn(bn, np.moveaxis(x, 1, -1), p, s, np.moveaxis(ct, 1, -1))
    _check_bn(ranks, "dense", ref, 1)


@pytest.mark.parametrize("key", ["masked", "dense"])
def test_batchnorm_outside_the_step_is_rank_local(bn_case, key):
    """Under the process group but outside ``dist.sharded_batch()`` a
    train-mode BN makes no collective: each rank's is a one-process BN on
    its own slice."""
    from uni3detr_tpu_torch.models.layers import MaskedBatchNorm
    from uni3detr_tpu_torch.models.second3d import BatchNorm3d
    from torch_ddp_workers import _bn_state, _np
    masked, dense, ranks = bn_case
    if key == "masked":
        (x, mask, p, s, ct), extra = masked, (masked[1],)
        make = lambda: MaskedBatchNorm(x.shape[-1])
    else:
        (x, p, s, ct), extra = dense, ()
        make = lambda: BatchNorm3d(x.shape[1])
    half = x.shape[0] // 2
    for r, sl in enumerate((slice(0, half), slice(half, None))):
        bn = _bn_state(make(), p, s)
        xt = torch.from_numpy(x[sl]).requires_grad_()
        y = bn(xt, *(torch.from_numpy(e[sl]) for e in extra))
        (y * torch.from_numpy(ct[sl])).sum().backward()
        want = dict(y=_np(y), dx=_np(xt.grad), mean=_np(bn.running_mean),
                    var=_np(bn.running_var), dscale=_np(bn.weight.grad),
                    dbias=_np(bn.bias.grad))
        for k, v in want.items():
            _close(ranks[r][f"{key}_local"][k], v, msg=f"rank {r} {k}")


# -- one tiny train step -----------------------------------------------------

def _grad_tol(mu):
    return 1e-3 * max(np.abs(mu).max(), 1e-5)


@pytest.fixture(scope="module")
def dp_steps():
    import dataclasses
    import jax
    import jax.numpy as jnp
    import uni3detr_tpu.presets as jpresets
    from uni3detr_tpu.parallel.mesh import (make_mesh, replicate,
                                            set_active_mesh, shard_batch)
    from uni3detr_tpu.train import step as jstep
    from uni3detr_tpu.train.torch_import import import_torch_state_dict
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.weights import state_dict_from_jax
    from test_torch_import import make_state_dict

    cfg = dataclasses.replace(jpresets.TINY_SYNTHETIC, dropout=0.0,
                              matcher="scipy")
    tcfg = dataclasses.replace(tpresets.TINY_SYNTHETIC, dropout=0.0,
                               matcher="scipy")
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(8)), cfg)
    batch = clustered_train_batch(BATCH_SEED, tcfg, 8)
    lr = 1e-4
    tx = jstep.make_optimizer(lr)
    mesh = make_mesh(2, spatial=1)
    set_active_mesh(mesh)
    try:
        state = jstep.TrainState(
            step=jnp.zeros((), jnp.int32),
            params=replicate(v["params"], mesh),
            batch_stats=replicate(v["batch_stats"], mesh),
            opt_state=replicate(tx.init(v["params"]), mesh), tx=tx)
        state, jlogs = jstep.make_train_step(cfg, donate=False)(
            state, shard_batch({k: np.asarray(a) for k, a in batch.items()},
                               mesh), jax.random.PRNGKey(0))
        state = jax.tree_util.tree_map(np.asarray, state)
        jlogs = {k: float(a) for k, a in jlogs.items()}
    finally:
        set_active_mesh(None)
    sd = state_dict_from_jax(v, cfg)
    ranks = _spawn("train_step", tcfg, sd, batch, lr)
    import torch_ddp_workers
    one = torch_ddp_workers.train_step(tcfg, sd, batch, lr)
    return dict(cfg=cfg, v=v, state=state, jlogs=jlogs, ranks=ranks,
                one=one)


def test_dp_step_losses_match_jax_mesh(dp_steps):
    jlogs = dp_steps["jlogs"]
    for logs, _, _, _ in dp_steps["ranks"]:
        assert sorted(logs) == sorted(jlogs)
        for k in jlogs:
            _close(logs[k], jlogs[k], rtol=1e-4, atol=0, msg=k)


def _torch_tree(cfg, sd, mu=None):
    from uni3detr_tpu.train.torch_import import import_torch_state_dict
    sd = {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()}
    if mu is not None:
        sd.update({k: torch.from_numpy(a) for k, a in mu.items()})
    return import_torch_state_dict(sd, cfg)


def test_dp_step_grads_and_updates_match_jax_mesh(dp_steps):
    check_step_against_jax(dp_steps["cfg"], dp_steps["v"], dp_steps["state"],
                           dp_steps["ranks"])


def check_step_against_jax(cfg, v, state, ranks, lr=1e-4):
    """The ranks' ``torch_ddp_workers.train_step`` results against JAX's
    updated ``state`` from the variables ``v``: every rank's weights
    equal, the BN statistics and updated parameters within rtol 1e-4
    (atol 1e-6), the gradients (AdamW's first moments) within
    ``_grad_tol``."""
    import jax
    _, sd0, mu0, _ = ranks[0]
    for _, sd, mu, _ in ranks[1:]:     # the ranks agree
        for k in sd:
            np.testing.assert_array_equal(sd[k], sd0[k], err_msg=k)
    back = _torch_tree(cfg, sd0)
    jax.tree_util.tree_map(lambda a, b: _close(a, b, rtol=1e-4, atol=1e-6),
                           back["batch_stats"], state.batch_stats)
    tmu = _torch_tree(cfg, sd0, mu0)["params"]
    leaves = [dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in
              (back["params"], state.params, v["params"],
               state.opt_state[1][0].mu, tmu)]
    n_free = n_all = 0
    for path in leaves[0]:
        got, ref, init, mu, mu_t = (np.asarray(t[path]) for t in leaves)
        key = jax.tree_util.keystr(path)
        assert np.abs(mu_t - mu).max() <= _grad_tol(mu), key
        # as test_torch_port_train.py: an entry whose gradient is so near
        # zero that the two differ by > 0.5% of it may take Adam's first
        # step either way; both are held to one step there
        free = np.abs(mu_t - mu) > 0.005 * (np.abs(mu) + 1e-9)
        n_free += int(free.sum())
        n_all += free.size
        _close(got[~free], ref[~free], rtol=1e-4, atol=1e-6, msg=key)
        for a in (got, ref):
            assert np.all(np.abs(a - init)[free] <= 1.1 * lr + 1e-7), key
    assert n_free <= 0.01 * n_all, (n_free, n_all)


def test_dp_step_matches_one_process(dp_steps):
    logs1 = dp_steps["one"][0]
    for logs, _, _, _ in dp_steps["ranks"]:
        _close(logs["total_loss"], logs1["total_loss"], rtol=1e-5, atol=0)
        _close(logs["grad_norm"], logs1["grad_norm"], rtol=1e-3, atol=0)


# -- distributed evaluation --------------------------------------------------

def test_run_inference_distributed_matches_run_inference():
    import torch_ddp_workers as w
    from uni3detr_tpu_torch import config_file
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.weights import random_state_dict

    cfg = config_file.load_config(TINY)
    mc = config_file.build_model_config(cfg)
    model = Uni3DETR(mc).eval()
    sd = random_state_dict(model, 3)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()})
    ds = build_dataset(cfg.data, cfg.class_names, mc.pc_range, "val")
    n = 5                                   # 2 x 2 + 1: an unequal tail
    ranks = _spawn("inference", sd, n, (1, 2))
    assert ranks[1] == {1: ([], []), 2: ([], [])}
    for bs in (1, 2):
        def rp(k, a):
            scenes = list(range(k * bs, min((k + 1) * bs, n)))
            return w.scene_points(scenes + [scenes[-1]] * (bs - len(scenes)),
                                  a)
        ref_d, ref_g = tevaluator.run_inference(
            ds, model, mc, device="cpu", batch_size=bs, max_samples=n,
            random_points=rp)
        got_d, got_g = ranks[0][bs]
        assert len(got_d) == len(got_g) == n
        for i, (g, e) in enumerate(zip(got_d, ref_d)):
            np.testing.assert_array_equal(g["labels"], e["labels"])
            if bs == 1:                     # the same batches: bit for bit
                for k in e:
                    np.testing.assert_array_equal(g[k], e[k], err_msg=i)
            else:
                for k in ("boxes", "scores"):
                    _close(g[k], e[k], rtol=0, atol=ATOL, msg=f"{i} {k}")
        for g, e in zip(got_g, ref_g):
            for k in e:
                np.testing.assert_array_equal(g[k], e[k])


# -- the CLIs, the graft entry -----------------------------------------------

def test_clis_on_two_ranks(tmp_path):
    wd = str(tmp_path / "wd")
    ranks = spawn("torch_ddp_workers:clis", 2,
                  (wd, f"file://{tmp_path / 'rendezvous'}"), device="cpu",
                  init=False, threads=2, timeout=TIMEOUT)
    (f0, r0, t0), (f1, r1, t1) = ranks
    assert (f0["rank"], f1["rank"], f0["world_size"]) == (0, 1, 2)
    # 8 scenes at a global batch of 2 x 2: 2 steps an epoch
    assert (f0["step"], f0["epoch"], r0["step"], r0["epoch"]) == (3, 1, 4, 2)
    assert set(f0["evals"]) == {1} and set(r0["evals"]) == {2}
    assert f1["evals"] == r1["evals"] == {}
    assert "mAP_0.25" in r0["evals"][2]
    files = set(os.listdir(wd))
    assert {"epoch_1", "epoch_2", "latest", "train.log", "train.rank1.log",
            "dets.pkl"} <= files, files
    with open(os.path.join(wd, "train.log")) as f:
        text = f.read()
    assert "eval epoch 1 | " in text and "resumed from" in text
    with open(os.path.join(wd, "train.rank1.log")) as f:
        assert "| total" not in f.read()     # warnings only
    # cli.test: rank 0 alone holds and writes the gathered detections
    assert t1["dets"] == [] and t1["metrics"] == {}
    assert len(t0["dets"]) == 5 and "mAP_0.25" in t0["metrics"]
    with open(os.path.join(wd, "dets.pkl"), "rb") as f:
        dets = pickle.load(f)
    for d, e in zip(dets, t0["dets"]):
        np.testing.assert_array_equal(d["boxes"], e["boxes"])
    # every scene once, in dataset order: the GT of a one-process run
    plain = cli_test.main([TINY, os.path.join(wd, "latest"), "--eval",
                           "bbox", "--max-samples", "5", "--device", "cpu"])
    for g, e in zip(t0["gts"], plain["gts"]):
        for k in e:
            np.testing.assert_array_equal(g[k], e[k])


def test_graft_entry_matches_jax_entry(monkeypatch):
    import jax
    import __graft_entry__
    import uni3detr_tpu.presets as jpresets

    monkeypatch.setattr(jpresets, "SUNRGBD", jpresets.TINY_SYNTHETIC)
    fn, args = __graft_entry__.entry()
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))
    tfn, targs = graft_entry.entry(device="cpu",
                                   cfg=tpresets.TINY_SYNTHETIC)
    assert all(a.device.type == "cpu" for a in targs)
    with torch.no_grad():
        got = tfn(*targs)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k], rtol=0, atol=1e-5, msg=k)


def test_dryrun_multichip_on_cpu():
    """Two ranks in the JAX dry run's (1, 2) layout: 2 scenes, the
    volume split along H, the eval over 3."""
    res = graft_entry.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    assert [r["layout"] for r in res] == [(1, 2)] * 2
    assert res[0]["n_eval"] == 3 and res[1]["n_eval"] == 0
    assert res[0]["loss"] == res[1]["loss"] and np.isfinite(res[0]["loss"])


def test_dryrun_multichip_four_ranks_on_cpu():
    """Four ranks in the (2, 2) layout: 4 scenes, the eval over 5."""
    res = spawn("uni3detr_tpu_torch.graft_entry:_dryrun_rank", 4,
                kwargs={"device": "cpu"}, device="cpu", threads=1,
                timeout=TIMEOUT, spatial=2)
    assert graft_entry.dryrun_layout(4) == (2, 2)
    assert [r["layout"] for r in res] == [(2, 2)] * 4
    assert [r["n_eval"] for r in res] == [5, 0, 0, 0]
    assert len({r["loss"] for r in res}) == 1 and np.isfinite(res[0]["loss"])


def test_spatial_shard_still_raises(tmp_path):
    """``cli.train --spatial-shard 2 --num-processes 2 --device cpu`` end
    to end (what once raised): 3 steps with an eval after the first
    epoch, the two ranks of the group on the same batches and with equal
    weights after, rank 0's checkpoint holding them, its log the layout."""
    from uni3detr_tpu_torch.train.checkpoint import load_checkpoint
    wd = str(tmp_path / "wd")
    ranks = spawn("torch_spatial_workers:cli_spatial", 2,
                  (wd, f"file://{tmp_path / 'rendezvous'}"), device="cpu",
                  init=False, threads=2, timeout=TIMEOUT)
    (r0, sd0, b0), (r1, sd1, b1) = ranks
    assert (r0["rank"], r1["rank"], r0["world_size"]) == (0, 1, 2)
    assert r0["step"] == r1["step"] == 3
    assert set(r0["evals"]) == {1} and r1["evals"] == {}
    assert len(b0) == len(b1) == 3
    for x, y in zip(b0, b1):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    ckpt = load_checkpoint(os.path.join(wd, "latest"))[0]["model"]
    for k in sd0:
        np.testing.assert_array_equal(sd1[k], sd0[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(ckpt[k]), sd0[k], err_msg=k)
    with open(os.path.join(wd, "train.log")) as f:
        text = f.read()
    assert "2 processes (1 data x 2 spatial)" in text
    assert "eval epoch 1 | " in text


def test_step_seed_keeps_one_process_and_splits_ranks():
    s = cli_train.step_seed
    assert s(0, 5) == s(0, 5, None) == int(np.random.SeedSequence(
        [0, 5]).generate_state(1, np.uint64)[0])
    assert len({s(0, step, r) for step in range(3) for r in range(2)}) == 6
