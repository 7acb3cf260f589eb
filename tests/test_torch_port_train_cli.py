"""The port's train CLI (``cli.train``) against the JAX package's, on the
CPU.

- ``batch_iterator``: the same order as JAX's for a seed, tail wrap
  included.
- Every shipped config: the CLI's optimizer gives the lr (and beta1) of
  JAX's schedules at every step of a run of the config's epochs: the
  step policy within LR_RTOL relative (optax rounds its value to
  float32, observed 6.6e-8); the cyclic policy and momentum within
  CYCLIC_RTOL relative plus CYCLIC_ATOL of the peak, the tolerance of
  ``test_torch_port_nuscenes.py::test_cyclic_schedules_match_optax``:
  optax computes them in float32, the port in float64 (at step 0,
  ``(2e-5 - 2e-4) * 1 + 2e-4`` in float32 is 3.9e-7 from 2e-5); its
  groups take the config's ``lr_mult`` by module prefix and
  leave the frozen ResNet stages out (ROADMAP Queue 3: JAX's first-match
  lookup gives them ``img_backbone``'s 0.1).
- End to end on ``uni3detr_synthetic_tiny.py`` with ``--device cpu``:
  ``--max-steps 3`` (an eval after the first epoch), a resume from
  ``latest``, then ``cli.test`` on the resumed run's ``latest``; the first
  step's loss equal to a direct ``train_step`` on the same batch and the
  seed's weights; each step's lr against JAX's schedule; the OV tiny
  config's staged branch loading, lr multipliers and frozen stages.
- ``--spatial-shard 2`` refused on one process and on 3; without a card
  and without ``--device cpu`` the CLI exits non-zero.
"""
import glob
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from uni3detr_tpu import config as jconfig
from uni3detr_tpu.cli import train as jtrain
from uni3detr_tpu.models.resnet import ResNet as JResNet
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu_torch import config_file as tconfig
from uni3detr_tpu_torch.cli import test as cli_test
from uni3detr_tpu_torch.cli import train as cli_train
from uni3detr_tpu_torch.models.detector import Uni3DETR
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
from uni3detr_tpu_torch.models.resnet import ResNet
from uni3detr_tpu_torch.train import checkpoint as tcheckpoint
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import init_state_dict

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_tiny.py")
OV_TINY = os.path.join(ROOT,
                       "configs/ov_uni3detr/ov_uni3detr_synthetic_tiny.py")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py")) if "_base_" not in p)
LR_RTOL = 1e-7
CYCLIC_RTOL, CYCLIC_ATOL = 1e-6, 1e-6
# a short tiny run: 4 scenes at B=2 (2 steps an epoch), an eval after
# every epoch, a log line every step, the lr milestone after epoch 1
TINY_OPTS = ["data.length=4", "evaluation.interval=1",
             "evaluation.max_samples=2", "log_config.interval=1",
             "lr_config.step=[1]"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """torch on two threads: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


class _Indexed:
    """Samples that carry their index (in meta) and a point per index."""

    def __len__(self):
        return self.n

    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return {"points": np.full((3, 3), i, np.float32),
                "gt_boxes": np.zeros((1, 7), np.float32),
                "gt_labels": np.zeros(1, np.int32), "meta": {"index": i}}


@pytest.mark.parametrize("n,bs", [(7, 3), (6, 3), (2, 3)])
@pytest.mark.parametrize("seed", [0, 5])
def test_batch_iterator_matches_jax(n, bs, seed):
    mc = types.SimpleNamespace(num_points=4, max_gt=2, in_point_features=3,
                               code_size=8)
    ds = _Indexed(n)
    with ThreadPoolExecutor(2) as pool:
        got = list(cli_train.batch_iterator(ds, bs, mc,
                                            np.random.RandomState(seed),
                                            pool))
        want = list(jtrain.batch_iterator(ds, bs, mc,
                                          np.random.RandomState(seed), pool))
    assert len(got) == len(want) == -(-n // bs)
    for (tb, tm), (jb, jm) in zip(got, want):
        assert [m["index"] for m in tm] == [m["index"] for m in jm]
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    order = [m["index"] for _, ms in got for m in ms]
    assert sorted(set(order)) == list(range(n))    # the tail wraps


def _jax_schedules(cfg, spe):
    """The lr and momentum schedules as the JAX CLI builds them
    (``uni3detr_tpu/cli/train.py:127-164``)."""
    opt = cfg.get("optimizer", {})
    epochs = cfg.get("total_epochs", 40)
    lr_cfg = cfg.get("lr_config", {"policy": "step", "step": [1 << 30]})
    if lr_cfg.get("policy") == "cyclic":
        sched = jstep.cyclic_lr_schedule(
            opt.get("lr", 1e-4), spe * epochs,
            tuple(lr_cfg.get("target_ratio", (10, 1e-4))),
            lr_cfg.get("step_ratio_up", 0.4))
    else:
        sched = jstep.step_lr_schedule(opt.get("lr", 1e-4), spe,
                                       lr_cfg.get("step", []))
    mom_cfg = cfg.get("momentum_config") or {}
    mom = None
    if mom_cfg.get("policy") == "cyclic":
        mom = jstep.cyclic_momentum_schedule(
            opt.get("beta1", 0.9), spe * epochs,
            tuple(mom_cfg.get("target_ratio", (0.85 / 0.95, 1.0))),
            mom_cfg.get("step_ratio_up", 0.4))
    return sched, mom


@pytest.mark.parametrize("path", CONFIGS)
def test_config_schedules_and_groups_match_jax(path):
    """The CLI's optimizer for the config's model (built on the meta
    device: no weights) over a run of ``total_epochs`` epochs of 3
    steps: every step's lr and beta1 equal JAX's; every trainable
    parameter in the group of its ``lr_mult`` prefix; the frozen ResNet
    stages out of the optimizer."""
    path = os.path.join(ROOT, path)
    cfg = tconfig.load_config(path)
    mc = tconfig.build_model_config(cfg)
    with torch.device("meta"):
        model = (OV_Uni3DETR if hasattr(mc, "clip_dim") else Uni3DETR)(mc)
    spe = 3
    opt = cli_train.build_optimizer(cfg, model, spe)
    sched, mom = _jax_schedules(jconfig.load_config(path), spe)
    total = spe * cfg.get("total_epochs", 40)
    cyclic = cfg.get("lr_config", {}).get("policy") == "cyclic"
    peak = max(float(sched(k)) for k in range(total))
    tol = dict(rel=CYCLIC_RTOL, abs=CYCLIC_ATOL * peak) if cyclic \
        else dict(rel=LR_RTOL, abs=0)
    for k in list(range(total)) + [total + 5]:
        opt.steps = k
        opt._set_hyperparams()
        for g in opt.adamw.param_groups:
            assert g["lr"] / g["lr_mult"] == pytest.approx(float(sched(k)),
                                                           **tol), k
            want_b1 = 0.9 if mom is None else float(mom(k))
            assert g["betas"][0] == pytest.approx(
                want_b1, rel=CYCLIC_RTOL if mom else LR_RTOL), k
    lr_mult = dict(cfg.get("lr_mult") or {})
    group_of = {id(p): g["lr_mult"] for g in opt.adamw.param_groups
                for p in g["params"]}
    frozen = ResNet.frozen_param_prefixes(getattr(mc, "frozen_stages", -1)) \
        if getattr(mc, "use_camera", False) else ()
    for name, p in model.named_parameters():
        if name.startswith(tuple(frozen)):
            assert not p.requires_grad and id(p) not in group_of, name
            continue
        want = next((m for pre, m in lr_mult.items()
                     if name == pre or name.startswith(pre + ".")), 1.0)
        assert group_of[id(p)] == want, name
    if frozen and lr_mult.get("img_backbone"):
        # JAX's CLI appends the frozen prefixes at 0x after the config's
        # entries; its first-match lookup gives them img_backbone's 0.1
        jm = dict(lr_mult)
        for pre in JResNet.frozen_param_prefixes(mc.frozen_stages):
            jm[pre] = 0.0
        first = next(m for pre, m in jm.items()
                     if "img_backbone/stem_conv/kernel".startswith(pre))
        assert first == lr_mult["img_backbone"] != 0.0


class _Recorder:
    """Wraps ``train.step.train_step`` (the CLI looks it up each step):
    per step the optimizer's step count before it, the lr and beta1 it
    used and the loss; at the first step the batch, the model's state
    and torch's generator state."""

    def __init__(self):
        self.steps, self.first = [], None
        self.real = tstep.train_step

    def __call__(self, model, opt, batch, **kw):
        if self.first is None:
            self.first = dict(
                batch={k: v.clone() for k, v in batch.items()},
                state={k: v.clone() for k, v in model.state_dict().items()},
                rng=torch.get_rng_state())
        before = opt.steps
        logs = self.real(model, opt, batch, **kw)
        g = opt.adamw.param_groups[0]
        self.steps.append(dict(step=before, lr=g["lr"] / g["lr_mult"],
                               beta1=g["betas"][0],
                               loss=float(logs["total_loss"])))
        return logs


def _run(argv, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tstep, "train_step", rec)
    return cli_train.main(argv), rec


def test_cli_end_to_end_on_cpu(tmp_path, monkeypatch):
    wd = str(tmp_path / "wd")
    base = [TINY, "--work-dir", wd, "--device", "cpu", "--cfg-options",
            *TINY_OPTS]
    r1, rec1 = _run(base[:5] + ["--max-steps", "3"] + base[5:],
                    monkeypatch)
    assert (r1["epoch"], r1["step"]) == (1, 3) and list(r1["evals"]) == [1]
    assert [s["step"] for s in rec1.steps] == [0, 1, 2]
    assert len(r1["stats"]["load_ms"]) >= 2
    assert [s[1] for s in r1["stats"]["log_s"]] == [1, 2, 3]
    cfg = tconfig.merge_cfg_options(tconfig.load_config(TINY), TINY_OPTS)
    sched, _ = _jax_schedules(
        jconfig.merge_cfg_options(jconfig.load_config(TINY), TINY_OPTS), 2)
    # the first step against a direct train_step: the seed's weights, the
    # recorded batch and generator state
    mc = tconfig.build_model_config(cfg)
    model = Uni3DETR(mc)
    want = init_state_dict(model, 0)
    for k, v in rec1.first["state"].items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    model.load_state_dict(rec1.first["state"])
    torch.set_rng_state(rec1.first["rng"])
    logs = tstep.train_step(model, cli_train.build_optimizer(cfg, model, 2),
                            rec1.first["batch"])
    assert float(logs["total_loss"]) == pytest.approx(rec1.steps[0]["loss"],
                                                      rel=1e-6)

    r2, rec2 = _run(base + ["--resume-from", os.path.join(wd, "latest")],
                    monkeypatch)
    assert (r2["epoch"], r2["step"]) == (2, 5) and list(r2["evals"]) == [2]
    assert [s["step"] for s in rec2.steps] == [3, 4]
    for s in rec1.steps + rec2.steps:
        assert s["lr"] == pytest.approx(float(sched(s["step"])),
                                        rel=LR_RTOL) and s["beta1"] == 0.9
    assert rec1.steps[2]["lr"] < rec1.steps[1]["lr"]    # the milestone
    with open(os.path.join(wd, "train.log")) as f:
        text = f.read()
    for line in ("eval epoch 1 | mAP_0.25=", "eval epoch 2 | mAP_0.25=",
                 "resumed from", "max steps reached", "epoch 1 step 5 |"):
        assert line in text, line
    for name, (epoch, step) in (("epoch_1", (1, 2)), ("epoch_2", (2, 5)),
                                ("latest", (2, 5))):
        _, meta = tcheckpoint.load_checkpoint(os.path.join(wd, name))
        assert (meta["epoch"], meta["step"]) == (epoch, step)
        assert meta["classes"] == ["a", "b", "c"]
    res = cli_test.main([TINY, os.path.join(wd, "latest"), "--device",
                         "cpu", "--eval", "bbox", "--max-samples", "2"])
    assert set(res["metrics"]) == set(r2["evals"][2])


def test_ov_cli_staged_loading_on_cpu(tmp_path, monkeypatch):
    """OV tiny (both branches): a first run's ``latest`` loaded into a
    second run by branch prefix (``pretrained_pts`` / ``pretrained_img``),
    the loaded tensors equal to the source at the first step, the frozen
    ResNet stages unchanged by the steps, the config's multipliers."""
    src = str(tmp_path / "src")
    cli_train.main([OV_TINY, "--work-dir", src, "--device", "cpu",
                    "--max-steps", "1"])
    latest = os.path.join(src, "latest")
    wd = str(tmp_path / "wd")
    opts = [f"pretrained_pts={latest!r}", f"pretrained_img={latest!r}",
            "load_pts=['pts_middle_encoder', 'pts_backbone']",
            "load_img=['img_backbone', 'img_neck']",
            "lr_mult={'img_backbone': 0.1, 'pts_backbone': 0.5}"]
    r, rec = _run([OV_TINY, "--work-dir", wd, "--device", "cpu", "--seed",
                   "1", "--max-steps", "2", "--cfg-options", *opts],
                  monkeypatch)
    assert r["step"] == 2 and len(rec.steps) == 2
    source = tcheckpoint.load_checkpoint(latest)[0]["model"]
    first = rec.first["state"]
    for prefix in ("pts_middle_encoder", "pts_backbone", "img_backbone",
                   "img_neck"):
        keys = [k for k in first if k.startswith(prefix)]
        assert r["staged"][prefix] == len(keys) > 0
        for k in keys:
            assert torch.equal(first[k], source[k]), k
    # a branch not named keeps the seed-1 weights
    assert not torch.equal(first["pts_bbox_head.cls_branches.0.0.weight"],
                           source["pts_bbox_head.cls_branches.0.0.weight"])
    final = tcheckpoint.load_checkpoint(os.path.join(wd, "latest"))[0]
    mc = tconfig.build_model_config(tconfig.load_config(OV_TINY))
    frozen = ResNet.frozen_param_prefixes(mc.frozen_stages)
    fz = [k for k in first if k.startswith(frozen)]
    assert fz and all(torch.equal(final["model"][k], first[k]) for k in fz)
    mults = {g["lr_mult"] for g in final["optimizer"]["adamw"]
             ["param_groups"]}
    assert mults == {0.1, 0.5, 1.0}


def test_cli_refuses_unported_options_and_a_missing_card(monkeypatch):
    # spatial sharding needs S to divide the processes
    # (tests/test_torch_port_spatial.py): one process, or 3 at S = 2,
    # is refused before any process group starts
    with pytest.raises(ValueError, match="--spatial-shard 2 must divide "
                                         "the number of processes 1"):
        cli_train.main([TINY, "--device", "cpu", "--spatial-shard", "2"])
    with pytest.raises(ValueError, match="--spatial-shard 2 must divide "
                                         "the number of processes 3"):
        cli_train.main([TINY, "--device", "cpu", "--spatial-shard", "2",
                        "--num-processes", "3", "--process-id", "0",
                        "--coordinator", "127.0.0.1:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli_train.main([TINY])
    assert e.value.code not in (0, None)
