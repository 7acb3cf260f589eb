"""A configuration that brings its own model family (CPU): a family file
and a configuration file naming it are all a new model needs, and no
file of the harness is edited. The family here is the port's tiny
OV-Uni3DETR (points, images, cameras, the CLIP head), with the port's
own model in float32 standing in for the reference: the seam is under
test, not the verdict.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import math
import os
import time

import pytest
import torch

import bench_fixtures as fx

CPU = torch.device("cpu")

FAMILY = '''"""The port's tiny OV-Uni3DETR: point scenes with images and cameras
drawn from the seed, drawn CLIP class embeddings in place of a
``zeroshot_path``; the port's model in float32 stands in for the
reference."""
import math

import numpy as np
import torch

import bench_count
import bench_scenes
from reference.loss import total_loss as reference_loss
from reference.model import quantizer
from reference.postprocess import detect as reference_detect

STAGE_MODULES = (("encoder", "pts_middle_encoder"),
                 ("backbone_neck", "pts_neck"),
                 ("image", "view_trans"),
                 ("head", "pts_bbox_head"))
LIDAR_TO_CAMERA = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                            [0, 0, 0, 1]], np.float32)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(model):
    from uni3detr_tpu_torch.config import OVUni3DETRConfig
    return OVUni3DETRConfig(**{k: _tuples(v) for k, v in model.items()})


def build(cfg):
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    return OV_Uni3DETR(cfg)


def _cameras(seed, model, batch, index, tag):
    rng = np.random.default_rng([int(seed), tag, int(index)])
    H, W = model["img_size"]
    N = model["num_cams"]
    K = np.zeros((batch, N, 4, 4), np.float32)
    K[..., 0, 0] = K[..., 1, 1] = 520.0 * W / 640 * rng.uniform(
        0.9, 1.1, (batch, N))
    K[..., 0, 2], K[..., 1, 2] = W / 2, H / 2
    K[..., 2, 2] = K[..., 3, 3] = 1.0
    yaw = rng.uniform(-0.1, 0.1, batch)
    rot = np.zeros((batch, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(yaw)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    rot[:, 2, 2] = 1.0
    return {"images": rng.random((batch, N, H, W, 3), np.float32),
            "lidar2img": K @ LIDAR_TO_CAMERA, "uni_rot_aug": rot}


def train_batch(seed, model, batch, index):
    return {**bench_scenes.train_batch(seed, model, batch, index),
            **_cameras(seed, model, batch, index, 3)}


def infer_batch(seed, model, batch, index):
    return {**bench_scenes.infer_batch(seed, model, batch, index),
            **_cameras(seed, model, batch, index, 4)}


def infer(model, batch):
    return model(batch, batch["random_points"])


def optimizer_kwargs(config):
    return {"lr_mult": config["train"]["lr_mult"]}


def weight_rule(kind, name, mod, leaf, t):
    if kind != "init":
        return None
    if leaf == "zs_weights":
        return ("normal", 0.0, 1.0)
    if t.dim() == 4:                     # Conv2d and the DCN's kernels
        return ("truncated", 0.0, 1 / math.sqrt(t[0].numel()))
    if isinstance(mod, torch.nn.Conv2d):
        return ("const", 0.0, 0)
    return None


def reference(model):
    return build(port_config({**model, "compute_dtype": "float32"}))


def reference_forward(ref, batch, quant):
    return ref(batch)


def reference_scene(ref, batch, b, device, quant):
    one = {k: v[b:b + 1].to(device) for k, v in batch.items()}
    return {k: v[:, 0] for k, v in ref(one, one["random_points"]).items()}


def work(model, train, batch, batches):
    V = model["max_voxels"] if train else model["max_voxels_test"]
    return bench_count.Work(model, V, batch, train,
                            [(i, b["points"].numpy()) for i, b in batches],
                            lambda cfg, n, train: 0.0)
'''

TRAFFIC = {
    "ov_train": {"kind": "train", "batch": 2, "pool_batches": 3,
                 "checked_steps": 2, "weights": "init", "trace_skip": 0,
                 "trace_iters": 1},
    "ov_eval": {"kind": "infer", "loop": "pipelined", "batch": 2,
                "pool_batches": 2, "warmup_batches": 1, "weights": "random",
                "check_batches": 1, "trace_skip": 0, "trace_iters": 1},
}


def _ov_model():
    from uni3detr_tpu_torch import presets
    cfg = dataclasses.replace(presets.OV_TINY_SYNTHETIC, max_voxels_test=256,
                              max_num=32, num_thr=20)
    return dataclasses.asdict(cfg)


def _add_cell(root, name, config, traffic, family, model=None):
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "uni3detr_nuscenes.json")) as f:
        train = json.load(f)["train"]
    train["lr_mult"] = {"img_backbone": 0.1, "img_neck": 0.1}
    with open(os.path.join(bdir, "configs", f"{config}.json"), "w") as f:
        json.dump({"source": "tests", "reduced": [], "family": family,
                   "model": model or _ov_model(), "train": train}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config, "source": "tests",
                             "reduced": [], "why": "tests",
                             "file": f"benchmark/configs/{config}.json"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = fx.make_tree(tmp_path_factory.mktemp("family"))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "families", "ov_tiny.py"), "w") as f:
        f.write(FAMILY)
    for name, mix in TRAFFIC.items():
        with open(os.path.join(bdir, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    _add_cell(root, "ov.train", "ov_tiny", "ov_train", "ov_tiny")
    _add_cell(root, "ov.eval", "ov_tiny_eval", "ov_eval", "ov_tiny")
    return root


def _harness_untouched(root):
    """Every file of the shipped harness is in the tree as it ships."""
    bdir = os.path.join(root, "benchmark")
    for d, _, files in os.walk(fx.BENCH):
        rel = os.path.relpath(d, fx.BENCH)
        if rel.split(os.sep)[0] in ("tests", "__pycache__") or \
                "__pycache__" in rel:
            continue
        for f in files:
            assert filecmp.cmp(os.path.join(d, f),
                               os.path.join(bdir, rel, f), shallow=False), \
                os.path.join(rel, f)


def test_a_new_family_trains_through_the_runner(tree):
    import bench_drive
    cell = fx.load(tree, "ov.train")
    assert cell.family.__name__ == "bench_family_ov_tiny"
    torch.manual_seed(0)
    r = bench_drive.run(cell, 2 ** 31 + 5, 0.2, False, CPU,
                        time.perf_counter())
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["pool"][0]) >= {"points", "images", "lidar2img",
                                 "uni_rot_aug", "gt_boxes"}
    prog, ref = r["readings"]["program"], r["readings"]["reference"]
    assert len(prog["loss"]) == len(ref["loss"]) == 2
    # the optimizer's parameters alone, the frozen ResNet stem left out,
    # on both sides
    assert prog["grad"].keys() == ref["grad"].keys()
    assert not any(k.startswith("img_backbone.conv1.") for k in prog["grad"])
    assert any(k.startswith("img_backbone.layer2.") for k in prog["grad"])
    assert all(math.isfinite(v) for v in r["numbers"].values())
    _harness_untouched(tree)


def test_a_new_family_infers_through_the_runner_traced(tree):
    import bench_count
    import bench_drive
    cell = fx.load(tree, "ov.eval")
    torch.manual_seed(0)
    r = bench_drive.run(cell, 2 ** 31 + 6, 0.2, True, CPU,
                        time.perf_counter())
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert r["numbers"]["kept_miss"] == 0.0, r["numbers"]
    assert r["numbers"]["score_gap"] < 1e-3, r["numbers"]
    t = r["trace"]
    assert {"encoder", "backbone_neck", "image", "head",
            "postprocess"} <= set(t.stages)
    assert t.stage_ms("image") > 0
    assert t.work.per_iter(bench_count.model_flops) > 0
    _harness_untouched(tree)


def test_an_unknown_family_exits_listing_the_families(tree):
    _add_cell(tree, "nosuch.eval", "nosuch", "ov_eval", "no_such_family",
              model=fx.tiny_model())
    with pytest.raises(SystemExit) as e:
        fx.load(tree, "nosuch.eval")
    msg = str(e.value)
    assert "no_such_family" in msg
    assert "['ov_tiny', 'uni3detr']" in msg


def test_an_entry_no_rule_covers_still_raises_naming_it(tree):
    import bench_cell
    import bench_weights
    fam = bench_cell.family("ov_tiny", os.path.join(tree, "benchmark"))
    model = torch.nn.Module()
    model.proj = torch.nn.Conv2d(3, 4, 3)        # the family's rule
    model.norm = torch.nn.LayerNorm(4)           # a shared rule
    bench_weights.draw(model, 1, "init", CPU, fam.weight_rule)
    model.odd = torch.nn.Bilinear(2, 2, 2, bias=False)   # neither
    with pytest.raises(KeyError, match=r"odd\.weight \(Bilinear\)"):
        bench_weights.draw(model, 1, "init", CPU, fam.weight_rule)
    del model.odd
    with pytest.raises(KeyError, match=r"proj\.bias \(Conv2d\)"):
        bench_weights.draw(model, 1, "init", CPU)
