"""The shipped OV-Uni3DETR family (``families/ov_uni3detr.py``) at a tiny
model on the CPU: its inference path through the unedited runner is
judged correct against the plain ``reference/ov_model.py``, and the two
faults planted in that reference's image path (``FAULTS``: the fusion
fed [points, points], the DCNs at zero offsets) are judged not correct,
so the comparison sees the image branch, the lift and the fusion.

    python -m pytest benchmark/tests/test_bench_ov_family.py -q
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import pytest
import torch

import bench_fixtures as fx

CPU = torch.device("cpu")
CELL = "ov_tiny.eval"
# tiny readings on the CPU (bf16 program, fp32 reference; seeds 3-6,
# 2147483659, 2147483700-01): program score_gap_median 3.5e-7-3.0e-6,
# box_gap_median 1.3e-6-3.7e-5; fusion fed [points, points] 6.0e-5-4.3e-4
# and 1.3e-3-8.4e-3; DCN offsets zero 1.1e-5-6.9e-5 and 2.8e-4-1.6e-3;
# kept_miss 0 and no wrong box anywhere
LIMITS = {"score_gap_median": 6e-6, "box_gap_median": 1e-4,
          "kept_miss": 0.05, "wrong_boxes": 0}
TRAFFIC = {"kind": "infer", "loop": "pipelined", "batch": 2,
           "pool_batches": 2, "warmup_batches": 1, "weights": "init",
           "check_batches": 2, "trace_skip": 0, "trace_iters": 1}


def _model():
    from uni3detr_tpu_torch import presets
    cfg = dataclasses.replace(presets.OV_TINY_SYNTHETIC, img_size=(64, 64),
                              max_voxels_test=256, max_num=32, num_thr=20,
                              compute_dtype="bfloat16")
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The shipped benchmark with the shipped OV configuration's file cut
    to the tiny model, one inference cell on it and its limits."""
    root = fx.make_tree(tmp_path_factory.mktemp("ov_family"))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs",
                           "ov_uni3detr_sunrgbd_mm.json")) as f:
        config = json.load(f)
    config["model"] = _model()
    with open(os.path.join(bdir, "configs", "ov_tiny.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bdir, "traffic", "ov_tiny_eval.json"), "w") as f:
        json.dump(TRAFFIC, f)
    with open(os.path.join(bdir, "limits", f"{CELL}.json"), "w") as f:
        json.dump(LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "ov_tiny", "source": "tests",
                             "reduced": [], "why": "tests",
                             "file": "benchmark/configs/ov_tiny.json"})
    bench["workloads"].append({"name": CELL, "config": "ov_tiny",
                               "traffic": "ov_tiny_eval", "chips": 1,
                               "why": "tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_the_ov_family_is_judged_correct_and_its_image_faults_not(tree):
    import bench_check
    import calibrate_faults
    from reference.ov_model import FAULTS

    cell = fx.load(tree, CELL)
    assert cell.family.__name__ == "bench_family_ov_uni3detr"
    torch.manual_seed(0)
    got = calibrate_faults.readings(cell, 2 ** 31 + 11, 0.2, CPU, FAULTS)
    prog = got.pop("program")
    assert prog["correct"], prog
    assert prog["kept_boxes"] > 0 and prog["wrong_boxes"] == 0
    for fault, numbers in got.items():
        assert not numbers["correct"], (fault, numbers)
        # the fault moves the scores and boxes, each beyond its limit
        assert numbers["score_gap_median"] > LIMITS["score_gap_median"]
        assert numbers["box_gap_median"] > LIMITS["box_gap_median"]
    assert bench_check.verdict(prog, cell.limits)[0]


def test_the_ov_family_runs_traced_with_its_stages(tree):
    import bench_cell
    import bench_count
    import bench_drive
    cell = fx.load(tree, CELL)
    torch.manual_seed(0)
    r = bench_drive.run(cell, 2 ** 31 + 12, 0.2, True, CPU,
                        time.perf_counter())
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["pool"][0]) == {"points", "pts_mask", "random_points",
                                 "images", "lidar2img", "uni_rot_aug"}
    t = r["trace"]
    assert {"encoder", "backbone_neck", "image", "fusion", "head",
            "postprocess"} <= set(t.stages)
    # the dense count holds the view convs and the fusion beyond the
    # Lidar family's count of the same point branch
    cfg, B = cell.model, cell.traffic["batch"]
    lidar = bench_cell.family("uni3detr", os.path.join(tree, "benchmark"))
    D, H, W = cell.family.encoder_grid(cfg)
    C, n = cfg["embed_dim"], cfg["num_view_convs"]
    convs = 2 * B * D * H * W * 27 * C * C * (n + 2)
    dense = cell.family.dense_flops(cfg, B, False)
    assert dense > lidar.dense_flops(cfg, B, False) + convs
    assert t.work.per_iter(bench_count.model_flops) > dense
