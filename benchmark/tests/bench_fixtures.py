"""A tiny copy of the benchmark for the CPU tests: the port's
``uni3detr_tpu_torch`` tiny preset as a configuration file, one cell of
each traffic kind on it, and limits set from tiny readings on the CPU
(fp32 reference against the port's bf16 path; see ``TINY_LIMITS``)."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELLS = {"tiny.train": "train_closed", "tiny.eval": "eval_batched",
         "tiny.online": "online_b1"}
# tiny readings on the CPU, seeds 3-5 (bench_check's numbers): sound
# bn_gap 0.017-0.045, change_gap 0.10-0.14, score_gap_median 1.7e-7-2.3e-7,
# kept_miss 0; the float8 controls 0.26-0.40 (bn_gap) and 8.3e-6-2.8e-5
# (score_gap_median); the faults: half a batch 1.0-1.4 (bn_gap), a frozen
# state 1 (change_gap), an altered score: 7-16 wrong boxes, half the
# batch (all of it at B=1) empty: kept_miss 0.5 (1.0), no NMS: kept_miss
# 0.14-0.26
TINY_LIMITS = {"tiny.train": {"bn_gap": 0.12, "change_gap": 0.5},
               "tiny.eval": {"score_gap_median": 2e-6, "kept_miss": 0.05,
                             "wrong_boxes": 0},
               "tiny.online": {"score_gap_median": 2e-6, "kept_miss": 0.05,
                               "wrong_boxes": 0}}


def tiny_model(**kw):
    from uni3detr_tpu_torch import presets
    fields = dict(compute_dtype="bfloat16", code_size=10,
                  code_weights=(1.0,) * 10, max_num=32, num_thr=20,
                  nms_thr=0.2, max_voxels_test=256)
    fields.update(kw)
    cfg = dataclasses.replace(presets.TINY_SYNTHETIC, **fields)
    return dataclasses.asdict(cfg)


def make_tree(tmp, **model_kw):
    """A checkout at ``tmp`` with the benchmark's files, a tiny
    configuration and the tiny cells; returns its root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(BENCH, "configs", "uni3detr_nuscenes.json")) as f:
        train = json.load(f)["train"]
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"),
              "w") as f:
        json.dump({"source": "tiny", "reduced": [],
                   "model": tiny_model(**model_kw), "train": train}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tiny", "reduced": [],
                             "file": "benchmark/configs/tiny.json",
                             "why": "tests"})
    os.makedirs(os.path.join(root, "benchmark", "limits"), exist_ok=True)
    suffix = {"train_closed": "train", "eval_batched": "infer",
              "online_b1": "online"}
    for name, traffic in CELLS.items():
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "tests"})
        with open(os.path.join(root, "benchmark", "limits", f"{name}.json"),
                  "w") as f:
            json.dump(TINY_LIMITS[name], f)
        kind = suffix[traffic]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (m["name"].endswith("." + kind)
                                     or m["name"] in _E2E[kind]):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


_E2E = {"train": ("train_scenes_per_s",), "infer": ("infer_scenes_per_s",),
        "online": ("frame_ms_p95",)}


def load(root, name):
    import bench_cell
    return bench_cell.load(root, name, os.path.join(root, "benchmark"))
