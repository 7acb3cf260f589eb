"""The comparison that decides ``correct`` (CPU, tiny preset, the port's
plain kernels): the reference agrees with the port where both compute
alike, and the control and each planted fault of the timed path come out
not correct.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import time

import pytest
import torch

import bench_fixtures as fx

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fx.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def fp32_tree(tmp_path_factory):
    return fx.make_tree(tmp_path_factory.mktemp("bench32"),
                        compute_dtype="float32", matcher="scipy")


def _run(root, name, seed, fault=None):
    import bench_drive
    torch.manual_seed(0)
    return bench_drive.run(fx.load(root, name), seed, 0.3, False, CPU,
                           time.perf_counter(), fault=fault)


def _verdict(root, name, numbers):
    import bench_check
    return bench_check.verdict(numbers, fx.load(root, name).limits)[0]


@pytest.mark.parametrize("name", ["tiny.eval", "tiny.online"])
def test_reference_matches_the_port_in_fp32_inference(fp32_tree, name):
    n = _run(fp32_tree, name, 3)["numbers"]
    assert n["score_gap"] < 1e-5 and n["box_gap"] < 1e-4, n
    assert n["kept_miss"] == 0.0


def test_reference_matches_the_port_in_an_fp32_train_step(fp32_tree):
    r = _run(fp32_tree, "tiny.train", 3)
    p, ref = r["readings"]["program"], r["readings"]["reference"]
    assert p["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    assert r["numbers"]["grad_gap"] < 1e-3, r["numbers"]


@pytest.mark.parametrize("name", ["tiny.train", "tiny.eval", "tiny.online"])
def test_sound_runs_are_correct(tree, name):
    r = _run(tree, name, 4)
    assert _verdict(tree, name, r["numbers"]), r["numbers"]


@pytest.mark.parametrize("precision", ["float8", "float8_alone"])
def test_the_float8_control_is_not_correct_in_training(tree, precision):
    import bench_check
    r = _run(tree, "tiny.train", 3)
    cell = fx.load(tree, "tiny.train")
    ctl = bench_check.train_reference(cell, 3, r["pool"][:3], CPU,
                                      precision)
    n = bench_check.train_numbers(ctl, r["readings"]["reference"])
    assert not _verdict(tree, "tiny.train", n), n


@pytest.mark.parametrize("precision", ["float8", "float8_alone"])
@pytest.mark.parametrize("name", ["tiny.eval", "tiny.online"])
def test_the_float8_control_is_not_correct_in_inference(tree, name,
                                                         precision):
    import bench_check
    r = _run(tree, name, 3)
    cell = fx.load(tree, name)
    ctl = bench_check.InferReference(cell, 3, CPU, precision)
    judged = [bench_check.judge_scene(ctl.as_output(ctl.scene(r["pool"][i],
                                                              b)), det)
              for i, b, det in r["checked_scenes"]]
    n = bench_check.infer_numbers(judged)
    assert not _verdict(tree, name, n), n


@pytest.mark.parametrize("name,fault", [("tiny.train", "half_batch"),
                                        ("tiny.train", "frozen"),
                                        ("tiny.eval", "altered"),
                                        ("tiny.online", "altered"),
                                        ("tiny.eval", "half_empty"),
                                        ("tiny.online", "half_empty"),
                                        ("tiny.eval", "no_nms"),
                                        ("tiny.online", "no_nms")])
def test_a_broken_timed_path_is_not_correct(tree, name, fault):
    r = _run(tree, name, 3, fault)
    assert not _verdict(tree, name, r["numbers"]), r["numbers"]


@pytest.mark.parametrize("name", ["tiny.train", "tiny.eval"])
def test_calibration_judges_each_reading(tree, name):
    """``calibrate.readings``: the program and the bf16 witness come out
    correct, both controls and every planted fault not; in training the
    first step's assignments are counted, also with the dropout at 0."""
    import calibrate
    cell = fx.load(tree, name)
    torch.manual_seed(0)
    got = calibrate.readings(cell, 5, 0.3, CPU, faults=name == "tiny.eval",
                             dropout0=name == "tiny.train")
    verdicts = {k: v["correct"] for k, v in got.items()}
    want = {"program": True, "reference_bfloat16": True,
            "reference_float8": False, "reference_float8_alone": False}
    if name == "tiny.train":
        want["dropout0"] = True
        assert all(0 <= got[k]["assign_flips"] <= got[k]["assign_pos"]
                   and got[k]["assign_pos"] > 0 for k in want)
    else:
        want.update(altered=False, half_empty=False, no_nms=False)
    assert verdicts == want, got
    assert cell.model["dropout"] == fx.load(tree, name).model["dropout"]
