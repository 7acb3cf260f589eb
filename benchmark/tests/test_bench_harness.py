"""The harness as data, its inputs, its count of the work and its guards
(CPU).

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_fixtures as fx

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "uni3detr_tpu")


def test_cells_mixes_and_metrics_are_found_by_name(tmp_path):
    root = fx.make_tree(tmp_path)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"kind": "infer", "loop": "closed", "batch": 2,
                   "pool_batches": 3, "warmup_batches": 1,
                   "weights": "random", "check_batches": 1,
                   "trace_skip": 0, "trace_iters": 1}, f)
    with open(os.path.join(bdir, "metrics", "dummy_metric.online.py"),
              "w") as f:
        f.write("def read(t):\n    return 42.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.dummy", "config": "tiny",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric.online", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "host", "moves": "frame_ms_p95",
                               "workloads": ["tiny.dummy"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = fx.load(root, "tiny.dummy")
    assert cell.traffic["batch"] == 2 and cell.model["num_classes"] == 3
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric.online"]
    assert cell.reader("dummy_metric.online")(None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_gib",
                                                     "setup_s"}
    with pytest.raises(SystemExit):
        fx.load(root, "no.such.cell")


def test_a_roofline_is_a_metric_file_of_its_own(tmp_path):
    """A traced run (CPU profile) read by a new roofline file, which names
    its kernels and its least time; the shipped readers on the same
    trace: no port kernel, so the rooflines read nothing, and the MFU is
    the benchmark's count over the window."""
    import time

    import bench_count
    import bench_drive
    root = fx.make_tree(tmp_path)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "metrics", "k4_twice_roofline.infer.py"),
              "w") as f:
        f.write("KERNELS = ('u3d_fps',)\n\n\n"
                "def least(work, counts):\n"
                "    return 2.0\n\n\n"
                "def read(t):\n"
                "    return t.roofline(KERNELS, least)\n")
    cell = fx.load(root, "tiny.eval")
    r = bench_drive.run(cell, 3, 0.3, True, torch.device("cpu"),
                        time.perf_counter())
    t = r["trace"]
    assert cell.reader("fps_roofline.infer")(t) is None
    assert cell.reader("sparse_conv_roofline.infer")(t) is None
    flops = t.work.per_iter(bench_count.model_flops)
    assert flops > t.work.dense_flops() > 0
    assert cell.reader("mfu.infer")(t) == pytest.approx(
        100 * flops * t.iters / (t.window_s * 989e12))
    # one launch of a port kernel of 4 s (the trace's times are in us)
    t.kernels = [("void u3d_fps_pair<256>(float*)", 0.0, 4e6),
                 ("void other_kernel()", 0.0, 4e6)]
    got = cell.reader("k4_twice_roofline.infer")(t)
    assert got == pytest.approx(100 * 2.0 * t.iters / 4.0)


def test_repository_cells_name_existing_files():
    with open(os.path.join(fx.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = fx.load(fx.ROOT, w["name"])
        assert cell.traffic["kind"] in ("train", "infer")
        assert cell.per_layer and cell.end_to_end
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert cell.limits, f"{w['name']} has no limits"


def test_scene_pool_is_a_function_of_the_seed():
    import bench_scenes
    cfg = fx.tiny_model()
    big = 2 ** 31 + 12345
    a = bench_scenes.train_batch(big, cfg, 2, 1)
    b = bench_scenes.train_batch(big, cfg, 2, 1)
    c = bench_scenes.train_batch(big + 1, cfg, 2, 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert not np.array_equal(a["points"], c["points"])
    i1 = bench_scenes.infer_batch(7, cfg, 3, 0)
    i2 = bench_scenes.infer_batch(7, cfg, 3, 0)
    np.testing.assert_array_equal(i1["points"], i2["points"])
    np.testing.assert_array_equal(i1["random_points"], i2["random_points"])
    assert i1["points"].shape == (3, cfg["num_points"],
                                  cfg["in_point_features"])


@pytest.mark.parametrize("kind", ["init", "random"])
def test_weights_are_the_same_for_program_and_reference(kind):
    import bench_weights
    from reference.model import Detector
    from uni3detr_tpu_torch.config import Uni3DETRConfig
    from uni3detr_tpu_torch.models.detector import Uni3DETR

    cfg = fx.tiny_model()
    prog = Uni3DETR(Uni3DETRConfig(**{k: tuple(v) if isinstance(v, list)
                                      else v for k, v in cfg.items()}))
    ref = Detector(cfg)
    a = bench_weights.draw(prog, 3, kind, torch.device("cpu"))
    b = bench_weights.draw(ref, 3, kind, torch.device("cpu"))
    assert a.keys() == b.keys() == prog.state_dict().keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = bench_weights.draw(prog, 4, kind, torch.device("cpu"))
    w = "pts_backbone.blocks.0.0.weight"
    assert not torch.equal(a[w], c[w])
    if kind == "init":
        bias = a["pts_bbox_head.cls_branches.0.6.bias"]
        assert torch.allclose(bias, torch.full_like(bias, -4.59511985))
        std = a[w][0].numel() ** -0.5
        assert float(a[w].abs().max()) <= \
            2 * std / bench_weights.TRUNCATED_STD + 1e-6


def _brute_pairs(ids, grid, out_ids, out_grid, stride, pad):
    D, H, W = grid
    Do, Ho, Wo = out_grid
    have = set(ids.tolist())
    n = 0
    for o in out_ids.tolist():
        oz, oy, ox = o // (Ho * Wo), (o // Wo) % Ho, o % Wo
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    if stride == 1:
                        z, y, x = oz + dz - 1, oy + dy - 1, ox + dx - 1
                    else:
                        z, y, x = (2 * oz - pad[0] + dz, 2 * oy - pad[1] + dy,
                                   2 * ox - pad[2] + dx)
                    if 0 <= z < D and 0 <= y < H and 0 <= x < W and \
                            (z * H + y) * W + x in have:
                        n += 1
    return n


def test_pairs_flops_and_bytes_agree_with_a_hand_count():
    import bench_cell
    import bench_count
    cfg = fx.tiny_model()
    rng = np.random.default_rng(0)
    lo = np.asarray(cfg["pc_range"][:3])
    hi = np.asarray(cfg["pc_range"][3:])
    pts = np.concatenate([lo + (hi - lo) * rng.random((300, 3)),
                          rng.random((300, cfg["in_point_features"] - 3))],
                         -1).astype(np.float32)
    V = 64
    st = bench_count.scene_sites(pts, cfg, V)
    ids = bench_count.voxel_ids(pts, cfg, V)
    grid = tuple(cfg["grid_size"])
    assert st[0]["sites"] == len(ids) == V
    assert st[0]["subm_pairs"] == _brute_pairs(ids, grid, ids, grid, 1, None)
    # the strided site set by hand: every output one of whose 27 taps
    # lands on an input site, ascending, cut at the budget
    pad = cfg["encoder_downsample_paddings"][0]
    og = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
    have = set(ids.tolist())
    outs = []
    for o in range(og[0] * og[1] * og[2]):
        oz, oy, ox = o // (og[1] * og[2]), (o // og[2]) % og[1], o % og[2]
        if any((z * grid[1] + y) * grid[2] + x in have
               for z in range(2 * oz - pad[0], 2 * oz - pad[0] + 3)
               for y in range(2 * oy - pad[1], 2 * oy - pad[1] + 3)
               for x in range(2 * ox - pad[2], 2 * ox - pad[2] + 3)
               if 0 <= z < grid[0] and 0 <= y < grid[1] and 0 <= x < grid[2]):
            outs.append(o)
    outs = np.asarray(outs[:bench_count.budget(cfg, V, 0)])
    assert st[1]["sites"] == len(outs)
    assert st[1]["down_pairs"] == _brute_pairs(ids, grid, outs, og, 2, pad)
    assert st[1]["subm_pairs"] == _brute_pairs(outs, og, outs, og, 1, None)
    # FLOPs: 2 * pairs * Cin * Cout a conv, three times over in training
    # but for the first conv's feature gradient
    w = bench_count.sparse_work([st], cfg, V, train=False)
    C = cfg["encoder_base_channels"]
    c0 = 2 * st[0]["subm_pairs"] * cfg["in_point_features"] * C
    c1 = 2 * st[0]["subm_pairs"] * C * C * 2 * (len(
        cfg["encoder_channels"][0]) - 1)
    assert w["flops"] > c0 + c1
    t = bench_count.sparse_work([st], cfg, V, train=True)
    assert abs(t["flops"] - 3 * w["flops"] + c0) < 1e-6 * t["flops"]
    # bytes: each input once, each output once
    got = bench_count.conv_least(10, 100, 16, 50, 32, 2) * \
        bench_count.H100_BYTES_PER_S
    assert got == pytest.approx(2 * (2 * 100 * 16 + 27 * 16 * 32
                                     + 2 * 50 * 32) + 4 * 2 * 50 * 27)
    dense = bench_cell.family("uni3detr").dense_flops
    assert dense(cfg, 2, False) > 0
    assert dense(cfg, 2, True) > 2 * dense(cfg, 2, False)


def test_no_jax_module_is_loaded():
    code = (
        "import sys, os; sys.path[:0] = [%r, %r]\n"
        "import run; run._environment()\n"
        "import bench_cell, bench_check, bench_count, bench_drive, "
        "bench_scenes, bench_trace, bench_weights, calibrate\n"
        "import reference.model, reference.loss, reference.postprocess\n"
        "import uni3detr_tpu_torch.models.detector, "
        "uni3detr_tpu_torch.train.step, uni3detr_tpu_torch.train.coder\n"
        "c = bench_cell.load(%r, 'nuscenes.train.b4')\n"
        "[c.reader(m['name']) for m in c.per_layer]\n"
        "import torch\n"
        "with torch.device('meta'):\n"
        "    c.family.build(c.family.port_config(c.model))\n"
        "[bench_cell.family(f) for f in bench_cell.families()]\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    ) % (fx.ROOT, fx.BENCH, fx.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=_clean_env())
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "uni3detr_tpu_torch" in names


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(fx.BENCH, "run.py"), "--workload",
         "nuscenes.train.b4", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=fx.ROOT, env=_clean_env())
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    import shutil
    shutil.copytree(fx.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(fx.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "nuscenes.train.b4", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, env=_clean_env())
    assert out.returncode != 0 and "correct" not in out.stdout
