"""The port's tools against the JAX package's, on the CPU: the import of
a reference checkpoint (``train.torch_import``, ``cli.import_ckpt``),
``utils.profiling`` and ``cli.get_flops``.

- The import: a reference-layout state dict
  (``test_torch_import.make_state_dict`` in mmcv's and spconv-v2's
  sparse-conv layouts, ``test_torch_import_ov.make_ov_state_dict``)
  through JAX's ``import_torch_state_dict(_ov)`` and then
  ``weights.state_dict_from_jax(_ov)`` equals the port's
  ``load_reference_state_dict`` tensor for tensor, exactly; one tiny
  forward on the imported weights matches JAX's at the tiny parity tests'
  atol 1e-4.
- The FLOPs: what each kernel wrapper records for a launch
  (``ops.cost.flops``) equals ``FlopCounterMode``'s count of its plain
  version at two shapes; the parameter counts equal JAX's.
"""
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.models.detector import Uni3DETR as JModel
from uni3detr_tpu.models.ov_detector import OV_Uni3DETR as JOVModel
from uni3detr_tpu.train.torch_import import (import_torch_state_dict,
                                             import_torch_state_dict_ov)
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.config import OVUni3DETRConfig as TOVConfig
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR as TOVModel
from uni3detr_tpu_torch.ops import cost, kernel_wrappers
from uni3detr_tpu_torch.ops import fps, matching, nms
from uni3detr_tpu_torch.ops import sparse_conv_cuda as sc
from uni3detr_tpu_torch.geom import iou
from uni3detr_tpu_torch.train.torch_import import load_reference_state_dict
from uni3detr_tpu_torch.utils import profiling
from uni3detr_tpu_torch.weights import (state_dict_from_jax,
                                        state_dict_from_jax_ov)
from test_ov import OV_TINY, _ov_batch
from test_torch_import import make_state_dict
from test_torch_import_ov import _bn, _conv3, make_ov_state_dict
from test_torch_port_slice import _scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = os.path.join(REPO, "configs/uni3detr/uni3detr_synthetic_tiny.py")
ATOL = 1e-4       # the tiny detector parity tests' (test_torch_port_slice)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == np.ascontiguousarray(v).tobytes(), k


# -- the import -------------------------------------------------------------

@pytest.mark.parametrize("preset", ["uni3detr_tiny_synthetic",
                                    "uni3detr_sunrgbd"])
@pytest.mark.parametrize("spconv_v2", [False, True])
def test_load_reference_matches_jax_import(preset, spconv_v2):
    jcfg, tcfg = jpresets.PRESETS[preset], tpresets.PRESETS[preset]
    sd = make_state_dict(jcfg, np.random.RandomState(1), spconv_v2)
    want = state_dict_from_jax(import_torch_state_dict(sd, jcfg), jcfg)
    _assert_state_dicts_equal(load_reference_state_dict(sd, tcfg), want)


def _ov_cfgs(mode):
    j = {"mm": OV_TINY,
         "rgb": dataclasses.replace(OV_TINY, use_lidar=False,
                                    multimodal=False),
         "sweep_cat": dataclasses.replace(OV_TINY, num_sweeps=2,
                                          sweep_fusion="sweep_cat"),
         "with_time": dataclasses.replace(OV_TINY, num_sweeps=2,
                                          sweep_fusion="with_time")}[mode]
    return j, TOVConfig(**dataclasses.asdict(j))


def _ov_state_dict(mode, rng):
    sd = make_ov_state_dict(OV_TINY, rng)
    C = OV_TINY.embed_dim
    if mode == "rgb":
        sd = {k: v for k, v in sd.items() if not k.startswith((
            "pts_middle_encoder.", "pts_backbone.", "pts_neck.",
            "conv_trans_head_1.", "pts_conv.", "img_conv."))}
    elif mode == "sweep_cat":
        _conv3(sd, rng, "view_trans.trans_conv.0", C, 2 * C, 1, 1, 1)
        _bn(sd, rng, "view_trans.trans_conv.1", C)
    elif mode == "with_time":
        _conv3(sd, rng, "view_trans.time_conv.0", C, C + 1, 1, 1, 1)
        _bn(sd, rng, "view_trans.time_conv.1", C)
    return sd


@pytest.mark.parametrize("mode", ["mm", "rgb", "sweep_cat", "with_time"])
def test_load_reference_matches_jax_import_ov(mode):
    """OV-Uni3DETR: the CLIP text embeddings carried, the dead
    ``pts_conv`` / ``img_conv`` dropped, the sweep modes' conv + BN folded
    into the port's 1x1 conv ``.0`` as JAX folds them into its Dense (the
    port has no ``.1`` there)."""
    jcfg, tcfg = _ov_cfgs(mode)
    sd = _ov_state_dict(mode, np.random.RandomState(2))
    want = state_dict_from_jax_ov(import_torch_state_dict_ov(sd, jcfg), jcfg)
    got = load_reference_state_dict(sd, tcfg)
    _assert_state_dicts_equal(got, want)
    sweep = {"sweep_cat": "trans_conv", "with_time": "time_conv"}.get(mode)
    if sweep:
        assert f"view_trans.{sweep}.0.weight" in got
        assert not any(k.startswith(f"view_trans.{sweep}.1.") for k in got)
    assert got["pts_bbox_head.zs_weights"].numpy().tobytes() == \
        sd["pts_bbox_head.zs_weights"].tobytes()


def test_unwraps_mmdet3d_checkpoint():
    cfg = jpresets.TINY_SYNTHETIC
    sd = make_state_dict(cfg, np.random.RandomState(3), spconv_v2=True)
    raw = {"meta": {"epoch": 36},
           "state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()},
           "optimizer": {}}
    _assert_state_dicts_equal(
        load_reference_state_dict(raw, tpresets.TINY_SYNTHETIC),
        state_dict_from_jax(import_torch_state_dict(sd, cfg), cfg))


def _broken(kind):
    sd = make_state_dict(jpresets.TINY_SYNTHETIC, np.random.RandomState(4))
    key = "pts_bbox_head.reg_branches.0.4.weight"
    if kind == "shape":
        sd[key] = sd[key][:-1]
    elif kind == "stray":
        sd["pts_bbox_head.extra.weight"] = np.zeros(3, np.float32)
    elif kind == "missing":
        del sd[key]
    elif kind == "layout":
        key = "pts_middle_encoder.conv_input.0.weight"
        sd[key] = np.zeros((3, 3, 3, 2, 5), np.float32)
    return sd, key


@pytest.mark.parametrize("kind", ["shape", "stray", "missing", "layout"])
def test_import_raises_naming_the_key(kind):
    sd, key = _broken(kind)
    with pytest.raises((KeyError, ValueError)) as e:
        load_reference_state_dict(sd, tpresets.TINY_SYNTHETIC)
    want = "pts_bbox_head.extra.weight" if kind == "stray" else key
    assert want in str(e.value)


def test_imported_forward_matches_jax():
    cfg = jpresets.TINY_SYNTHETIC
    sd = make_state_dict(cfg, np.random.RandomState(5), spconv_v2=True)
    v = import_torch_state_dict(sd, cfg)
    model = TModel(tpresets.TINY_SYNTHETIC).eval()
    model.load_state_dict(
        load_reference_state_dict(sd, tpresets.TINY_SYNTHETIC), strict=True)
    pts, mask, rnd = _scene(0)
    # jitted: one compile takes a fifth of the op-by-op run
    apply = jax.jit(functools.partial(JModel(cfg).apply, train=False))
    jout = apply(v, jnp.asarray(pts), jnp.asarray(mask),
                 random_points=jnp.asarray(rnd))
    with torch.no_grad():
        tout = model(torch.from_numpy(pts), torch.from_numpy(mask),
                     torch.from_numpy(rnd))
    for k in ("all_cls_scores", "all_bbox_preds", "all_iou_preds"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def _save_pth(path, sd, epoch=12):
    torch.save({"meta": {"epoch": epoch, "CLASSES": ["a", "b", "c"]},
                "state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)


def test_import_ckpt_cli_then_test_and_resume(tmp_path):
    """``cli.import_ckpt`` writes a checkpoint that ``cli.test`` scores
    as the same weights loaded directly (detections bit-equal) and that
    ``cli.train --resume-from`` starts from at step 0."""
    from uni3detr_tpu_torch.cli import import_ckpt, test as cli_test
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.train.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    cfg = jpresets.TINY_SYNTHETIC
    sd = make_state_dict(cfg, np.random.RandomState(6), spconv_v2=True)
    pth = str(tmp_path / "ref.pth")
    _save_pth(pth, sd)
    out = str(tmp_path / "imported")
    n = import_ckpt.main([pth, out, "--preset", "uni3detr_tiny_synthetic"])
    tree, meta = load_checkpoint(out)
    assert n == len(tree["model"]) and "optimizer" not in tree
    assert meta["classes"] == ["a", "b", "c"] and meta["step"] == 0
    assert meta["torch_meta_keys"] == ["CLASSES", "epoch"]
    direct = TModel(tpresets.TINY_SYNTHETIC)
    direct.load_state_dict({k: torch.from_numpy(a) for k, a in
                            state_dict_from_jax(import_torch_state_dict(
                                sd, cfg), cfg).items()}, strict=True)
    save_checkpoint(str(tmp_path / "direct"), direct)
    args = ["--eval", "bbox", "--max-samples", "2", "--device", "cpu"]
    a = cli_test.main([TINY_CONFIG, out] + args)
    b = cli_test.main([TINY_CONFIG, str(tmp_path / "direct")] + args)
    for da, db in zip(a["dets"], b["dets"]):
        for k in ("boxes", "scores", "labels"):
            assert np.asarray(da[k]).tobytes() == np.asarray(db[k]).tobytes()
    r = cli_train.main([TINY_CONFIG, "--work-dir", str(tmp_path / "wd"),
                        "--resume-from", out, "--max-steps", "1",
                        "--device", "cpu", "--cfg-options", "data.length=4",
                        "evaluation.interval=0"])
    assert r["step"] == 1


def test_import_ckpt_cli_fails_on_a_wrong_shape(tmp_path):
    sd, key = _broken("shape")
    pth = str(tmp_path / "bad.pth")
    _save_pth(pth, sd)
    r = subprocess.run(
        [sys.executable, "-m", "uni3detr_tpu_torch.cli.import_ckpt", pth,
         str(tmp_path / "out"), "--preset", "uni3detr_tiny_synthetic"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and key in r.stderr
    assert not os.path.exists(tmp_path / "out")


# -- FLOPs ------------------------------------------------------------------

def _plain_cases(shape):
    """(wrapper name, plain function, its arguments) of every kernel
    wrapper at one of two shapes."""
    B, V, C, Vout, K, Cout, N = [(1, 40, 8, 30, 27, 16, 20),
                                 (2, 70, 16, 50, 8, 24, 37)][shape]
    g = torch.Generator().manual_seed(shape)
    feats = torch.randn(B, V, C, generator=g)
    nb = torch.randint(0, V + 1, (B, Vout, K), dtype=torch.int32,
                       generator=g)
    sid = torch.sort(torch.randint(0, 1000, (B, V), generator=g), 1)[0] \
        .int()
    qids = torch.randint(-1, 1000, (B, Vout, K), dtype=torch.int32,
                         generator=g)
    w = torch.randn(K, C, Cout, generator=g)
    dy = torch.randn(B, Vout, Cout, generator=g)
    xyz = torch.rand(B, N + 10, 3, generator=g)
    m = torch.ones(B, N + 10, dtype=torch.bool)
    boxes = torch.rand(B, N, 7, generator=g) * 3
    boxes2 = torch.rand(B, N // 2, 7, generator=g) * 3
    labels = torch.randint(0, 3, (B, N), dtype=torch.int32, generator=g)
    bitmask = nms.overlap_mask(boxes, labels, 0.2)
    order = torch.arange(N).expand(B, N).contiguous()
    benefit = torch.rand(3, N // 4, N, generator=g)
    scores = torch.rand(B, N, generator=g)
    s_order, s_lab = nms.soft_nms_order(scores, labels,
                                        torch.ones(B, N, dtype=torch.bool), 3)
    s_boxes = torch.gather(boxes, 1, s_order[..., None].expand(-1, -1, 7))
    soft = (nms.iou3d_class_blocks_plain(s_boxes, s_lab), s_order, s_lab,
            scores, 3, 0.3, 1e-3, N)
    return [
        ("match_positions", sc.match_positions_plain, (sid, qids, V)),
        ("gather_conv", sc.gather_conv_plain, (feats, nb, w)),
        ("gather_conv_ids", sc.gather_conv_ids_plain, (feats, sid, qids, w)),
        ("gather_conv_dw", sc.gather_conv_dw_plain, (feats, nb, dy)),
        ("gather_conv_ids_dw", sc.gather_conv_ids_dw_plain,
         (feats, sid, qids, dy)),
        ("fps_pair", fps.farthest_point_sample_pair, (xyz, m, xyz, m, 8)),
        ("fps", fps.farthest_point_sample, (xyz, m, 8)),
        ("auction_lap", matching.auction_lap_plain,
         (benefit, torch.ones(3))),
        ("iou3d_rotated", nms.overlap_mask_plain, (boxes, labels, 0.2)),
        ("iou_bev_rotated_mask", nms.overlap_mask_plain,
         (boxes, labels, 0.2, "bottom", True)),
        ("nms_greedy", nms.greedy_scan_plain, (bitmask, labels, order)),
        ("soft_nms", nms.soft_nms_segments_plain, soft),
        ("iou3d_rotated_blocks", nms.iou3d_class_blocks_plain,
         (s_boxes, s_lab)),
        ("iou3d_rotated_matrix", iou.iou3d_rotated_pairwise, (boxes,)),
        ("iou3d_rotated_sets", iou.iou3d_rotated_sets, (boxes, boxes2)),
        ("iou_bev_rotated_sets", iou.iou_bev_rotated_sets, (boxes, boxes2)),
    ]


@pytest.mark.parametrize("shape", [0, 1])
def test_recorded_kernel_flops_equal_plain_flop_counts(shape):
    cases = _plain_cases(shape)
    assert {n for n, _, _ in cases} == set(kernel_wrappers()) | {"fps"}
    for name, plain, args in cases:
        with FlopCounterMode(display=False) as counter:
            plain(*args)
        assert cost.flops(name, *args) == counter.get_total_flops(), name


def test_flops_of_counts_products_kernels_and_bytes():
    """A product, the CPU flash attention counted as the card's, and the
    bytes of operands and results; a kernel's record adds to both."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    r = profiling.flops_of(torch.mm, a, b)
    assert r["flops"] == 2 * 8 * 16 * 4
    assert r["bytes_accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert r["peak_memory_bytes"] == -1
    q = torch.randn(2, 4, 10, 8)
    r = profiling.flops_of(torch.nn.functional.scaled_dot_product_attention,
                           q, q, q)
    assert r["flops"] == 2 * (2 * 2 * 4 * 10 * 10 * 8)

    feats, nb = torch.randn(1, 5, 3), torch.zeros(1, 4, 2, dtype=torch.int32)
    w, out = torch.randn(2, 3, 6), torch.empty(1, 4, 6)

    def launch():
        cost.record("gather_conv", (feats, nb, w), out)
        return a @ b
    r = profiling.flops_of(launch)
    conv = 2 * 1 * 4 * 2 * 3 * 6
    assert r["flops"] == conv + 2 * 8 * 16 * 4
    assert r["kernels"]["gather_conv"] == {
        "launches": 1, "flops": conv,
        "bytes": 4 * (1 * 5 * 3 + 4 * 2 + 2 * 3 * 6 + 4 * 6)}


def _jax_n_params(model, nq, *args):
    rp = jnp.full((1, nq, 3), 0.5)
    v = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "modality": jax.random.PRNGKey(1)},
        *args, train=False, random_points=rp))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(v["params"]))


@pytest.mark.parametrize("preset", ["uni3detr_tiny_synthetic",
                                    "uni3detr_sunrgbd", "ov_tiny"])
def test_params_equal_jax(preset):
    if preset == "ov_tiny":
        batch, _ = _ov_batch(B=1)
        want = _jax_n_params(JOVModel(OV_TINY), OV_TINY.num_query, batch)
        with torch.device("meta"):
            model = TOVModel(TOVConfig(**dataclasses.asdict(OV_TINY)))
    else:
        cfg = jpresets.PRESETS[preset]
        pts = jnp.zeros((1, 64, cfg.in_point_features))
        want = _jax_n_params(JModel(cfg), cfg.num_query, pts,
                             jnp.ones((1, 64), bool))
        with torch.device("meta"):
            model = TModel(tpresets.PRESETS[preset])
    assert sum(p.numel() for p in model.parameters()) == want


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with profiling.trace_context(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.mark.parametrize("config", [
    "uni3detr/uni3detr_synthetic_tiny.py",
    "ov_uni3detr/ov_uni3detr_synthetic_tiny.py"])
def test_get_flops_cli_on_cpu(config):
    r = subprocess.run(
        [sys.executable, "-m", "uni3detr_tpu_torch.cli.get_flops",
         os.path.join(REPO, "configs", config), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert [l.split(":")[0] for l in lines] == [
        "params", "forward flops", "bytes moved", "peak memory"]
    assert float(lines[1].split()[2]) > 0


def test_get_flops_count_is_input_independent():
    """Two scenes and the CLI's zeros batch give one count: the budgets
    are static."""
    from uni3detr_tpu_torch import synthetic
    from uni3detr_tpu_torch.cli import get_flops
    cfg = tpresets.TINY_SYNTHETIC
    model = TModel(cfg).eval()
    counts = []
    with torch.no_grad():
        for seed in (0, 1):
            pts, rnd = synthetic.clustered_scene(seed, cfg)
            p = torch.from_numpy(pts)
            counts.append(profiling.flops_of(
                model, p, torch.ones(p.shape[:2], dtype=torch.bool),
                torch.from_numpy(rnd))["flops"])
        counts.append(profiling.flops_of(
            model, *get_flops.zeros_batch(cfg, 1, "cpu"))["flops"])
    assert counts[0] == counts[1] == counts[2] > 0
    r = get_flops.main([TINY_CONFIG, "--device", "cpu"])
    assert r["flops"] == counts[0]
