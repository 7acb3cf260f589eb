"""The port's OV-Uni3DETR against the benchmark's plain reference
(``benchmark/reference/ov_model.py``), the reference an OV cell's
``correct`` is judged against on the card: one seeded draw of the
benchmark family's ``init`` rule (``benchmark/families/ov_uni3detr.py``)
loaded into both, float32 on the CPU, at the tiny OV preset with a 48 x
64 image and a 2 x 4 x 4 encoder grid mostly in front of the camera (at
the preset's 32 x 32 the last ResNet stage is 1 x 1, and its 1 x 4 x 4
grid, half of it behind the family's camera, leaves at most 2 of 16
voxels in the frustum; a non-square image whose FPN levels are not all
2x apart keeps the axes and the half-pixel upsample honest). No JAX.

Tolerances: both sides compute in fp32 from the same numbers, in
different orders (a gather per DCN tap and a matrix product against the
port's ``grid_sample_2d`` and its own product; F.conv2d on both), so
each comparison holds the largest gap to 1e-5 of the largest value,
some ten roundings of fp32 deep; the frustum masks and the kept sets
must be equal.

    python -m pytest tests/test_ov_reference.py -q
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import subprocess
import sys

import pytest
import torch

from uni3detr_tpu_torch import presets
from uni3detr_tpu_torch.models.dcn import DeformConv2dV2
from uni3detr_tpu_torch.models.view_trans import project_voxels
from uni3detr_tpu_torch.train.coder import decode_predictions, post_process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 24
RTOL = 1e-5


@contextlib.contextmanager
def _bench_path():
    """The benchmark's directory first on the path, as the harness runs."""
    sys.path.insert(0, BENCH)
    try:
        yield
    finally:
        sys.path.remove(BENCH)


def _gap(a, b):
    """The largest gap over the largest value of ``b``."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads: the tier-1 run has several test processes,
    and torch's default of one thread a core oversubscribes the machine."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def ov(_two_threads):
    with _bench_path():
        bench_weights = importlib.import_module("bench_weights")
        R = importlib.import_module("reference.ov_model")
        fam = importlib.import_module("bench_cell").family("ov_uni3detr",
                                                           BENCH)
    box = (-2.0, -0.5, -0.5, 2.0, 3.5, 0.5)
    cfg = dataclasses.replace(presets.OV_TINY_SYNTHETIC, img_size=(48, 64),
                              max_voxels_test=256, pc_range=box,
                              post_center_range=box, grid_size=(16, 32, 32),
                              voxel_size=(0.125, 0.125, 0.0625))
    model = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(cfg).items()}
    port = fam.build(fam.port_config(model)).eval()
    ref = fam.reference(model).eval()
    drawn = [bench_weights.draw(m, SEED, "init", CPU, fam.weight_rule)
             for m in (port, ref)]
    assert drawn[0].keys() == drawn[1].keys()
    assert all(torch.equal(drawn[0][k], drawn[1][k]) for k in drawn[0])
    port.load_state_dict(drawn[0])
    ref.load_state_dict(drawn[1])
    batch = {k: torch.from_numpy(v)
             for k, v in fam.infer_batch(SEED, model, 2, 0).items()}
    with torch.no_grad():
        outs, inter = port(batch, batch["random_points"],
                           return_intermediates=True)
        rinter = {}
        routs = ref(batch, R.quantizer("float32"), rinter)
    return dict(fam=fam, R=R, model=model, cfg=cfg, port=port, ref=ref,
                batch=batch, outs=outs, inter=inter, routs=routs,
                rinter=rinter)


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_matches_mmcv_deform_conv_with_offsets(ov, stride):
    R = ov["R"]
    torch.manual_seed(stride)
    C, k = 6, 3
    port = DeformConv2dV2(C, 5, k, stride)
    ref = R.DCNv2(C, 5, k, stride)
    with torch.no_grad():
        port.weight.normal_()
        port.conv_offset.weight.normal_(0.0, 0.3)
        port.conv_offset.bias.normal_(0.0, 0.5)
    ref.load_state_dict(port.state_dict())
    x = torch.randn(2, C, 11, 13)
    exact = R.quantizer("float32")
    with torch.no_grad():
        off, _ = ref.offsets(x, exact)
    # offsets of about a pixel, fractional, some throwing taps outside
    assert 0.3 < float(off.abs().median()) < 3.0
    assert float(off.abs().max()) > 2.0
    with torch.no_grad():
        got, want = port(x), ref(x, exact)
        flat = ref(x, R.quantizer("dcn_offsets_zero"))
    assert got.shape == want.shape == (2, 5, (11 - 1) // stride + 1,
                                       (13 - 1) // stride + 1)
    assert _gap(got, want) < RTOL
    assert _gap(flat, want) > 0.1


def test_resnet_fpn_levels_and_depth_distributions(ov):
    port, ref, R, batch = ov["port"], ov["ref"], ov["R"], ov["batch"]
    exact = R.quantizer("float32")
    with torch.no_grad():
        mlvl, depths = port.image_features(batch["images"])
        rmlvl, rdepths, rstages = ref.image_features(batch["images"], exact)
        images = batch["images"].flatten(0, 1).permute(0, 3, 1, 2)
        stages = port.img_backbone(images)
    assert [tuple(s.shape[2:]) for s in stages] == [(12, 16), (6, 8), (3, 4),
                                                    (2, 2)]
    for a, b in zip(stages, rstages):
        assert _gap(a, b) < RTOL
    assert len(mlvl) == len(rmlvl) == ov["cfg"].fpn_levels
    for a, b in zip(mlvl + depths, rmlvl + rdepths):
        assert a.shape == b.shape and _gap(a, b) < RTOL
    assert torch.allclose(rdepths[0].sum(-1), torch.ones(()), atol=1e-6)


def test_lifted_features_and_frustum_mask(ov):
    port, inter, rinter = ov["port"], ov["inter"], ov["rinter"]
    batch, cfg = ov["batch"], ov["cfg"]
    vt = port.view_trans
    _, _, mask = project_voxels(vt.reference_voxels(batch["uni_rot_aug"]),
                                batch["lidar2img"], cfg.img_size,
                                cfg.depth_dim)
    assert torch.equal(mask, rinter["mask"])
    assert 0.05 < float(mask.float().mean()) < 0.95
    assert _gap(inter["lifted"], rinter["lifted"]) < RTOL
    outside = ~mask[..., None].expand_as(rinter["lifted"])
    assert not rinter["lifted"][outside].any()


@pytest.mark.parametrize("key", ["image_volume", "fused_volume"])
def test_view_conv_and_fused_volumes(ov, key):
    assert _gap(ov["inter"][key], ov["rinter"][key]) < RTOL


@pytest.mark.parametrize("key", ["all_cls_scores", "all_bbox_preds",
                                 "all_iou_preds", "all_uncertainty_preds"])
def test_every_layer_of_the_clip_head(ov, key):
    got, want = ov["outs"][key], ov["routs"][key]
    assert got.shape == want.shape
    assert got.shape[:2] == (ov["cfg"].num_decoder_layers, 2)
    for layer in range(got.shape[0]):
        assert _gap(got[layer], want[layer]) < RTOL, layer


def test_reference_detection_keeps_what_the_port_keeps(ov):
    fam, cfg, model = ov["fam"], ov["cfg"], ov["model"]
    with _bench_path():
        bench_check = importlib.import_module("bench_check")
    with torch.no_grad():
        res = post_process(*decode_predictions(ov["outs"], cfg), cfg)
    boxes, scores, labels, valid = (t.numpy() for t in res)
    for b in range(2):
        det = fam.reference_detect({k: v[:, b] for k, v in
                                    ov["routs"].items()}, model)
        mine = {"boxes": boxes[b], "scores": scores[b], "labels": labels[b],
                "valid": valid[b]}
        sg, bg, miss, either, _, wrong = bench_check.judge_scene(mine, det)
        assert either > 0 and miss == 0 and wrong == 0
        assert sg < 1e-4 and bg < 1e-4


def test_the_control_rounds_every_new_conv(ov):
    """``float8``'s ``dense`` reaches the weight of every conv the port
    runs on TF32: the ResNet's, the DCNs' and their offset convs, the
    FPN's, ``input_proj``, ``depth_net``, the view convs and the
    fusion."""
    R, ref, batch = ov["R"], ov["ref"], ov["batch"]
    seen = set()
    base = R.quantizer("float8")

    def dense(w):
        seen.add(id(w))
        return base.dense(w)

    with torch.no_grad():
        ref(batch, R.OVPrecision(base.act, dense))
    unused = tuple(f"img_neck.fpn_convs.{i}." for i in
                   range(ov["cfg"].fpn_levels, 4))     # levels not built
    convs = {n: p for n, p in ref.named_parameters()
             if p.dim() in (4, 5) and not n.startswith(
                 ("pts_middle_encoder",) + unused)}
    assert any(n.endswith("conv_offset.weight") for n in convs)
    assert [n for n, p in convs.items() if id(p) not in seen] == []


def test_the_reference_loads_no_port_and_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import reference.ov_model, reference.postprocess; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'uni3detr_tpu', "
            "'uni3detr_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
