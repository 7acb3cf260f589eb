"""The port's evaluation loop and CLIs against the JAX package, on the
CPU.

``run_inference`` on ``uni3detr_tiny_synthetic`` (fp32, the synthetic
dataset of ``configs/uni3detr/uni3detr_synthetic_tiny.py``), with JAX's
weights brought over by ``state_dict_from_jax`` and the random query
points that JAX's ``jax.random.split`` chain draws injected through
``random_points``: 5 scenes at batch 2 (a padded tail), with and without
TTA (flips). The detections equal JAX's within the tolerance of the
port's tiny forward tests (``tests/test_torch_port_slice.py``): labels
and counts equal, scores and boxes within atol 1e-4 (fp32 sums in
another order through ~20 convs and the decoder; observed ~1e-6).

``cli.test --device cpu`` end to end on the Lidar and the OV synthetic
tiny configs (``--max-samples 2 --out --show-dir``), then
``cli.eval_metric`` on the pkl: the same metric dict; without a card and
without ``--device cpu`` the CLI exits non-zero.
"""
import os
import pickle
import types

import numpy as np
import pytest
import jax
import torch

from uni3detr_tpu import config as jconfig
from uni3detr_tpu.data import datasets as jdatasets
from uni3detr_tpu.train import evaluator as jevaluator
from uni3detr_tpu.train.step import make_eval_step
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu.train.tta import make_aug_grid
from uni3detr_tpu_torch import config_file as tconfig
from uni3detr_tpu_torch.cli import eval_metric
from uni3detr_tpu_torch.cli import test as cli_test
from uni3detr_tpu_torch.data import datasets as tdatasets
from uni3detr_tpu_torch.models.detector import Uni3DETR
from uni3detr_tpu_torch.train import evaluator as tevaluator
from uni3detr_tpu_torch.weights import state_dict_from_jax
from test_torch_import import make_state_dict

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_tiny.py")
OV_TINY = os.path.join(ROOT,
                       "configs/ov_uni3detr/ov_uni3detr_synthetic_tiny.py")
ATOL = 1e-4
N_SCENES, BATCH = 5, 2


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """torch on two threads: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup():
    jc = jconfig.load_config(TINY)
    jmc = jconfig.build_model_config(jc)
    tc = tconfig.load_config(TINY)
    tmc = tconfig.build_model_config(tc)
    v = import_torch_state_dict(
        make_state_dict(jmc, np.random.RandomState(7)), jmc)
    model = Uni3DETR(tmc).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, jmc).items()}, strict=True)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"], constants={})
    return dict(jc=jc, jmc=jmc, tc=tc, tmc=tmc, model=model, state=state,
                eval_fn=make_eval_step(jmc))


def _jax_random_points(n_draws, B, nq):
    """The points JAX's run_inference draws: one split of PRNGKey(0) a
    batch and view, in that order."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n_draws):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, (B, nq, 3))))
    return out


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_run_inference_matches_jax(setup, tta):
    s = setup
    grid = make_aug_grid(flips=(False, True)) if tta else None
    jds = jdatasets.build_dataset(s["jc"].data, s["jc"].class_names,
                                  s["jmc"].pc_range, "val")
    tds = tdatasets.build_dataset(s["tc"].data, s["tc"].class_names,
                                  s["tmc"].pc_range, "val")
    jd, jg = jevaluator.run_inference(
        jds, s["state"], s["eval_fn"], s["jmc"], batch_size=BATCH,
        max_samples=N_SCENES, tta_grid=grid)
    views = len(grid) if tta else 1
    rps = _jax_random_points(-(-N_SCENES // BATCH) * views, BATCH,
                             s["jmc"].num_query)
    stats = {}
    td, tg = tevaluator.run_inference(
        tds, s["model"], s["tmc"], device="cpu", batch_size=BATCH,
        max_samples=N_SCENES, tta_grid=grid,
        random_points=lambda k, a: rps[k * views + a], stats=stats)
    assert len(td) == len(jd) == N_SCENES
    assert stats["batches"] == 3 and len(stats["load_ms"]) == 3
    for i, (t, j) in enumerate(zip(td, jd)):
        assert set(t) == set(j) == {"boxes", "scores", "labels"}
        np.testing.assert_array_equal(t["labels"], j["labels"], err_msg=i)
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(t["boxes"], j["boxes"], rtol=0,
                                   atol=ATOL)
        assert t["boxes"].dtype == np.float32 and len(t["scores"]) > 0
    for t, j in zip(tg, jg):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])


def test_run_inference_refuses_tta_on_ov():
    tc = tconfig.load_config(OV_TINY)
    mc = tconfig.build_model_config(tc)
    with pytest.raises(ValueError, match="lidar-only"):
        tevaluator.run_inference([], None, mc, device="cpu",
                                 tta_grid=make_aug_grid(flips=(False,
                                                               True)))


@pytest.mark.parametrize("config", [TINY, OV_TINY], ids=["lidar", "ov"])
def test_cli_end_to_end_on_cpu(tmp_path, config):
    out = str(tmp_path / "dets.pkl")
    show = tmp_path / "show"
    r = cli_test.main([config, "--eval", "bbox", "--max-samples", "2",
                       "--out", out, "--show-dir", str(show),
                       "--device", "cpu"])
    with open(out, "rb") as f:
        dets = pickle.load(f)
    assert len(dets) == len(r["dets"]) == 2
    for d, e in zip(dets, r["dets"]):
        np.testing.assert_array_equal(d["boxes"], e["boxes"])
        assert len(d["scores"]) > 0 and np.isfinite(d["boxes"]).all()
    assert len(os.listdir(show)) == 2
    assert "mAP_0.25" in r["metrics"]
    assert eval_metric.main([config, out, "--device", "cpu"]) == r["metrics"]


def test_cli_needs_a_card_or_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli_test.main([TINY, "--eval", "bbox"])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        eval_metric.main([TINY, "dets.pkl"])
    assert e.value.code not in (0, None)
    with pytest.raises(NotImplementedError, match="DDP"):
        cli_test.main([TINY, "--num-processes", "2", "--device", "cpu"])


def test_cli_model_reads_checkpoint_and_zeroshot(setup, tmp_path):
    """``cli.test``'s model: a port checkpoint's weights bit for bit, and
    the CLIP text embeddings of ``zeroshot_path`` (unit rows, stored
    transposed) where the config names one."""
    import dataclasses
    from uni3detr_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "ckpt"), setup["model"])
    again = cli_test.build_model(setup["tmc"], str(tmp_path / "ckpt"),
                                 "cpu", log=lambda *a: None)
    for k, v in setup["model"].state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    mc = tconfig.build_model_config(tconfig.load_config(OV_TINY))
    zs = np.random.RandomState(0).randn(mc.num_classes, mc.clip_dim)
    np.save(tmp_path / "zs.npy", zs)
    mz = dataclasses.replace(mc, zeroshot_path=str(tmp_path / "zs.npy"))
    model = cli_test.build_model(mz, device="cpu", log=lambda *a: None)
    want = zs / np.linalg.norm(zs, axis=1, keepdims=True)
    np.testing.assert_allclose(model.pts_bbox_head.zs_weights.numpy(),
                               want.T, rtol=1e-6, atol=1e-7)
