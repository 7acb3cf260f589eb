"""``weights.init_state_dict`` (the port's start of training) against the
JAX package's initialisation (``train/step.py::create_train_state``,
flax's ``model.init``), on the CPU.

- ``uni3detr_tiny_synthetic`` and ``ov_uni3detr_tiny_synthetic``: every
  leaf of JAX's ``params`` and ``batch_stats`` (and OV's CLIP embeddings
  in ``constants``), carried into the port's layout by
  ``state_dict_from_jax`` / ``state_dict_from_jax_ov``, against
  ``init_state_dict(model, 0)``: the same keys and shapes; a leaf whose
  JAX entries are all equal planned constant and bit-equal; every other
  leaf planned random, and where it has 256 entries or more, each side's
  mean within 4 sigma / sqrt(n) of 0 (sigma: the plan's std) and the std
  ratio port / JAX in [0.85, 1.15]; truncated-normal leaves within 2
  sigma / 0.8796 on both sides, normal leaves of 256 or more entries
  beyond it on both sides;
- every shipped preset at full width (the six Lidar ones, the tiny ones,
  the three OV ones) and VoVNet-V2-39: every ``state_dict`` key covered
  by a rule, and the plan's constants those that the JAX modules name,
  read here from the keys alone; the flagship's weights drawn and held
  to their plan;
- a leaf no rule covers raises.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.models.detector import Uni3DETR
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
from uni3detr_tpu_torch.models.vovnet import VoVNet
from uni3detr_tpu_torch.synthetic import clustered_train_batch, ov_train_batch
from uni3detr_tpu_torch.weights import (TRUNCATED_STD, init_plan,
                                        init_state_dict, state_dict_from_jax,
                                        state_dict_from_jax_ov)

CLS_PRIOR = np.float32(-np.log(0.99 / 0.01))
MIN_STAT = 256          # entries a leaf needs for the mean and std checks


def _jax_init(name):
    """JAX's ``create_train_state`` of the preset at PRNGKey(0), in the
    port's layout."""
    cfg = jpresets.PRESETS[name]
    tcfg = tpresets.PRESETS[name]
    ov = name.startswith("ov_")
    batch = ov_train_batch(0, tcfg, 1)[0] if ov \
        else clustered_train_batch(0, tcfg, 1)
    state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch,
                                     jstep.make_optimizer(1e-3))
    v = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "constants": state.constants})
    if ov:
        return state_dict_from_jax_ov(v, cfg), OV_Uni3DETR(tcfg)
    return state_dict_from_jax(v, cfg), Uni3DETR(tcfg)


@pytest.fixture(scope="module", params=["uni3detr_tiny_synthetic",
                                        "ov_uni3detr_tiny_synthetic"])
def tiny(request):
    ref, model = _jax_init(request.param)
    return ref, init_plan(model), init_state_dict(model, 0)


def test_tiny_keys_and_shapes_match_jax(tiny):
    ref, plan, got = tiny
    assert sorted(got) == sorted(ref) == sorted(plan)
    for k in ref:
        assert got[k].shape == ref[k].shape, k


def test_tiny_constants_bit_equal_to_jax(tiny):
    ref, plan, got = tiny
    n = 0
    for k, a in ref.items():
        a = np.asarray(a)
        if a.size and (a == a.flat[0]).all() and plan[k].kind == "const":
            np.testing.assert_array_equal(got[k], a, err_msg=k)
            n += 1
        elif a.size > 1 and not (a == a.flat[0]).all():
            assert plan[k].kind != "const", k
        else:
            pytest.fail(f"{k}: JAX holds one value, the plan draws "
                        f"{plan[k]}")
    assert n > 0


def _bound(std):
    return 2.0 * std / TRUNCATED_STD


def test_tiny_random_leaves_match_jax_distribution(tiny):
    ref, plan, got = tiny
    checked = {"truncated": 0, "normal": 0}
    for k, init in plan.items():
        a, b = np.asarray(ref[k], np.float64), got[k].astype(np.float64)
        if init.kind == "unit_columns":         # OV's CLIP embeddings
            for zs in (a, b):
                np.testing.assert_allclose(np.linalg.norm(zs, axis=0), 1.0,
                                           rtol=1e-6, err_msg=k)
        if init.kind in ("const", "unit_columns"):
            continue
        lim = _bound(init.std) * (1 + 1e-6)
        if init.kind == "truncated":
            assert np.abs(a).max() <= lim and np.abs(b).max() <= lim, k
        if a.size < MIN_STAT:
            continue
        checked[init.kind] += 1
        tol = 4 * init.std / np.sqrt(a.size)
        assert abs(a.mean()) <= tol and abs(b.mean()) <= tol, \
            (k, a.mean(), b.mean(), tol)
        assert 0.85 <= b.std() / a.std() <= 1.15, (k, b.std(), a.std())
        if init.kind == "normal":
            assert np.abs(a).max() > lim and np.abs(b).max() > lim, k
    assert checked["truncated"] > 0 and checked["normal"] > 0, checked


# -- every shipped preset at full width -------------------------------------

def _expected_constant(key, lidar_head):
    """The value a JAX module gives ``key`` at init, from the key alone,
    or None for a random leaf: BN statistics 0 and 1, norm scales 1 (the
    port's only 1-D weights), every bias 0 but the Lidar cls branches'
    last (-log(0.99 / 0.01)), the zero cross-attention weights and DCN
    offset convs."""
    if key.endswith(("running_mean", "num_batches_tracked")):
        return 0.0
    if key.endswith("running_var"):
        return 1.0
    if lidar_head and re.fullmatch(r"pts_bbox_head\.cls_branches\.\d+\.6\."
                                   r"bias", key):
        return float(CLS_PRIOR)
    if key.endswith(("bias", "in_proj_bias")):
        return 0.0
    if key.endswith(("attention_weights.weight", "conv_offset.weight")):
        return 0.0
    return None


SHIPPED = [n for n in tpresets.PRESETS] + ["vovnet"]


@pytest.mark.parametrize("name", SHIPPED)
def test_every_preset_covered_with_its_constants(name):
    model = VoVNet() if name == "vovnet" else (
        OV_Uni3DETR if name.startswith("ov_") else Uni3DETR)(
            tpresets.PRESETS[name])
    plan = init_plan(model)
    sd = model.state_dict()
    assert list(plan) == list(sd)
    lidar = name.startswith("uni3detr_")
    n_prior = 0
    for k, init in plan.items():
        want = _expected_constant(k, lidar)
        if want is None and sd[k].dim() == 1 and k.endswith("weight"):
            want = 1.0                              # a norm's scale
        if want is None:
            assert init.kind != "const", (k, init)
            continue
        assert init.kind == "const" and np.float32(init.value) == \
            np.float32(want), (k, init, want)
        n_prior += np.float32(init.value) == CLS_PRIOR
    if lidar:
        assert n_prior == tpresets.PRESETS[name].num_decoder_layers
    else:
        assert n_prior == 0


def test_flagship_draw_follows_its_plan():
    model = Uni3DETR(tpresets.SUNRGBD)
    plan = init_plan(model)
    got = init_state_dict(model, 0)
    again = init_state_dict(model, 0)
    other = init_state_dict(model, 1)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                          strict=True)
    for k, init in plan.items():
        np.testing.assert_array_equal(got[k], again[k], err_msg=k)
        a = got[k].astype(np.float64)
        if init.kind == "const":
            assert (a == np.float32(init.value)).all(), k
            continue
        assert not np.array_equal(got[k], other[k]), k
        if init.kind == "truncated":
            assert np.abs(a).max() <= _bound(init.std) * (1 + 1e-6), k
        if a.size >= MIN_STAT:
            assert 0.85 <= a.std() / init.std <= 1.15, (k, a.std(), init)
            assert abs(a.mean()) <= 4 * init.std / np.sqrt(a.size), k
    assert got["pts_middle_encoder.conv_input.1.num_batches_tracked"].dtype \
        == np.int64


def test_uncovered_leaf_raises():
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.PReLU())
    with pytest.raises(KeyError, match=r"1\.weight.*PReLU"):
        init_plan(model)
    with pytest.raises(KeyError, match=r"1\.weight"):
        init_state_dict(model, 0)


def test_unknown_leaf_of_a_known_module_raises():
    lin = torch.nn.Linear(4, 4)
    lin.register_buffer("scale", torch.ones(4))
    with pytest.raises(KeyError, match="scale"):
        init_plan(torch.nn.Sequential(lin))


def test_attention_and_offsets_zero_at_flagship_width():
    """The constants the cross-attention and the DCN sampling rely on at
    init: zero attention-weight kernels (sigmoid 0.5 for every query) and
    zero DCN offset convs (a plain conv with masks of 0.5)."""
    model = OV_Uni3DETR(tpresets.PRESETS["ov_uni3detr_sunrgbd_rgb"])
    plan = init_plan(model)
    zero = [k for k in plan if k.endswith(("attention_weights.weight",
                                           "attention_weights.bias",
                                           "conv_offset.weight",
                                           "conv_offset.bias"))]
    cfg = tpresets.PRESETS["ov_uni3detr_sunrgbd_rgb"]
    n_dcn = sum(n for n, d in zip((3, 4, 6, 3), cfg.stage_with_dcn) if d)
    assert len(zero) == 2 * cfg.num_decoder_layers + 2 * n_dcn
    assert all(plan[k] == dataclasses.replace(plan[k], kind="const",
                                              value=0.0) for k in zero)
