"""The port trains to the JAX package's accuracy bars, on the CPU.

- slow (``pytest -m slow``, as the JAX package's
  ``tests/test_cli_overfit.py``): the two shipped convergence configs
  through ``cli.train --device cpu`` as shipped (600 and 650 steps, seed
  0, from ``weights.init_state_dict``), then ``cli.test <cfg>
  <wd>/latest --eval bbox --device cpu``: Lidar mAP@0.25 and mAP@0.50 at
  least 0.9, OV mAP@0.25 at least 0.9, the JAX package's bars; torch on
  two threads;
- tier 1: the first ten steps of ``uni3detr_synthetic_overfit.py``. Both
  packages start from JAX's ``create_train_state`` for the config's
  preset (carried across by ``state_dict_from_jax``), with dropout 0 and
  scipy's matcher on both sides; the config's two scenes go through each
  package's train pipeline and collate to equal batches. JAX takes ten
  steps under the config's AdamW, clip and step schedule; from each of
  its ten states (parameters, BN statistics, Adam's moments and count)
  the port takes one step of its own ``train_step`` under
  ``cli.train.build_optimizer``. Every logged loss term and the gradient
  norm must lie within twice the JAX package's own spread over the ten
  steps: the largest gap between its step and its step from the same
  state with every parameter nudged by a relative 1e-6 (signs from
  ``RandomState(1)``). The same rule holds the update: a step's
  parameter entries whose update differs from JAX's by more than 0.01
  lr, at most twice the most the nudged step moves. Measured on an
  8-core x86 CPU: the port's largest loss gap is 0.29 of its floor
  (``d0.loss_iou``: 4.8e-7 against 1.7e-6; ``total_loss``: 9.5e-7
  against 5.7e-6); its updates move 31-63 entries a step, the nudge's
  31-601 (floor 1202), and an Adam eps of 1e-7 in place of 1e-8 moves
  736-2246. Each step starts from JAX's
  state because the free-running trajectories part after the third
  step, as JAX's own does from its nudged start: Adam's first steps move
  every entry by about the lr whatever its gradient's size, so the few
  entries whose gradient is rounding noise (the self-attention key
  biases, a few sparse-conv taps) step either way, 20 entries beyond 0.1
  lr after the first step for the port and 19 for the nudge, and the
  losses differ by up to 0.15 (the port) and 0.09 (six nudges) by the
  tenth.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uni3detr_tpu import config as jconfig
from uni3detr_tpu.data import datasets as jdatasets
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu_torch import config_file as tconfig
from uni3detr_tpu_torch.cli import test as cli_test
from uni3detr_tpu_torch.cli import train as cli_train
from uni3detr_tpu_torch.data import datasets as tdatasets
from uni3detr_tpu_torch.models.detector import Uni3DETR
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import state_dict_from_jax

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LIDAR = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_overfit.py")
OV = os.path.join(ROOT, "configs/ov_uni3detr/ov_uni3detr_synthetic_overfit.py")
STEPS = 10
NUDGE = 1e-6
UPDATE_TOL = 0.01       # of the step's lr


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


# -- the shipped convergence configs through the CLIs (slow) ------------------

def _train_and_test(config, wd):
    r = cli_train.main([config, "--work-dir", wd, "--device", "cpu"])
    assert os.path.isdir(os.path.join(wd, "latest"))
    res = cli_test.main([config, os.path.join(wd, "latest"), "--eval", "bbox",
                         "--device", "cpu"])
    return r, res["metrics"]


@pytest.mark.slow
def test_cli_overfit_lidar(tmp_path):
    r, m = _train_and_test(LIDAR, str(tmp_path / "wd"))
    assert r["step"] == 600
    assert m["mAP_0.25"] >= 0.9, m
    assert m["mAP_0.50"] >= 0.9, m


@pytest.mark.slow
def test_cli_overfit_ov_multimodal(tmp_path):
    r, m = _train_and_test(OV, str(tmp_path / "wd"))
    assert r["step"] == 650
    assert m["mAP_0.25"] >= 0.9, m


# -- ten steps of the Lidar config in both packages (tier 1) ------------------

def _batches():
    """The config's two scenes through each package's train pipeline,
    collated: (JAX's batch, the port's, the configs)."""
    jc, tc = jconfig.load_config(LIDAR), tconfig.load_config(LIDAR)
    jmc = dataclasses.replace(jconfig.build_model_config(jc), dropout=0.0,
                              matcher="scipy")
    tmc = dataclasses.replace(tconfig.build_model_config(tc), dropout=0.0,
                              matcher="scipy")
    jd = jdatasets.build_dataset(jc.data, jc.class_names, jmc.pc_range,
                                 "train")
    td = tdatasets.build_dataset(tc.data, tc.class_names, tmc.pc_range,
                                 "train")
    assert len(jd) == len(td) == 2
    args = (tmc.num_points, tmc.max_gt, tmc.in_point_features, tmc.code_size)
    jb = jdatasets.collate_batch([jd[0], jd[1]], *args)[0]
    tb = tdatasets.collate_batch([td[0], td[1]], *args)[0]
    return jb, tb, jc, tc, jmc, tmc


def _port_layout(params, batch_stats, jmc):
    v = jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": batch_stats})
    return state_dict_from_jax(v, jmc)


def _port_state(model, opt, jstate, jmc, k):
    """Load JAX's state after ``k`` steps (parameters, BN statistics,
    Adam's moments and count) into the port's model and optimizer."""
    def layout(params):
        return {n: torch.from_numpy(np.array(a)) for n, a in
                _port_layout(params, jstate.batch_stats, jmc).items()}

    model.load_state_dict(layout(jstate.params), strict=True)
    opt.steps = k
    if k:
        adam = jstate.opt_state[1][0]
        mu, nu = layout(adam.mu), layout(adam.nu)
        for name, p in model.named_parameters():
            opt.adamw.state[p] = {"step": torch.tensor(float(k)),
                                  "exp_avg": mu[name],
                                  "exp_avg_sq": nu[name]}


def _moved(got, ref, names, tol):
    """Entries of the parameters ``names`` more than ``tol`` apart."""
    return sum(int((np.abs(np.asarray(got[n]) - ref[n]) > tol).sum())
               for n in names)


def _trajectories():
    """JAX's ten steps from its ``create_train_state``; from each of its
    states, JAX's step with the parameters nudged and the port's step.
    Returns the two collated batches, the three runs' logs (a dict a
    step), and a step's parameter entries whose update differs from
    JAX's by more than UPDATE_TOL x lr, for the port and the nudge."""
    jb, tb, jc, tc, jmc, tmc = _batches()
    opt = jc.get("optimizer", {})
    sched = jstep.step_lr_schedule(opt["lr"], 1, jc["lr_config"]["step"])
    tx = jstep.make_optimizer(sched, opt["weight_decay"], opt["clip_norm"])
    states = [jstep.create_train_state(jmc, jax.random.PRNGKey(0), jb, tx)]
    batch = {k: jnp.asarray(v) for k, v in jb.items()}
    step = jstep.make_train_step(jmc, donate=False)
    key = jax.random.PRNGKey(jc.get("seed", 0) + 1)
    rng = np.random.RandomState(1)
    ref, spread, nudged_next = [], [], []
    for _ in range(STEPS):
        st = states[-1]
        nudged = st.replace(params=jax.tree_util.tree_map(
            lambda p: jnp.asarray((np.asarray(p) * (1 + NUDGE * rng.choice(
                [-1.0, 1.0], p.shape))).astype(p.dtype)), st.params))
        nst, nlogs = step(nudged, batch, key)
        spread.append({k: float(v) for k, v in nlogs.items()})
        nudged_next.append(nst)
        st, logs = step(st, batch, key)
        states.append(st)
        ref.append({k: float(v) for k, v in logs.items()})

    model = Uni3DETR(tmc)
    topt = cli_train.build_optimizer(tc, model, 1)
    tbatch = {k: torch.from_numpy(a) for k, a in tb.items()}
    names = [n for n, _ in model.named_parameters()]
    got, moved = [], {"port": [], "nudge": []}
    for k in range(STEPS):
        _port_state(model, topt, states[k], jmc, k)
        got.append({n: float(v) for n, v in tstep.train_step(
            model, topt, tbatch).items()})
        want = _port_layout(states[k + 1].params, states[k + 1].batch_stats,
                            jmc)
        nst = nudged_next[k]
        tol = UPDATE_TOL * float(sched(k))
        moved["port"].append(_moved(
            {n: p.detach() for n, p in model.named_parameters()}, want,
            names, tol))
        moved["nudge"].append(_moved(_port_layout(
            nst.params, nst.batch_stats, jmc), want, names, tol))
    return jb, tb, ref, spread, got, moved


@pytest.fixture(scope="module")
def trajectories():
    return _trajectories()


def test_train_pipelines_give_equal_batches(trajectories):
    jb, tb = trajectories[:2]
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_ten_steps_within_jax_spread(trajectories):
    _, _, ref, spread, got, _ = trajectories
    assert sorted(got[0]) == sorted(ref[0])
    for k in ref[0]:
        floor = 2 * max(abs(s[k] - r[k]) for s, r in zip(spread, ref))
        gap = max(abs(g[k] - r[k]) for g, r in zip(got, ref))
        assert gap <= floor, (k, gap, floor)
    assert ref[-1]["total_loss"] < ref[0]["total_loss"]


def test_ten_updates_within_jax_spread(trajectories):
    moved = trajectories[-1]
    assert max(moved["port"]) <= 2 * max(moved["nudge"]), moved
