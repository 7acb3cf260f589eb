"""The port's spans and counters (``utils/profiling.py``): nothing at all
with no profiler running; with one, nested spans, iterations, self time,
the ring of iterations, the counters against hand counts on a tiny
forward and train step, and span names the benchmark's trace takes for
annotations (CPU; no JAX).

    python -m pytest tests/test_torch_port_tracing.py -q
"""
from __future__ import annotations

import importlib.util
import os
import re
import sys
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from uni3detr_tpu_torch import presets
from uni3detr_tpu_torch.models.detector import Uni3DETR
from uni3detr_tpu_torch.ops import matching, nms
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.train.coder import decode_predictions, post_process
from uni3detr_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "uni3detr_tpu_torch")
CPU = torch.profiler.ProfilerActivity.CPU


def _profiled():
    return torch.profiler.profile(activities=[CPU])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_runs_no_tensor_operation():
    rec = profiling.Recorder()
    mask = torch.ones(2, 5, dtype=torch.bool)
    with _Ops() as seen:
        first = rec.span("train_step")
        with first:
            with rec.span("loss"):
                rec.count("voxels_kept", mask)
                rec.count("auction_rounds", 3, max)
        assert rec.span("forward") is first
        profiling.count("nms_in", mask)
        with profiling.span("forward"):
            pass
    assert seen.ops == []
    assert len(rec.iterations) == 0
    assert rec.report() == {"iterations": 0, "host_ms": 0.0, "spans": {},
                            "counts": {}}


def test_nested_spans_carry_parent_iteration_and_self_time():
    rec = profiling.Recorder()
    with _profiled():
        with rec.span("train_step") as step:
            with rec.span("loss") as loss:
                time.sleep(0.002)
                with rec.span("matching") as match:
                    time.sleep(0.003)
            with rec.span("backward") as back:
                time.sleep(0.002)
    assert step.parent is None and loss.parent is step
    assert match.parent is loss and back.parent is step
    assert {s.iteration for s in (step, loss, match, back)} == {0}
    rep = rec.report()
    ms = {n: v["stream_ms"] for n, v in rep["spans"].items()}
    self_ms = {n: v["self_stream_ms"] for n, v in rep["spans"].items()}
    assert rep["iterations"] == 1
    assert ms["matching"] >= 3.0 and ms["loss"] >= 5.0
    assert self_ms["matching"] == ms["matching"]
    assert self_ms["loss"] == pytest.approx(ms["loss"] - ms["matching"])
    assert self_ms["train_step"] == pytest.approx(
        ms["train_step"] - ms["loss"] - ms["backward"])
    # the host's clock: the outermost span's ms is the iteration's
    assert rep["host_ms"] == rep["spans"]["train_step"]["host_ms"] >= 7.0


def test_iterations_group_decode_and_nms_under_their_forward():
    rec = profiling.Recorder()
    with _profiled():
        for _ in range(2):
            with rec.span("forward"):
                with rec.span("head"):
                    pass
            with rec.span("decode"):
                pass
            with rec.span("post_process"):
                with rec.span("nms"):
                    rec.count("nms_kept", torch.tensor([[True, False]]))
        with rec.span("train_step"):
            with rec.span("forward"):      # inside a step: not a root
                pass
    names = [[s.name for s in it.spans] for it in rec.iterations]
    assert names == [["forward", "head", "decode", "post_process", "nms"]] \
        * 2 + [["train_step", "forward"]]
    assert [it.index for it in rec.iterations] == [0, 1, 2]
    rep = rec.report(slice(0, 2))
    assert rep["iterations"] == 2
    assert [s.name for s in rec.iterations[0].spans].count("nms") == 1
    assert rep["counts"] == {"nms_kept": 1.0}
    assert rep["host_ms"] == pytest.approx(sum(
        rep["spans"][n]["host_ms"] for n in ("forward", "decode",
                                             "post_process")))


def test_the_ring_keeps_the_last_iterations():
    rec = profiling.Recorder()
    with _profiled():
        for i in range(profiling.KEEP + 6):
            with rec.span("forward"):
                rec.count("voxels_kept", i)
    assert len(rec.iterations) == profiling.KEEP
    assert rec.iterations[0].index == 6
    last = rec.report(slice(-3, None))
    assert last["iterations"] == 3
    assert last["counts"]["voxels_kept"] == pytest.approx(
        sum(range(profiling.KEEP + 3, profiling.KEEP + 6)) / 3)
    assert rec.report()["iterations"] == profiling.KEEP
    rec.reset()
    assert rec.report()["iterations"] == 0


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = presets.TINY_SYNTHETIC
    B, P = 2, cfg.num_points
    lo = torch.tensor(cfg.pc_range[:3])
    hi = torch.tensor(cfg.pc_range[3:])
    pts = torch.cat([lo + (hi - lo) * torch.rand(B, P, 3),
                     torch.rand(B, P, cfg.in_point_features - 3)], -1)
    mask = torch.ones(B, P, dtype=torch.bool)
    mask[1, 200:] = False          # scene 1 leaves the voxel budget room
    gt = torch.zeros(B, 3, 7)
    gt[..., :3] = lo + (hi - lo) * torch.rand(B, 3, 3)
    gt[..., 3:6] = 0.5
    batch = {"points": pts, "pts_mask": mask, "gt_boxes": gt,
             "gt_labels": torch.tensor([[0, 1, 2], [2, 1, 0]]),
             "gt_mask": torch.tensor([[True, True, True],
                                      [True, True, False]])}
    return cfg, Uni3DETR(cfg), batch


def test_counters_of_a_forward_equal_hand_counts(tiny, monkeypatch):
    cfg, model, batch = tiny
    model.eval()
    pts, mask = batch["points"], batch["pts_mask"]
    rp = torch.rand(pts.shape[0], cfg.num_query, 3)
    kept = []

    def nms_keep(*args, **kw):
        kept.append(nms.nms_keep(*args, **kw))
        return kept[-1]

    monkeypatch.setattr("uni3detr_tpu_torch.train.coder.nms_keep", nms_keep)
    with torch.no_grad():
        plain, inter = model(pts, mask, rp, return_intermediates=True)
        decoded = decode_predictions(plain, cfg)
        profiling.RECORDER.reset()
        with _profiled():
            outs = model(pts, mask, rp)
            post_process(*decode_predictions(outs, cfg), cfg)
    for k in plain:
        assert torch.equal(outs[k], plain[k]), k
    counts = profiling.report()["counts"]
    vmask = inter["vmask"]
    assert counts["voxels_kept"] == vmask.sum().item()
    assert counts["voxel_budget_full"] == 1 == vmask.all(-1).sum().item()
    sets = model.pts_middle_encoder.site_sets(inter["coords"], vmask)
    for i, s in enumerate(sets[1:], 2):
        assert counts[f"sites.encoder_layer{i}"] == s["mask"].sum().item()
        assert counts[f"site_budget_full.encoder_layer{i}"] == \
            (s["mask"].sum(-1) == s["n_sites"]).sum().item()
    assert counts["nms_in"] == decoded[3].sum().item()
    assert counts["nms_kept"] == kept[-1].sum().item() > 0
    assert counts["nms_kept"] <= counts["nms_in"]


def test_counters_of_a_train_step_equal_hand_counts(tiny, monkeypatch):
    cfg, model, batch = tiny
    problems = []
    auction = matching.auction_lap

    def watched(benefit, spread, eps_div, **kw):
        problems.append((benefit.clone(), spread.clone(), eps_div))
        return auction(benefit, spread, eps_div, **kw)

    monkeypatch.setattr(matching, "auction_lap", watched)
    opt = tstep.make_optimizer(model, 1e-4)
    profiling.RECORDER.reset()
    with _profiled():
        tstep.train_step(model, opt, batch)
    rep = profiling.report()
    assert rep["iterations"] == 1 and len(problems) == 1
    _, counts = matching.auction_lap_plain(*problems[0], return_counts=True)
    assert rep["counts"]["auction_rounds"] == counts[:, 0].max().item() > 0
    assert rep["counts"]["auction_bids"] == counts[:, 1].sum().item()
    spans = rep["spans"]
    opened = [s.name for s in profiling.RECORDER.iterations[0].spans]
    for name in ("train_step", "forward", "loss", "matching", "backward",
                 "optimizer"):
        assert opened.count(name) == 1, name
    assert spans["train_step"]["stream_ms"] >= sum(
        spans[n]["stream_ms"] for n in ("forward", "loss", "backward",
                                        "optimizer"))


def _bench_trace():
    bench = os.path.join(ROOT, "benchmark")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_trace_for_port_tests",
            os.path.join(bench, "bench_trace.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod


def test_every_span_name_is_an_annotation_of_the_benchmark(tiny):
    """The names in the port's source, and those a train step and an
    evaluation open under a profiler, are one set, and the benchmark's
    trace takes each for an annotation, not device work."""
    cfg, model, batch = tiny
    in_source = set()
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    in_source |= set(re.findall(r'\bspan\("([^"]+)"\)',
                                                fh.read()))
    opt = tstep.make_optimizer(model, 1e-4)
    with _profiled() as prof:
        tstep.train_step(model, opt, batch)
        model.eval()
        with torch.no_grad():
            outs = model(batch["points"], batch["pts_mask"],
                         torch.rand(2, cfg.num_query, 3))
            post_process(*decode_predictions(outs, cfg), cfg)
    opened = {e.name for e in prof.events()
              if e.name.startswith(profiling.STAGE_PREFIX)}
    assert opened == {profiling.STAGE_PREFIX + n for n in in_source}
    assert len(opened) == 15
    bench_trace = _bench_trace()
    assert all(bench_trace._annotation(n) for n in opened)
    assert bench_trace.STAGE_SPAN == profiling.STAGE_PREFIX
