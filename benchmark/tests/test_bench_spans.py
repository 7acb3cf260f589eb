"""The readers of the port's spans and counters (``bench_spans.py``) in a
traced run, and the trace's handling of the port's spans (CPU).

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import time
import types

import pytest
import torch

import bench_fixtures as fx

# the readers that read the port's record, with their cells' kind
SPAN_METRICS = {
    "train": ("voxelize_ms.train", "matching_ms.train", "loss_ms.train",
              "backward_ms.train", "optimizer_ms.train",
              "host_enqueue_ms.train", "auction_rounds.train"),
    "eval": ("voxelize_ms.infer", "fps_ms.infer", "nms_ms.infer",
             "host_enqueue_ms.infer"),
}


def _traced_run(root, name, monkeypatch):
    """A ``--trace 1`` run of a tiny cell whose iterations each count the
    phase they ran in, into the port's record."""
    import bench_drive
    from uni3detr_tpu_torch.utils import profiling

    after = bench_drive.Tracer.after

    def counted(self, i):
        k = i - self.skip
        if self.n <= k < 2 * self.n:
            profiling.count("phase.device", 1)
        elif k >= 2 * self.n:
            profiling.count("phase.host", 1)
        after(self, i)

    monkeypatch.setattr(bench_drive.Tracer, "after", counted)
    profiling.RECORDER.reset()
    cell = fx.load(root, name)
    r = bench_drive.run(cell, 2 ** 31 + 77, 0.2, True, torch.device("cpu"),
                        time.perf_counter())
    return cell, r["trace"]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_every_span_reader_reads_the_device_profiled_iterations(
        tmp_path, monkeypatch, kind):
    import bench_drive
    import bench_spans
    from uni3detr_tpu_torch.utils import profiling

    root = fx.make_tree(tmp_path)
    cell, t = _traced_run(root, f"tiny.{kind}", monkeypatch)
    listed = {m["name"] for m in cell.per_layer}
    for name in SPAN_METRICS[kind]:
        assert name in listed
        v = cell.reader(name)(t)
        assert isinstance(v, float) and v > 0, (name, v)
    # the record holds the two profiled phases; the readers take the
    # device-only one, every iteration of it and none of the other
    h = bench_drive.Tracer.HOST_ITERS
    assert len(profiling.RECORDER.iterations) == t.iters + h
    rep = bench_spans.report(t)
    assert rep["iterations"] == t.iters
    assert rep["counts"]["phase.device"] == 1.0
    assert "phase.host" not in rep["counts"]
    whole = profiling.report()
    assert whole["counts"]["phase.host"] == pytest.approx(h / (t.iters + h))
    if kind == "train":
        spans = rep["spans"]
        assert cell.reader("loss_ms.train")(t) == pytest.approx(
            spans["loss"]["stream_ms"] - spans["matching"]["stream_ms"])
        assert cell.reader("host_enqueue_ms.train")(t) == \
            spans["train_step"]["host_ms"] == rep["host_ms"]
    else:
        top = ("forward", "decode", "post_process")
        assert cell.reader("host_enqueue_ms.infer")(t) == pytest.approx(
            sum(rep["spans"][s]["host_ms"] for s in top))


def test_a_port_without_the_record_reads_nothing(monkeypatch):
    import bench_spans
    from uni3detr_tpu_torch.utils import profiling

    t = types.SimpleNamespace(iters=4)
    profiling.RECORDER.reset()
    assert bench_spans.span_ms(t, "voxelize") is None
    assert bench_spans.counter(t, "auction_rounds") is None
    assert bench_spans.host_ms(t) is None
    monkeypatch.delattr(profiling, "report")
    assert bench_spans.report(t) is None


class _Event:
    def __init__(self, name, device, start, end):
        self.name = name
        self.device_type = device
        self.time_range = types.SimpleNamespace(start=start, end=end)


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_the_port_spans_are_no_device_work():
    """A device timeline with the port's spans laid on it, as the profiler
    lays ``record_function`` ranges: busy time, launches and idle gaps
    count the kernels alone, and each gap is named by the port's span the
    host was in."""
    import bench_trace
    from uni3detr_tpu_torch.utils import profiling

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    stage = profiling.STAGE_PREFIX
    kernels = [("u3d_gather_conv", 0.0, 10.0), ("gemm", 30.0, 40.0),
               ("u3d_auction_lap", 60.0, 70.0)]
    spans = [(stage + "train_step", 0.0, 100.0),
             (stage + "backward", 12.0, 45.0),
             (stage + "optimizer", 46.0, 100.0)]
    dev = [_Event(n, cuda, s, e) for n, s, e in kernels + spans]
    host = [_Event(bench_trace.WINDOW_SPAN, cpu, 0.0, 100.0)]
    host += [_Event(n, cpu, s, e) for n, s, e in spans]
    host += [_Event(n, cuda, s, e) for n, s, e in kernels + spans]
    clock = types.SimpleNamespace(stage_ms=lambda: {})
    t = bench_trace.TraceData(_Profile(dev), _Profile(host), clock, 1,
                              100e-6, None, [])
    assert t.busy_s == pytest.approx(30e-6)
    assert t.idle_share() == pytest.approx(0.7)
    assert t.launches_per_iter() == 3 and t.port_launches() == 2
    got = sorted((round(d * 1e6), label) for label, d in t.idle_gaps)
    assert got == [(20, "backward: idle host"), (20, "optimizer: idle host"),
                   (30, "optimizer: idle host")]
