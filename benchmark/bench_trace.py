"""The traced part of a ``--trace 1`` run, in three phases of the window
(``Tracer``): stage times from CUDA events recorded at module hooks, with
no profiler running; the device's kernels from ``torch.profiler``
tracing the device alone (CUPTI), which adds little host time; and a
short profile of host and device together, whose host spans name what
the host was doing in each of the device's idle gaps.

Stages (the layers of ``PERF.md``), each the stream's time between two
events: the model family's ``STAGE_MODULES``, each from the end of the
one before (the first from the detector's forward pre-hook) to its
module's end (``uni3detr``: ``encoder``, voxelize + sparse encoder, to
``pts_middle_encoder``'s end; ``backbone_neck`` to ``pts_neck``'s end;
``head``, FPS and ``pts_bbox_head``, to the head's end), then from the
last one's end ``postprocess`` (decode + NMS, to the return of
``post_process``) in inference and ``after_forward`` (loss, matching,
backward, optimizer, to the return of ``train_step``) in training.
"""
from __future__ import annotations

import collections
import statistics
import time

import torch

import bench_count

# the port's kernels carry this prefix (``ops/cuda_lib.py``); a profiler
# shows them demangled, ``void u3d_...<...>(...)``
PORT_PREFIX = "u3d_"


class _HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event`` where there is no
    card (the CPU tests of the harness)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class StageClock:
    """Records, while armed, one CUDA event at each stage boundary of an
    iteration, ``stages`` being the family's ``STAGE_MODULES``;
    ``mark(name)`` adds the events recorded after a call returns."""

    AFTER = ("postprocess", "after_forward")

    def __init__(self, model, device, stages):
        self.cuda = device.type == "cuda"
        self.armed = False       # record events
        self.spans = False       # open record_function spans
        self.iters = []
        self._spans = []
        self.order = ["start"] + [s for s, _ in stages] + list(self.AFTER)
        self._handles = [model.register_forward_pre_hook(self._start)]
        for stage, mod in stages:
            m = getattr(model, mod)
            self._handles.append(m.register_forward_pre_hook(
                lambda *_, s=stage: self._open(s)))
            self._handles.append(m.register_forward_hook(
                lambda *_, s=stage: self._close(s)))

    def _event(self, name):
        if self.armed:
            e = torch.cuda.Event(enable_timing=True) if self.cuda \
                else _HostEvent()
            e.record()
            self.iters[-1][name] = e

    def _start(self, *_):
        if self.armed:
            self.iters.append({})
            self._event("start")

    def _open(self, stage):
        if self.spans:
            rf = torch.profiler.record_function(STAGE_SPAN + stage)
            rf.__enter__()
            self._spans.append(rf)

    def _close(self, stage):
        if self.spans:
            self._spans.pop().__exit__(None, None, None)
        self._event(stage)

    def mark(self, name):
        self._event(name)

    def remove(self):
        for h in self._handles:
            h.remove()

    def stage_ms(self):
        """Mean stream ms a iteration of each stage."""
        last = self.order[-len(self.AFTER) - 1]
        out = collections.defaultdict(list)
        for it in self.iters:
            names = [n for n in self.order if n in it]
            prev = names[0]
            for n in names[1:]:
                base = last if n in self.AFTER else prev
                out[n].append(it[base].elapsed_time(it[n]))
                prev = n
        return {k: statistics.fmean(v) for k, v in out.items()}


WINDOW_SPAN = "bench_window"
STAGE_SPAN = "stage:"


def _annotation(name):
    """The benchmark's own spans, which the profiler also lays on the
    device's timeline."""
    return name == WINDOW_SPAN or name.startswith(STAGE_SPAN)


def _union(intervals):
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals, lo, hi):
    """Idle intervals of the device inside [lo, hi]."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def _device_events(prof):
    """(name, start, end) of every operation on the device, the
    benchmark's own spans left out."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not _annotation(e.name)]


class TraceData:
    """What the per-layer readers read: ``iters`` iterations whose device
    activity ``kernels`` traced over ``window_s`` seconds (``busy_s`` of
    them with an operation on the device), their kernels by name, the
    stage ms of the clock's iterations, the cell's inputs in those
    iterations for the readers' counts (``work``, a
    ``bench_count.Work``), the host-labelled
    idle gaps of the ``host`` profile, and the run's frame times."""

    def __init__(self, kernels, host, clock, iters, window_s, work,
                 frames_s):
        self.iters = iters
        self.work = work
        self.frames_s = frames_s
        self.stages = clock.stage_ms()
        dev = _device_events(kernels)
        self.window_s = window_s
        self.busy_s = _union([(s, t) for _, s, t in dev]) * 1e-6
        self.kernels = [(n, s, t) for n, s, t in dev
                        if not n.startswith(("Memcpy", "Memset"))]
        by = collections.Counter()
        for n, s, t in dev:
            by[n] += (t - s) * 1e-6
        self.device_ops = by
        win = [e for e in host.events() if e.name == WINDOW_SPAN
               and e.device_type == torch.autograd.DeviceType.CPU]
        if not win:
            raise RuntimeError("trace: no bench_window span")
        lo, hi = win[0].time_range.start, win[0].time_range.end
        hdev = [(s, t) for _, s, t in _device_events(host)]
        cpu = [e for e in host.events()
               if e.device_type == torch.autograd.DeviceType.CPU]
        gaps = sorted(_gaps(hdev, lo, hi), key=lambda g: g[0] - g[1])[:10]
        self.idle_gaps = [[self._host_at(cpu, g), (g[1] - g[0]) * 1e-6]
                          for g in gaps]

    @staticmethod
    def _host_at(host, gap):
        """The stage span and innermost host op running at a gap's
        middle."""
        mid = (gap[0] + gap[1]) / 2
        stage, op, best = "outside stages", "idle host", None
        for e in host:
            if e.name == WINDOW_SPAN:
                continue
            if e.time_range.start <= mid <= e.time_range.end:
                if e.name.startswith(STAGE_SPAN):
                    stage = e.name[len(STAGE_SPAN):]
                elif best is None or e.time_range.start > best:
                    op, best = e.name, e.time_range.start
        return f"{stage}: {op}"

    def port_launches(self):
        return sum(1 for n, _, _ in self.kernels if PORT_PREFIX in n)

    def device_s(self, kernels):
        """Device seconds of the kernels whose names hold one of
        ``kernels``."""
        return sum(t - s for n, s, t in self.kernels
                   if any(k in n for k in kernels)) * 1e-6

    def stage_ms(self, stage):
        return self.stages.get(stage)

    def launches_per_iter(self):
        return len(self.kernels) / self.iters

    def roofline(self, kernels, least_s):
        """``least_s``, the least seconds of ``kernels`` an iteration (a
        function of ``bench_count.Work`` and an iteration's counts), over
        their device seconds in the trace, as a percentage; None when the
        trace holds none of them."""
        dev = self.device_s(kernels)
        if dev <= 0:
            return None
        return 100.0 * self.work.per_iter(least_s) * self.iters / dev

    def mfu(self, flops):
        """``flops`` (as ``least_s`` above) of the traced iterations over
        the window's seconds times the bf16 dense peak, as a percentage."""
        return 100.0 * self.work.per_iter(flops) * self.iters / (
            self.window_s * bench_count.H100_PEAK_OPS["bf16"])

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def frame_ms_p50(self):
        return statistics.median(self.frames_s) * 1e3 if self.frames_s \
            else None

    def breakdown(self):
        return {"device_ops": [[n, s] for n, s in
                               self.device_ops.most_common(10)],
                "idle_gaps": self.idle_gaps}
