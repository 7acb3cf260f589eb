"""FLOPs, traces, spans and counters of the port (after
``uni3detr_tpu/utils/profiling.py``, where XLA's cost analysis and the
JAX profiler serve):

- :func:`flops_of` runs a function once and counts its FLOPs, the bytes
  it moves and its peak device memory;
- :func:`trace_context` records a ``torch.profiler`` trace (Chrome /
  TensorBoard JSON) of a block;
- :func:`span` and :func:`count` mark the layers of the hot path and
  count what they keep and drop, while a profiler runs;
  :func:`report` reads them back.

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s (2 a
multiply-add of products and convolutions; elementwise work is not
counted), plus what each kernel launch records (``ops.cost``: its plain
version's count on the same shapes). The CPU's flash-attention op, which
``FlopCounterMode`` has no formula for, counts as the card's attention
does, so a count taken on the card equals one taken on the CPU.

Bytes follow XLA's "bytes accessed": each dispatched operation's operand
and result bytes, summed (views and allocations move none), plus each
kernel launch's operands and results. The plain versions on the CPU
materialise what the kernels keep on chip, so the CPU's figure is larger
than the card's; the JAX package's figures count XLA's fused
computations and compare with neither.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.autograd import _profiler_enabled
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, sdpa_flop_count

_aten = torch.ops.aten
# dispatched operations that move no bytes: allocations and the views
# that PyTorch does not mark as views
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten._unsafe_view.default,
             _aten.lift_fresh.default}


def _cpu_flash_attention_flops(query_shape, key_shape, value_shape, *args,
                               out_shape=None, **kwargs):
    """The CPU's ``_scaled_dot_product_flash_attention_for_cpu``, counted
    as ``FlopCounterMode`` counts the card's flash attention."""
    return sdpa_flop_count(query_shape, key_shape, value_shape)


_CUSTOM_FLOPS = {
    _aten._scaled_dot_product_flash_attention_for_cpu:
        _cpu_flash_attention_flops}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums each dispatched operation's operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (getattr(func, "is_view", False) or func in _NO_BYTES):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def flops_of(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return ``{"flops",
    "bytes_accessed", "peak_memory_bytes", "kernels", "output"}``:
    FLOPs and bytes as the module docstring defines them, the kernels'
    share by wrapper name (``ops.cost.KernelCost.by_name``), and the
    peak of the card's allocated memory over the call
    (``torch.cuda.max_memory_allocated``; -1 when no argument, and no
    parameter of an ``nn.Module`` ``fn``, lies on a CUDA device)."""
    from ..ops import cost

    leaves = tree_flatten((args, kwargs))[0]
    if isinstance(fn, torch.nn.Module):
        leaves += list(fn.parameters())
    on_card = any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with cost.counting() as kernels, FlopCounterMode(
            display=False, custom_mapping=_CUSTOM_FLOPS) as counter, \
            _BytesMode() as moved:
        output = fn(*args, **kwargs)
    peak = -1
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    return {"flops": counter.get_total_flops() + kernels.flops,
            "bytes_accessed": moved.bytes + kernels.bytes,
            "peak_memory_bytes": peak, "kernels": kernels.by_name,
            "output": output}


@contextlib.contextmanager
def trace_context(logdir: str):
    """``with trace_context(dir) as prof:`` records the block's host and
    (when a card is there) device activity with ``torch.profiler`` and
    writes it under ``dir`` as ``<worker>.<time>.pt.trace.json`` (Chrome
    trace format, which TensorBoard's profiler plugin and Perfetto read);
    ``prof.key_averages()`` is there after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def trace_kernel_counts(logdir: str, prefix: str = "u3d_"):
    """(path, {kernel name: launches}) of the newest trace that
    :func:`trace_context` wrote under ``logdir``: its device kernel
    events whose name holds ``prefix`` (the port's kernels by default,
    ``ops.cuda_lib.KERNEL_PREFIX``)."""
    path = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "kernel" and prefix in e.get("name", ""):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return path, counts


# -- spans and counters -------------------------------------------------------
#
# Spans and counters record only while a torch profiler runs (any
# ``torch.profiler.profile``, ``trace_context`` or ``emit_nvtx``): with
# none running, ``span`` hands back one shared null context and ``count``
# returns at once, with no tensor operation and no allocation, so the hot
# path pays one check of the profiler's state for each.

STAGE_PREFIX = "stage:"
"""The prefix of every span's ``record_function`` name. The benchmark
(``benchmark/bench_trace.py``) takes names so prefixed for annotations,
not device work: it keeps them off the device's busy time and launch
count, and labels each idle gap of the device with the one the host was
in at the gap's middle."""

# a span of one of these names, opened while no span is open, begins an
# iteration: a train step, or a forward outside one
ROOT_SPANS = ("train_step", "forward")
# the iterations a recorder keeps, the newest
KEEP = 64
_OFF = contextlib.nullcontext()


def _mark():
    """A point on the current stream: a recorded CUDA event once CUDA is
    in use, else the host's clock in seconds."""
    if torch.cuda.is_initialized():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class _Iteration:
    def __init__(self, index: int):
        self.index = index
        self.spans = []     # in the order they opened
        self.counts = {}    # name -> [(value, reduce)]


class _Span:
    """One span while a profiler runs: a ``record_function`` named
    ``STAGE_PREFIX + name`` (on the profiler's clock; an NVTX range under
    ``emit_nvtx``), the host's clock and two marks on the stream."""

    __slots__ = ("rec", "name", "parent", "iteration", "host", "stream",
                 "_rf")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name
        self.host = self.stream = None

    def __enter__(self):
        rec = self.rec
        self.parent = rec._open[-1] if rec._open else None
        it = rec._current(self.parent is None and self.name in ROOT_SPANS)
        self.iteration = it.index
        it.spans.append(self)
        self._rf = torch.profiler.record_function(STAGE_PREFIX + self.name)
        self._rf.__enter__()
        rec._open.append(self)
        self.stream = (_mark(), None)
        self.host = (time.perf_counter(), None)
        return self

    def __exit__(self, *exc):
        self.host = (self.host[0], time.perf_counter())
        self.stream = (self.stream[0], _mark())
        self.rec._open.remove(self)
        self._rf.__exit__(*exc)
        return False


class Recorder:
    """Spans and counters of the last ``keep`` iterations.

    An iteration begins at a root span (``ROOT_SPANS``) opened while no
    span is open; spans and counts that come after it, up to the next
    root, belong to it (in evaluation: the decode and the NMS after a
    forward)."""

    def __init__(self, keep: int = KEEP):
        self.iterations = collections.deque(maxlen=keep)
        self._open = []     # the open spans, innermost last
        self._next = 0

    def _current(self, root: bool = False) -> _Iteration:
        if root or not self.iterations:
            self.iterations.append(_Iteration(self._next))
            self._next += 1
        return self.iterations[-1]

    def span(self, name: str):
        """``with span(name):`` marks a layer of the hot path."""
        if not _profiler_enabled():
            return _OFF
        return _Span(self, name)

    def count(self, name: str, value, reduce: Callable = torch.sum) -> None:
        """Adds ``value`` (an int, or a tensor the program computed anyway)
        to the iteration's counter ``name``. A tensor is kept and turned
        into a number by ``reduce`` when the record is read, never here, so
        that counting launches nothing. Counts of one name in one iteration
        add up."""
        if not _profiler_enabled():
            return
        self._current().counts.setdefault(name, []).append((value, reduce))

    def reset(self) -> None:
        self.iterations.clear()

    def report(self, iterations: slice = slice(None)) -> dict:
        """The mean a iteration over the kept iterations, or the
        ``iterations`` slice of them (oldest first):

        ``{"iterations": n, "host_ms": host ms of the iterations'
        outermost spans, "spans": {name: {"stream_ms", "host_ms",
        "self_stream_ms"}}, "counts": {name: total}}``.

        ``stream_ms`` is the stream's time between the span's marks (CUDA
        events; the host's clock before CUDA is in use), ``self_stream_ms``
        that less its child spans' ``stream_ms``. Waits for the device."""
        its = list(self.iterations)[iterations]
        closed = [s for it in its for s in it.spans
                  if s.host[1] is not None]
        if torch.cuda.is_initialized() and any(
                not isinstance(s.stream[0], float) for s in closed):
            torch.cuda.synchronize()
        n = max(len(its), 1)
        spans, inner = {}, collections.Counter()
        for s in closed:
            ms = _ms(*s.stream)
            if s.parent is not None:
                inner[id(s.parent)] += ms
        host = 0.0
        for s in closed:
            ms = _ms(*s.stream)
            h = (s.host[1] - s.host[0]) * 1e3
            if s.parent is None:
                host += h
            r = spans.setdefault(s.name, dict.fromkeys(
                ("stream_ms", "host_ms", "self_stream_ms"), 0.0))
            r["stream_ms"] += ms / n
            r["host_ms"] += h / n
            r["self_stream_ms"] += (ms - inner[id(s)]) / n
        counts = collections.Counter()
        for it in its:
            for name, values in it.counts.items():
                counts[name] += sum(_reduce(v, how) for v, how in values) / n
        return {"iterations": len(its), "host_ms": host / n, "spans": spans,
                "counts": dict(counts)}


def _reduce(value, reduce):
    return reduce(value).item() if isinstance(value, torch.Tensor) \
        else value


def full_rows(mask: torch.Tensor) -> torch.Tensor:
    """The rows of ``mask`` whose entries are all true: the scenes whose
    budget of rows ran full, a ``reduce`` for :func:`count`."""
    return mask.all(-1).sum()


RECORDER = Recorder()
"""The process's recorder, which the port's spans and counts feed."""


def span(name: str):
    """``RECORDER.span``: a null context unless a profiler runs."""
    return RECORDER.span(name)


def count(name: str, value, reduce: Callable = torch.sum) -> None:
    """``RECORDER.count``: nothing unless a profiler runs."""
    RECORDER.count(name, value, reduce)


def report(iterations: slice = slice(None)) -> dict:
    """``RECORDER.report``: the spans and counters of the port's last
    iterations."""
    return RECORDER.report(iterations)
