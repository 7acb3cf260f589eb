"""FLOPs, traces and step timing of the port (after
``uni3detr_tpu/utils/profiling.py``, where XLA's cost analysis, the JAX
profiler and the same timer serve):

- :func:`flops_of` runs a function once and counts its FLOPs, the bytes
  it moves and its peak device memory;
- :func:`trace_context` records a ``torch.profiler`` trace (Chrome /
  TensorBoard JSON) of a block;
- :class:`StepTimer` keeps an exponential moving average of step times.

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

import contextlib
import glob
import json
import os
import time
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
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


class StepTimer:
    """Seconds a step as an exponential moving average: ``tick()`` once
    a step; ``dt`` is None until two ticks, then the first interval, then
    ``ema * dt + (1 - ema) * interval``."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._t = None
        self.dt: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._t is not None:
            d = now - self._t
            self.dt = d if self.dt is None else \
                self.ema * self.dt + (1 - self.ema) * d
        self._t = now

    @property
    def steps_per_sec(self):
        return 1.0 / self.dt if self.dt else float("nan")
