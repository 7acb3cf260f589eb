"""The port's own spans and counters in a ``--trace 1`` run, for the
per-layer readers.

The port records them while a torch profiler runs
(``uni3detr_tpu_torch.utils.profiling``), so in the window's second and
third phases (``bench_drive.Tracer``). The readers take the second's
iterations, with only the device profiled: the last ``t.iters +
Tracer.HOST_ITERS`` iterations recorded, less the final ``HOST_ITERS``,
whose host the profile of its operations slows. A port without the
record reads None.
"""
from __future__ import annotations

import bench_drive


def report(t):
    """The port's ``profiling.report`` of the traced run's device-profiled
    iterations, or None."""
    from uni3detr_tpu_torch.utils import profiling
    read = getattr(profiling, "report", None)
    if read is None:
        return None
    h = bench_drive.Tracer.HOST_ITERS
    r = read(slice(-(t.iters + h), -h))
    return r if r["iterations"] == t.iters else None


def span_ms(t, name, key="stream_ms"):
    """``key`` of the port's span ``name`` a iteration: ``stream_ms``,
    ``self_stream_ms`` or ``host_ms``; None where no such span ran."""
    r = report(t)
    s = r["spans"].get(name) if r else None
    return s[key] if s else None


def counter(t, name):
    """The port's counter ``name`` a iteration; None where nothing was
    counted."""
    r = report(t)
    return r["counts"].get(name) if r else None


def host_ms(t):
    """The host's ms a iteration inside the port's outermost spans: what
    it took to enqueue the iteration."""
    r = report(t)
    return r["host_ms"] if r and r["spans"] else None
