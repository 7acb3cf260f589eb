#!/usr/bin/env python3
"""Benchmark of uni3detr_tpu_torch, the PyTorch / CUDA port, on NVIDIA
GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration file and a traffic mix; the run
draws its scenes and weights from ``--seed``, sets up, measures for
``--seconds``, checks what the timed path produced against the plain
reference and prints one JSON line last on standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``. It exits non-zero, printing no result, without a CUDA
device, and when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "uni3detr_tpu")


def _environment():
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(cell, result, trace):
    """The cell's metrics: end-to-end ones from the run, per-layer ones
    from their readers over the trace."""
    out = {}
    if not trace:
        values = {"setup_s": result["setup_s"],
                  "peak_mem_gib": result["peak"] / 2 ** 30}
        values.update({k: result[k] for k in
                       ("train_scenes_per_s", "infer_scenes_per_s",
                        "frame_ms_p95") if k in result})
        for m in cell.end_to_end:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    t = result["trace"]
    if t.port_launches() == 0:
        raise RuntimeError("trace: the profiler saw none of the port's "
                           "u3d_ kernels")
    for m in cell.per_layer:
        v = cell.reader(m["name"])(t)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            print(f"benchmark: {m['name']}, listed for {cell.name}, found "
                  f"nothing to read in the trace and is left out",
                  file=sys.stderr)
    return out


def main(argv=None, device=None):
    """Run a cell; ``device`` other than a CUDA device is for the tests
    alone."""
    args = parse(argv)
    _environment()
    import torch

    import bench_cell
    import bench_check
    import bench_drive

    cell = bench_cell.load(ROOT, args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = bench_drive.run(cell, args.seed, args.seconds, bool(args.trace),
                             device, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    correct, checks = bench_check.verdict(result["numbers"], cell.limits)
    correct = correct and result["failed"] == 0
    line = {"correct": bool(correct), "attempted": result["attempted"],
            "failed": result["failed"],
            "metrics": metrics_of(cell, result, args.trace),
            "device": bench_drive._device_info(device, result["peak"])}
    if args.trace:
        t = result["trace"]
        line["device"]["busy_s"] = t.busy_s
        line["device"]["window_s"] = t.window_s
        line["breakdown"] = t.breakdown()
    line["checks"] = {k: v for k, v in checks.items()
                      if v["limit"] is not None}
    print("set-up steps (s): " + json.dumps(result["setup_steps"]) +
          "; window rate of each 5 s: " + json.dumps(result["chunk_rates"]),
          file=sys.stderr)
    diag = {k: v["value"] for k, v in checks.items() if v["limit"] is None}
    if diag:
        print("not compared: " + json.dumps(diag), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
