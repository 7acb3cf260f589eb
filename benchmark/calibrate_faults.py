#!/usr/bin/env python3
"""Readings of faults planted in an inference cell's reference, on the
card: each shows that the comparison sees a mechanism of the model.

    python3 benchmark/calibrate_faults.py --workload <cell> \
        --seeds 1,2,3 --faults a,b [--seconds 2]

For each seed: one run of the cell with a short window (the program's
reading, as ``calibrate.py`` takes it), then each named fault of the
model family's reference (a precision name its ``quantizer`` takes, such
as ``reference.ov_model.FAULTS``) put in the program's place on the same
checked scenes and judged by the same comparison. Each reading carries
``correct``, the cell's verdict on it: the program's has to come out
true, every fault's false. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed, seconds, device, faults):
    import bench_check
    import bench_drive

    def judged(numbers):
        return {**numbers,
                "correct": bench_check.verdict(numbers, cell.limits)[0]}

    r = bench_drive.run(cell, seed, seconds, False, device,
                        time.perf_counter())
    out = {"program": judged(r["numbers"])}
    pool, scenes = r.pop("pool"), r.pop("checked_scenes")
    del r
    for fault in faults:
        alt = bench_check.InferReference(cell, seed, device, fault)
        j = [bench_check.judge_scene(alt.as_output(alt.scene(pool[idx], b)),
                                     det) for idx, b, det in scenes]
        out[fault] = judged(bench_check.infer_numbers(j))
        del alt
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import run
    run._environment()
    import torch

    import bench_cell
    import bench_drive

    if not torch.cuda.is_available():
        print("calibrate_faults: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = bench_cell.load(ROOT, args.workload)
    if cell.traffic["kind"] != "infer":
        print("calibrate_faults: inference cells only", file=sys.stderr)
        return 2
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, s, args.seconds, device, args.faults.split(","))
        bench_drive._free()
        print(json.dumps({"workload": cell.name, "seed": s, "seconds":
                          round(time.perf_counter() - t, 1), **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
