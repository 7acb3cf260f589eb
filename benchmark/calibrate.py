#!/usr/bin/env python3
"""Readings that set the limits of a cell's comparison, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--faults] [--dropout0]

For each seed: one run of the cell with a short window (the program's
reading, the lower end of each limit), then in the same process the
controls, the reference put in the program's place and judged by the same
comparison (the upper end): ``float8``, one precision below the
configuration everywhere (float8 where it computes in bf16, bf16
dense-conv weights where it runs fp32 on TF32, TF32 products in the
head), and ``float8_alone``, float8 where it computes in bf16 and nothing
else lowered; and the reference rounded to bfloat16 where the
configuration computes in it (a second witness for the program's
reading). With ``--faults`` also the planted faults of the timed path:
``half_batch`` (training), ``altered``, ``half_empty`` and ``no_nms``
(inference). Each reading carries ``correct``, the cell's verdict on it:
the program's and the witness's have to come out true, every control's
and fault's false. In training each reading also counts the queries
whose assigned ground truth at the first checked step differs from the
reference's (``assign_flips`` of ``assign_pos``, every decoder layer);
``--dropout0`` adds a program run and its reference with the decoder's
dropout at 0 on both sides (a look at the cause of the loss's gap, never
a run of the cell as configured). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@contextlib.contextmanager
def assignments():
    """Records the first assignment of the program (``train.losses.
    assign_layers``: (L, B, Q)) and of the reference (``reference.loss.
    assign``, one (layer, scene) a call, in that order) in the block."""
    from uni3detr_tpu_torch.train import losses as P

    import reference.loss as R
    got = {"program": None, "reference": []}
    p_orig, r_orig = P.assign_layers, R.assign

    def p_wrap(costs, gt_mask, cfg):
        out = p_orig(costs, gt_mask, cfg)
        if got["program"] is None:
            got["program"] = out.detach().cpu()
        return out

    def r_wrap(*a, **k):
        out = r_orig(*a, **k)
        got["reference"].append(out.cpu())
        return out

    P.assign_layers, R.assign = p_wrap, r_wrap
    try:
        yield got
    finally:
        P.assign_layers, R.assign = p_orig, r_orig


def first_step(calls, shape):
    """The reference's assignment (L, B, Q) at the first step, from its
    calls of one (layer, scene) each."""
    import torch
    L, B, Q = shape
    return torch.stack(calls[:L * B]).reshape(L, B, Q)


def assign_diff(a, b):
    """{``assign_flips``: queries assigned differently in ``a`` and ``b``
    (each (L, B, Q)), ``assign_pos``: queries assigned on either side}."""
    either = (a >= 0) | (b >= 0)
    return {"assign_flips": int(((a != b) & either).sum()),
            "assign_pos": int(either.sum())}


def readings(cell, seed, seconds, device, faults, dropout0=False):
    import bench_check
    import bench_drive

    def judged(numbers):
        return {**numbers,
                "correct": bench_check.verdict(numbers, cell.limits)[0]}

    out = {}
    with assignments() as got:
        r = bench_drive.run(cell, seed, seconds, False, device,
                            time.perf_counter())
    out["program"] = judged(r["numbers"])
    pool = r.pop("pool")
    if cell.traffic["kind"] == "train":
        shape = tuple(got["program"].shape)
        ref_assign = first_step(got["reference"], shape)
        out["program"].update(assign_diff(got["program"], ref_assign))
        ref = r["readings"]["reference"]
        batches = pool[:cell.traffic["checked_steps"]]
        for prec in ("float8", "float8_alone", "bfloat16"):
            with assignments() as alt_got:
                alt = bench_check.train_reference(cell, seed, batches,
                                                  device, prec)
            out[f"reference_{prec}"] = judged(
                bench_check.train_numbers(alt, ref))
            out[f"reference_{prec}"].update(assign_diff(
                first_step(alt_got["reference"], shape), ref_assign))
        del r
        if faults:
            f = bench_drive.run(cell, seed, seconds, False, device,
                                time.perf_counter(), fault="half_batch")
            out["half_batch"] = judged(f["numbers"])
            del f
        if dropout0:
            rate = cell.model["dropout"]
            cell.model["dropout"] = 0.0
            try:
                bench_drive._free()
                with assignments() as got0:
                    d = bench_drive.run(cell, seed, seconds, False, device,
                                        time.perf_counter())
                out["dropout0"] = judged(d["numbers"])
                out["dropout0"].update(assign_diff(
                    got0["program"], first_step(got0["reference"], shape)))
                del d
            finally:
                cell.model["dropout"] = rate
    else:
        scenes = r.pop("checked_scenes")
        del r
        for prec in ("float8", "float8_alone", "bfloat16"):
            alt = bench_check.InferReference(cell, seed, device, prec)
            j = [bench_check.judge_scene(
                alt.as_output(alt.scene(pool[idx], b)), det)
                for idx, b, det in scenes]
            out[f"reference_{prec}"] = judged(bench_check.infer_numbers(j))
            del alt
        if faults:
            for fault in ("altered", "half_empty", "no_nms"):
                bench_drive._free()
                f = bench_drive.run(cell, seed, seconds, False, device,
                                    time.perf_counter(), fault=fault)
                out[fault] = judged(f["numbers"])
                del f
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--dropout0", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import run
    run._environment()
    import torch

    import bench_cell
    import bench_drive

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = bench_cell.load(ROOT, args.workload)
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, s, args.seconds, device, args.faults,
                       args.dropout0)
        bench_drive._free()
        print(json.dumps({"workload": cell.name, "seed": s, "seconds":
                          round(time.perf_counter() - t, 1), **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
