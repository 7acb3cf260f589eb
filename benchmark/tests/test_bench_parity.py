"""What a seed gives, held bit for bit (CPU, the fixture's tiny cells):
the scene pools, every state dict a run draws, the reference's readings
and the numbers the comparison judges, as recorded on the harness before
the model family moved behind ``families/``. A change to the harness
that moves any of them moves what a cell reads.

The constants were recorded with

    python benchmark/tests/test_bench_parity.py

on the harness as it stood before the family seam (this file copied
into that checkout), and are printed the same way now.
"""
from __future__ import annotations

import hashlib
import json
import time
import types

import numpy as np
import pytest
import torch

import bench_fixtures as fx

SEED = 2 ** 31 + 4242
# the window's clock: every read advances it by TICK seconds, so a window
# of WINDOW seconds holds the same iterations on every machine
TICK, WINDOW = 0.1, 0.3
THREADS = 2
# the cells run traced, for the work the per-layer readers count (the
# closed loop's count is the pipelined one's at another batch)
TRACED = ("tiny.eval", "tiny.train")


def _sha(chunks):
    """The first 128 bits of the sha256 of ``chunks``, in hex."""
    h = hashlib.sha256()
    for c in chunks:
        h.update(c if isinstance(c, bytes) else str(c).encode())
    return h.hexdigest()[:32]


def _tensor_bytes(t):
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return [str(t.dtype), str(tuple(t.shape)),
            t.reshape(-1).view(torch.uint8).numpy().tobytes()]


def _state_sha(sd):
    return _sha(c for k in sorted(sd) for c in [k] + _tensor_bytes(sd[k]))


def _arrays_sha(d):
    return _sha(c for k in sorted(d) for c in [k] + _tensor_bytes(
        torch.from_numpy(np.ascontiguousarray(d[k]))))


def _floats(d):
    return {k: repr(float(v)) for k, v in sorted(d.items())}


def _run(root, name, monkeypatch):
    """One run of a tiny cell on a clock of fixed ticks, every weight
    draw recorded."""
    import bench_drive
    import bench_weights

    now = [0.0]

    def clock():
        now[0] += TICK
        return now[0]

    drawn = []
    draw = bench_weights.draw

    def recorded(*a, **k):
        sd = draw(*a, **k)
        drawn.append(_state_sha(sd))
        return sd

    monkeypatch.setattr(bench_drive, "time",
                        types.SimpleNamespace(perf_counter=clock))
    monkeypatch.setattr(bench_weights, "draw", recorded)
    torch.manual_seed(0)
    r = bench_drive.run(fx.load(root, name), SEED, WINDOW, name in TRACED,
                        torch.device("cpu"), 0.0)
    return r, drawn


def readings(root, name, monkeypatch):
    import bench_count
    r, drawn = _run(root, name, monkeypatch)
    keys = sorted(r["pool"][0])
    out = {"attempted": r["attempted"],
           "pool": {k: _sha(_arrays_sha({k: b[k].numpy()})
                            for b in r["pool"]) for k in keys},
           "drawn": drawn, "numbers": _floats(r["numbers"])}
    if "trace" in r:
        out["work"] = _floats({f: r["trace"].work.per_iter(
            getattr(bench_count, f)) for f in ("model_flops",
                                               "sparse_conv_least_s",
                                               "fps_least_s")})
    if "readings" in r:
        for side, got in r["readings"].items():
            out[side] = {"loss": [repr(v) for v in got["loss"]],
                         "grad": _floats(got["grad"]),
                         "change": _floats(got["change"]),
                         "bn": _arrays_sha(got["bn"])}
        out["grad"] = _sha(json.dumps(out[s]["grad"]) for s in
                           ("program", "reference"))
        out["change"] = _sha(json.dumps(out[s]["change"]) for s in
                             ("program", "reference"))
        for s in ("program", "reference"):
            del out[s]["grad"], out[s]["change"]
    else:
        out["reference"] = _sha(f"{idx},{b},{_arrays_sha(det)}"
                                for idx, b, det in r["checked_scenes"])
    return out


def drawn_weights(kind):
    """The tiny model's state dict drawn on the program and on the
    reference."""
    import bench_weights
    from reference.model import Detector
    from uni3detr_tpu_torch.config import Uni3DETRConfig
    from uni3detr_tpu_torch.models.detector import Uni3DETR

    cfg = fx.tiny_model()
    prog = Uni3DETR(Uni3DETRConfig(**{k: tuple(v) if isinstance(v, list)
                                      else v for k, v in cfg.items()}))
    cpu = torch.device("cpu")
    return [_state_sha(bench_weights.draw(m, SEED, kind, cpu))
            for m in (prog, Detector(cfg))]


# recorded before the family seam (the module docstring says how)
RECORDED = {
    "cells": {
        "tiny.eval": {
            "attempted": 168,
            "drawn": [
                "bda5b32e7e8ee9c5ddef4e8c25a54a02",
                "bda5b32e7e8ee9c5ddef4e8c25a54a02"
            ],
            "numbers": {
                "box_gap": "1.609325408935547e-05",
                "box_gap_median": "1.7881393432617188e-07",
                "kept_boxes": "20.0",
                "kept_miss": "0.0",
                "score_gap": "1.553971742396243e-06",
                "score_gap_median": "2.2135276367407641e-07",
                "wrong_boxes": "0.0"
            },
            "pool": {
                "points": "d1a46ec6a725935b022afc532986ac0c",
                "pts_mask": "2a1e1d98eda1ad0bb608874d78392524",
                "random_points": "fe89847e185253fabae80921d87762d4"
            },
            "reference": "c337a6096214e18a95a934c54735c7e4",
            "work": {
                "fps_least_s": "7.183283582089552e-08",
                "model_flops": "130012278.0",
                "sparse_conv_least_s": "2.4856883582089555e-06"
            }
        },
        "tiny.online": {
            "attempted": 2,
            "drawn": [
                "bda5b32e7e8ee9c5ddef4e8c25a54a02",
                "bda5b32e7e8ee9c5ddef4e8c25a54a02"
            ],
            "numbers": {
                "box_gap": "1.1324882507324219e-06",
                "box_gap_median": "1.4901161193847656e-07",
                "kept_boxes": "20.0",
                "kept_miss": "0.0",
                "score_gap": "8.500911121700483e-07",
                "score_gap_median": "2.454084722103289e-07",
                "wrong_boxes": "0.0"
            },
            "pool": {
                "points": "036b15ae50c49a0e204247c583186f28",
                "pts_mask": "4a658f02f691e588f25a6703f7534da7",
                "random_points": "0ec4035bbc778d097506620db95a8f27"
            },
            "reference": "513d24b382d523ddbd38b8dfca3e3e2d"
        },
        "tiny.train": {
            "attempted": 12,
            "change": "54dfb95e19a300c4aa1e53629318f075",
            "drawn": [
                "bda5b32e7e8ee9c5ddef4e8c25a54a02",
                "bda5b32e7e8ee9c5ddef4e8c25a54a02"
            ],
            "grad": "b4e460c5c25df227faac2afbc0160d85",
            "numbers": {
                "bn_gap": "0.023027738856211715",
                "bn_gap_median": "0.0021193689742125396",
                "change_gap": "0.1578655362257711",
                "change_gap_median": "0.008655432046520308",
                "grad_gap": "0.40349626164145147",
                "grad_gap_median": "0.02954285533488518",
                "loss_gap": "0.0013124979162197267",
                "loss_gap_first": "0.00029936765028359155"
            },
            "pool": {
                "gt_boxes": "5c58599ee0035a9a009bc3142f1adf1a",
                "gt_labels": "dbffed79e510e51a65a67d5a5d03c397",
                "gt_mask": "64bce473eb30570ccf7de7900bb7f7a8",
                "points": "01cfb8c8bcea84dc6bf2073c0a6b8956",
                "pts_mask": "ad7731124c8ad5df59d4666915109301"
            },
            "program": {
                "bn": "da05096658f404bac8f030c55a73e49e",
                "loss": [
                    "11.102054595947266",
                    "10.912422180175781"
                ]
            },
            "reference": {
                "bn": "ef612fdf14ac0a20a6bede2a95f16526",
                "loss": [
                    "11.098731994628906",
                    "10.926763534545898"
                ]
            },
            "work": {
                "fps_least_s": "3.591641791044776e-08",
                "model_flops": "165549264.0",
                "sparse_conv_least_s": "3.272611343283584e-06"
            }
        }
    },
    "weights": {
        "init": [
            "bda5b32e7e8ee9c5ddef4e8c25a54a02",
            "bda5b32e7e8ee9c5ddef4e8c25a54a02"
        ],
        "random": [
            "bc313479b94b803e48e43fe2436e68bd",
            "bc313479b94b803e48e43fe2436e68bd"
        ]
    }
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fx.make_tree(tmp_path_factory.mktemp("parity"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(fx.CELLS))
def test_a_seed_reads_what_it_read_before_the_family_seam(tree, name,
                                                          monkeypatch):
    assert readings(tree, name, monkeypatch) == RECORDED["cells"][name]


@pytest.mark.parametrize("kind", ["init", "random"])
def test_drawn_weights_are_what_they_were(kind):
    assert drawn_weights(kind) == RECORDED["weights"][kind]


def main():
    import tempfile
    torch.set_num_threads(THREADS)
    mp = pytest.MonkeyPatch()
    with tempfile.TemporaryDirectory() as tmp:
        root = fx.make_tree(tmp)
        cells = {}
        for name in sorted(fx.CELLS):
            cells[name] = readings(root, name, mp)
            mp.undo()
    got = {"cells": cells,
           "weights": {k: drawn_weights(k) for k in ("init", "random")}}
    print(json.dumps(got, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
