#!/usr/bin/env python3
"""Time the bf16 sparse-conv weight-gradient kernels K7 and K10 at the
train-step shapes of both presets, on one GPU, without checks.

    python3 tools/time_dw_kernels.py [ROOT] [TAG]

ROOT (default: this checkout) is the tree whose ``uni3detr_tpu_torch``
and ``chip_smoke.py`` are imported, so that variants of ``csrc/`` in
copies of the tree (each builds its own library) can be timed in turns
in one call. Per call shape of ``uni3detr_nuscenes`` and then
``uni3detr_sunrgbd`` (B=4, the site sets of one clustered train batch,
random bf16 features and cotangents): the median CUDA-event time of 20
wrapper calls, and the sums per train step. Event times of calls under
~0.15 ms hold the wrapper's host work; ``tools/profile_torch_train.py``
gives device times. ``chip_smoke.dw_phase`` checks the same shapes
against the plain versions.
"""
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib  # noqa: E402
from uni3detr_tpu_torch.ops import sparse_conv_cuda as sc  # noqa: E402
from uni3detr_tpu_torch.presets import NUSCENES, SUNRGBD  # noqa: E402
from uni3detr_tpu_torch.synthetic import clustered_train_batch  # noqa: E402


def main(tag: str = "dw"):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not cuda_lib.CSRC.is_relative_to(ROOT):
        raise SystemExit(f"imported {cuda_lib.CSRC}, not from {ROOT}")
    print(chip_smoke.card_line())
    cuda_lib.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, cfg in (("nuscenes", NUSCENES), ("sunrgbd", SUNRGBD)):
        model = Uni3DETR(cfg).to(dev).train()
        batch = clustered_train_batch(0, cfg, chip_smoke.TRAIN_B)
        with torch.no_grad():
            pts = torch.from_numpy(batch["points"]).to(dev)
            mask = torch.from_numpy(batch["pts_mask"]).to(dev)
            _, coords, vmask = model.voxelize(pts, mask)
            sets = model.pts_middle_encoder.site_sets(coords, vmask)
            subm, strided = chip_smoke.conv_cases(cfg)
            cases = []
            for si, C, Cout, calls in subm:
                s = sets[si]
                nb = sc.match_positions_plain(s["ids"], s["qids"],
                                              s["n_sites"])
                cases.append(("K7", sc.gather_conv_dw, (nb,), s["n_sites"],
                              s["n_sites"], C, Cout, calls))
            for si, C, Cout, calls in strided:
                prev, s = sets[si - 1], sets[si]
                cases.append(("K10", sc.gather_conv_ids_dw,
                              (prev["ids"], s["sq"]), prev["n_sites"],
                              s["n_sites"], C, Cout, calls))
            total = {"K7": 0.0, "K10": 0.0}
            for kind, kern, index, V, Vout, C, Cout, calls in cases:
                x = torch.randn((chip_smoke.TRAIN_B, V, C), generator=gen,
                                device=dev).bfloat16()
                g = torch.randn((chip_smoke.TRAIN_B, Vout, Cout),
                                generator=gen, device=dev).bfloat16()
                ms = chip_smoke.median_ms(torch, lambda: kern(x, *index, g),
                                          20)
                total[kind] += ms * calls
                print(f"[{tag}-{name}] {kind} C={C}->{Cout} V={V} "
                      f"Vout={Vout} ms={ms:.4f} x{calls}/step")
            print(f"[{tag}-{name}] sum ms/step K7 {total['K7']:.4f} "
                  f"K10 {total['K10']:.4f}")
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*sys.argv[2:3])
