#!/usr/bin/env python3
"""Where a round of the auction kernel (K12) goes, on one GPU.

    python3 tools/auction_phase_clocks.py [WORKDIR]

Copies ``uni3detr_tpu_torch`` into WORKDIR (default
``build/auction_phase_clocks``, git-ignored), adds ``clock64()``
counters between the phases of each round of ``u3d_auction_kernel`` in
that copy (the round's start, the row passes, the merge and bids, the
barrier after them, the installs, the barrier after those), builds it,
and runs it on the train step's own matching costs of both presets
(seeded random weights, one clustered train batch, train mode, dropout
seeded; the instances the loss's one matching call solves) in every
variant that fits. Prints, for the first two blocks (the two blocks of
instance 0 in a cluster), the rounds, the mean open bidders a round of
the block and the cycles a round of each phase, read by thread 0; and
the atomic instructions the compiler emitted for the kernel
(``cuobjdump -sass``). The counters cost a few cycles a phase; the
checkout's own kernel is not changed.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = Path(sys.argv[1] if len(sys.argv) > 1 else
            ROOT / "build" / "auction_phase_clocks").resolve()
PHASES = ("start", "rows", "rows_barrier", "merge_bids", "barrier",
          "installs", "barrier_end")

# (anchor in csrc/matching.cu, text inserted after it)
PATCHES = [
    ("namespace cg = cooperative_groups;\n",
     "__device__ unsigned long long g_clocks[32];\n"
     "#define U3D_TICK(k) do { c1 = clock64(); acc[k] += c1 - c0; "
     "c0 = c1; } while (0)\n"),
    ("  long long bids = 0;\n",
     "  unsigned long long c0 = clock64(), c1, acc[7] = {0, 0, 0, 0, 0, 0,"
     " 0};\n  long long open_sum = 0;\n"),
    ("    const int* list = s_list + par * MH;\n",
     "    open_sum += n_loc;\n    U3D_TICK(0);\n"),
    ("        top2_push(a, row[j] - s_price[j], j);\n      top2_warp(a);\n"
     "      if (lane == 0) {\n        s_pv1[t] = a.v1;\n"
     "        s_pj1[t] = a.j1;\n        s_pv2[t] = a.v2;\n      }\n    }\n",
     "    U3D_TICK(1);\n"),
    ("    __syncthreads();\n    // merge the parts", None),
    ("        if (bid > AUC_NEG / 2) atomicMax(key + a.j1, "
     "bid_key(bid, list[e], M));\n      }\n    }\n", "    U3D_TICK(3);\n"),
    ("    U3D_TICK(3);\n    round_barrier<CL>();\n", "    U3D_TICK(4);\n"),
    ("        *peer<CL>(s_list + (par ^ 1) * MH + slot, r) = stay;\n"
     "      }\n    }\n", "    U3D_TICK(5);\n"),
    ("    U3D_TICK(5);\n    round_barrier<CL>();\n",
     "    U3D_TICK(6);\n"),
    ("    out[(long long)inst * M + e * CL + rank] = s_item[e];\n",
     "  if (blockIdx.x < 2 && tid == 0) {\n"
     "    for (int k = 0; k < 7; ++k) g_clocks[blockIdx.x * 16 + k] = "
     "acc[k];\n"
     "    g_clocks[blockIdx.x * 16 + 8] = it;\n"
     "    g_clocks[blockIdx.x * 16 + 9] = open_sum;\n  }\n"),
    ('extern "C" {\n',
     "int u3d_auction_clocks(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_clocks, "
     "sizeof(g_clocks));\n}\n"),
]


def patch(src: str) -> str:
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in matching.cu: "
                             f"{anchor[:60]!r}")
        if text is None:        # the rows barrier: ticks on both sides
            src = src.replace(anchor, anchor.replace(
                "    __syncthreads();\n",
                "    __syncthreads();\n    U3D_TICK(2);\n"))
        else:
            src = src.replace(anchor, anchor + text)
    return src


def main():
    if WORK.exists():
        shutil.rmtree(WORK)
    shutil.copytree(ROOT / "uni3detr_tpu_torch", WORK / "uni3detr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = WORK / "uni3detr_tpu_torch" / "csrc" / "matching.cu"
    cu.write_text(patch(cu.read_text()))
    sys.path.insert(0, str(WORK))

    import torch

    from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.ops import cuda_lib, matching
    from uni3detr_tpu_torch.presets import NUSCENES, SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.train import losses
    from uni3detr_tpu_torch.weights import random_state_dict

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not cuda_lib.CSRC.is_relative_to(WORK):
        raise SystemExit(f"imported {cuda_lib.CSRC}, not the copy")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = cuda_lib.library()
    so = next(cuda_lib.BUILD_DIR.glob("libu3d_kernels_*.so"))
    sass = subprocess.run([str(Path(cuda_lib._nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True)
    kernel, ops = None, {}
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
        elif kernel and "auction" in kernel and "ATOM" in line:
            op = line.split("*/")[1].split()[0] if "*/" in line else line
            ops[op] = ops.get(op, 0) + 1
    print(f"atomic instructions in the auction kernels: {ops}")
    clocks = lib.u3d_auction_clocks
    clocks.argtypes = [ctypes.c_void_p]
    clocks.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    for name, cfg in (("nuscenes", NUSCENES), ("sunrgbd", SUNRGBD)):
        model = Uni3DETR(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               random_state_dict(model, 0).items()})
        model.to(dev).train()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 clustered_train_batch(0, cfg, 4).items()}
        with torch.no_grad():
            torch.manual_seed(0)
            outs = model(batch["points"], batch["pts_mask"])
            costs = losses.all_layer_costs(outs, gravity_center_boxes(
                batch["gt_boxes"]), batch["gt_labels"], cfg)
            L, B = costs.shape[:2]
            benefit, spread, eps_div = matching.auction_problem(
                costs.reshape(L * B, *costs.shape[2:]),
                batch["gt_mask"].repeat(L, 1), cfg.num_query,
                cfg.gt_repeattimes, cfg.matcher_phases)
            for variant in matching.AUCTION_VARIANTS:
                try:
                    matching.auction_lap(benefit, spread, eps_div,
                                         variant=variant)
                except ValueError:
                    continue
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 32)()
                cuda_lib.check(clocks(ctypes.addressof(buf)), "clocks")
                for blk in range(2):
                    a = list(buf)[16 * blk:16 * blk + 10]
                    n = max(a[8], 1)
                    print(f"{name} {tuple(benefit.shape)} {variant} block "
                          f"{blk}: rounds={a[8]} open bidders a round="
                          f"{a[9] / n:.1f} cycles a round: " + " ".join(
                              f"{p}={a[k] / n:.0f}"
                              for k, p in enumerate(PHASES)))
        del model, outs, costs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
