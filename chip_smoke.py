#!/usr/bin/env python3
"""Smoke run of the PyTorch port (uni3detr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, one or more lines each; any failure raises and exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the CUDA kernels from ``uni3detr_tpu_torch/csrc/``;
3. kernels: each of K1-K4 against its plain PyTorch version on the card,
   at the shapes the flagship path gives it on a clustered 100k-point
   SUN RGB-D scene: max error, median kernel and plain times (CUDA
   events, after warm-up), per call shape and summed per scene;
4. flagship: ``uni3detr_sunrgbd`` as preset (bf16), seeded random
   weights, points -> head -> decode -> per-class NMS on a few scenes:
   valid boxes, ms/scene, peak memory, and the kernel launch counts of
   that run, which must be K1 4, K2 17, K3 3 and K4 1 per scene;
5. fp32: one scene through the port on the card (kernels) and on the
   CPU (plain versions), TF32 off: voxels and FPS indices must be equal,
   head outputs close.

Then one JSON line of the kernels, the card line, and the result line
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
CUDA device the script fails before any phase.
"""
import dataclasses
import json
import statistics
import subprocess
import time

N_SCENES = 5          # the first is the warm-up
FP32_ATOL = 5e-3      # phase 5, see fp32_phase
WEIGHT_SEED = 0


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=120)
    return r.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def conv_cases(cfg):
    """(site-set index, C, Cout, calls per scene) of the submanifold
    convs (K2) and of the strided convs (K3, index of the output set)."""
    subm = [(0, cfg.in_point_features, cfg.encoder_base_channels, 1)]
    strided = []
    n = len(cfg.encoder_channels)
    cin = cfg.encoder_base_channels
    for i, blocks in enumerate(cfg.encoder_channels):
        body = blocks[:-1] if i < n - 1 else blocks
        subm.append((i, body[0], body[0], 2 * len(body)))
        if i < n - 1:
            strided.append((i + 1, cin, blocks[-1], 1))
            cin = blocks[-1]
    return subm, strided


def kernel_phase(torch, model, pts, dev):
    from uni3detr_tpu_torch.ops import fps, sparse_conv_cuda as sc

    cfg = model.cfg
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    feats, coords, vmask = model.voxelize(pts, mask)
    sets = model.pts_middle_encoder.site_sets(coords, vmask)
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}

    def add(name, err, ms, plain_ms, calls):
        r = report.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                         plain_ms=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms * calls
        r["plain_ms"] += plain_ms * calls

    # K1: one rulebook per site set, exact
    for s in sets:
        args = (s["ids"], s["qids"], s["n_sites"])
        got, ref = sc.match_positions(*args), sc.match_positions_plain(*args)
        if not torch.equal(got, ref):
            fail(f"K1 match_positions differs at V={s['n_sites']}")
        ms = median_ms(torch, lambda: sc.match_positions(*args), 20)
        pms = median_ms(torch, lambda: sc.match_positions_plain(*args), 20)
        print(f"[kernels] K1 match_positions V={s['n_sites']} "
              f"queries={tuple(s['qids'].shape)} exact ms={ms:.4f} "
              f"plain_ms={pms:.4f}")
        add("match_positions", 0.0, ms, pms, 1)

    def conv_check(name, kern, plain, rest, C, Cout, V, calls):
        for dtype, rtol in ((torch.float32, 1e-4),
                            (torch.bfloat16, 2 * 2.0 ** -8)):
            x = torch.randn((1, V, C), generator=gen, device=dev)
            a = (x.to(dtype),) + rest
            got, ref = kern(*a), plain(*a)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= rtol * max(scale, 1e-6):
                fail(f"{name} C={C}->{Cout} {dtype}: max err {err} > "
                     f"{rtol} x {scale}")
            ms = median_ms(torch, lambda: kern(*a), 20)
            pms = median_ms(torch, lambda: plain(*a), 20)
            if dtype == torch.bfloat16:   # the flagship's dtype: reported
                add(name, err, ms, pms, calls)
            print(f"[kernels] {name} V={V} C={C}->{Cout} {dtype} "
                  f"max_abs_err={err:.3g} (max |ref| {scale:.3g}, rtol "
                  f"{rtol:.3g}) ms={ms:.4f} plain_ms={pms:.4f} "
                  f"x{calls}/scene")

    subm, strided = conv_cases(cfg)
    for si, C, Cout, calls in subm:
        s = sets[si]
        nb = sc.match_positions_plain(s["ids"], s["qids"], s["n_sites"])
        w = torch.randn((27, C, Cout), generator=gen, device=dev) \
            / (27 * C) ** 0.5
        conv_check("gather_conv", sc.gather_conv, sc.gather_conv_plain,
                   (nb, w), C, Cout, s["n_sites"], calls)
    for si, C, Cout, calls in strided:
        prev, s = sets[si - 1], sets[si]
        w = torch.randn((27, C, Cout), generator=gen, device=dev) \
            / (27 * C) ** 0.5
        conv_check("gather_conv_ids", sc.gather_conv_ids,
                   sc.gather_conv_ids_plain, (prev["ids"], s["sq"], w),
                   C, Cout, prev["n_sites"], calls)

    # K4: both FPS runs of the detector, exact
    xyz = pts[..., :3].contiguous()
    vc = coords.flip(-1).float()
    vc = torch.where(vmask[..., None], vc, torch.zeros_like(vc))
    fargs = (xyz, mask, vc, vmask, cfg.num_query)
    ga, gb = fps.farthest_point_sample_pair(*fargs)
    ra = fps.farthest_point_sample_plain(xyz, mask, cfg.num_query)
    rb = fps.farthest_point_sample_plain(vc, vmask, cfg.num_query)
    if not (torch.equal(ga, ra) and torch.equal(gb, rb)):
        fail("K4 farthest_point_sample_pair differs from the plain version")
    ms = median_ms(torch, lambda: fps.farthest_point_sample_pair(*fargs), 10)
    pms = median_ms(torch, lambda: (
        fps.farthest_point_sample_plain(xyz, mask, cfg.num_query),
        fps.farthest_point_sample_plain(vc, vmask, cfg.num_query)), 3, 1)
    print(f"[kernels] K4 fps_pair N=({xyz.shape[1]}, {vc.shape[1]}) "
          f"S={cfg.num_query} exact ms={ms:.4f} plain_ms={pms:.4f}")
    add("fps_pair", 0.0, ms, pms, 1)
    print(f"[kernels] voxels={int(vmask.sum())} sites per stage="
          f"{[int(s['mask'].sum()) for s in sets]} budgets="
          f"{[s['n_sites'] for s in sets]}")
    return report


def flagship_phase(torch, model, scenes, dev):
    from uni3detr_tpu_torch.ops import fps, sparse_conv_cuda as sc
    from uni3detr_tpu_torch.train.coder import decode_predictions, post_process

    cfg = model.cfg
    wrappers = {"match_positions": sc.match_positions,
                "gather_conv": sc.gather_conv,
                "gather_conv_ids": sc.gather_conv_ids,
                "fps_pair": fps.farthest_point_sample_pair}
    subm, strided = conv_cases(cfg)
    per_scene = {"match_positions": len(cfg.encoder_channels),
                 "gather_conv": sum(c[-1] for c in subm),
                 "gather_conv_ids": len(strided), "fps_pair": 1}
    data = [(torch.from_numpy(p).to(dev), torch.from_numpy(r).to(dev))
            for p, r in scenes]
    mask = torch.ones(data[0][0].shape[:2], dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for fn in wrappers.values():
        fn.launches = 0
    for i, (pts, rnd) in enumerate(data):
        t0 = time.perf_counter()
        outs = model(pts, mask, rnd)
        boxes, scores, labels, valid = post_process(
            *decode_predictions(outs, cfg), cfg)
        n_valid = int(valid.sum())           # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        L, nq = cfg.num_decoder_layers, 4 * cfg.num_query
        shapes = {"all_cls_scores": (L, 1, nq, cfg.num_classes),
                  "all_bbox_preds": (L, 1, nq, cfg.code_size),
                  "all_iou_preds": (L, 1, nq)}
        for k, shp in shapes.items():
            if tuple(outs[k].shape) != shp or not bool(
                    torch.isfinite(outs[k]).all()):
                fail(f"scene {i}: {k} has shape {tuple(outs[k].shape)} "
                     f"(want {shp}) or non-finite values")
        if not (n_valid > 0 and bool(torch.isfinite(boxes[valid]).all())):
            fail(f"scene {i}: {n_valid} valid boxes, or non-finite boxes")
        print(f"[flagship] scene {i}: valid boxes={n_valid} "
              f"ms={times[-1]:.3f}{' (warm-up)' if i == 0 else ''}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: v * len(data) for k, v in per_scene.items()}
    print(f"[flagship] ms/scene median of {len(times) - 1} after warm-up="
          f"{statistics.median(times[1:]):.3f} all={[round(t, 3) for t in times]}"
          f" peak_mem_bytes={peak}")
    print(f"[flagship] launches={launches} expected={want}")
    if launches != want:
        fail(f"kernel launch counts {launches} != {want}")
    return launches


def fp32_phase(torch, sd, scene, dev):
    """Card (kernels) vs CPU (plain versions), fp32, TF32 off.

    Tolerance FP32_ATOL: the two runs sum in different orders through
    ~40 sparse and dense convs and three decoder layers; the JAX
    package's real-size torch parity test (tests/test_torch_import.py)
    holds 2e-3.
    """
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.presets import SUNRGBD

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SUNRGBD, compute_dtype="float32")
    res = {}
    for where in (dev, torch.device("cpu")):
        model = Uni3DETR(cfg).eval()
        model.load_state_dict(sd, strict=True)
        model.to(where)
        pts, rnd = (torch.from_numpy(a).to(where) for a in scene)
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=where)
        t0 = time.perf_counter()
        outs, inter = model(pts, mask, rnd, return_intermediates=True)
        res[where.type] = (
            {k: v.cpu() for k, v in outs.items()},
            {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                 else v.cpu()) for k, v in inter.items()},
            time.perf_counter() - t0)
    (og, ig, tg), (oc, ic, tc) = res["cuda"], res["cpu"]
    nv_g, nv_c = int(ig["vmask"].sum()), int(ic["vmask"].sum())
    if nv_g != nv_c or not torch.equal(ig["coords"], ic["coords"]):
        fail(f"fp32: voxels differ card {nv_g} vs cpu {nv_c}")
    if not all(torch.equal(a, b) for a, b in zip(ig["fps_idx"],
                                                 ic["fps_idx"])):
        fail("fp32: FPS indices differ between card and cpu")
    errs = {k: (og[k] - oc[k]).abs().max().item() for k in og}
    print(f"[fp32] voxels={nv_g} fps equal; card vs cpu max_abs_err="
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } "
          f"(atol {FP32_ATOL}); card {tg:.2f}s cpu {tc:.2f}s")
    if max(errs.values()) > FP32_ATOL:
        fail(f"fp32: head outputs differ by {errs}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.ops import cuda_lib
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_scene
    from uni3detr_tpu_torch.weights import random_state_dict

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s from {cuda_lib.CSRC}")

    cfg = SUNRGBD
    model = Uni3DETR(cfg).eval()
    sd = {k: torch.from_numpy(v)
          for k, v in random_state_dict(model, WEIGHT_SEED).items()}
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    scenes = [clustered_scene(seed, cfg) for seed in range(N_SCENES)]

    with torch.inference_mode():
        report = kernel_phase(torch, model, torch.from_numpy(
            scenes[0][0]).to(dev), dev)
        launches = flagship_phase(torch, model, scenes, dev)
        fp32_phase(torch, sd, scenes[0], dev)

    meta = {
        "match_positions": ("uni3detr_tpu_torch/csrc/sparse_conv.cu",
                            "uni3detr_tpu/ops/sparse_conv_pallas.py:944"),
        "gather_conv": ("uni3detr_tpu_torch/csrc/sparse_conv.cu",
                        "uni3detr_tpu/ops/sparse_conv_pallas.py:355"),
        "gather_conv_ids": ("uni3detr_tpu_torch/csrc/sparse_conv.cu",
                            "uni3detr_tpu/ops/sparse_conv_pallas.py:619"),
        "fps_pair": ("uni3detr_tpu_torch/csrc/fps.cu",
                     "uni3detr_tpu/ops/fps.py:123"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **report[name])
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
