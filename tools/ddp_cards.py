#!/usr/bin/env python3
"""Data parallelism over the cards of one host, one rank a card (NCCL).

    python3 tools/ddp_cards.py [N]        # N ranks, default every card
    python3 tools/ddp_cards.py N --spatial-shard S   # (N / S, S) layout
    python3 tools/ddp_cards.py --seeds A-B  # one card: batch seeds A..B

1. One process on one card: the flagship's fp32 train step (TF32 off,
   dropout 0) at 2 scenes, the work one rank does, its ms/step over
   ``chip_smoke.DDP_TIMED`` steps after a first one.
2. ``chip_smoke.ddp_step_phase`` on N ranks: the same step at 2 scenes a
   rank against one process on the global batch of 2N scenes (loss and
   gradient norm), each rank's ms/step and the all-reduces' share of it,
   its kernel launches asserted, ``run_inference_distributed`` against
   ``run_inference``.
3. ``chip_smoke.ddp_cli_phase`` on N ranks: ``cli.train`` / resume /
   ``cli.test`` with the JAX CLI's flags, launches asserted.

With ``--spatial-shard S`` (S > 1) it runs instead the spatially sharded
step over NCCL, a card a rank in N / S data groups of S: the flagship's
fp32 step at 2 scenes a data group (``chip_smoke.spatial_step_task``)
against one process on the global batch of 2 N / S scenes
(``chip_smoke.spatial_reference``, ``check_spatial_step``: the gathered
fused volume, loss, gradient norm and each module's gradients, BN
statistics), each rank's ms/step, all-reduces and their share, peak
memory and launches.

With ``--seeds`` it only runs ``chip_smoke.one_process_steps`` on one
card for each batch seed of the range: the flagship's first fp32 step at
``chip_smoke.DDP_B`` scenes twice and with the points nudged by
``NUDGE`` either way, once with the matching free and
once with the last three runs on the first run's matching
(``chip_smoke.pinned_matching``, as phase 60 holds its ranks), and
prints how far each run moves the loss.

Prints the card's name and power limit. Writes its data root under
``build/ddp_cards`` and removes it at the end.
"""
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402

NUDGE = 1e-7     # --seeds: the points' relative nudge, either way


def one_card_ms(torch, dev, steps):
    """ms/step of one process at 2 scenes (each after the first)."""
    import dataclasses
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SUNRGBD, compute_dtype="float32", dropout=0.0)
    model = c.build_model(cfg)
    model.load_state_dict(c._state_dict(torch, model), strict=True)
    model.to(dev)
    opt = make_optimizer(model, c.TRAIN_LR)
    batch = {k: torch.from_numpy(v[:2]).to(dev)
             for k, v in clustered_train_batch(2, cfg, 2).items()}
    ms = []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        train_step(model, opt, batch)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt, batch
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return ms


def seed_scan(torch, dev, seeds):
    """``chip_smoke.one_process_steps`` for each batch seed: prints the
    loss's relative moves (a second run, the two nudges)."""
    import dataclasses
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(SUNRGBD, compute_dtype="float32", dropout=0.0)
    sd = c._state_dict(torch, c.build_model(cfg))
    for seed in seeds:
        batch = clustered_train_batch(seed, cfg, c.DDP_B)
        for pin in (False, True):
            runs, _ = c.one_process_steps(torch, dev, cfg, sd, batch,
                                          (-NUDGE, NUDGE), pin)
            loss = runs[0]["total_loss"]
            moved = [abs(r["total_loss"] - loss) / abs(loss)
                     for r in runs[1:]]
            print(f"[ddp-seeds] batch seed {seed}, matching "
                  f"{'pinned' if pin else 'free'}: total_loss {loss!r}, "
                  f"relative moves: again {moved[0]:.3g}, points x (1 -+ "
                  f"{NUDGE}) {moved[1]:.3g} {moved[2]:.3g}")


def spatial_cards(torch, dev, n, S):
    """The spatially sharded flagship step on n cards, (n / S, S), over
    NCCL, against one process on the global batch."""
    import dataclasses
    from uni3detr_tpu_torch.parallel.launch import spawn
    from uni3detr_tpu_torch.presets import SUNRGBD
    from uni3detr_tpu_torch.synthetic import clustered_train_batch

    tag = f"ddp-cards-{n // S}x{S}"
    cfg = dataclasses.replace(SUNRGBD, compute_dtype="float32", dropout=0.0)
    sd = c._state_dict(torch, c.build_model(cfg))
    batch_np = clustered_train_batch(c.DDP_BATCH_SEED, cfg, 2 * (n // S))
    ref = c.spatial_reference(torch, dev, cfg, sd, batch_np, tag)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:spatial_rank", n, ([
        ("cards", "step", dict(cfg=cfg, sd={k: v.numpy()
                                            for k, v in sd.items()},
                               batch_np=batch_np, assigned=ref["assigned"],
                               timed=c.DDP_TIMED, fp32=True))],),
        device="cuda", timeout=c.DDP_TIMEOUT, spatial=S)
    c.check_spatial_step(tag, ranks, "cards", ref, c.train_per_step(cfg),
                         True, "nccl")
    print(f"[{tag}] {n} ranks in {time.perf_counter() - t0:.1f}s")


def main():
    import torch

    if not torch.cuda.is_available():
        c.fail("no CUDA device: tools/ddp_cards.py runs on NVIDIA GPUs")
    if len(sys.argv) > 2 and sys.argv[1] == "--seeds":
        lo, hi = map(int, sys.argv[2].split("-"))
        print(f"[ddp-seeds] {c.card_line()}")
        seed_scan(torch, torch.device("cuda", 0), range(lo, hi + 1))
        return
    args = sys.argv[1:]
    S = 1
    if "--spatial-shard" in args:
        i = args.index("--spatial-shard")
        S = int(args[i + 1])
        del args[i:i + 2]
    n = int(args[0]) if args else torch.cuda.device_count()
    if not 1 < n <= torch.cuda.device_count():
        c.fail(f"{n} ranks for {torch.cuda.device_count()} cards: one a card")
    if n % S:
        c.fail(f"--spatial-shard {S} must divide the {n} ranks")
    dev = torch.device("cuda", 0)
    print(f"[ddp-cards] {c.card_line()} x {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    if S > 1:
        spatial_cards(torch, dev, n, S)
        print(c.card_line())
        return
    work = os.path.join(ROOT, "build", "ddp_cards")
    shutil.rmtree(work, ignore_errors=True)
    root = c.ddp_root(os.path.join(work, "sunrgbd"), c.DDP_SCENES)
    ms = one_card_ms(torch, dev, c.DDP_TIMED)
    print(f"[ddp-cards] one process, one card, 2 scenes: ms/step median "
          f"{statistics.median(ms):.3f} ({[round(t, 3) for t in ms]})")
    c.ddp_step_phase(torch, dev, n, 2 * n, "nccl", root, c.SUNRGBD_CONFIG,
                     f"ddp-cards-{n}")
    c.ddp_cli_phase(torch, n, root, os.path.join(work, "cli"),
                    f"ddp-cards-cli-{n}")
    shutil.rmtree(work, ignore_errors=True)
    print(c.card_line())


if __name__ == "__main__":
    main()
