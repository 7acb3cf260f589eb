"""Train CLI of the port (after ``uni3detr_tpu/cli/train.py``):

    python -m uni3detr_tpu_torch.cli.train CONFIG [--work-dir DIR] \\
        [--resume-from CKPT] [--seed N] [--max-steps N] \\
        [--num-processes W --process-id R --coordinator HOST:PORT] \\
        [--spatial-shard S] \\
        [--cfg-options k=v ...] [--device cuda|cpu]
    torchrun --nproc_per_node W -m uni3detr_tpu_torch.cli.train CONFIG ...

Trains a config file's model on its data root: the train split with its
augmentations (``data.datasets.build_dataset``, ``RepeatDataset`` /
``CBGSDataset``), loaded by a thread pool of ``workers_per_gpu`` and
collated in a background thread (``data.loading.prefetch``, pinned host
tensors copied to the card without waiting); the optimizer and the lr /
momentum schedules of ``optimizer``, ``lr_config`` and
``momentum_config``; the OV configs' frozen ResNet stages (out of the
optimizer), ``lr_mult`` and staged branch loading (``pretrained_pts`` /
``pretrained_img`` with ``load_pts`` / ``load_img``); the epoch loop on
``train.step.train_step``; a log line every ``log_config.interval`` steps
in ``WORK_DIR/train.log`` (the losses reach the host only there);
checkpoints ``epoch_N`` and ``latest`` with ``meta.json`` every
``checkpoint_config.interval`` epochs; the val split's metric every
``evaluation.interval`` epochs (``train.evaluator``); and
``--resume-from`` / ``resume_from``. ``--max-steps`` saves ``latest`` and
stops.

Weights start from ``weights.random_state_dict`` of the seed. Dropout
and the OV modality draw take their generators' seeds from (seed, step),
so a resumed run steps as an uninterrupted one. The sample order is the
JAX CLI's: ``RandomState(seed)``'s permutations, the first of them drawn
for the JAX package's init batch. It runs on the card (``--device cuda``,
the default) and exits with an error when there is none; ``--device
cpu`` runs the kernels' plain versions on the CPU.

Data parallel: one process per card, started by torchrun (its
environment) or by hand with the JAX CLI's flags (``--num-processes``,
``--process-id``, ``--coordinator``, a ``host:port`` or a ``tcp://`` /
``file://`` URL), over NCCL, or gloo where ranks share a card or run on
the CPU (``parallel.dist.init_distributed``). The global batch is
``samples_per_gpu`` x W and the epoch counts its steps; every rank draws
the same order and loads its own slice (``batch_iterator(local=)``). The
step is the global batch's (``train.step``: global BN statistics and
positive counts, averaged gradients), the OV modality draw is seeded
from (seed, step) on every rank and dropout from (seed, step, rank).
Rank 0 writes ``train.log`` and the checkpoints; rank r > 0 logs
warnings to ``train.rank{r}.log``. The eval hook runs a shard a rank
(``run_inference_distributed``) and the metric on rank 0.

Spatial sharding (``--spatial-shard S``, the JAX CLI's flag): the W
ranks form W // S data groups of S ranks (``parallel.dist.set_layout``,
rank r in group r // S at spatial index r % S; S must divide W, else the
CLI refuses, one process included). The global batch is
``samples_per_gpu`` x (W // S); the S ranks of a group load the group's
slice and take the batch of its first rank (a broadcast over the
group: the train pipeline's draws are unseeded), and in the step each
holds an H slice of the dense volume (``parallel/spatial.py``). Dropout
is seeded from (seed, step, data group), so the S ranks of a group draw
the same masks. The eval hook runs whole, a round-robin shard a rank.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a uni3detr_tpu_torch "
                                            "model")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap total steps (smoke runs)")
    p.add_argument("--spatial-shard", type=int, default=1,
                   help="the ranks along the spatial axis: W // S data "
                        "groups of S ranks that split the dense volume's "
                        "H (must divide the number of processes)")
    add_dist_args(p)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) runs the kernels on the card; "
                        "cpu runs their plain versions")
    return p.parse_args(argv)


def add_dist_args(p):
    """The JAX CLIs' multi-process flags (``cli.train``, ``cli.test``)."""
    p.add_argument("--coordinator", default=None,
                   help="data parallel: the rendezvous, host:port or a "
                        "tcp:// / file:// URL (default: torchrun's "
                        "MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="data parallel: the number of ranks (default: "
                        "torchrun's WORLD_SIZE, else 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="data parallel: this rank (default: RANK)")


def start_distributed(args):
    """(device, whether this call started the process group): the
    process group of the flags or of torchrun's environment, or none
    (one process on ``args.device``), with the (data, spatial) layout of
    ``args.spatial_shard`` (default 1); raises ValueError before joining
    when S does not divide the number of processes."""
    from ..parallel import dist

    wanted = args.num_processes not in (None, 1) or args.coordinator \
        or args.process_id is not None \
        or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)
    S = getattr(args, "spatial_shard", 1)
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    elif not wanted:
        world = 1
    else:
        world = args.num_processes if args.num_processes is not None \
            else int(os.environ.get("WORLD_SIZE", "1"))
    err = dist.layout_error(world, S)
    if err:
        raise ValueError(err)
    if not wanted:
        return torch.device(args.device), False
    started = not torch.distributed.is_initialized()
    dev = dist.init_distributed(args.coordinator, args.num_processes,
                                args.process_id, device=args.device,
                                spatial=S)
    return dev, started


def batch_iterator(dataset, batch_size, cfg_model, rng, pool,
                   local=slice(None)):
    """Shuffled epoch iterator with threaded sample loading, as the JAX
    CLI's: the order is ``rng.permutation``, the tail partial batch is
    padded by wrapping to the epoch's first samples (``np.resize``), so
    every sample is seen and every batch has ``batch_size`` scenes.
    ``local``: this rank's slice of each global batch (every rank draws
    the same order from the same seed). Yields ``collate_batch``'s
    (numpy batch, metas) of the slice."""
    from ..data.datasets import collate_batch

    order = rng.permutation(len(dataset))
    if len(order) % batch_size:
        # np.resize wraps, covering datasets smaller than one batch too
        order = np.resize(order, len(order) + batch_size
                          - len(order) % batch_size)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idxs = order[i:i + batch_size][local]
        samples = list(pool.map(dataset.__getitem__, idxs))
        batch, metas = collate_batch(
            samples, cfg_model.num_points, cfg_model.max_gt,
            cfg_model.in_point_features, cfg_model.code_size)
        yield batch, metas


def host_batches(batches, pin: bool, load_ms: list):
    """``batch_iterator``'s batches as torch tensors (pinned with
    ``pin``), appending each batch's load + augment + collate ms to
    ``load_ms``."""
    t0 = time.perf_counter()
    for batch, _ in batches:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        load_ms.append((time.perf_counter() - t0) * 1e3)
        yield batch
        t0 = time.perf_counter()


def build_schedules(cfg, steps_per_epoch: int):
    """(lr schedule, momentum schedule or None) of a config, as the JAX
    CLI builds them: the mmcv step or cyclic lr policy and the cyclic
    momentum policy over ``total_epochs`` epochs of ``steps_per_epoch``."""
    from ..train.step import (cyclic_lr_schedule, cyclic_momentum_schedule,
                              step_lr_schedule)

    opt = cfg.get("optimizer", {})
    total = steps_per_epoch * cfg.get("total_epochs", 40)
    lr_cfg = cfg.get("lr_config", {"policy": "step", "step": [1 << 30]})
    if lr_cfg.get("policy") == "cyclic":
        sched = cyclic_lr_schedule(
            opt.get("lr", 1e-4), total,
            tuple(lr_cfg.get("target_ratio", (10, 1e-4))),
            lr_cfg.get("step_ratio_up", 0.4))
    else:
        sched = step_lr_schedule(opt.get("lr", 1e-4), steps_per_epoch,
                                 lr_cfg.get("step", []))
    mom_cfg = cfg.get("momentum_config") or {}
    mom_sched = None
    if mom_cfg.get("policy") == "cyclic":
        mom_sched = cyclic_momentum_schedule(
            opt.get("beta1", 0.9), total,
            tuple(mom_cfg.get("target_ratio", (0.85 / 0.95, 1.0))),
            mom_cfg.get("step_ratio_up", 0.4))
    return sched, mom_sched


def build_optimizer(cfg, model, steps_per_epoch: int):
    """The config's clip + AdamW over ``model``'s trainable parameters
    with its schedules and ``lr_mult`` groups. Frozen ResNet stages do
    not require gradients and stay out of it (ROADMAP Queue 3: the JAX
    CLI's 0x mask is shadowed by ``img_backbone``'s 0.1)."""
    from ..train.step import make_optimizer

    opt = cfg.get("optimizer", {})
    sched, mom_sched = build_schedules(cfg, steps_per_epoch)
    return make_optimizer(model, sched, opt.get("weight_decay", 0.01),
                          opt.get("clip_norm", 10.0),
                          momentum_schedule=mom_sched,
                          lr_mult=dict(cfg.get("lr_mult") or {}))


def step_seed(seed: int, step: int, group=None) -> int:
    """The seed of the generators of step ``step``: of (seed, step) alone
    for the OV modality draw and a single data group's dropout, of (seed,
    step, data group) for a group's dropout over several (the groups do
    not draw the same masks; the S ranks of one, which run the same
    decoder, do)."""
    key = [seed, step] if group is None else [seed, step, group]
    return int(np.random.SeedSequence(key).generate_state(
        1, np.uint64)[0])


def _logger(work_dir, rank=0):
    log = logging.getLogger("uni3detr_tpu_torch.cli.train")
    log.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s %(message)s")
    name = "train.log" if rank == 0 else f"train.rank{rank}.log"
    for h in (logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(work_dir, name))):
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def main(argv=None):
    """Run the CLI; returns {"work_dir", "epoch", "step", "evals" (epoch
    -> metric dict, rank 0's), "staged" (prefix -> tensors loaded),
    "stats", "rank", "world_size", "launches"} for callers in the same
    process. ``stats``: the loader's ms a batch (``load_ms``) and, at
    each log step, (epoch, step, host seconds after the losses reached
    the host) in ``log_s``; ``launches``: this rank's kernel launches in
    the run by kernel (``ops.launch_counts``)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("cli.train: no CUDA device; pass --device cpu to run the "
                 "plain versions of the kernels on the CPU")
    from ..config_file import build_model_config, load_config, \
        merge_cfg_options
    from ..ops import launch_counts
    from ..parallel import dist

    device, started = start_distributed(args)
    try:
        cfg = merge_cfg_options(load_config(args.config), args.cfg_options)
        model_cfg = build_model_config(cfg)
        work_dir = args.work_dir or cfg.get("work_dir") or os.path.join(
            "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
        os.makedirs(work_dir, exist_ok=True)
        log = _logger(work_dir, dist.rank())
        before = launch_counts()
        try:
            result = _train(args, cfg, model_cfg, work_dir, log, device)
        finally:
            for h in list(log.handlers):
                log.removeHandler(h)
                h.close()
        after = launch_counts()
        result.update(rank=dist.rank(), world_size=dist.world_size(),
                      launches={k: after[k] - before[k] for k in after})
        return result
    finally:
        if started:
            dist.destroy_distributed()


def _train(args, cfg, model_cfg, work_dir, log, device):
    from ..data.datasets import box_type_of, build_dataset
    from ..data.loading import prefetch
    from ..train import evaluator
    from ..train import step as step_mod
    from ..parallel import dist
    from ..train.checkpoint import (load_branch, load_checkpoint, restore,
                                    save_checkpoint)
    from .test import build_model

    cuda = device.type == "cuda"
    W, G, S = dist.world_size(), dist.data_size(), dist.spatial_size()
    log.info("config: %s", args.config)
    log.info("device: %s%s, %d process%s (%d data x %d spatial)", device,
             f" ({torch.cuda.get_device_name(device)})" if cuda else "", W,
             "es" if W > 1 else "", G, S)
    seed = args.seed if args.seed is not None else cfg.get("seed", 0)
    rng = np.random.RandomState(seed)
    dataset = build_dataset(cfg.data, cfg.class_names, model_cfg.pc_range,
                            "train")
    bs = cfg.data.get("samples_per_gpu", 2)
    # the global batch over the data groups (the reference's
    # samples_per_gpu x world size; the JAX CLI's x devices // spatial);
    # the schedules count whole global batches, as the JAX CLI's (the
    # iterator pads the tail batch)
    gbs = bs * G
    local = dist.local_slice(gbs)
    steps_per_epoch = max(len(dataset) // gbs, 1)
    epochs = cfg.get("total_epochs", 40)
    # the JAX CLI draws one order for its init batch before the epochs
    rng.permutation(len(dataset))

    model = build_model(model_cfg, None, device, log.info, seed).train()
    opt = build_optimizer(cfg, model, steps_per_epoch)
    log.info("train split: %d samples, batch %d (%d a data group), %d "
             "steps an epoch, %d epochs", len(dataset), gbs, bs,
             steps_per_epoch,
             epochs)

    # OV staged init: separately trained branches by key prefix
    staged = {}
    for src, keys in ((cfg.get("pretrained_pts"), cfg.get("load_pts")),
                      (cfg.get("pretrained_img"), cfg.get("load_img"))):
        if src and keys:
            tree, _ = load_checkpoint(src)
            for k in keys:
                staged[k] = load_branch(model, tree["model"], k, k)
                log.info("staged init: %s <- %s (%d tensors)", k, src,
                         staged[k])

    start_epoch = 0
    resume = args.resume_from or cfg.get("resume_from")
    if resume:
        tree, meta = load_checkpoint(resume)
        restore(model, tree, opt)
        start_epoch = (meta or {}).get("epoch", 0)
        log.info("resumed from %s at epoch %d, step %d", resume,
                 start_epoch, opt.steps)
    # every rank holds rank 0's weights (all start from the same seed and
    # checkpoints; this makes it so whatever the caller did)
    dist.broadcast_module(model)

    eval_cfg = cfg.get("evaluation", {})
    eval_int = eval_cfg.get("interval", 0)
    val_dataset = build_dataset(cfg.data, cfg.class_names,
                                model_cfg.pc_range, "val") \
        if eval_int else None

    def ckpt_meta(epoch, step):
        return {"epoch": epoch, "step": step,
                "classes": list(cfg.class_names),
                "config_path": os.path.abspath(args.config),
                "config": dict(cfg)}

    mm = evaluator.is_ov(model_cfg) and model_cfg.use_lidar \
        and model_cfg.use_camera
    modality_gen = torch.Generator() if mm else None
    log_int = cfg.get("log_config", {}).get("interval", 50)
    ckpt_int = cfg.get("checkpoint_config", {}).get("interval", 1)
    stats = {"load_ms": [], "log_s": []}
    result = {"work_dir": work_dir, "evals": {}, "staged": staged,
              "stats": stats}
    gstep = opt.steps
    t_last = time.perf_counter()
    with ThreadPoolExecutor(max_workers=cfg.data.get("workers_per_gpu",
                                                     4)) as pool:
        for epoch in range(start_epoch, epochs):
            batches = host_batches(
                batch_iterator(dataset, gbs, model_cfg, rng, pool, local),
                cuda, stats["load_ms"])
            for batch in prefetch(batches):
                batch = dist.group_broadcast(
                    {k: v.to(device, non_blocking=True)
                     for k, v in batch.items()})
                torch.manual_seed(step_seed(
                    seed, gstep, dist.data_index() if G > 1 else None))
                if modality_gen is not None:
                    modality_gen.manual_seed(step_seed(seed, gstep))
                logs = step_mod.train_step(model, opt, batch,
                                           modality_generator=modality_gen)
                gstep += 1
                if gstep % log_int == 0:
                    logs = {k: float(v) for k, v in logs.items()}
                    now = time.perf_counter()
                    stats["log_s"].append((epoch, gstep, now))
                    group = opt.adamw.param_groups[0]
                    log.info("epoch %d step %d | %.2f it/s | lr %.4g | "
                             "total %.4f cls %.4f bbox %.4f iou %.4f ioup "
                             "%.4f gnorm %.2f", epoch, gstep,
                             log_int / max(now - t_last, 1e-9),
                             group["lr"] / group["lr_mult"],
                             logs["total_loss"], logs["loss_cls"],
                             logs["loss_bbox"], logs["loss_iou"],
                             logs["loss_iou_pred"], logs["grad_norm"])
                    t_last = now
                if args.max_steps and gstep >= args.max_steps:
                    save_checkpoint(os.path.join(work_dir, "latest"), model,
                                    opt, ckpt_meta(epoch, gstep))
                    log.info("max steps reached; checkpoint saved")
                    result.update(epoch=epoch, step=gstep)
                    return result
            if (epoch + 1) % ckpt_int == 0:
                for name in (f"epoch_{epoch + 1}", "latest"):
                    save_checkpoint(os.path.join(work_dir, name), model,
                                    opt, ckpt_meta(epoch + 1, gstep))
                log.info("checkpoint saved at epoch %d", epoch + 1)
            if eval_int and (epoch + 1) % eval_int == 0:
                model.eval()
                dets, gts = evaluator.run_inference_distributed(
                    val_dataset, model, model_cfg, device=device,
                    batch_size=bs, max_samples=eval_cfg.get("max_samples"),
                    box_type=box_type_of(cfg.data),
                    tmpdir=os.path.join(work_dir, ".dist_eval"))
                model.train()
                if dist.is_main_process():
                    res = evaluator.evaluate(dets, gts, cfg, val_dataset,
                                             log=log.info, device=device)
                    result["evals"][epoch + 1] = res
                    log.info("eval epoch %d | %s", epoch + 1,
                             " ".join(f"{k}={v:.4f}" for k, v in res.items()
                                      if isinstance(v, float) and v == v))
                t_last = time.perf_counter()
    result.update(epoch=epochs, step=gstep)
    return result


if __name__ == "__main__":
    main()
