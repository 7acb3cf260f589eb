"""Batched inference over a dataset's val split, test-time augmentation
and the metric dispatch (port of ``uni3detr_tpu/train/evaluator.py``).

:func:`run_inference` is a pipelined loop. A thread loads, runs the test
pipeline on and collates batch k+1 (``data.loading.prefetch``, pinned
host tensors) while the main thread sends batch k to the device
(non-blocking), runs the model, ``train.coder`` (decode, per-class NMS,
thresholds) and, with TTA, maps each view's boxes back and merges the
views with one BEV NMS for the batch (``train.tta``). Each batch's
outputs are packed into one tensor (``eval.postprocess.pack_batch``) and
copied to pinned host memory without waiting; the host splits and
post-processes batch k (box merging, the TTA cut) while the device runs
batch k+1. A batch is always ``batch_size`` scenes: the tail repeats its
last scene and the surplus detections are dropped, as in the JAX
package.

:func:`run_inference_distributed` runs one round-robin shard of the
split on each rank of a process group and gathers the detections on
rank 0 in dataset order (the JAX package's multi-process eval). The JAX
package's single-process eval over a local device mesh
(``run_inference(mesh=)``) has no counterpart: the port runs one process
per card.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import collate_batch
from ..data.loading import prefetch
from ..eval.postprocess import pack_batch, postprocess_sample, unpack_batch
from ..parallel import dist
from .coder import decode_predictions, post_process
from .tta import (apply_aug_points, map_boxes_back, merge_aug_detections,
                  select_merged)

# the collated keys the models read (the GT stays on the host)
MODEL_KEYS = ("points", "pts_mask", "images", "lidar2img", "uni_rot_aug",
              "sweep_times", "img_rot_aug", "img_trans_aug")
TTA_NMS_THR, TTA_MAX_OUT = 0.1, 500   # train/tta.py merge_aug_detections


def is_ov(cfg) -> bool:
    """Whether ``cfg`` is an OV-Uni3DETR config (``OVUni3DETRConfig``)."""
    return hasattr(cfg, "clip_dim")


def forward(model, cfg, batch: Dict[str, torch.Tensor], random_points):
    """The head outputs of one forward of a collated batch (tensors on
    the model's device)."""
    if is_ov(cfg):
        return model(batch, random_points)
    return model(batch["points"], batch["pts_mask"], random_points)


def _sync_mode(mode: Optional[str], device):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, on a CUDA
    device and when ``mode`` is given."""
    if mode is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def ctx():
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return ctx()


def run_inference(dataset, model, cfg, *, device="cuda",
                  batch_size: int = 1, max_samples: Optional[int] = None,
                  tta_grid: Optional[List[dict]] = None,
                  box_type: str = "Depth", log=None,
                  random_points: Optional[Callable] = None,
                  sync_debug_mode: Optional[str] = None,
                  stats: Optional[dict] = None):
    """Run ``model`` (a ``Uni3DETR`` or ``OV_Uni3DETR`` in eval mode on
    ``device``) over ``dataset`` and return (dets, gts): one dict of
    numpy 'boxes', 'scores', 'labels' per scene, and the scenes' GT
    ('boxes', 'labels', and 'attrs' where the dataset has them).

    ``tta_grid``: augmentations from ``train.tta.make_aug_grid``; each
    runs its own forward, Lidar models only. The random query group of
    each forward is (B, num_query, 3) uniform points drawn from a
    ``torch.Generator`` on ``device`` seeded 0, batch by batch and view
    by view; ``random_points(batch_index, view_index)``, when given,
    supplies them instead (the tests inject the JAX package's draws).
    With ``sync_debug_mode`` ("warn" or "error") decoding,
    post-processing, the TTA merge and the output copy run under
    ``torch.cuda.set_sync_debug_mode``. ``stats``, when given, receives
    per batch the host's load and collate ms (``load_ms``), the device's
    ms from the input copy to the output copy (``stream_ms``, CUDA
    events) and the seconds from the start at which its scenes were
    done (``done_s``), and the wall time (``wall_s``).
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    augs = tta_grid or [None]
    if tta_grid and is_ov(cfg):
        raise ValueError("TTA supports lidar-only models")
    merging = cfg.post_processing == "box_merging"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    stats = stats if stats is not None else {}
    stats.update(load_ms=[], stream_ms=[], done_s=[], scenes=n, batches=0)
    dets: List[dict] = []
    gts: List[dict] = []

    def produce():
        for start in range(0, n, batch_size):
            t0 = time.perf_counter()
            samples = [dataset[i] for i in
                       range(start, min(start + batch_size, n))]
            real = len(samples)
            samples += [samples[-1]] * (batch_size - real)  # pad tail
            batches = []
            for aug in augs:
                cur = samples
                if aug is not None:
                    if "images" in samples[0]:
                        raise ValueError("TTA supports lidar-only models")
                    cur = [dict(s, points=apply_aug_points(
                        s["points"], aug, box_type=box_type))
                        for s in samples]
                batch, _ = collate_batch(cur, cfg.num_points, cfg.max_gt,
                                         cfg.in_point_features,
                                         cfg.code_size)
                batch = {k: torch.from_numpy(v) for k, v in batch.items()
                         if k in MODEL_KEYS}
                if cuda:
                    batch = {k: v.pin_memory() for k, v in batch.items()}
                batches.append(batch)
            stats["load_ms"].append((time.perf_counter() - t0) * 1e3)
            yield start, real, samples, batches

    def launch(k, batches):
        """Batch k's device work, ending with its packed outputs on
        their way to the host: (host tensor, done event, events)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if cuda else None
        if cuda:
            ev[0].record()
        outs = []
        for a, (aug, batch) in enumerate(zip(augs, batches)):
            batch = {key: v.to(device, non_blocking=True)
                     for key, v in batch.items()}
            B = batch["points"].shape[0]
            if random_points is not None:
                rp = torch.as_tensor(random_points(k, a),
                                     dtype=torch.float32, device=device)
            else:
                rp = torch.rand((B, cfg.num_query, 3), generator=gen,
                                device=device)
            heads = forward(model, cfg, batch, rp)
            with _sync_mode(sync_debug_mode, device):
                boxes, scores, labels, valid = post_process(
                    *decode_predictions(heads, cfg), cfg)
                if aug is not None:
                    boxes = map_boxes_back(boxes, aug, box_type=box_type)
            outs.append((boxes, scores, labels, valid))
        with _sync_mode(sync_debug_mode, device):
            if len(outs) > 1:
                boxes, scores, labels, valid, keep = merge_aug_detections(
                    outs, cfg.num_classes, TTA_NMS_THR)
                packed = pack_batch(boxes, scores, labels, valid, keep=keep)
            else:
                packed = pack_batch(*outs[0], with_iou=merging)
            if not cuda:
                return packed, None, None
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ev[1].record()
        return host, ev[1], ev

    def consume(pending):
        real, samples, host, done, ev, D = pending
        if done is not None:
            done.synchronize()
            stats["stream_ms"].append(ev[0].elapsed_time(ev[1]))
        per_scene = unpack_batch(host.numpy(), D,
                                 with_iou=merging and len(augs) == 1,
                                 with_keep=len(augs) > 1)
        for bi in range(real):
            det = per_scene[bi]
            if len(augs) > 1:
                det = select_merged(det, TTA_MAX_OUT)
            dets.append(postprocess_sample(det, cfg, device=device))
            gt = {"boxes": samples[bi]["gt_boxes"],
                  "labels": samples[bi]["gt_labels"]}
            meta = samples[bi].get("meta", {})
            if "gt_attrs" in meta:
                gt["attrs"] = meta["gt_attrs"]
            gts.append(gt)
        stats["done_s"].append(time.perf_counter() - t_start)

    t_start = time.perf_counter()
    pending = None
    D = 9 if cfg.code_size > 8 else 7
    with torch.inference_mode():
        for k, (start, real, samples, batches) in enumerate(
                prefetch(produce(), depth=2)):
            host, done, ev = launch(k, batches)
            if pending is not None:
                consume(pending)
            pending = (real, samples, host, done, ev, D)
            stats["batches"] += 1
            if log and k % 25 == 24:
                log(f"[{min(start + batch_size, n)}/{n}]")
        if pending is not None:
            consume(pending)
    stats["wall_s"] = time.perf_counter() - t_start
    return dets, gts


class _DatasetShard:
    """Index-remapped view of a dataset (one rank's eval shard)."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[i]]


def run_inference_distributed(dataset, model, cfg, *, device="cuda",
                              batch_size: int = 1,
                              max_samples: Optional[int] = None,
                              tta_grid: Optional[List[dict]] = None,
                              box_type: str = "Depth", log=None,
                              tmpdir: Optional[str] = None,
                              random_points: Optional[Callable] = None,
                              **kw):
    """:func:`run_inference` over the ranks of a process group: rank r of
    W runs the scenes ``range(r, n, W)`` of the first n, the detections
    and GT are gathered on rank 0 (``parallel.dist.gather_objects``, in
    ``tmpdir`` under ``UNI3DETR_GATHER=file``) and returned there in
    dataset order; the other ranks return ([], []). A single process runs
    :func:`run_inference` on the whole split. ``random_points(scenes,
    view_index)``, when given, supplies a batch's random query group from
    the dataset indices of its scenes (the padded tail repeats the last),
    so that draws keyed by scene are the same for any number of ranks.
    Without it each rank draws from a generator seeded 0, as each JAX
    process restarts ``PRNGKey(0)``: W ranks do not draw one process's
    points (ROADMAP Queue 3). Other keywords go to :func:`run_inference`.
    """
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    w, r = dist.world_size(), dist.rank()
    idxs = list(range(r, n, w))
    rp = None
    if random_points is not None:
        def rp(k, a):
            scenes = idxs[k * batch_size:(k + 1) * batch_size]
            return random_points(
                scenes + [scenes[-1]] * (batch_size - len(scenes)), a)
    if w == 1:
        return run_inference(dataset, model, cfg, device=device,
                             batch_size=batch_size, max_samples=n,
                             tta_grid=tta_grid, box_type=box_type, log=log,
                             random_points=rp, **kw)
    dets_l, gts_l = run_inference(
        _DatasetShard(dataset, idxs), model, cfg, device=device,
        batch_size=batch_size, tta_grid=tta_grid, box_type=box_type,
        log=log, random_points=rp, **kw)
    parts = dist.gather_objects((idxs, dets_l, gts_l), tmpdir, name="eval")
    if parts is None:
        return [], []
    dets, gts = [None] * n, [None] * n
    for part_idxs, part_dets, part_gts in parts:
        for i, d, g in zip(part_idxs, part_dets, part_gts):
            dets[i], gts[i] = d, g
    assert all(d is not None for d in dets)
    return dets, gts


def evaluate(dets, gts, cfg, dataset, *, out_prefix: Optional[str] = None,
             log=print, format_only: bool = False,
             device="cuda") -> Dict[str, float]:
    """Metric dispatch by dataset_type. Returns a flat {name: float} dict.

    kitti: the GT from the dataset's infos, each det's 2D box and alpha
    from its calib, the label txts (with ``out_prefix`` or
    ``format_only``), then ``kitti_eval``; nuscenes: the submission JSON
    (likewise), then ``nuscenes_detection_metrics``; otherwise
    ``indoor_eval`` (with ``seen_classes``) and its table. The overlaps
    of the metrics run on ``device``. ``format_only`` writes the
    submission files and computes no metric."""
    classes = list(cfg.class_names)
    dtype_ = cfg.data["dataset_type"]
    if dtype_ == "kitti":
        from ..eval.kitti_eval import (kitti_eval, kitti_gt_from_info,
                                       lidar_alpha, project_boxes_to_image)
        infos = getattr(dataset, "infos", None)
        if infos:
            # official-style eval: raw annotations + det 2D-height filter
            gts = [kitti_gt_from_info(infos[i], classes)
                   for i in range(len(dets))]
            for det, info in zip(dets, infos):
                if "calib" in info:
                    shape = info.get("image", {}).get("image_shape")
                    det["bbox"] = project_boxes_to_image(
                        det["boxes"], info["calib"], shape)
                    det["alpha"] = lidar_alpha(det["boxes"], info["calib"])
            if out_prefix or format_only:
                from ..eval.kitti_submission import write_kitti_results
                d = (out_prefix or "work_dirs/results") + "_kitti"
                n = write_kitti_results(dets, infos[:len(dets)], classes, d)
                log(f"wrote {n} KITTI result files under {d}")
        if format_only:
            return {}
        return kitti_eval(gts, dets, classes, device=device)
    if dtype_ == "nuscenes":
        from ..eval.nuscenes_eval import format_results
        from ..eval.nuscenes_metrics import nuscenes_detection_metrics
        infos = [dataset.infos[i] for i in range(len(dets))] \
            if hasattr(dataset, "infos") else []
        if (out_prefix or format_only) and infos:
            p = format_results(dets, infos, classes,
                               (out_prefix or "work_dirs/results")
                               + "_nusc.json")
            log(f"wrote nuScenes submission {p}")
        if format_only:
            return {}
        return nuscenes_detection_metrics(dets, gts, classes)
    if format_only:
        log("no submission format for indoor datasets (SUN RGB-D and "
            "ScanNet are evaluated directly); nothing written")
        return {}
    from ..eval.indoor_eval import format_table, indoor_eval
    res = indoor_eval(gts, dets, classes,
                      seen_classes=cfg.get("seen_classes"), device=device)
    log(format_table(res, classes))
    return {k: v for k, v in res.items() if isinstance(v, (int, float))}
