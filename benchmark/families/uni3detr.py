"""Uni3DETR, the Lidar detector: the port's ``models.detector.Uni3DETR``
on the point scenes of ``bench_scenes``, judged against the plain
``reference.model.Detector``, ``reference.loss.total_loss`` and
``reference.postprocess.detect``. The names are those of
``families/__init__.py``."""
from __future__ import annotations

import bench_count
import bench_scenes
from reference.loss import total_loss as reference_loss  # noqa: F401
from reference.model import Detector, quantizer  # noqa: F401
from reference.postprocess import detect as reference_detect  # noqa: F401

STAGE_MODULES = (("encoder", "pts_middle_encoder"),
                 ("backbone_neck", "pts_neck"),
                 ("head", "pts_bbox_head"))
train_batch = bench_scenes.train_batch
infer_batch = bench_scenes.infer_batch
weight_rule = None


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(model):
    from uni3detr_tpu_torch.config import Uni3DETRConfig
    return Uni3DETRConfig(**{k: _tuples(v) for k, v in model.items()})


def build(cfg):
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    return Uni3DETR(cfg)


def infer(model, batch):
    return model(batch["points"], batch["pts_mask"], batch["random_points"])


def optimizer_kwargs(config):
    return {}


def reference(model):
    return Detector(model)


def reference_forward(ref, batch, quant):
    return ref(batch["points"], quant=quant)


def reference_scene(ref, batch, b, device, quant):
    pts = batch["points"][b:b + 1].to(device)
    rnd = batch["random_points"][b:b + 1].to(device)
    return {k: v[:, 0] for k, v in ref(pts, rnd, quant).items()}


def dense_flops(model, batch, train):
    """FLOPs of SECOND3D, the FPN and the head for a batch of ``batch``
    scenes: ``FlopCounterMode`` over the plain reference on meta tensors
    (forward; with ``train`` also the backward of the outputs' sum)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        ref = Detector(model)
    ref.train(train)
    D, H, W = model["grid_size"]
    for pad in model["encoder_downsample_paddings"]:
        D, H, W = ((g + 2 * p - 3) // 2 + 1 for g, p in zip((D, H, W), pad))
    nq = model["num_query"]
    vol = torch.empty(batch, D, H, W, model["encoder_out_channels"],
                      device="meta", requires_grad=train)
    seeds = torch.empty(batch, 2 * nq, 3, device="meta")
    rnd = torch.empty(batch, nq, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        outs = ref.dense(vol, seeds, rnd, quantizer("float32"))
        if train:
            sum(v.sum() for v in outs.values()).backward()
    return float(fc.get_total_flops())


def work(model, train, batch, batches):
    V = model["max_voxels"] if train else model["max_voxels_test"]
    return bench_count.Work(model, V, batch, train,
                            [(i, b["points"].numpy()) for i, b in batches],
                            dense_flops)
