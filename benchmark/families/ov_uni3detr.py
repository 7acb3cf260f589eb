"""OV-Uni3DETR, the multimodal open-vocabulary detector: the port's
``models.ov_detector.OV_Uni3DETR`` on the point scenes of
``bench_scenes``, each with one image a camera and its camera drawn
from the seed, judged against the plain ``reference.ov_model.OVDetector``
and ``reference.postprocess.detect``. The names are those of
``families/__init__.py``.

Drawn where a deployment loads files: the images (pixels uniform in [0,
255), normalised with the configuration's ImageNet mean and deviation),
the cameras (SUN RGB-D's intrinsics, f about 520 at 640 wide, the
principal point at the centre; the camera at the origin looking along +y,
so about half of the encoder grid lies in its frustum) and a small yaw
as ``uni_rot_aug``; and, with the weights, the CLIP text embeddings of
the classes (the head's ``zs_weights``) in place of a ``zeroshot_path``.

Inference only: the reference has no modality draw and no uncertainty
loss, so ``reference_forward`` and ``reference_loss`` raise, and no
train cell runs this family.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import bench_count
import bench_scenes
from reference.ov_model import OVDetector, encoder_grid, quantizer  # noqa: F401
from reference.postprocess import detect as reference_detect  # noqa: F401

# the stages in the order the forward runs them; "image" also holds the
# point branch's FPS, which runs between the neck and the image branch
STAGE_MODULES = (("encoder", "pts_middle_encoder"),
                 ("backbone_neck", "pts_neck"),
                 ("image", "view_trans"),
                 ("fusion", "conv_trans_head_1"),
                 ("head", "pts_bbox_head"))
# world (x right, y forward, z up) -> camera (x right, y down, z forward)
LIDAR_TO_CAMERA = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                            [0, 0, 0, 1]], np.float32)
FOCAL = 520.0          # SUN RGB-D's focal length at 640 pixels wide
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
# the generators' tags beside ``bench_scenes.TAGS`` (1, 2)
CAMERA_TAGS = {"train": 3, "infer": 4}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(model):
    from uni3detr_tpu_torch.config import OVUni3DETRConfig
    return OVUni3DETRConfig(**{k: _tuples(v) for k, v in model.items()})


def build(cfg):
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    return OV_Uni3DETR(cfg)


def cameras(seed, model, batch, index, tag):
    """Batch ``index``'s images (B, N, H, W, 3), ``lidar2img`` (B, N, 4,
    4) and ``uni_rot_aug`` (B, 3, 3), float32: focal lengths within 5% of
    ``FOCAL``, yaws within 0.1 rad."""
    rng = np.random.default_rng([int(seed), CAMERA_TAGS[tag], int(index)])
    H, W = model["img_size"]
    N = model["num_cams"]
    pixels = rng.random((batch, N, H, W, 3), dtype=np.float32) * 255.0
    K = np.zeros((batch, N, 4, 4), np.float32)
    K[..., 0, 0] = K[..., 1, 1] = FOCAL * W / 640 * rng.uniform(
        0.95, 1.05, (batch, N))
    K[..., 0, 2], K[..., 1, 2] = W / 2, H / 2
    K[..., 2, 2] = K[..., 3, 3] = 1.0
    yaw = rng.uniform(-0.1, 0.1, batch)
    rot = np.zeros((batch, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(yaw)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    rot[:, 2, 2] = 1.0
    return {"images": (pixels - IMG_MEAN) / IMG_STD,
            "lidar2img": K @ LIDAR_TO_CAMERA, "uni_rot_aug": rot}


def train_batch(seed, model, batch, index):
    return {**bench_scenes.train_batch(seed, model, batch, index),
            **cameras(seed, model, batch, index, "train")}


def infer_batch(seed, model, batch, index):
    return {**bench_scenes.infer_batch(seed, model, batch, index),
            **cameras(seed, model, batch, index, "infer")}


def infer(model, batch):
    return model(batch, batch["random_points"])


def optimizer_kwargs(config):
    return {"lr_mult": config["train"]["lr_mult"]}


def weight_rule(kind, name, mod, leaf, t):
    """``init``: Conv2d and DCN kernels lecun-normal, ``conv_offset``'s
    among them (so the DCNs sample at fractional offsets, where the JAX
    package's initialiser puts zeros), Conv2d biases 0,
    ``zs_weights`` N(0, 1 / clip_dim) (columns of about unit norm, as the
    normalised CLIP embeddings are); the rest by the shared rules."""
    if kind != "init":
        return None
    if leaf == "zs_weights":
        return ("normal", 0.0, 1 / math.sqrt(t.shape[0]))
    if t.dim() == 4 and leaf == "weight":
        return ("truncated", 0.0, 1 / math.sqrt(t[0].numel()))
    if isinstance(mod, torch.nn.Conv2d) and leaf == "bias":
        return ("const", 0.0, 0)
    return None


def reference(model):
    return OVDetector(model)


_NO_TRAIN = ("the OV reference is inference only: it has no modality "
             "draw and no uncertainty loss")


def reference_forward(ref, batch, quant):
    raise NotImplementedError(_NO_TRAIN)


def reference_loss(outs, batch, model):
    raise NotImplementedError(_NO_TRAIN)


SCENE_KEYS = ("points", "random_points", "images", "lidar2img",
              "uni_rot_aug")


def reference_scene(ref, batch, b, device, quant):
    one = {k: batch[k][b:b + 1].to(device) for k in SCENE_KEYS}
    return {k: v[:, 0] for k, v in ref(one, quant).items()}


def dense_flops(model, batch, train):
    """FLOPs of SECOND3D, the FPN, the image branch (ResNet-50 with its
    DCNs' products, the FPN, ``input_proj``, ``depth_net``), the view
    convs, the fusion and the head for a batch of ``batch`` scenes:
    ``FlopCounterMode`` over the plain reference on meta tensors
    (forward; with ``train`` also the backward of the outputs' sum)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        ref = OVDetector(model)
    ref.train(train)
    D, H, W = encoder_grid(model)
    nq, N = model["num_query"], model["num_cams"]
    Hi, Wi = model["img_size"]
    meta = dict(device="meta")
    vol = torch.empty(batch, D, H, W, model["encoder_out_channels"],
                      requires_grad=train, **meta)
    inputs = (vol, torch.empty(batch, 2 * nq, 3, **meta),
              torch.empty(batch, nq, 3, **meta),
              torch.empty(batch, N, Hi, Wi, 3, **meta),
              torch.empty(batch, N, 4, 4, **meta),
              torch.empty(batch, 3, 3, **meta))
    with FlopCounterMode(display=False) as fc:
        outs = ref.dense(*inputs, quantizer("float32"))
        if train:
            sum(v.sum() for v in outs.values()).backward()
    return float(fc.get_total_flops())


def work(model, train, batch, batches):
    V = model["max_voxels"] if train else model["max_voxels_test"]
    return bench_count.Work(model, V, batch, train,
                            [(i, b["points"].numpy()) for i, b in batches],
                            dense_flops)
