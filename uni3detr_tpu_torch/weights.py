"""Weights of the port.

- :func:`state_dict_from_jax` turns the JAX package's variables
  (``{"params", "batch_stats"}`` as numpy) into the port's reference-
  layout ``state_dict``: the inverse of
  ``uni3detr_tpu/train/torch_import.py::import_torch_state_dict``.
- :func:`state_dict_from_jax_ov` does the same for ``OV_Uni3DETR``
  (``{"params", "batch_stats", "constants"}``): the inverse of
  ``import_torch_state_dict_ov``.
- :func:`state_dict_from_jax_vovnet` does the same for the JAX
  package's ``VoVNet`` (``models/vovnet.py``), whose keys are its module
  names.
- :func:`init_state_dict` starts a model as the JAX package's
  ``model.init`` does (``train/step.py::create_train_state``): each
  leaf from the initialiser of the flax module behind it
  (:func:`init_plan`), drawn from numpy's generator. ``cli.train`` starts
  from it.
- :func:`random_state_dict` makes seeded random weights for a model
  (numpy's generator, so every device gets the same numbers): a
  distribution for parity checks, with no zero or constant leaf to make
  a kernel's check trivial.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
from torch import nn

from .config import Uni3DETRConfig


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


class _Out:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def linear(self, k, p):
        self.sd[k + ".weight"] = _f32(np.asarray(p["kernel"]).T)
        self.sd[k + ".bias"] = _f32(p["bias"])

    def layernorm(self, k, p):
        self.sd[k + ".weight"] = _f32(p["scale"])
        self.sd[k + ".bias"] = _f32(p["bias"])

    def bn(self, k, p, s):
        self.sd[k + ".weight"] = _f32(p["scale"])
        self.sd[k + ".bias"] = _f32(p["bias"])
        self.sd[k + ".running_mean"] = _f32(s["mean"])
        self.sd[k + ".running_var"] = _f32(s["var"])
        self.sd[k + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def spconv(self, k, kernel):
        w = np.asarray(kernel)                          # (K, in, out)
        r = round(w.shape[0] ** (1.0 / 3.0))
        self.sd[k + ".weight"] = _f32(w.reshape(r, r, r, *w.shape[1:]))

    def conv3d(self, k, kernel):                        # (kd,kh,kw,in,out)
        self.sd[k + ".weight"] = _f32(np.asarray(kernel).transpose(
            4, 3, 0, 1, 2))

    def deconv3d(self, k, kernel):
        # flax ConvTranspose kernel -> torch (in, out, kd, kh, kw); torch's
        # transposed conv is the gradient form, so the taps flip
        w = np.asarray(kernel)[::-1, ::-1, ::-1]
        self.sd[k + ".weight"] = _f32(w.transpose(3, 4, 0, 1, 2))


def _encoder(o: _Out, cfg, p, s, prefix):
    o.spconv(f"{prefix}.conv_input.0", p["conv_input"]["_SpConv_0"]["kernel"])
    o.bn(f"{prefix}.conv_input.1", p["conv_input"]["MaskedBatchNorm_0"],
         s["conv_input"]["MaskedBatchNorm_0"])
    n_stages = len(cfg.encoder_channels)
    for i, blocks in enumerate(cfg.encoder_channels):
        strided = i < n_stages - 1
        body = blocks[:-1] if strided else blocks
        for j in range(len(body)):
            src = f"{prefix}.encoder_layers.encoder_layer{i + 1}.{j}"
            bp, bs = p[f"stage{i + 1}_block{j}"], s[f"stage{i + 1}_block{j}"]
            for n in (0, 1):
                o.spconv(f"{src}.conv{n + 1}", bp[f"_SpConv_{n}"]["kernel"])
                o.bn(f"{src}.bn{n + 1}", bp[f"MaskedBatchNorm_{n}"],
                     bs[f"MaskedBatchNorm_{n}"])
        if strided:
            src = f"{prefix}.encoder_layers.encoder_layer{i + 1}.{len(body)}"
            o.spconv(f"{src}.0", p[f"stage{i + 1}_down"]["kernel"])
            o.bn(f"{src}.1", p[f"stage{i + 1}_down_bn"],
                 s[f"stage{i + 1}_down_bn"])
    kern = np.asarray(p["conv_out"]["kernel"])          # Dense (in, out)
    o.sd[f"{prefix}.conv_out.0.weight"] = _f32(kern.reshape(
        1, 1, 1, *kern.shape))
    o.bn(f"{prefix}.conv_out.1", p["conv_out_bn"], s["conv_out_bn"])


def _backbone(o: _Out, cfg, p, s, prefix):
    for i, n in enumerate(cfg.backbone_layers):
        for k in range(n + 1):
            name = f"stage{i}_conv{k}"
            o.conv3d(f"{prefix}.blocks.{i}.{3 * k}",
                     p[name]["Conv_0"]["kernel"])
            o.bn(f"{prefix}.blocks.{i}.{3 * k + 1}", p[name]["BatchNorm_0"],
                 s[name]["BatchNorm_0"])


def _neck(o: _Out, cfg, p, s, prefix):
    for i, us in enumerate(cfg.neck_upsample_strides):
        if us > 1:
            o.deconv3d(f"{prefix}.deblocks.{i}.0",
                       p[f"deblock{i}_deconv"]["kernel"])
        else:
            o.conv3d(f"{prefix}.deblocks.{i}.0",
                     p[f"deblock{i}_conv"]["kernel"])
        o.bn(f"{prefix}.deblocks.{i}.1", p[f"deblock{i}_bn"],
             s[f"deblock{i}_bn"])
    for j in range(3):
        o.conv3d(f"{prefix}.extra_blocks.{3 * j}",
                 p[f"extra{j}"]["Conv_0"]["kernel"])
        o.bn(f"{prefix}.extra_blocks.{3 * j + 1}",
             p[f"extra{j}"]["BatchNorm_0"], s[f"extra{j}"]["BatchNorm_0"])


def _branch(o: _Out, k, p, layer_norm):
    idx = [0, 3, 6] if layer_norm else [0, 2, 4]
    for i, seq in enumerate(idx):
        o.linear(f"{k}.{seq}", p[f"Dense_{i}"])
    if layer_norm:
        for i, seq in enumerate((1, 4)):
            o.layernorm(f"{k}.{seq}", p[f"LayerNorm_{i}"])


def _mha(o: _Out, k, p):
    q = np.asarray(p["query"]["kernel"])                # (C, heads, dh)
    C = q.shape[0]
    ws = [np.asarray(p[n]["kernel"]).reshape(C, C).T
          for n in ("query", "key", "value")]
    bs = [np.asarray(p[n]["bias"]).reshape(C)
          for n in ("query", "key", "value")]
    o.sd[k + ".in_proj_weight"] = _f32(np.concatenate(ws, 0))
    o.sd[k + ".in_proj_bias"] = _f32(np.concatenate(bs, 0))
    o.sd[k + ".out_proj.weight"] = _f32(
        np.asarray(p["out"]["kernel"]).reshape(C, C).T)
    o.sd[k + ".out_proj.bias"] = _f32(p["out"]["bias"])


def _head(o: _Out, cfg, p, prefix):
    o.sd[f"{prefix}.tgt_embed.weight"] = _f32(p["tgt_embed"])
    o.sd[f"{prefix}.refpoint_embed.weight"] = _f32(p["refpoint_embed"])
    for l in range(cfg.num_decoder_layers):
        _branch(o, f"{prefix}.cls_branches.{l}", p[f"cls_branch{l}"], True)
        _branch(o, f"{prefix}.reg_branches.{l}", p[f"reg_branch{l}"], False)
        _branch(o, f"{prefix}.iou_branches.{l}", p[f"iou_branch{l}"], False)
    _decoder(o, cfg, p["decoder"], f"{prefix}.transformer.decoder")


def _decoder(o: _Out, cfg, dp, dec):
    for mlp in ("ref_point_head", "query_scale"):
        for i in range(3):
            o.linear(f"{dec}.{mlp}.layers.{i}", dp[mlp][f"Dense_{i}"])
    for l in range(cfg.num_decoder_layers):
        src, lp = f"{dec}.layers.{l}", dp[f"layer{l}"]
        _mha(o, f"{src}.attentions.0.attn", lp["self_attn"])
        ca, cs = lp["cross_attn"], f"{src}.attentions.1"
        o.linear(f"{cs}.attention_weights", ca["attention_weights"])
        o.linear(f"{cs}.output_proj", ca["output_proj"])
        o.linear(f"{cs}.position_encoder.0", ca["pos_enc0"])
        o.layernorm(f"{cs}.position_encoder.1", ca["LayerNorm_0"])
        o.linear(f"{cs}.position_encoder.3", ca["pos_enc1"])
        o.layernorm(f"{cs}.position_encoder.4", ca["LayerNorm_1"])
        o.linear(f"{src}.ffns.0.layers.0.0", lp["Dense_0"])
        o.linear(f"{src}.ffns.0.layers.1", lp["Dense_1"])
        for i in range(3):
            o.layernorm(f"{src}.norms.{i}", lp[f"LayerNorm_{i}"])


def state_dict_from_jax(variables: Mapping, cfg: Uni3DETRConfig
                        ) -> Dict[str, np.ndarray]:
    """JAX ``{"params", "batch_stats"}`` of ``Uni3DETR`` -> the port's
    ``state_dict`` as numpy arrays (load with ``strict=True``)."""
    p, s = variables["params"], variables["batch_stats"]
    o = _Out()
    _encoder(o, cfg, p["pts_middle_encoder"], s["pts_middle_encoder"],
             "pts_middle_encoder")
    _backbone(o, cfg, p["pts_backbone"], s["pts_backbone"], "pts_backbone")
    _neck(o, cfg, p["pts_neck"], s["pts_neck"], "pts_neck")
    _head(o, cfg, p["pts_bbox_head"], "pts_bbox_head")
    return o.sd


def _conv2d(o: _Out, k, p):
    """flax Conv (kh, kw, in, out) [+ bias] -> torch (out, in, kh, kw)."""
    o.sd[k + ".weight"] = _f32(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        o.sd[k + ".bias"] = _f32(p["bias"])


def _resnet(o: _Out, cfg, p, s, prefix):
    _conv2d(o, f"{prefix}.conv1", p["stem_conv"])
    o.bn(f"{prefix}.bn1", p["stem_bn"], s["stem_bn"])
    for i, n in enumerate((3, 4, 6, 3)):
        for j in range(n):
            src = f"{prefix}.layer{i + 1}.{j}"
            bp, bs = p[f"layer{i + 1}_{j}"], s[f"layer{i + 1}_{j}"]
            _conv2d(o, f"{src}.conv1", bp["conv1"])
            if cfg.stage_with_dcn[i]:
                w = np.asarray(bp["conv2"]["kernel"])   # (kk, in, out)
                k = round(w.shape[0] ** 0.5)
                o.sd[f"{src}.conv2.weight"] = _f32(
                    w.reshape(k, k, *w.shape[1:]).transpose(3, 2, 0, 1))
                _conv2d(o, f"{src}.conv2.conv_offset",
                        bp["conv2"]["offset_conv"])
            else:
                _conv2d(o, f"{src}.conv2", bp["conv2"])
            _conv2d(o, f"{src}.conv3", bp["conv3"])
            for b in (1, 2, 3):
                o.bn(f"{src}.bn{b}", bp[f"bn{b}"], bs[f"bn{b}"])
            if j == 0:
                _conv2d(o, f"{src}.downsample.0", bp["ds_conv"])
                o.bn(f"{src}.downsample.1", bp["ds_bn"], bs["ds_bn"])


def _view_trans(o: _Out, cfg, p, s, prefix):
    for k in range(cfg.num_view_convs):
        src = f"{prefix}.conv_trans_head_{k + 1}"
        o.conv3d(f"{src}.0", p[f"conv_trans{k + 1}"]["kernel"])
        o.sd[f"{src}.0.bias"] = _f32(p[f"conv_trans{k + 1}"]["bias"])
        o.bn(f"{src}.1", p[f"bn{k + 1}"], s[f"bn{k + 1}"])
    for name in ("trans_conv", "time_conv"):
        if name in p:
            # the JAX Dense is the port's 1x1 conv ``.0``
            kern = np.asarray(p[name]["kernel"])          # (in, out)
            o.sd[f"{prefix}.{name}.0.weight"] = _f32(kern.T.reshape(
                kern.shape[1], kern.shape[0], 1, 1, 1))
            o.sd[f"{prefix}.{name}.0.bias"] = _f32(p[name]["bias"])


def _head_clip(o: _Out, cfg, p, c, prefix):
    o.sd[f"{prefix}.tgt_embed.weight"] = _f32(p["tgt_embed"])
    o.sd[f"{prefix}.refpoint_embed.weight"] = _f32(p["refpoint_embed"])
    for l in range(cfg.num_decoder_layers):
        cb = p[f"cls_branch{l}"]
        for i, seq in enumerate((0, 3)):
            o.linear(f"{prefix}.cls_branches.{l}.{seq}", cb[f"Dense_{i}"])
            o.layernorm(f"{prefix}.cls_branches.{l}.{seq + 1}",
                        cb[f"LayerNorm_{i}"])
        _branch(o, f"{prefix}.uncertainty_branches.{l}",
                p[f"uncertainty_branch{l}"], True)
        _branch(o, f"{prefix}.reg_branches.{l}", p[f"reg_branch{l}"], False)
        _branch(o, f"{prefix}.iou_branches.{l}", p[f"iou_branch{l}"], False)
    _decoder(o, cfg, p["decoder"], f"{prefix}.transformer.decoder")
    # stored (ncls, clip_dim) in JAX, registered transposed in the reference
    o.sd[f"{prefix}.zs_weights"] = _f32(np.asarray(c["zs_weights"]).T)


def state_dict_from_jax_ov(variables: Mapping, cfg
                           ) -> Dict[str, np.ndarray]:
    """JAX ``{"params", "batch_stats", "constants"}`` of ``OV_Uni3DETR``
    -> the port's ``state_dict`` as numpy arrays: the inverse of
    ``import_torch_state_dict_ov`` (the reference's dead ``pts_conv`` /
    ``img_conv`` modules, which that importer drops, are not built)."""
    p, s = variables["params"], variables["batch_stats"]
    o = _Out()
    if "pts_middle_encoder" in p:
        _encoder(o, cfg, p["pts_middle_encoder"], s["pts_middle_encoder"],
                 "pts_middle_encoder")
        _backbone(o, cfg, p["pts_backbone"], s["pts_backbone"],
                  "pts_backbone")
        _neck(o, cfg, p["pts_neck"], s["pts_neck"], "pts_neck")
    if "img_backbone" in p:
        _resnet(o, cfg, p["img_backbone"], s["img_backbone"], "img_backbone")
        for i in range(4):
            for kind, name in (("lateral", "lateral_convs"),
                               ("fpn_conv", "fpn_convs")):
                _conv2d(o, f"img_neck.{name}.{i}.conv",
                        p["img_neck"][f"{kind}{i}"])
        _conv2d(o, "input_proj", p["input_proj"])
        _conv2d(o, "depth_net", p["depth_net"])
        _view_trans(o, cfg, p["view_trans"], s.get("view_trans", {}),
                    "view_trans")
    if "fusion_conv" in p:
        o.conv3d("conv_trans_head_1.0", p["fusion_conv"]["kernel"])
        o.sd["conv_trans_head_1.0.bias"] = _f32(p["fusion_conv"]["bias"])
        o.bn("conv_trans_head_1.1", p["fusion_bn"], s["fusion_bn"])
    _head_clip(o, cfg, p["pts_bbox_head"], variables["constants"][
        "pts_bbox_head"], "pts_bbox_head")
    return o.sd


DCN_OFFSET_SCALE = 0.02


def state_dict_from_jax_vovnet(variables: Mapping
                               ) -> Dict[str, np.ndarray]:
    """JAX ``{"params", "batch_stats"}`` of ``VoVNet`` -> the
    ``state_dict`` of ``models.vovnet.VoVNet``, module by module under
    the same names: each flax ConvBNReLU's ``Conv_0`` / ``BatchNorm_0``
    to ``.conv`` / ``.bn``, each eSE's ``Dense_0`` to ``.ese.fc``."""
    o = _Out()
    p, s = variables["params"], variables["batch_stats"]
    for name, sub in p.items():
        if name.startswith("stem"):
            sub, stats = {"": sub}, {"": s[name]}
        else:
            o.linear(f"{name}.ese.fc", sub["ese"]["Dense_0"])
            stats = s[name]
        for c, pp in sub.items():
            if c != "ese":
                k = f"{name}.{c}".rstrip(".")
                _conv2d(o, f"{k}.conv", pp["Conv_0"])
                o.bn(f"{k}.bn", pp["BatchNorm_0"], stats[c]["BatchNorm_0"])
    return o.sd


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for every entry of ``model.state_dict()``.

    Weights are N(0, 2/fan) (fan = fan_in + fan_out for linears, fan_in
    for convs), norm scales 1 + 0.1 N, biases 0.02 N, BN running means
    0.1 N and variances U(0.5, 1.5), embeddings N(0, 1), the CLIP text
    embeddings N(0, 1) normalised per class. The DCN offset convs take
    ``DCN_OFFSET_SCALE`` of a conv's weights: the deep ResNet stages'
    activations reach ~1e2, and full-size offset weights would move every
    tap out of the image (a DCN of zeros), where these move them by
    about a pixel or a few.
    """
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = np.asarray(0, np.int64)
        elif leaf == "zs_weights":  # (clip_dim, ncls), unit columns
            w = rng.randn(*shape)
            out[name] = w / np.linalg.norm(w, axis=0, keepdims=True)
        elif leaf == "running_var":
            out[name] = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean":
            out[name] = 0.1 * rng.randn(*shape)
        elif "embed" in name and len(shape) == 2:
            out[name] = rng.randn(*shape)
        elif len(shape) == 1 and leaf == "weight":
            out[name] = 1.0 + 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            out[name] = 0.02 * rng.randn(*shape)
        elif len(shape) == 2:       # linear / in_proj (out, in)
            out[name] = rng.randn(*shape) * math.sqrt(2.0 / sum(shape))
        elif "pts_middle_encoder" in name:  # (kd, kh, kw, in, out)
            fan_in = int(np.prod(shape[:-1]))
            out[name] = rng.randn(*shape) * math.sqrt(2.0 / fan_in)
        else:                       # conv (out, in, k..) / deconv (in, ..)
            fan_in = int(np.prod(shape[1:]))
            out[name] = rng.randn(*shape) * math.sqrt(2.0 / fan_in)
            if "conv_offset" in name:
                out[name] *= DCN_OFFSET_SCALE
        out[name] = np.asarray(out[name]).astype(
            np.int64 if leaf == "num_batches_tracked" else np.float32)
    return out


# -- the JAX package's initialisation ----------------------------------------

# the std of N(0, 1) truncated to [-2, 2]: flax's truncated variance
# scaling divides by it, so that the leaf keeps the std it asks for
TRUNCATED_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class Init:
    """How one leaf of the JAX package's ``model.init`` starts.

    ``kind``: ``"const"`` (every entry ``value``); ``"truncated"`` (flax's
    ``lecun_normal``, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: N(0, 1) cut to [-2, 2], times ``std`` /
    ``TRUNCATED_STD``, so entries lie within 2 ``std`` / ``TRUNCATED_STD``
    and the leaf's std is ``std``); ``"normal"`` (N(0, ``std``^2));
    ``"unit_columns"`` (the CLIP text embeddings: N(0, 1), each class's
    column scaled to norm 1)."""
    kind: str
    value: float = 0.0
    std: float = 1.0


def _lecun(fan_in: int) -> Init:
    return Init("truncated", std=1.0 / math.sqrt(fan_in))


def _normal(fan_in: int) -> Init:
    return Init("normal", std=1.0 / math.sqrt(fan_in))


_ZERO, _ONE = Init("const", 0.0), Init("const", 1.0)


def _leaf_init(name: str, mod: nn.Module, leaf: str, role) -> Init:
    """The :class:`Init` of ``mod``'s ``leaf``, by the flax module behind
    ``mod`` (the comments cite ``uni3detr_tpu/models/``). fan_in is counted in JAX's layout from ``mod``'s weight: a
    Dense (in, out) is the port's Linear (out, in), a Conv (k.., in, out)
    its (out, in, k..), a ConvTranspose (k.., in, out) its (in, out, k..),
    a sparse conv (K, in, out) its (kd, kh, kw, in, out)."""
    from torch.nn.modules.batchnorm import _BatchNorm

    from .models.dcn import DeformConv2dV2
    from .models.head import _CLS_BIAS_INIT
    from .models.head_clip import Uni3DETRHeadCLIP
    from .models.sparse_encoder import SparseConvWeight

    w = getattr(mod, "weight", None)
    if isinstance(mod, _BatchNorm):         # layers.py:27-31, flax BatchNorm
        rules = {"weight": _ONE, "bias": _ZERO, "running_mean": _ZERO,
                 "running_var": _ONE, "num_batches_tracked": _ZERO}
    elif isinstance(mod, nn.LayerNorm):
        rules = {"weight": _ONE, "bias": _ZERO}
    elif isinstance(mod, nn.Linear):        # nn.Dense, zero bias
        rules = {"weight": _ZERO if role == "zero" else _lecun(w.shape[1]),
                 "bias": Init("const", _CLS_BIAS_INIT)
                 if role == "cls_prior" else _ZERO}
    elif isinstance(mod, nn.MultiheadAttention):
        # flax's attention: q, k, v DenseGeneral (C, heads, dh), fan_in C
        rules = {"in_proj_weight": _lecun(mod.in_proj_weight.shape[1]),
                 "in_proj_bias": _ZERO}
    elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
        # nn.Conv, zero bias; the view transformer's 1x1 convs are Dense
        rules = {"weight": _ZERO if role == "zero"
                 else _lecun(w[0].numel()), "bias": _ZERO}
    elif isinstance(mod, nn.ConvTranspose3d):
        rules = {"weight": _lecun(w[:, 0].numel())}
    elif isinstance(mod, SparseConvWeight):
        # sparse_encoder.py:65-67; conv_out is a Dense (:293, :339)
        fan_in = w[..., 0].numel()
        rules = {"weight": _lecun(fan_in) if role == "dense"
                 else _normal(fan_in)}
    elif isinstance(mod, DeformConv2dV2):   # dcn.py:59
        rules = {"weight": _normal(w[0].numel())}
    elif isinstance(mod, nn.Embedding):     # head.py:58-60, head_clip.py:74-76
        rules = {"weight": Init("normal", std=1.0)}
    elif isinstance(mod, Uni3DETRHeadCLIP):  # head_clip.py:64-72
        rules = {"zs_weights": Init("unit_columns")}
    else:
        rules = {}
    if leaf not in rules:
        raise KeyError(f"init_plan: no initialiser for {name} "
                       f"({type(mod).__name__}.{leaf})")
    return rules[leaf]


def init_plan(model: nn.Module) -> Dict[str, Init]:
    """The :class:`Init` of every entry of ``model.state_dict()``, as the
    JAX package's modules initialise them: flax's defaults (``lecun_normal``
    kernels, zero biases, norms at scale 1 and bias 0, BN statistics at 0
    and 1) but for the sparse-conv and DCN kernels (untruncated, variance
    1 / fan_in), the query and reference embeddings (N(0, 1)), the zero
    ``attention_weights`` of the cross-attention and the zero DCN offset
    convs, and the focal prior -log(0.99 / 0.01) on each Lidar cls
    branch's last bias (the comments cite ``uni3detr_tpu/models/``).
    Raises KeyError for a leaf no rule covers."""
    from .models.dcn import DeformConv2dV2
    from .models.head import Uni3DETRHead
    from .models.sparse_encoder import SparseEncoderHD
    from .models.transformer import UniCrossAtten

    roles = {}
    for m in model.modules():
        if isinstance(m, UniCrossAtten):        # transformer.py:49
            roles[id(m.attention_weights)] = "zero"
        elif isinstance(m, DeformConv2dV2):     # dcn.py:37-38
            roles[id(m.conv_offset)] = "zero"
        elif isinstance(m, Uni3DETRHead):       # head.py:31, :80
            for br in m.cls_branches:
                roles[id(br[-1])] = "cls_prior"
        elif isinstance(m, SparseEncoderHD):
            roles[id(m.conv_out[0])] = "dense"
    plan = {}
    for name in model.state_dict():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        plan[name] = _leaf_init(name, mod, leaf, roles.get(id(mod)))
    return plan


def _truncated_normal(rng: np.random.RandomState, shape) -> np.ndarray:
    """N(0, 1) cut to [-2, 2], entries outside redrawn."""
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return x


def init_state_dict(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """``model``'s initial weights, every leaf from its
    :func:`init_plan` rule, drawn in ``state_dict`` order from one
    ``numpy.random.RandomState(seed)`` (the same numbers on every
    device). The draws are not flax's, whose generator is JAX's; the
    families, scales and constants are."""
    rng = np.random.RandomState(seed)
    plan = init_plan(model)
    out = {}
    for name, t in model.state_dict().items():
        init, shape = plan[name], tuple(t.shape)
        if init.kind == "const":
            a = np.full(shape, init.value)
        elif init.kind == "normal":
            a = rng.standard_normal(shape) * init.std
        elif init.kind == "truncated":
            a = _truncated_normal(rng, shape) * (init.std / TRUNCATED_STD)
        else:                                   # unit_columns
            a = rng.standard_normal(shape)
            a = a / np.linalg.norm(a, axis=0, keepdims=True)
        out[name] = np.array(
            a, np.float32 if t.dtype.is_floating_point else np.int64)
    return out
