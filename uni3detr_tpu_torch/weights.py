"""Weights of the port.

- :func:`state_dict_from_jax` turns the JAX package's variables
  (``{"params", "batch_stats"}`` as numpy) into the port's reference-
  layout ``state_dict``: the inverse of
  ``uni3detr_tpu/train/torch_import.py::import_torch_state_dict``.
- :func:`random_state_dict` makes seeded random weights for a model
  (numpy's generator, so every device gets the same numbers).
"""
from __future__ import annotations

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
    dec, dp = f"{prefix}.transformer.decoder", p["decoder"]
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


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for every entry of ``model.state_dict()``.

    Weights are N(0, 2/fan) (fan = fan_in + fan_out for linears, fan_in
    for convs), norm scales 1 + 0.1 N, biases 0.02 N, BN running means
    0.1 N and variances U(0.5, 1.5), embeddings N(0, 1).
    """
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = np.asarray(0, np.int64)
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
        out[name] = np.asarray(out[name]).astype(
            np.int64 if leaf == "num_batches_tracked" else np.float32)
    return out
