"""Weights drawn on the device from the run's seed.

Every entry of a model's ``state_dict`` gets a family by its module's
(plain ``torch.nn``) type and its name, and all entries are drawn from one
``torch.Generator`` on the device in two large calls (one normal, one
uniform), in sorted name order, so that the system under test and the
reference, whose entries have the same names, get the same numbers. A
model family's own rule (its ``weight_rule``) is tried before the shared
ones below.

``init``: the state training starts from (the JAX package's
initialisers): norms at scale 1 and bias 0, BN statistics 0 and 1,
Dense / conv kernels ``lecun_normal`` (normal cut at two standard
deviations, std 1 / sqrt(fan_in)), sparse-conv kernels N(0, 1 / fan_in),
embeddings N(0, 1), zero cross-attention weights and the focal prior
-log(0.99 / 0.01) on each class branch's last bias.

``random``: a wider spread for inference, so that every query gives a
box in range (the port's ``weights.random_state_dict``): kernels N(0, 2
/ fan), norm scales 1 + 0.1 N, biases 0.02 N, BN running means 0.1 N
and variances U(0.5, 1.5), embeddings N(0, 1).
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn

TRUNCATED_STD = 0.87962566103423978
CLS_PRIOR = -math.log((1 - 0.01) / 0.01)

# (family, a, b): const a; normal a + b N; truncated b T; uniform a + b U


def _owners(model: nn.Module):
    owner = {}
    for mname, mod in model.named_modules():
        for leaf, _ in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            owner[f"{mname}.{leaf}" if mname else leaf] = (mod, leaf)
    return owner


def _init_rule(name, mod, leaf, t):
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return ("const", 1.0 if leaf in ("weight", "running_var") else 0.0, 0)
    if isinstance(mod, nn.LayerNorm):
        return ("const", 1.0 if leaf == "weight" else 0.0, 0)
    if isinstance(mod, nn.Embedding):
        return ("normal", 0.0, 1.0)
    if isinstance(mod, nn.MultiheadAttention):
        if leaf == "in_proj_weight":
            return ("truncated", 0.0, 1 / math.sqrt(t.shape[1]))
        return ("const", 0.0, 0)
    if isinstance(mod, nn.Linear):
        if leaf == "bias":
            prior = re.search(r"cls_branches\.\d+\.6\.bias$", name)
            return ("const", CLS_PRIOR if prior else 0.0, 0)
        if name.endswith("attention_weights.weight"):
            return ("const", 0.0, 0)
        return ("truncated", 0.0, 1 / math.sqrt(t.shape[1]))
    if isinstance(mod, nn.ConvTranspose3d):
        return ("truncated", 0.0, 1 / math.sqrt(t[:, 0].numel()))
    if isinstance(mod, nn.Conv3d):
        if leaf == "bias":
            return ("const", 0.0, 0)
        return ("truncated", 0.0, 1 / math.sqrt(t[0].numel()))
    if t.dim() == 5 and leaf == "weight":        # sparse conv (k, k, k, in, out)
        fan_in = t[..., 0].numel()
        if name.endswith("conv_out.0.weight"):
            return ("truncated", 0.0, 1 / math.sqrt(fan_in))
        return ("normal", 0.0, 1 / math.sqrt(fan_in))
    raise KeyError(f"no initialiser for {name} ({type(mod).__name__})")


def _random_rule(name, mod, leaf, t):
    shape = tuple(t.shape)
    if leaf == "num_batches_tracked":
        return ("const", 0.0, 0)
    if leaf == "running_var":
        return ("uniform", 0.5, 1.0)
    if leaf == "running_mean":
        return ("normal", 0.0, 0.1)
    if "embed" in name and len(shape) == 2:
        return ("normal", 0.0, 1.0)
    if len(shape) == 1:
        return ("normal", 1.0, 0.1) if leaf == "weight" \
            else ("normal", 0.0, 0.02)
    if len(shape) == 2:
        return ("normal", 0.0, math.sqrt(2.0 / sum(shape)))
    if "pts_middle_encoder" in name:
        return ("normal", 0.0, math.sqrt(2.0 / math.prod(shape[:-1])))
    return ("normal", 0.0, math.sqrt(2.0 / math.prod(shape[1:])))


RULES = {"init": _init_rule, "random": _random_rule}


def plan(model: nn.Module, kind: str, model_rule=None):
    """name -> (family, a, b, shape, dtype), sorted by name; ``model_rule``
    is a model family's ``weight_rule``."""
    owner = _owners(model)
    rule = RULES[kind]
    out = {}
    for name, t in sorted(model.state_dict().items()):
        mod, leaf = owner[name]
        if not t.dtype.is_floating_point:
            fam = ("const", 0.0, 0)
        else:
            fam = model_rule and model_rule(kind, name, mod, leaf, t)
            fam = fam or rule(name, mod, leaf, t)
        out[name] = (*fam, tuple(t.shape), t.dtype)
    return out


@torch.no_grad()
def draw(model: nn.Module, seed: int, kind: str, device,
         model_rule=None) -> dict:
    """The ``state_dict`` of ``model`` drawn from ``seed`` on ``device``
    (``model_rule``: as :func:`plan`'s)."""
    p = plan(model, kind, model_rule)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = {k: math.prod(v[3]) for k, v in p.items()}
    nrm = [k for k, v in p.items() if v[0] in ("normal", "truncated")]
    uni = [k for k, v in p.items() if v[0] == "uniform"]
    n_total = sum(sizes[k] for k in nrm)
    normal = torch.randn(n_total, generator=gen, device=device)
    trunc = torch.cat([torch.full((sizes[k],), p[k][0] == "truncated",
                                  device=device) for k in nrm]) \
        if nrm else torch.zeros(0, dtype=torch.bool, device=device)
    while True:
        bad = trunc & (normal.abs() > 2.0)
        if not bool(bad.any()):
            break
        normal = torch.where(bad, torch.randn(n_total, generator=gen,
                                              device=device), normal)
    uniform = torch.rand(sum(sizes[k] for k in uni), generator=gen,
                         device=device)
    out, on, ou = {}, 0, 0
    for k, (fam, a, b, shape, dtype) in p.items():
        n = sizes[k]
        if fam == "const":
            v = torch.full(shape, a, device=device)
        elif fam == "uniform":
            v = a + b * uniform[ou:ou + n].view(shape)
            ou += n
        elif fam == "truncated":
            v = normal[on:on + n].view(shape) * (b / TRUNCATED_STD)
            on += n
        else:
            v = a + b * normal[on:on + n].view(shape)
            on += n
        out[k] = v.to(dtype)
    return out
