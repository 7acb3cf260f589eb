"""Train step of the port (counterpart of ``uni3detr_tpu/train/step.py``).

One step: forward in train mode -> matching -> set losses -> backward ->
global-norm clip -> AdamW, as the JAX package's ``make_train_step`` with
``make_optimizer`` (optax ``chain(clip_by_global_norm, adamw)`` over all
parameters, no mask). The lr follows a schedule of the step count, as
optax's ``scale_by_schedule`` does.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, Union

import torch
from torch import nn

from ..geom.boxes import gravity_center_boxes
from .losses import uni3detr_loss

Schedule = Callable[[int], float]


class Optimizer:
    """Global-norm clip to ``clip_norm``, then AdamW (betas 0.9/0.999,
    eps 1e-8, decoupled weight decay) with the lr of ``lr_schedule`` at
    the number of steps taken so far."""

    def __init__(self, params: Iterable[nn.Parameter],
                 lr_schedule: Union[float, Schedule],
                 weight_decay: float = 0.01, clip_norm: float = 10.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr_schedule if callable(lr_schedule) \
            else (lambda step: lr_schedule)
        self.clip_norm = clip_norm
        self.steps = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=float(self.schedule(0)), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Clip and update; returns the global gradient norm before the
        clip. A parameter the loss did not reach gets a zero gradient, so
        weight decay still applies to it, as in optax."""
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax clip_by_global_norm: g * max / norm when norm >= max
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = float(self.schedule(self.steps))
        self.adamw.step()
        self.steps += 1
        return norm


def make_optimizer(model: nn.Module, lr_schedule: Union[float, Schedule],
                   weight_decay: float = 0.01,
                   clip_norm: float = 10.0) -> Optimizer:
    """AdamW + global-norm clip over all of ``model``'s parameters (the
    reference's optimizer_config, uni3detr_sunrgbd.py)."""
    return Optimizer(model.parameters(), lr_schedule, weight_decay,
                     clip_norm)


def step_lr_schedule(base_lr: float, steps_per_epoch: int, milestones,
                     gamma: float = 0.1, warmup_steps: int = 0,
                     warmup_ratio: float = 1.0 / 3) -> Schedule:
    """mmcv's step policy: ``base_lr`` times ``gamma`` per milestone
    (in epochs) passed, after a linear warmup from ``base_lr *
    warmup_ratio`` over ``warmup_steps`` steps (optax's
    ``piecewise_constant_schedule`` joined after a ``linear_schedule``)."""
    bounds = sorted(int(m * steps_per_epoch) for m in milestones)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return (base_lr * warmup_ratio - base_lr) * (
                1 - step / warmup_steps) + base_lr
        s = step - warmup_steps
        return base_lr * gamma ** bisect.bisect_right(bounds, s)

    return schedule


def train_step(model: nn.Module, opt: Optimizer,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One step on ``batch``: points (B, P, C), pts_mask (B, P), gt_boxes
    (B, G, 7|9) in the bottom-z storage layout, gt_labels (B, G), gt_mask
    (B, G). Dropout draws from torch's global generator.

    Returns detached logs: ``total_loss``, ``grad_norm`` (before the
    clip) and the per-layer loss terms of :func:`uni3detr_loss`."""
    cfg = model.cfg
    model.train()
    opt.zero_grad()
    outs = model(batch["points"], batch["pts_mask"])
    gt = gravity_center_boxes(batch["gt_boxes"])
    total, logs = uni3detr_loss(outs, gt, batch["gt_labels"],
                                batch["gt_mask"], cfg)
    total.backward()
    grad_norm = opt.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["total_loss"] = total.detach()
    logs["grad_norm"] = grad_norm
    return logs
