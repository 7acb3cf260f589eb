"""Train step of the port (counterpart of ``uni3detr_tpu/train/step.py``).

One step: forward in train mode -> matching -> set losses -> backward ->
global-norm clip -> AdamW, as the JAX package's ``make_train_step`` with
``make_optimizer`` (optax ``chain(clip_by_global_norm, adamw)``). The lr
follows a schedule of the step count, as optax's ``scale_by_schedule``
does; an optional momentum schedule sets AdamW's beta1 each step, as
``inject_hyperparams(adamw)(b1=...)`` does for the nuScenes cyclic
policy. Per-module lr multipliers (the OV configs' ``lr_mult``) are
AdamW parameter groups whose lr is the schedule's times the multiplier,
so the decoupled weight decay scales with them, as under the JAX
package's per-leaf scale after AdamW. Parameters that do not require
gradients (the frozen ResNet stages) stay out of the optimizer: never
updated, not even by weight decay (the reference's ``requires_grad =
False``; see ROADMAP Queue 3 for the JAX CLI's mask).
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import torch
from torch import nn

from ..config import OVUni3DETRConfig
from ..geom.boxes import gravity_center_boxes
from ..parallel import dist
from ..utils.profiling import span
from .losses import uni3detr_loss

Schedule = Callable[[int], float]


class Optimizer:
    """Global-norm clip to ``clip_norm``, then AdamW (beta2 0.999, eps
    1e-8, decoupled weight decay) with the lr of ``lr_schedule`` (times
    each group's ``lr_mult``) and the beta1 of ``momentum_schedule`` (0.9
    without one) at the number of steps taken so far.

    ``params``: parameters, or groups ``{"params": [...], "lr_mult": m}``;
    those that do not require gradients are left out."""

    def __init__(self, params: Iterable,
                 lr_schedule: Union[float, Schedule],
                 weight_decay: float = 0.01, clip_norm: float = 10.0,
                 momentum_schedule: Optional[Schedule] = None):
        groups = list(params)
        if not groups or not isinstance(groups[0], dict):
            groups = [{"params": groups}]
        groups = [{"params": [p for p in g["params"] if p.requires_grad],
                   "lr_mult": float(g.get("lr_mult", 1.0))} for g in groups]
        groups = [g for g in groups if g["params"]]
        self.params = [p for g in groups for p in g["params"]]
        self.schedule = lr_schedule if callable(lr_schedule) \
            else (lambda step: lr_schedule)
        self.momentum = momentum_schedule or (lambda step: 0.9)
        self.clip_norm = clip_norm
        self.steps = 0
        self.adamw = torch.optim.AdamW(
            groups, lr=float(self.schedule(0)),
            betas=(float(self.momentum(0)), 0.999), eps=1e-8,
            weight_decay=weight_decay)

    def _set_hyperparams(self) -> None:
        lr = float(self.schedule(self.steps))
        beta1 = float(self.momentum(self.steps))
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_mult"]
            group["betas"] = (beta1, group["betas"][1])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Clip and update; returns the global gradient norm before the
        clip. A parameter the loss did not reach gets a zero gradient, so
        weight decay still applies to it, as in optax. Under a process
        group of several ranks the gradients are first replaced by their
        sum over the ranks over the number of data groups (one flat
        all-reduce, ``dist.average_gradients``), so that the norm, the
        clip and the update are the global batch's on every rank; an
        unreached parameter takes part with its zeros (the OV modality
        draw leaves a branch without gradient on every rank alike)."""
        with span("optimizer"):
            return self._step()

    def _step(self) -> torch.Tensor:
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        dist.average_gradients(grads)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax clip_by_global_norm: g * max / norm when norm >= max
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        self._set_hyperparams()
        self.adamw.step()
        self.steps += 1
        return norm

    def state_dict(self) -> Dict:
        """AdamW's moments and step counts, and the schedule's step."""
        return {"adamw": self.adamw.state_dict(), "steps": self.steps}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.steps = int(state["steps"])


def lr_mult_groups(model: nn.Module, lr_mult: Mapping[str, float]):
    """``model``'s trainable parameters grouped by multiplier: each takes
    the first prefix of ``lr_mult`` (in its order) that is its module
    path or a parent of it, else 1; one group a multiplier, in the order
    of the parameters."""
    groups: Dict[float, list] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        mult = next((m for prefix, m in lr_mult.items()
                     if name == prefix or name.startswith(prefix + ".")),
                    1.0)
        groups.setdefault(float(mult), []).append(p)
    return [{"params": ps, "lr_mult": m} for m, ps in groups.items()]


def make_optimizer(model: nn.Module, lr_schedule: Union[float, Schedule],
                   weight_decay: float = 0.01, clip_norm: float = 10.0,
                   momentum_schedule: Optional[Schedule] = None,
                   lr_mult: Optional[Mapping[str, float]] = None
                   ) -> Optimizer:
    """AdamW + global-norm clip over ``model``'s trainable parameters
    (the reference's optimizer_config, uni3detr_sunrgbd.py), with the
    per-module multipliers of ``lr_mult`` (module-path prefix ->
    multiplier, e.g. the OV configs' ``lr_mult``) when given."""
    return Optimizer(lr_mult_groups(model, lr_mult or {}), lr_schedule,
                     weight_decay, clip_norm, momentum_schedule)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda step: init
    return lambda step: (init - end) * (
        1 - min(max(step, 0), steps) / steps) + end


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules`` of two: ``second`` gets the steps since
    the boundary."""
    return lambda step: first(step) if step < boundary \
        else second(step - boundary)


def step_lr_schedule(base_lr: float, steps_per_epoch: int, milestones,
                     gamma: float = 0.1, warmup_steps: int = 0,
                     warmup_ratio: float = 1.0 / 3) -> Schedule:
    """mmcv's step policy: ``base_lr`` times ``gamma`` per milestone
    (in epochs) passed, after a linear warmup from ``base_lr *
    warmup_ratio`` over ``warmup_steps`` steps (optax's
    ``piecewise_constant_schedule`` joined after a ``linear_schedule``)."""
    bounds = sorted(int(m * steps_per_epoch) for m in milestones)

    def steps(step: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(bounds, step)

    return _join(_linear(base_lr * warmup_ratio, base_lr, warmup_steps),
                 steps, warmup_steps)


def cyclic_lr_schedule(base_lr: float, total_steps: int,
                       target_ratio=(10, 1e-4),
                       step_ratio_up: float = 0.4) -> Schedule:
    """mmcv's cyclic policy (uni3detr_nuscenes.py lr_config): linear
    from ``base_lr`` up to ``base_lr * r0`` over the first
    ``step_ratio_up`` of the run, then a cosine down to ``base_lr * r1``
    (optax ``cosine_decay_schedule`` with ``alpha = r1 / r0``)."""
    up = int(total_steps * step_ratio_up)
    down = total_steps - up
    if down <= 0:
        raise ValueError("cyclic_lr_schedule needs total_steps * "
                         "(1 - step_ratio_up) >= 1")
    peak = base_lr * target_ratio[0]
    alpha = target_ratio[1] / target_ratio[0]

    def cosine(step):
        t = min(step, down)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / down))
                       + alpha)

    return _join(_linear(base_lr, peak, up), cosine, up)


def cyclic_momentum_schedule(base_m: float, total_steps: int,
                             target_ratio=(0.85 / 0.95, 1.0),
                             step_ratio_up: float = 0.4) -> Schedule:
    """mmcv's CyclicMomentumUpdater (uni3detr_nuscenes.py
    momentum_config): beta1 moves against the lr cycle, linear from
    ``base_m`` to ``base_m * r0`` over the up phase, then a cosine back
    to ``base_m * r1``."""
    up = int(total_steps * step_ratio_up)
    down = max(total_steps - up, 1)
    m1, m2 = base_m * target_ratio[0], base_m * target_ratio[1]

    def cos_rise(step):
        f = min(max(step / down, 0.0), 1.0)
        return m2 + (m1 - m2) * 0.5 * (1 + math.cos(math.pi * f))

    return _join(_linear(base_m, m1, up), cos_rise, up)


def train_step(model: nn.Module, opt: Optimizer,
               batch: Dict[str, torch.Tensor],
               modality_generator: Optional[torch.Generator] = None,
               modality: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One step on ``batch``: points (B, P, C), pts_mask (B, P), gt_boxes
    (B, G, 7|9) in the bottom-z storage layout, gt_labels (B, G), gt_mask
    (B, G); for OV-Uni3DETR the batch dict its forward reads (images,
    lidar2img, uni_rot_aug and / or the points), whose modality dropout
    draws ri from ``modality_generator`` (a CPU generator: no device
    sync) or takes ``modality``. Dropout draws from torch's global
    generator.

    Returns detached logs: ``total_loss``, ``grad_norm`` (before the
    clip) and the per-layer loss terms of :func:`uni3detr_loss`. Under a
    process group of several ranks ``batch`` is this rank's data group's
    slice of the global batch (the S ranks of a group pass the same one)
    and every rank must call the step: it is the global batch's (the
    forward, the loss and the backward run inside
    ``dist.sharded_batch()``: global BN statistics and positive counts,
    the dense volume split along H over the S ranks; gradients averaged
    over the data groups), and the logged losses are their means over
    the ranks, the global batch's values; every rank must draw the same
    ``modality``. A train-mode forward or loss outside the step stays
    the rank's own."""
    with span("train_step"):
        return _train_step(model, opt, batch, modality_generator, modality)


def _train_step(model, opt, batch, modality_generator, modality):
    cfg = model.cfg
    model.train()
    opt.zero_grad()
    with dist.sharded_batch():
        if isinstance(cfg, OVUni3DETRConfig):
            outs = model(batch, modality=modality,
                         generator=modality_generator)
        else:
            outs = model(batch["points"], batch["pts_mask"])
        gt = gravity_center_boxes(batch["gt_boxes"])
        total, logs = uni3detr_loss(outs, gt, batch["gt_labels"],
                                    batch["gt_mask"], cfg)
        # the S ranks of a data group each hold the group's loss: each
        # backpropagates 1 / S of it, so the whole-volume layers' S
        # gradients add up to one and the sliced layers' partial ones
        # to the whole (parallel/spatial.py's backward rules)
        S = dist.spatial_size()
        with span("backward"):
            (total / S if S > 1 else total).backward()
    grad_norm = opt.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["total_loss"] = total.detach()
    if dist.world_size() > 1:
        keys = list(logs)
        mean = dist.mean_over_ranks(torch.stack([logs[k] for k in keys]))
        logs = dict(zip(keys, mean.unbind()))
    logs["grad_norm"] = grad_norm
    return logs
