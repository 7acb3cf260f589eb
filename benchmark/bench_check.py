"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference (``reference/``, as the cell's model
family gives it: ``families/``) run after the window on the same inputs
and the same drawn weights.

Training (the steps set-up drives through the window's own call): each
step's loss (``loss_gap``, the largest relative gap), the norm of the
first gradient as AdamW holds it (its first moment over 1 - beta1) and the
norm of each parameter's change after the steps (``grad_gap`` and
``change_gap``: the largest gap over the leaves between the program's
norm and the reference's, over the larger of the reference's norm of the
leaf and of the median leaf). Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone under AdamW and
are left out of both.

Inference (a sample of the window's batches, drawn from the seed): each
box the program kept is matched to the reference query whose box lies
nearest; ``score_gap`` is the largest relative gap of a kept box's score
to the reference's score of that (query, class), ``box_gap`` the largest
1 - 3D IoU of a kept box with that query's reference box, ``kept_miss``
the share of (query, class) pairs kept by one side only (what the NMS and
the cuts kept: a scene left empty, an NMS that keeps every box or
suppresses the wrong ones moves it), and the medians over the kept boxes
of the relative score gap and of the box gap; ``wrong_boxes`` counts the
kept boxes whose score is off by far more than rounding gives
(``WRONG_SCORE``), such as an answer altered where it is produced.
"""
from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch

import bench_weights
from reference import geometry as RG
from reference.loss import adamw_step


@contextlib.contextmanager
def no_tf32(precision="float32"):
    """TF32 off for the reference's products and convs; for the float8
    control the products take TF32, one precision below the head's fp32
    (the second control, ``float8_alone``, keeps them in fp32)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "float8"
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def step_seed(seed: int, k: int) -> int:
    """The seed of the global generator (dropout) before checked step k."""
    return (int(seed) * 1000003 + 7919 * (k + 1)) % (2 ** 63)


# -- schedules: mmcv's cyclic lr and momentum policies (optax semantics) ----

def _linear(a, b, n):
    return (lambda s: a) if n <= 0 else \
        (lambda s: (a - b) * (1 - min(max(s, 0), n) / n) + b)


def schedules(train_cfg):
    """(lr(step), beta1(step)) of a configuration's ``train`` section."""
    opt = train_cfg["optimizer"]
    total = train_cfg["total_epochs"] * train_cfg["steps_per_epoch"]
    lrc, mc = train_cfg["lr_config"], train_cfg["momentum_config"]
    up = int(total * lrc["step_ratio_up"])
    down = total - up
    base, peak = opt["lr"], opt["lr"] * lrc["target_ratio"][0]
    alpha = lrc["target_ratio"][1] / lrc["target_ratio"][0]
    lin = _linear(base, peak, up)

    def lr(s):
        if s < up:
            return lin(s)
        t = min(s - up, down)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / down))
                       + alpha)

    b1 = opt["beta1"]
    m1, m2 = b1 * mc["target_ratio"][0], b1 * mc["target_ratio"][1]
    mup = int(total * mc["step_ratio_up"])
    mdown = max(total - mup, 1)
    mlin = _linear(b1, m1, mup)

    def beta1(s):
        if s < mup:
            return mlin(s)
        f = min(max((s - mup) / mdown, 0.0), 1.0)
        return m2 + (m1 - m2) * 0.5 * (1 + math.cos(math.pi * f))

    return lr, beta1


# -- training -----------------------------------------------------------------

def _leaf_gap(prog, ref, keep):
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep),
               default=0.0)


def train_numbers(prog, ref):
    """The compared numbers of one run: ``prog`` and ``ref`` hold
    ``loss`` (per step), ``grad`` and ``change`` (name -> norm)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    med = statistics.median(ref["grad"].values())
    keep = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    first = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    bn = [float(np.linalg.norm(prog["bn"][k] - ref["bn"][k])
                / max(np.linalg.norm(ref["bn"][k]), 1e-30)) for k in ref["bn"]]
    return {"loss_gap": loss, "loss_gap_first": first, "bn_gap": max(bn),
            "bn_gap_median": statistics.median(bn),
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], keep),
            "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
            "grad_gap_median": statistics.median(
                abs(prog["grad"][k] - ref["grad"][k]) / ref["grad"][k]
                for k in keep),
            "change_gap_median": statistics.median(
                abs(prog["change"][k] - ref["change"][k])
                / ref["change"][k] for k in keep)}


def bn_moves(model, before):
    """name -> the move of each BN running statistic from ``before`` (the
    drawn values), as a numpy vector."""
    return {k: (b.detach().double() - before[k].to(b.device).double()).cpu()
            .numpy() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def train_reference(cell, seed, batches, device, precision="float32"):
    """The reference's steps on ``batches`` (host tensors) from the drawn
    weights: ``{"loss", "grad", "change"}``."""
    fam, cfg, tcfg = cell.family, cell.model, cell.config["train"]
    lr, beta1 = schedules(tcfg)
    quant = fam.quantizer(precision)
    with no_tf32(precision):
        ref = fam.reference(cfg).to(device)
        drawn = bench_weights.draw(ref, seed, cell.traffic["weights"], device,
                                   fam.weight_rule)
        ref.load_state_dict(drawn)
        params = {k: p for k, p in ref.named_parameters() if p.requires_grad}
        init = {k: p.detach().clone() for k, p in params.items()}
        state, losses, grad = {}, [], None
        for k, host in enumerate(batches):
            batch = {n: t.to(device) for n, t in host.items()}
            ref.train()
            ref.zero_grad(set_to_none=True)
            torch.manual_seed(step_seed(seed, k))
            loss = fam.reference_loss(fam.reference_forward(ref, batch, quant),
                                      batch, cfg)
            loss.backward()
            clipped = adamw_step(params, state, lr(k), beta1(k),
                                 tcfg["optimizer"]["weight_decay"],
                                 tcfg["optimizer"]["clip_norm"])
            losses.append(float(loss.detach()))
            if k == 0:
                grad = {n: float(g.double().norm()) for n, g in
                        clipped.items()}
                bn = bn_moves(ref, drawn)
        change = {n: float((p.detach() - init[n]).double().norm())
                  for n, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change, "bn": bn}


# -- inference ----------------------------------------------------------------

# a kept box is wrong when its score is off the reference's by more than
# half of it: far beyond what rounding gives (the program's widest gap read
# on the card: 2.1e-4 at the flagship, 6.3e-3 at nuScenes; PERF.md), as
# an answer altered where it is produced is
WRONG_SCORE = 0.5


def judge_scene(out, ref):
    """``out``: one scene of the program's post-processed output (numpy
    boxes (K, 7|9) bottom z, scores, labels, valid); ``ref``: the
    family's ``reference_detect`` of it. -> (score gap, box gap, kept by one
    side only, kept by either)."""
    kept = np.nonzero(out["valid"])[0]
    if len(kept):
        c = out["boxes"][kept, :3]
        d = ((c[:, None, :] - ref["all_box"][None, :, :3]) ** 2).sum(-1)
        q = d.argmin(1)
        lab = out["labels"][kept].astype(np.int64)
        rel = np.abs(out["scores"][kept] - ref["all_score"][q, lab]) / \
            np.maximum(ref["all_score"][q, lab], 1e-12)
        sg = float(rel.max())
        iou = RG.iou3d_aligned(
            torch.from_numpy(out["boxes"][kept, :7].astype(np.float32)),
            torch.from_numpy(ref["all_box"][q, :7].astype(np.float32)),
            "bottom").numpy()
        bg = float((1.0 - iou).max())
        wrong = int((rel > WRONG_SCORE).sum())
        each = (rel, 1.0 - iou)
        P = set(zip(q.tolist(), lab.tolist()))
    else:
        sg = bg = 0.0
        wrong = 0
        each = (np.zeros(0), np.zeros(0))
        P = set()
    R = set(zip(ref["query"][ref["kept"]].tolist(),
                ref["label"][ref["kept"]].tolist()))
    return sg, bg, len(P ^ R), len(P | R), each, wrong


def infer_numbers(judged):
    """The numbers of the judged scenes: the widest relative score gap and
    box gap,
    the share kept by one side only, and the median relative score gap
    and median box gap over every kept box."""
    sg = max(j[0] for j in judged)
    bg = max(j[1] for j in judged)
    miss = sum(j[2] for j in judged) / max(sum(j[3] for j in judged), 1)
    rel = np.concatenate([j[4][0] for j in judged])
    box = np.concatenate([j[4][1] for j in judged])
    return {"score_gap": sg, "box_gap": bg, "kept_miss": miss,
            "score_gap_median": float(np.median(rel)) if len(rel) else 0.0,
            "box_gap_median": float(np.median(box)) if len(box) else 0.0,
            "kept_boxes": len(rel) / len(judged),
            "wrong_boxes": sum(j[5] for j in judged)}


class InferReference:
    """The reference detector with the drawn weights, run one scene at a
    time."""

    def __init__(self, cell, seed, device, precision="float32"):
        self.family = fam = cell.family
        self.cfg = cell.model
        self.device = device
        self.precision = precision
        self.quant = fam.quantizer(precision)
        with no_tf32():
            self.model = fam.reference(self.cfg).to(device).eval()
            self.model.load_state_dict(bench_weights.draw(
                self.model, seed, cell.traffic["weights"], device,
                fam.weight_rule))

    @torch.no_grad()
    def scene(self, host_batch, b):
        with no_tf32(self.precision):
            outs = self.family.reference_scene(self.model, host_batch, b,
                                               self.device, self.quant)
            return self.family.reference_detect(outs, self.cfg)

    def as_output(self, det):
        """A reference detection in the program's output layout (for the
        control put in the program's place)."""
        return {"boxes": det["box"], "scores": det["score"],
                "labels": det["label"], "valid": det["kept"]}


def verdict(numbers, limits):
    """-> (correct, each number with its limit). A number without a limit
    is printed and not compared; a number that is not finite fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and
             (c["limit"] is None or c["value"] <= c["limit"])
             for c in checks.values())
    return ok, checks
