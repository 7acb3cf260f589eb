"""Uni3DETR's set loss and the optimizer step of the plain reference.

Per decoder layer and scene the queries of each group are matched to the
ground truth on the detached cost by the configuration's ``matcher``: an
exact assignment (``scipy``, the upstream Hungarian matcher) or the
auction with eps = spread / 2048 (``auction``, the JAX package's):
focal class cost x 2, L1 on the first 8 code dims x 0.25, (1 - nearest
bird's-eye IoU) x 1.2. Then the soft focal loss against (bird's-eye IoU
+ z IoU) / 2 (x 1.5), L1 on the code (x 0.25), 1 - bird's-eye IoU (x 1.2)
plus 1 - z IoU, and the BCE of the IoU branch against the rotated 3D IoU
(x 1.2); each sum over the batch's positive count. Global-norm clip to
10, then AdamW (mmcv's ``optimizer_config``).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from . import geometry as G


def _focal_cost(logits, labels, alpha=0.25, gamma=2.0, eps=1e-12):
    p = torch.sigmoid(logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return torch.gather(pos - neg, -1, labels[None, :].expand(
        logits.shape[0], -1))


NEG = -1e30


def auction(benefit, spread, eps_div, max_iters=20000):
    """Jacobi auction (Bertsekas) of every instance at once: benefit (I, M,
    N) (bidders by items, M <= N), each bid raising the price by the gap
    to the bidder's second-best value plus eps = spread / ``eps_div``; ties
    to the lowest item and the lowest bidder. -> (I, M) item of each
    bidder, -1 if left unassigned after ``max_iters`` rounds."""
    I, M, N = benefit.shape
    dev = benefit.device
    eps = (spread / eps_div)[:, None]
    rows = torch.arange(M, device=dev)[None, :, None]
    cols = torch.arange(N, device=dev)[None, None, :]
    price = torch.zeros(I, N, device=dev)
    owner = torch.full((I, N), -1, dtype=torch.long, device=dev)
    item = torch.full((I, M), -1, dtype=torch.long, device=dev)
    neg = torch.tensor(NEG, device=dev)
    for _ in range(max_iters):
        active = item < 0
        if not bool(active.any()):
            break
        value = benefit - price[:, None, :]
        v1 = value.amax(2)
        best = torch.where(value == v1[..., None], cols, N).amin(2)
        top = cols == best[..., None]
        v2 = torch.where(top, neg, value).amax(2)
        v2 = torch.where(v2 <= NEG / 2, v1, v2)
        bid = torch.gather(price, 1, best) + (v1 - v2) + eps
        bids = torch.where(top & active[..., None], bid[..., None], neg)
        high = bids.amax(1)
        has = high > NEG / 2
        win = torch.where(bids == high[:, None, :], rows, M).amin(1)
        lost = ((owner[:, None, :] == rows) & has[:, None, :]).any(2)
        item = torch.where(lost, -1, item)
        got = torch.where((win[:, None, :] == rows) & has[:, None, :], cols,
                          -1).amax(2)
        item = torch.where(got >= 0, got, item)
        owner = torch.where(has, win, owner)
        price = torch.where(has, high, price)
    return item


def _auction_rows(cost):
    """(I, nq, M) cost -> (I, M) query of each GT column: the items are the
    queries, padded to a multiple of 128 at benefit -1e6; the bidders the
    columns, padded to a multiple of 8 with rows of jittered near-zero
    benefit; eps = spread / 2048."""
    I, nq, M = cost.shape
    N = -(-nq // 128) * 128
    M8 = -(-M // 8) * 8
    real = -cost.transpose(1, 2).float()
    flat = real.reshape(I, -1)
    spread = (flat.amax(1) - flat.amin(1)).clamp(min=1e-6)
    benefit = torch.cat([real, real.new_full((I, M, N - nq), -1e6)], 2)
    if M8 > M:
        d = torch.arange(M8 - M, dtype=torch.float32,
                         device=cost.device)[:, None]
        i = torch.arange(N, dtype=torch.float32, device=cost.device)[None]
        jitter = torch.remainder(d * 131.0 + i * 31.0, 97.0) / 97.0
        benefit = torch.cat([benefit, spread[:, None, None] * 1e-4
                             * jitter[None]], 1)
    return auction(benefit, spread, 2048.0)[:, :M]


@torch.no_grad()
def assign(cls, bbox, gt, labels, gt_mask, nq, matcher):
    """One scene's layer: cls (Q, ncls), bbox (Q, code), gt (Gt, 7|9)
    gravity-centred with its labels and mask (padded columns cost 0) ->
    (Q,) GT index per query, -1 background. ``matcher``: ``scipy`` (exact)
    or ``auction``."""
    Q = cls.shape[0]
    cost = (_focal_cost(cls, labels.long()) * 2.0
            + (bbox[:, None, :8] - G.encode(gt)[None, :, :8]).abs().sum(-1)
            * 0.25
            + (1.0 - G.nearest_bev_iou(G.decode(bbox), gt)) * 1.2)
    cost = torch.where(torch.isfinite(cost), cost, torch.full_like(cost, 1e4))
    cost = torch.where(gt_mask[None, :], cost, torch.zeros_like(cost))
    grouped = cost.reshape(Q // nq, nq, -1)
    if matcher == "auction":
        rows = _auction_rows(grouped).cpu()
    else:
        from scipy.optimize import linear_sum_assignment
        c = grouped.double().cpu().numpy()
        rows = torch.stack([torch.from_numpy(
            linear_sum_assignment(g.T)[1]) for g in c])
    out = torch.full((Q,), -1, dtype=torch.long)
    mask = gt_mask.cpu()
    for g in range(Q // nq):
        for col in range(rows.shape[1]):
            r = int(rows[g, col])
            if mask[col]:
                out[g * nq + (r % nq)] = col
    return out


def _soft_focal(logits, labels, quality, ncls, alpha=0.25):
    p = torch.sigmoid(logits)
    t = F.one_hot(labels, ncls + 1)[:, :ncls].to(logits.dtype) * quality[:,
                                                                          None]
    w = ((1 - alpha) + (2 * alpha - 1) * t) * (t - p) ** 2
    bce = logits.clamp(min=0) - logits * t + torch.log1p(torch.exp(
        -logits.abs()))
    return (bce * w).sum(-1)


def layer_loss(cls, bbox, iou, gt, labels, gt_mask, assigned, cfg):
    """cls (B, Q, ncls), bbox (B, Q, code), iou (B, Q); gt (B, Gt, 7|9)
    gravity-centred; assigned (B, Q)."""
    ncls = cfg["num_classes"]
    pos = assigned >= 0
    safe = assigned.clamp(min=0)
    lab = torch.where(pos, torch.gather(labels.long(), 1, safe),
                      torch.full_like(safe, ncls))
    tgt = torch.gather(gt, 1, safe[..., None].expand(-1, -1, gt.shape[-1]))
    tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))
    dec = G.decode(bbox)
    iou_bev = G.nearest_bev_iou_aligned(dec, tgt)
    iou_z = G.z_iou_aligned(dec, tgt)
    posf = pos.float()
    npos = posf.sum().clamp(min=1.0)
    l_cls = _soft_focal(cls.reshape(-1, ncls), lab.reshape(-1),
                        ((iou_bev + iou_z) * 0.5).reshape(-1), ncls)
    l_cls = l_cls.sum() / npos * cfg["loss_cls_weight"]
    cw = torch.tensor(cfg["code_weights"], device=bbox.device)
    l1 = (bbox - G.encode(tgt)).abs() * cw * posf[..., None]
    l1 = torch.where(torch.isfinite(l1), l1, torch.zeros_like(l1))
    l_box = l1.sum() / npos * cfg["loss_bbox_weight"]
    cw_mean = float(cw.mean())
    cw0 = float(cfg["code_weights"][0])
    l_iou = ((1.0 - iou_bev) * posf).sum() / npos * cfg["loss_iou_weight"] \
        * cw_mean + ((1.0 - iou_z) * posf).sum() / npos * cw0
    with torch.no_grad():
        iou_true = G.iou3d_aligned(dec, tgt, "bottom")
    bce = iou.clamp(min=0) - iou * iou_true + torch.log1p(torch.exp(
        -iou.abs()))
    l_pred = (bce * posf).sum() / npos * 1.2 * cw0
    return l_cls + l_box + l_iou + l_pred


def total_loss(outs, batch, cfg):
    """The summed loss of every decoder layer; ``batch`` holds gt_boxes
    (bottom z), gt_labels, gt_mask."""
    gt = G.gravity_center(batch["gt_boxes"])
    L, B = outs["all_cls_scores"].shape[:2]
    total = 0.0
    for l in range(L):
        assigned = torch.stack([assign(
            outs["all_cls_scores"][l, b], outs["all_bbox_preds"][l, b],
            gt[b], batch["gt_labels"][b], batch["gt_mask"][b],
            cfg["num_query"], cfg["matcher"]) for b in range(B)]).to(
                gt.device)
        total = total + layer_loss(
            outs["all_cls_scores"][l], outs["all_bbox_preds"][l],
            outs["all_iou_preds"][l], gt, batch["gt_labels"],
            batch["gt_mask"], assigned, cfg)
    return total


def adamw_step(params, state, lr, beta1, weight_decay=0.01, clip=10.0,
               beta2=0.999, eps=1e-8):
    """Clip the gradients of ``params`` (dict name -> parameter) to a
    global norm of ``clip``, then one decoupled AdamW update in place;
    ``state`` holds the moments and the step count. Returns the clipped
    gradients by name."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.items()}
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < clip else clip / float(norm)
    t = state.setdefault("t", 0) + 1
    state["t"] = t
    clipped = {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] * scale
            clipped[k] = g
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(beta1).add_(g, alpha=1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            mhat = m / (1 - beta1 ** t)
            vhat = v / (1 - beta2 ** t)
            p.mul_(1 - lr * weight_decay)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return clipped
