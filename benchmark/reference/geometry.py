"""Box codes and overlaps of the plain reference (fp32, plain PyTorch).

Storage boxes are ``(cx, cy, cz_bottom, dx, dy, dz, yaw[, vx, vy])``; the
model's boxes carry the gravity-centre z; the regression code is ``(cx,
cy, log dx, log dy, cz, log dz, sin r', cos r'[, vx, vy])`` with ``r' =
-yaw - pi/2`` (mmdet3d's NMS-free coder, as Uni3DETR uses it).

The rotated IoU clips one rectangle by the four edges of the other
(Sutherland-Hodgman) for every pair at once, over fixed 8-vertex buffers.
"""
from __future__ import annotations

import math

import torch

NV = 8


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def gravity_center(boxes):
    z = boxes[..., 2:3] + boxes[..., 5:6] * 0.5
    return torch.cat([boxes[..., :2], z, boxes[..., 3:]], dim=-1)


def bottom_center(boxes):
    z = boxes[..., 2:3] - boxes[..., 5:6] * 0.5
    return torch.cat([boxes[..., :2], z, boxes[..., 3:]], dim=-1)


def encode(boxes):
    rot = -boxes[..., 6:7] - math.pi / 2
    out = [boxes[..., 0:1], boxes[..., 1:2],
           torch.log(boxes[..., 3:4] + 1e-5), torch.log(boxes[..., 4:5] + 1e-5),
           boxes[..., 2:3], torch.log(boxes[..., 5:6] + 1e-5),
           torch.sin(rot), torch.cos(rot)]
    if boxes.shape[-1] > 7:
        out.append(boxes[..., 7:9])
    return torch.cat(out, dim=-1)


def decode(code):
    yaw = -torch.atan2(code[..., 6:7], code[..., 7:8]) - math.pi / 2
    out = [code[..., 0:1], code[..., 1:2], code[..., 4:5],
           torch.exp(code[..., 2:3]), torch.exp(code[..., 3:4]),
           torch.exp(code[..., 5:6]), yaw]
    if code.shape[-1] > 8:
        out.append(code[..., 8:10])
    return torch.cat(out, dim=-1)


def _corners(b5):
    """(P, 5) (x, y, dx, dy, yaw) -> (P, 4, 2), counter-clockwise."""
    cx, cy, hx, hy, yaw = (b5[:, 0], b5[:, 1], b5[:, 2] * 0.5,
                           b5[:, 3] * 0.5, b5[:, 4])
    c, s = torch.cos(yaw), torch.sin(yaw)
    ox = torch.stack([hx, -hx, -hx, hx], -1)
    oy = torch.stack([hy, hy, -hy, -hy], -1)
    return torch.stack([cx[:, None] + ox * c[:, None] - oy * s[:, None],
                        cy[:, None] + ox * s[:, None] + oy * c[:, None]], -1)


def _clip(verts, nv, p, q, eps):
    P = verts.shape[0]
    idx = torch.arange(NV, device=verts.device)
    nxt = (idx[None] + 1) % nv.clamp(min=1)[:, None]
    e = q - p
    d = (e[:, 0:1] * (verts[..., 1] - p[:, 1:2])
         - e[:, 1:2] * (verts[..., 0] - p[:, 0:1]))
    cur_in = d >= -eps[:, None]
    vn = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    dn = torch.gather(d, 1, nxt)
    nxt_in = dn >= -eps[:, None]
    den = d - dn
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    inter = verts + (d / den)[..., None] * (vn - verts)
    live = idx[None] < nv[:, None]
    emit = torch.stack([(cur_in != nxt_in) & live, nxt_in & live],
                       2).reshape(P, 2 * NV)
    cand = torch.stack([inter, vn], 2).reshape(P, 2 * NV, 2)
    pos = torch.cumsum(emit.long(), 1) - 1
    slot = torch.where(emit & (pos < NV), pos, torch.full_like(pos, NV))
    out = verts.new_zeros(P, NV + 1, 2).scatter_(
        1, slot[..., None].expand(-1, -1, 2), cand)
    return out[:, :NV], emit.sum(1)


def rect_inter_area(b1, b2):
    """Intersection areas of rotated rectangles (P, 5) x (P, 5)."""
    c1, c2 = _corners(b1), _corners(b2)
    scale = torch.maximum(b1[:, 2:4].amax(-1), b2[:, 2:4].amax(-1))
    eps = 1e-5 * scale.clamp(min=1e-3) ** 2
    verts = torch.cat([c1, c1.new_zeros(c1.shape[0], NV - 4, 2)], 1)
    nv = torch.full((c1.shape[0],), 4, dtype=torch.long, device=b1.device)
    for k in range(4):
        verts, nv = _clip(verts, nv, c2[:, k], c2[:, (k + 1) % 4], eps)
    idx = torch.arange(NV, device=verts.device)
    nxt = (idx[None] + 1) % nv.clamp(min=1)[:, None]
    x, y = verts[..., 0], verts[..., 1]
    live = (idx[None] < nv[:, None]).to(verts.dtype)
    area = 0.5 * ((x * torch.gather(y, 1, nxt)
                   - torch.gather(x, 1, nxt) * y) * live).sum(-1)
    return area.clamp(min=0.0)


def _bev5(b):
    return torch.cat([b[..., 0:2], b[..., 3:5], b[..., 6:7]], -1)


def iou3d_aligned(b1, b2, z_origin: str = "center", eps: float = 1e-6):
    """Elementwise rotated 3D IoU of broadcast (..., >=7) boxes."""
    shape = torch.broadcast_shapes(b1.shape[:-1], b2.shape[:-1])
    inter = rect_inter_area(_bev5(b1).expand(*shape, 5).reshape(-1, 5),
                            _bev5(b2).expand(*shape, 5).reshape(-1, 5)
                            ).reshape(shape)
    if z_origin == "bottom":
        lo1, hi1 = b1[..., 2], b1[..., 2] + b1[..., 5]
        lo2, hi2 = b2[..., 2], b2[..., 2] + b2[..., 5]
    else:
        lo1, hi1 = b1[..., 2] - b1[..., 5] / 2, b1[..., 2] + b1[..., 5] / 2
        lo2, hi2 = b2[..., 2] - b2[..., 5] / 2, b2[..., 2] + b2[..., 5] / 2
    zo = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    inter = inter * zo
    v1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    v2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return (inter / (v1 + v2 - inter).clamp(min=eps)).clamp(0.0, 1.0)


def iou3d_pairwise(b1, b2, z_origin: str = "center"):
    """(N, >=7) x (M, >=7) -> (N, M) rotated 3D IoU."""
    return iou3d_aligned(b1[:, None, :], b2[None, :, :], z_origin)


def _nearest_bev_xyxy(b):
    rot = b[..., 6] - torch.floor(b[..., 6] / math.pi + 0.5) * math.pi
    swap = rot.abs() > math.pi / 4
    w = torch.where(swap, b[..., 4], b[..., 3])
    l = torch.where(swap, b[..., 3], b[..., 4])
    return torch.stack([b[..., 0] - w / 2, b[..., 1] - l / 2,
                        b[..., 0] + w / 2, b[..., 1] + l / 2], -1)


def _iou2d(b1, b2, eps: float = 1e-6):
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter).clamp(min=eps)


def nearest_bev_iou(b1, b2):
    """Pairwise (..., N, 7) x (..., M, 7) -> (..., N, M): the 2D IoU of the
    nearest axis-aligned bird's-eye boxes (mmdet3d)."""
    return _iou2d(_nearest_bev_xyxy(b1)[..., :, None, :],
                  _nearest_bev_xyxy(b2)[..., None, :, :])


def nearest_bev_iou_aligned(b1, b2):
    return _iou2d(_nearest_bev_xyxy(b1), _nearest_bev_xyxy(b2))


def z_iou_aligned(b1, b2, eps: float = 1e-6):
    lo1, hi1 = b1[..., 2] - b1[..., 5] / 2, b1[..., 2] + b1[..., 5] / 2
    lo2, hi2 = b2[..., 2] - b2[..., 5] / 2, b2[..., 2] + b2[..., 5] / 2
    inter = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    span = torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2)
    return inter / span.clamp(min=eps)
