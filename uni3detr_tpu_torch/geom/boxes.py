"""3D box codes and corners (port of ``uni3detr_tpu/geom/boxes.py``).

Storage boxes are ``(cx, cy, cz_bottom, dx, dy, dz, yaw[, vx, vy])``,
model boxes carry the gravity-centre z, and the 8/10-dim regression code
is ``(cx, cy, log dx, log dy, cz, log dz, sin r', cos r'[, vx, vy])``
with ``r' = -yaw - pi/2``.
"""
from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically safe logit, as mmdet's ``inverse_sigmoid``."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def gravity_center_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Storage box (bottom z) -> model box (gravity-centre z)."""
    z = boxes[..., 2:3] + boxes[..., 5:6] * 0.5
    return torch.cat([boxes[..., :2], z, boxes[..., 3:]], dim=-1)


def bottom_center_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Model box (gravity-centre z) -> storage box (bottom z)."""
    z = boxes[..., 2:3] - boxes[..., 5:6] * 0.5
    return torch.cat([boxes[..., :2], z, boxes[..., 3:]], dim=-1)


def encode_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Gravity-centred boxes (..., 7|9) -> normalized code (..., 8|10):
    log sizes with a 1e-5 floor, rotation as (sin r', cos r')."""
    rot = -boxes[..., 6:7] - math.pi / 2
    out = [boxes[..., 0:1], boxes[..., 1:2],
           torch.log(boxes[..., 3:4] + 1e-5), torch.log(boxes[..., 4:5] + 1e-5),
           boxes[..., 2:3], torch.log(boxes[..., 5:6] + 1e-5),
           torch.sin(rot), torch.cos(rot)]
    if boxes.shape[-1] > 7:
        out.append(boxes[..., 7:9])
    return torch.cat(out, dim=-1)


def decode_boxes(code: torch.Tensor) -> torch.Tensor:
    """Normalized code (..., 8|10) -> gravity-centred boxes (..., 7|9)."""
    rot = torch.atan2(code[..., 6:7], code[..., 7:8])
    yaw = -rot - math.pi / 2
    out = [code[..., 0:1], code[..., 1:2], code[..., 4:5],
           torch.exp(code[..., 2:3]), torch.exp(code[..., 3:4]),
           torch.exp(code[..., 5:6]), yaw]
    if code.shape[-1] > 8:
        out.append(code[..., 8:10])
    return torch.cat(out, dim=-1)


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """BEV corners of (..., >=7) boxes -> (..., 4, 2), counter-clockwise
    from (+dx/2, +dy/2) in the box frame."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    hx, hy = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    yaw = boxes[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    ox = torch.stack([hx, -hx, -hx, hx], dim=-1)
    oy = torch.stack([hy, hy, -hy, -hy], dim=-1)
    x = cx[..., None] + ox * c[..., None] - oy * s[..., None]
    y = cy[..., None] + ox * s[..., None] + oy * c[..., None]
    return torch.stack([x, y], dim=-1)
