"""Exact rotated 3D IoU (port of ``uni3detr_tpu/geom/iou.py``).

The BEV intersection of two rotated rectangles is a Sutherland-Hodgman
clip of one rectangle by the four edges of the other, run for every box
pair at once over fixed 8-vertex buffers (a convex quad clipped by four
half-planes keeps at most 8 vertices). Box layout:
``(cx, cy, cz, dx, dy, dz, yaw, ...)``.

:func:`iou3d_rotated_pairwise` (N1) is the pairwise IoU of a batch of box
sets with themselves, :func:`iou3d_rotated_sets` and
:func:`iou_bev_rotated_sets` the 3D and bird's-eye IoU of two batches of
box sets against each other: the CUDA kernel ``u3d_iou_rotated_sets``
(``csrc/nms.cu``) for CUDA tensors, the plain :func:`iou3d_rotated` and
:func:`iou_bev_rotated` for CPU tensors; each one's ``launches``
attribute counts its kernel launches.

:func:`axis_aligned_iou3d` (pairwise) and :func:`rdiou` (elementwise)
serve the ``axis_aligned_iou3d`` and ``rdiou`` matching costs and loss;
they are plain PyTorch on every device, as the JAX package computes
them in XLA.
"""
from __future__ import annotations

import math

import torch

from ..ops import cost, cuda_lib
from .boxes import corners_bev

_NV = 8  # max vertices of a rect-rect intersection


def _clip_halfplane(verts, nv, p, q, eps):
    """Clip each pair's convex polygon ``verts[:nv]`` (CCW) by the
    half-plane left of p->q.

    verts (P, 8, 2); nv (P,); p, q (P, 2); eps (P,) a scale-relative
    hysteresis on the inside test, so edges lying on the clip line never
    register as crossings under float jitter. Returns (verts, nv).
    """
    P = verts.shape[0]
    idx = torch.arange(_NV, device=verts.device)
    nxt = (idx[None, :] + 1) % nv.clamp(min=1)[:, None]        # (P, 8)
    e = q - p
    d = (e[:, 0:1] * (verts[..., 1] - p[:, 1:2])
         - e[:, 1:2] * (verts[..., 0] - p[:, 0:1]))          # (P, 8)
    cur_in = d >= -eps[:, None]
    vnxt = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    dnxt = torch.gather(d, 1, nxt)
    nxt_in = dnxt >= -eps[:, None]
    denom = d - dnxt
    denom = torch.where(denom.abs() < 1e-12,
                        torch.full_like(denom, 1e-12), denom)
    t = d / denom
    inter = verts + t[..., None] * (vnxt - verts)
    valid_edge = idx[None, :] < nv[:, None]
    emit0 = (cur_in != nxt_in) & valid_edge      # crossing point
    emit1 = nxt_in & valid_edge                  # next vertex kept
    cand = torch.stack([inter, vnxt], dim=2).reshape(P, 2 * _NV, 2)
    emit = torch.stack([emit0, emit1], dim=2).reshape(P, 2 * _NV)
    # running count of emitted candidates as a product with a triangular
    # 0/1 matrix (exact: counts <= 16); a scan over 16-wide rows runs
    # PyTorch's slow innermost-dim scan kernel on the GPU
    tri = torch.ones(2 * _NV, 2 * _NV, dtype=verts.dtype,
                     device=verts.device).triu()
    pos = (emit.to(verts.dtype) @ tri).long() - 1
    # compact the emitted candidates; slot _NV collects the rest
    slot = torch.where(emit & (pos < _NV), pos, torch.full_like(pos, _NV))
    out = verts.new_zeros(P, _NV + 1, 2).scatter_(
        1, slot[..., None].expand(-1, -1, 2), cand)
    return out[:, :_NV], emit.sum(dim=1)


def _rect_intersection_area(b1, b2):
    """Exact intersection areas of rotated rects (P, 5) = (x,y,dx,dy,yaw)."""
    zero = torch.zeros_like(b1[:, :1])
    c1 = corners_bev(torch.cat([b1[:, :2], zero, b1[:, 2:4], zero,
                                b1[:, 4:5]], dim=-1))        # (P, 4, 2)
    c2 = corners_bev(torch.cat([b2[:, :2], zero, b2[:, 2:4], zero,
                                b2[:, 4:5]], dim=-1))
    scale = torch.maximum(b1[:, 2:4].amax(dim=-1), b2[:, 2:4].amax(dim=-1))
    eps = 1e-5 * scale.clamp(min=1e-3) ** 2
    verts = torch.cat([c1, c1.new_zeros(c1.shape[0], _NV - 4, 2)], dim=1)
    nv = torch.full((c1.shape[0],), 4, dtype=torch.long, device=b1.device)
    for k in range(4):
        verts, nv = _clip_halfplane(verts, nv, c2[:, k], c2[:, (k + 1) % 4],
                                    eps)
    idx = torch.arange(_NV, device=verts.device)
    nxt = (idx[None, :] + 1) % nv.clamp(min=1)[:, None]
    valid = (idx[None, :] < nv[:, None]).to(verts.dtype)
    x, y = verts[..., 0], verts[..., 1]
    xn, yn = torch.gather(x, 1, nxt), torch.gather(y, 1, nxt)
    area = 0.5 * torch.sum((x * yn - xn * y) * valid, dim=-1)
    return area.clamp(min=0.0)


def _bev5(boxes):
    """(..., >=7) box -> (..., 5) BEV (x, y, dx, dy, yaw)."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]],
                     dim=-1)


def _z_overlap(boxes1, boxes2, z_origin):
    if z_origin == "bottom":
        lo1, hi1 = boxes1[..., 2], boxes1[..., 2] + boxes1[..., 5]
        lo2, hi2 = boxes2[..., 2], boxes2[..., 2] + boxes2[..., 5]
    else:
        lo1 = boxes1[..., 2] - boxes1[..., 5] * 0.5
        hi1 = boxes1[..., 2] + boxes1[..., 5] * 0.5
        lo2 = boxes2[..., 2] - boxes2[..., 5] * 0.5
        hi2 = boxes2[..., 2] + boxes2[..., 5] * 0.5
    return (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)


def _iou3d_from_parts(inter_bev, zo, boxes1, boxes2, eps):
    inter = inter_bev * zo
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return (inter / (v1 + v2 - inter).clamp(min=eps)).clamp(0.0, 1.0)


def iou3d_rotated_aligned(boxes1, boxes2, z_origin: str = "center",
                          eps: float = 1e-6):
    """Elementwise exact rotated 3D IoU: (..., >=7) x (..., >=7) -> (...)."""
    shape = torch.broadcast_shapes(boxes1.shape[:-1], boxes2.shape[:-1])
    b1 = _bev5(boxes1).expand(*shape, 5).reshape(-1, 5)
    b2 = _bev5(boxes2).expand(*shape, 5).reshape(-1, 5)
    inter_bev = _rect_intersection_area(b1, b2).reshape(shape)
    zo = _z_overlap(boxes1, boxes2, z_origin)
    return _iou3d_from_parts(inter_bev, zo, boxes1, boxes2, eps)


def iou3d_rotated(boxes1, boxes2, z_origin: str = "center",
                  eps: float = 1e-6):
    """Pairwise exact rotated 3D IoU: (..., N, >=7) x (..., M, >=7) ->
    (..., N, M).

    mmdet3d ``bbox_overlaps_3d`` semantics: rotated BEV polygon
    intersection times the z overlap.
    """
    return iou3d_rotated_aligned(boxes1[..., :, None, :],
                                 boxes2[..., None, :, :], z_origin, eps)


def iou_bev_rotated(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise exact rotated bird's-eye IoU: (..., N, >=5) x (..., M,
    >=5) -> (..., N, M); 5-dim (x, y, dx, dy, yaw) boxes or full >=7-dim
    boxes. The intersection over ``clip(a1 + a2 - inter, eps)``, no z
    term (the official KITTI bev metric)."""
    b1 = boxes1 if boxes1.shape[-1] == 5 else _bev5(boxes1)
    b2 = boxes2 if boxes2.shape[-1] == 5 else _bev5(boxes2)
    b1, b2 = b1[..., :, None, :], b2[..., None, :, :]
    shape = torch.broadcast_shapes(b1.shape[:-1], b2.shape[:-1])
    inter = _rect_intersection_area(b1.expand(*shape, 5).reshape(-1, 5),
                                    b2.expand(*shape, 5).reshape(-1, 5)
                                    ).reshape(shape)
    a1, a2 = b1[..., 2] * b1[..., 3], b2[..., 2] * b2[..., 3]
    return (inter / (a1 + a2 - inter).clamp(min=eps)).clamp(0.0, 1.0)


def _iou_sets(fn, boxes1, boxes2, bev: bool, z_origin: str):
    """N1 on two batches of box sets: (B, M, >=7) x (B, N, >=7) -> (B, M,
    N) fp32; ``fn`` is the public wrapper whose launches it counts."""
    name = fn.__name__
    if boxes1.dim() != 3 or boxes2.dim() != 3 or boxes1.shape[0] != \
            boxes2.shape[0] or min(boxes1.shape[-1], boxes2.shape[-1]) < 7:
        raise ValueError(f"{name}: boxes (B, M, >=7) and (B, N, >=7)")
    if z_origin not in ("bottom", "center"):
        raise ValueError(f"{name}: z_origin {z_origin!r}")
    if boxes1.device.type == "cpu" and boxes2.device.type == "cpu":
        return iou_bev_rotated(boxes1, boxes2) if bev else \
            iou3d_rotated(boxes1, boxes2, z_origin)
    if not (boxes1.is_cuda and boxes2.device == boxes1.device):
        raise ValueError(f"{name}: both box sets on one CUDA device")
    a = boxes1[..., :7].float().contiguous()
    b = boxes2[..., :7].float().contiguous()
    B, M, N = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty((B, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        status = cuda_lib.library().u3d_iou_rotated_sets(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, M, N, int(bev),
            int(z_origin == "bottom"),
            torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(status, "u3d_iou_rotated_sets")
    fn.launches += 1
    key = "iou3d_rotated_matrix" if fn is iou3d_rotated_pairwise else name
    cost.record(key, (a, b), out)
    return out


def iou3d_rotated_pairwise(boxes: torch.Tensor,
                           z_origin: str = "bottom") -> torch.Tensor:
    """N1, matrix: (B, N, >=7) boxes -> (B, N, N) fp32, ``out[b, i, j]``
    the IoU of box i clipped by box j, as :func:`iou3d_rotated` computes
    it.

    The kernel reads fp32 boxes and differs from the plain version by
    fp32 rounding (the shoelace sum's order, sin and cos)."""
    return _iou_sets(iou3d_rotated_pairwise, boxes, boxes, False, z_origin)


def iou3d_rotated_sets(boxes1: torch.Tensor, boxes2: torch.Tensor,
                       z_origin: str = "bottom") -> torch.Tensor:
    """N1, two sets: (B, M, >=7) x (B, N, >=7) -> (B, M, N) fp32 rotated
    3D IoU, as :func:`iou3d_rotated`."""
    return _iou_sets(iou3d_rotated_sets, boxes1, boxes2, False, z_origin)


def iou_bev_rotated_sets(boxes1: torch.Tensor,
                         boxes2: torch.Tensor) -> torch.Tensor:
    """N1, two sets in bird's-eye view: (B, M, >=7) x (B, N, >=7) -> (B,
    M, N) fp32, as :func:`iou_bev_rotated`."""
    return _iou_sets(iou_bev_rotated_sets, boxes1, boxes2, True, "bottom")


iou3d_rotated_pairwise.launches = 0
iou3d_rotated_sets.launches = 0
iou_bev_rotated_sets.launches = 0


def _limit_period(val, offset: float = 0.5, period: float = math.pi):
    return val - torch.floor(val / period + offset) * period


def _nearest_bev_xyxy(boxes):
    """(..., >=7) -> xyxy of the nearest axis-aligned BEV box (mmdet3d
    ``nearest_bev``: yaw limited to [-pi/2, pi/2), dx/dy swapped when
    |yaw| > pi/4, rotation dropped)."""
    rot = _limit_period(boxes[..., 6])
    cond = rot.abs() > math.pi / 4
    w = torch.where(cond, boxes[..., 4], boxes[..., 3])
    l = torch.where(cond, boxes[..., 3], boxes[..., 4])
    cx, cy = boxes[..., 0], boxes[..., 1]
    return torch.stack([cx - w * 0.5, cy - l * 0.5, cx + w * 0.5,
                        cy + l * 0.5], dim=-1)


def _iou2d_xyxy(b1, b2, eps: float = 1e-6):
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter).clamp(min=eps)


def nearest_bev_iou(boxes1, boxes2):
    """Pairwise 2D IoU of the nearest axis-aligned BEV boxes:
    (..., N, >=7) x (..., M, >=7) -> (..., N, M) (mmdet3d
    ``bbox_overlaps_nearest_3d``)."""
    b1 = _nearest_bev_xyxy(boxes1)
    b2 = _nearest_bev_xyxy(boxes2)
    return _iou2d_xyxy(b1[..., :, None, :], b2[..., None, :, :])


def nearest_bev_iou_aligned(boxes1, boxes2):
    """Elementwise nearest-BEV 2D IoU: (..., >=7) x (..., >=7) -> (...)."""
    return _iou2d_xyxy(_nearest_bev_xyxy(boxes1), _nearest_bev_xyxy(boxes2))


def z_interval_iou_aligned(boxes1, boxes2, eps: float = 1e-6):
    """Elementwise 1D IoU of the centre-origin z extents (overlap over the
    enclosing span)."""
    lo1 = boxes1[..., 2] - boxes1[..., 5] * 0.5
    hi1 = boxes1[..., 2] + boxes1[..., 5] * 0.5
    lo2 = boxes2[..., 2] - boxes2[..., 5] * 0.5
    hi2 = boxes2[..., 2] + boxes2[..., 5] * 0.5
    inter = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    span = torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2)
    return inter / span.clamp(min=eps)


def axis_aligned_iou3d(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise axis-aligned 3D IoU, yaw ignored: (..., N, >=6) x (...,
    M, >=6) -> (..., N, M), centre-origin extents."""
    def _minmax(b):
        return b[..., :3] - b[..., 3:6] * 0.5, b[..., :3] + b[..., 3:6] * 0.5
    lo1, hi1 = _minmax(boxes1[..., :, None, :])
    lo2, hi2 = _minmax(boxes2[..., None, :, :])
    whd = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    v1 = torch.prod(boxes1[..., 3:6], dim=-1)[..., :, None]
    v2 = torch.prod(boxes2[..., 3:6], dim=-1)[..., None, :]
    return inter / (v1 + v2 - inter).clamp(min=eps)


def rdiou(boxes1, boxes2):
    """Rotation-decoupled IoU, the reference ``get_rdiou``: elementwise
    over broadcast (..., >=7) boxes with log sizes at dims 3:6 and the
    raw angle at dim 6. The first set's sizes are ``exp`` clipped at 10,
    the second's are not; y and z are doubled; the rotation is a fourth
    axis (t1 = sin a1 cos a2 against t2 = cos a1 sin a2, unit extent).
    Returns (u, the IoU): u the DIoU-style squared centre distance over
    the squared enclosing diagonal."""
    x1, y1, z1 = boxes1[..., 0], boxes1[..., 1] * 2, boxes1[..., 2] * 2
    l1 = torch.exp(boxes1[..., 3]).clamp(max=10.0)
    w1 = torch.exp(boxes1[..., 4]).clamp(max=10.0)
    h1 = torch.exp(boxes1[..., 5]).clamp(max=10.0)
    t1 = torch.sin(boxes1[..., 6]) * torch.cos(boxes2[..., 6])
    x2, y2, z2 = boxes2[..., 0], boxes2[..., 1] * 2, boxes2[..., 2] * 2
    l2 = torch.exp(boxes2[..., 3])
    w2 = torch.exp(boxes2[..., 4])
    h2 = torch.exp(boxes2[..., 5])
    t2 = torch.cos(boxes1[..., 6]) * torch.sin(boxes2[..., 6])
    j = torch.ones_like(h2)

    def _inter(a1, e1, a2, e2):
        return (torch.minimum(a1 + e1 / 2, a2 + e2 / 2)
                - torch.maximum(a1 - e1 / 2, a2 - e2 / 2)).clamp(min=0.0)

    def _span(a1, e1, a2, e2):
        return (torch.maximum(a1 + e1 / 2, a2 + e2 / 2)
                - torch.minimum(a1 - e1 / 2, a2 - e2 / 2)).clamp(min=0.0)

    inter = (_inter(x1, l1, x2, l2) * _inter(y1, w1, y2, w2)
             * _inter(z1, h1, z2, h2) * _inter(t1, j, t2, j))
    inter_diag = ((x2 - x1) ** 2 + (y2 - y1) ** 2 + (z2 - z1) ** 2
                  + (t2 - t1) ** 2)
    c_diag = (_span(x1, l1, x2, l2) ** 2 + _span(y1, w1, y2, w2) ** 2
              + _span(z1, h1, z2, h2) ** 2 + _span(t1, j, t2, j) ** 2)
    union = l1 * w1 * h1 + l2 * w2 * h2 - inter
    return inter_diag / c_diag, inter / union
