"""Per-class rotated 3D NMS (port of ``uni3detr_tpu/ops/nms.py`` and of
the NMS of ``uni3detr_tpu/train/coder.py::post_process``).

:func:`nms_keep` runs the greedy per-class NMS of a batch of scenes. For
CUDA tensors it makes two launches for all scenes and no host round
trip: :func:`overlap_mask` (N1, ``u3d_iou3d_rotated_mask`` in
``csrc/nms.cu``) writes one overlap bitmask per scene over the boxes in
scan order (:func:`nms_order`: by class, by descending score within a
class), and :func:`greedy_scan` (N2, ``u3d_nms_greedy``) scans it. Greedy
NMS per class on boxes that carry one label each keeps what one greedy
pass keeps whose overlap test also asks for equal labels, so one bitmask
serves every class. For CPU tensors :func:`nms_keep` runs
:func:`nms_keep_plain`: the IoU matrix and the JAX package's per-class
wavefront :func:`_greedy_suppress`. The wrappers' plain versions
(:func:`overlap_mask_plain`, :func:`greedy_scan_plain`) model the
kernels' algorithm; each wrapper's ``launches`` attribute counts kernel
launches.

:func:`_greedy_suppress` decides in each round every box whose
higher-ranked overlapping boxes are all decided, so the number of rounds
is the longest suppression chain, not the number of boxes.
:func:`_greedy_suppress_serial` is the one-box-per-step oracle. All rank
boxes by descending score with a stable sort (lower index first on
ties), as ``jnp.argsort`` does.
"""
from __future__ import annotations

import torch

from ..geom.iou import iou3d_rotated
from . import cuda_lib

WORD = 64   # boxes per bitmask word


def _rank_order(scores, valid):
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def nms_order(scores, labels, valid):
    """The order in which :func:`nms_keep` visits the boxes: by class,
    by descending score (ties to the lower index) within a class, the
    invalid boxes first. Greedy per-class NMS keeps the same boxes in
    any order of the classes; grouping them puts every candidate pair of
    the bitmask into blocks on its diagonal. Returns (order (B, N) int64,
    labels in that order (B, N) int32, -1 for an invalid box)."""
    order = _rank_order(scores, valid)
    lab = torch.where(valid, labels.to(torch.int32),
                      torch.full_like(labels, -1, dtype=torch.int32))
    lab = torch.gather(lab, 1, order)
    by_class = torch.sort(lab, dim=1, stable=True).indices
    return torch.gather(order, 1, by_class), torch.gather(lab, 1, by_class)


def _greedy_suppress_serial(iou, scores, valid, iou_thr):
    """Reference greedy NMS, one box per step. Returns the keep mask (N,)."""
    N = scores.shape[0]
    order = _rank_order(scores, valid).tolist()
    alive = torch.ones(N, dtype=torch.bool, device=scores.device)
    keep = torch.zeros(N, dtype=torch.bool, device=scores.device)
    for i in order:
        is_kept = bool(alive[i]) and bool(valid[i])
        keep[i] = is_kept
        if is_kept:
            alive &= ~(iou[i] > iou_thr)
        alive[i] = False
    return keep


def _greedy_suppress(iou, scores, valid, iou_thr):
    """Wavefront greedy NMS. iou (N, N); scores (N,); valid (..., N):
    leading dims of ``valid`` are independent problems over the same
    boxes (the coder passes one per class). Returns keep (..., N), equal
    to :func:`_greedy_suppress_serial` on each problem."""
    N = scores.shape[-1]
    order = _rank_order(scores.expand_as(valid), valid)
    ar = torch.arange(N, device=scores.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ar)
    # M[..., j, k]: valid j ranked above valid k can suppress k
    overl = (iou > iou_thr) & valid[..., :, None] & valid[..., None, :]
    M = overl & (rank[..., :, None] < rank[..., None, :])
    decided = ~valid
    kept = torch.zeros_like(valid)
    while not bool(decided.all()):
        blocked = (M & ~decided[..., :, None]).any(dim=-2)
        ready = ~decided & ~blocked
        sup = (M & kept[..., :, None]).any(dim=-2)
        kept = kept | (ready & ~sup)
        decided = decided | ready
    return kept


def nms_keep_plain(boxes, scores, labels, valid, iou_thr: float,
                   num_classes: int, z_origin: str = "bottom", iou=None):
    """The plain per-class NMS of B scenes, as the JAX coder runs it:
    the IoU matrix of each scene (or ``iou`` (B, N, N) if given), then
    :func:`_greedy_suppress` with one problem per class. Shapes as
    :func:`nms_keep`."""
    cls_ids = torch.arange(num_classes, device=labels.device)
    out = []
    for b in range(boxes.shape[0]):
        m = iou[b] if iou is not None else iou3d_rotated(
            boxes[b, :, :7], boxes[b, :, :7], z_origin)
        per_cls = valid[b][None, :] & (labels[b][None, :] == cls_ids[:, None])
        out.append(_greedy_suppress(m, scores[b], per_cls,
                                    iou_thr).any(dim=0))
    return torch.stack(out)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., M) bool -> (..., ceil(M / 64)) int64, bit j of word w is
    ``bits[..., 64 w + j]`` (bit 63 is the sign bit)."""
    M = bits.shape[-1]
    W = -(-M // WORD)
    pad = bits.new_zeros(*bits.shape[:-1], W * WORD - M)
    words = torch.cat([bits, pad], dim=-1).reshape(*bits.shape[:-1], W, WORD)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD, device=bits.device)
    # distinct powers of two: every partial sum stays inside int64
    return (words.long() * weights).sum(dim=-1)


def _unpack_bits(words: torch.Tensor, M: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits`: (..., W) int64 -> (..., M) bool."""
    shift = torch.arange(WORD, device=words.device)
    bits = (words[..., None] >> shift) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :M].bool()


def overlap_mask_plain(boxes, labels, iou_thr: float,
                       z_origin: str = "bottom"):
    """boxes (B, N, >=7) and labels (B, N) int32 (-1 for an invalid box)
    in scan order (:func:`nms_order`) -> (B, ceil(N/64), N) int64 bitmask
    in column words:
    bit j of ``mask[b, w, r]`` is pair (r, c = 64 w + j), set when r < c,
    both labels equal and valid, and IoU(r, c) > ``iou_thr`` (box r
    clipped by box c)."""
    N = boxes.shape[1]
    iou = iou3d_rotated(boxes[..., :7], boxes[..., :7], z_origin)
    above = torch.ones((N, N), dtype=torch.bool,
                       device=boxes.device).triu(1)
    same = ((labels[..., :, None] == labels[..., None, :])
            & (labels[..., :, None] >= 0))
    return _pack_bits(above & same & (iou > iou_thr)).transpose(1, 2) \
        .contiguous()


def overlap_mask(boxes, labels, iou_thr: float, z_origin: str = "bottom"):
    """N1 writing the NMS bitmask. See :func:`overlap_mask_plain`."""
    if boxes.dim() != 3 or boxes.shape[-1] < 7 or \
            labels.shape != boxes.shape[:2]:
        raise ValueError("overlap_mask: boxes (B, N, >=7), labels (B, N)")
    if boxes.device.type == "cpu" and labels.device.type == "cpu":
        return overlap_mask_plain(boxes, labels, iou_thr, z_origin)
    bx = boxes[..., :7].float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    if not (bx.is_cuda and lab.device == bx.device):
        raise ValueError("overlap_mask: boxes and labels on one CUDA device")
    B, N = lab.shape
    mask = torch.empty((B, -(-N // WORD), N), dtype=torch.int64,
                       device=bx.device)
    with torch.cuda.device(bx.device):
        status = cuda_lib.library().u3d_iou3d_rotated_mask(
            bx.data_ptr(), lab.data_ptr(), mask.data_ptr(), B, N,
            float(iou_thr), int(z_origin == "bottom"),
            torch.cuda.current_stream(bx.device).cuda_stream)
    cuda_lib.check(status, "u3d_iou3d_rotated_mask")
    overlap_mask.launches += 1
    return mask


overlap_mask.launches = 0


def greedy_scan_plain(mask, labels, order):
    """mask (B, ceil(N/64), N) int64 (:func:`overlap_mask`), labels
    (B, N) in scan order (-1 invalid), order (B, N) int64 (position ->
    box index, :func:`nms_order`) -> keep (B, N) bool by box index: the
    greedy pass in scan order, a valid box kept unless a kept box's row
    has its bit, on the host."""
    B, N = labels.shape
    bits = _unpack_bits(mask.cpu().transpose(1, 2), N)
    valid = (labels >= 0).cpu().tolist()
    kept = torch.zeros((B, N), dtype=torch.bool)
    for b in range(B):
        removed = torch.zeros(N, dtype=torch.bool)
        for r in range(N):
            if valid[b][r] and not removed[r]:
                kept[b, r] = True
                removed |= bits[b, r]
    keep = torch.zeros_like(kept).scatter_(1, order.cpu(), kept)
    return keep.to(labels.device)


def greedy_scan(mask, labels, order):
    """N2. See :func:`greedy_scan_plain`; one block per scene."""
    B, N = labels.shape
    if mask.shape != (B, -(-N // WORD), N) or order.shape != (B, N):
        raise ValueError("greedy_scan: mask (B, ceil(N/64), N), labels and "
                         "order (B, N)")
    if all(t.device.type == "cpu" for t in (mask, labels, order)):
        return greedy_scan_plain(mask, labels, order)
    lab = labels.to(torch.int32).contiguous()
    order = order.to(torch.int64).contiguous()
    mask = mask.contiguous()
    if not all(t.is_cuda and t.device == mask.device
               for t in (mask, lab, order)):
        raise ValueError("greedy_scan: tensors on one CUDA device")
    keep = torch.empty((B, N), dtype=torch.bool, device=mask.device)
    with torch.cuda.device(mask.device):
        status = cuda_lib.library().u3d_nms_greedy(
            mask.data_ptr(), lab.data_ptr(), order.data_ptr(),
            keep.data_ptr(), B, N,
            torch.cuda.current_stream(mask.device).cuda_stream)
    cuda_lib.check(status, "u3d_nms_greedy")
    greedy_scan.launches += 1
    return keep


greedy_scan.launches = 0


def nms_keep(boxes, scores, labels, valid, iou_thr: float,
             num_classes: int, z_origin: str = "bottom"):
    """Greedy per-class rotated 3D NMS of B scenes: boxes (B, N, >=7),
    scores (B, N), labels (B, N) in [0, num_classes), valid (B, N) bool
    -> keep (B, N) bool. A box is kept if it is valid and no kept box of
    its class ranked above it overlaps it by more than ``iou_thr``.

    CUDA tensors: one :func:`overlap_mask` and one :func:`greedy_scan`
    launch for all scenes, no host synchronisation. CPU tensors:
    :func:`nms_keep_plain`."""
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, scores, labels, valid, iou_thr,
                              num_classes, z_origin)
    order, lab = nms_order(scores, labels, valid)
    bx = torch.gather(boxes[..., :7], 1, order[..., None].expand(-1, -1, 7))
    mask = overlap_mask(bx, lab, iou_thr, z_origin)
    return greedy_scan(mask, lab, order)
