"""What the port's kernel launches cost, for ``utils.profiling.flops_of``.

The kernels launch through ``ctypes`` (``cuda_lib``), outside PyTorch's
dispatcher, so neither ``torch.utils.flop_counter.FlopCounterMode`` nor
a dispatch mode sees them. Each wrapper that launches its kernel calls
:func:`record` beside its ``launches`` count, under its name in
``ops.kernel_wrappers()`` (K11: ``fps``), with the kernel's operands and
results: the launch adds :func:`flops` of the operands (what
``FlopCounterMode`` counts for the wrapper's plain version on the same
shapes) and their bytes; on the CPU the wrapper runs the
plain version, which the counters see, and records nothing. So a count
taken on the card equals one taken on the CPU.

The FLOPs (what the plain versions' products count, 2 a multiply-add):

- K2 / K3 (``gather_conv``, ``gather_conv_ids``) and K7 / K10 (their
  weight gradients): ``2 B Vout K C Cout``, every tap of every budget row,
  the dense function the TPU kernel computes; not the pairs that have a
  neighbour, which the roofline bound of ``chip_smoke.py`` counts;
- N1 (every IoU form): ``IOU_PAIR_FLOPS`` (2048) a box pair (four
  half-plane clips, each a (16 x 16) 0/1 product that counts the
  emitted vertices);
- K1, K4 / K11, K12, N2 and N3: 0 (searches, comparisons, reductions
  and elementwise decays, which ``FlopCounterMode`` does not count).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

# FLOPs of N1's plain version a box pair: 4 clips x 2 x 16 x 16
IOU_PAIR_FLOPS = 2048


class KernelCost:
    """The kernels' FLOPs and bytes recorded inside one :func:`counting`
    block, in all and by wrapper name."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_name: Dict[str, Dict[str, int]] = {}

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        rec = self.by_name.setdefault(name, {"launches": 0, "flops": 0,
                                             "bytes": 0})
        rec["launches"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes


_OPEN: List[KernelCost] = []


@contextlib.contextmanager
def counting():
    """``with counting() as cost:`` every kernel launch inside the block
    adds its FLOPs and operand + result bytes to ``cost``."""
    cost = KernelCost()
    _OPEN.append(cost)
    try:
        yield cost
    finally:
        _OPEN.remove(cost)


def record(name: str, operands, *results) -> None:
    """A launch of the kernel of wrapper ``name`` on ``operands`` (the
    wrapper's arguments as the kernel reads them) giving ``results``: its
    :func:`flops` and the bytes of every tensor among them go to every
    open :func:`counting` block; nothing happens outside one."""
    if not _OPEN:
        return
    n = flops(name, *operands)
    nbytes = sum(t.numel() * t.element_size() for t in (*operands, *results)
                 if isinstance(t, torch.Tensor))
    for cost in _OPEN:
        cost.add(name, n, nbytes)


def _conv(features, index, weights_or_g):
    """K2 / K3 / K7 / K10: the plain versions' one (B Vout, K C) x (K C,
    Cout) product; ``index`` (B, Vout, K) is the rulebook or the query
    ids."""
    B, _, C = features.shape
    _, Vout, K = index.shape
    return 2 * B * Vout * K * C * weights_or_g.shape[-1]


def _iou_sets(boxes1, boxes2, *_):
    """N1 on two sets (B, M, .) x (B, N, .): every pair of each scene."""
    return IOU_PAIR_FLOPS * boxes1.shape[0] * boxes1.shape[1] \
        * boxes2.shape[1]


def _iou_self(boxes, *_):
    """N1 on one set (B, N, .) against itself (the NMS bitmask, the
    merge's matrix)."""
    return _iou_sets(boxes, boxes)


def _none(*_):
    return 0


# wrapper name -> FLOPs of one launch on the wrapper's arguments
_FLOPS = {
    "match_positions": _none,
    "gather_conv": _conv,
    "gather_conv_ids": lambda f, site_ids, qids, w: _conv(f, qids, w),
    "gather_conv_dw": _conv,
    "gather_conv_ids_dw": lambda f, site_ids, qids, g: _conv(f, qids, g),
    "fps_pair": _none, "fps": _none, "auction_lap": _none,
    "nms_greedy": _none, "soft_nms": _none,
    "iou3d_rotated": _iou_self, "iou_bev_rotated_mask": _iou_self,
    "iou3d_rotated_matrix": _iou_self, "iou3d_rotated_sets": _iou_sets,
    "iou_bev_rotated_sets": _iou_sets,
}


def flops(name: str, *args) -> int:
    """The FLOPs that wrapper ``name`` records for a launch on ``args``
    (its own positional arguments): ``FlopCounterMode``'s count of its
    plain version on the same shapes."""
    return int(_FLOPS[name](*args))
