"""N3's redesign (soft-NMS over each class's own segment, on N1's IoU of
same-class pairs) on the CPU, against the plain soft-NMS and JAX.

The card runs ``ops.nms.soft_nms`` as two kernels: N1's class blocks
(``iou3d_class_blocks``) over the boxes in ``soft_nms_order`` and N3
(``soft_nms_segments``), one block per (scene, class) over the class's
segment of positions. Here, with torch on two threads and N <= 300:

- the plain model of N3's algorithm, ``soft_nms_segments_plain`` (segment
  bounds from the ascending labels, per-segment loops, ties to the lower
  box index and not the lower position, the IoU-0 entries left as they
  are), equal bit for bit to ``soft_nms_plain`` on the IoU matrix, on
  random cases: scores rounded to 1/8 (many ties), one class holding
  every box, empty classes, invalid boxes, labels outside [0, C);
- the plain class blocks equal bit for bit to ``iou3d_rotated_pairwise``'s
  plain matrix at every pair of one class, in scan order;
- ``soft_nms`` on CPU tensors against JAX's ``soft_nms3d`` per class, 64
  boxes a scene: the kept indices in order and ``ok`` identical, scores
  within rtol 5e-5 (JAX's IoU and the port's plain IoU differ by fp32
  rounding, ~1e-6 on these jittered, rotated copies, and a box's score
  carries that of every decay it took; ``test_torch_port_options.py``
  holds ``soft_nms_plain`` to 1e-6 on its less crowded boxes);
- Python mirrors of two pieces of the CUDA kernel that only the card
  runs: the warp-wide 32-way search of a segment's bounds against
  ``torch.searchsorted``, and the 64-bit argmax key (the score as an
  order-preserving integer, then the complement of the box index)
  against ``torch.argmax``'s choice.
"""
import numpy as np
import pytest
import torch

from nms_cases import clustered_boxes
from uni3detr_tpu.ops.nms import soft_nms3d
from uni3detr_tpu_torch.geom.iou import iou3d_rotated_pairwise
from uni3detr_tpu_torch.ops import kernel_wrappers
from uni3detr_tpu_torch.ops import nms

SIGMA, PRUNE = 0.3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _scenes(case, B=2, N=None):
    """(boxes (B, N, 7) bottom z, scores, labels, valid, num_classes) of
    one case, from numpy with a seed."""
    n, C = {"random": (300, 18), "ties": (300, 18), "one_class": (200, 1),
            "empty_classes": (150, 40), "invalid": (200, 6),
            "outside": (250, 5), "tiny": (1, 3)}[case]
    N = N or n
    seed = ["random", "ties", "one_class", "empty_classes", "invalid",
            "outside", "tiny"].index(case)
    parts = [clustered_boxes(100 * seed + b, n=N) for b in range(B)]
    boxes, scores, labels, valid = (np.stack(a) for a in zip(*parts))
    boxes[..., 2] -= boxes[..., 5] / 2
    labels = labels % C
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0.0, 1.0, (B, N)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 8) / 8
    elif case == "empty_classes":
        labels = labels % 7 * 5            # classes 0, 5, ..., 30 only
    elif case == "invalid":
        valid = rng.rand(B, N) > 0.6
    elif case == "outside":
        labels = rng.randint(-3, C + 3, (B, N)).astype(np.int32)
    return (*(torch.from_numpy(np.ascontiguousarray(a))
              for a in (boxes, scores, labels, valid)), C)


def _matrix_blocks(iou, order, lab):
    """The class blocks N3 reads, cut from the IoU matrix: entry (r, c)
    the matrix entry of the boxes at positions r and c where both have one
    label >= 0, NaN elsewhere (never read)."""
    mat = torch.stack([m[o][:, o] for m, o in zip(iou, order)])
    same = (lab[:, :, None] == lab[:, None, :]) & (lab[:, :, None] >= 0)
    return torch.where(same, mat, torch.full_like(mat, float("nan")))


CASES = ["random", "ties", "one_class", "empty_classes", "invalid",
         "outside", "tiny"]


@pytest.mark.parametrize("case", CASES)
def test_segment_model_equals_soft_nms_plain(case):
    boxes, scores, labels, valid, C = _scenes(case)
    N = scores.shape[1]
    iou = iou3d_rotated_pairwise(boxes)
    ref = nms.soft_nms_plain(iou, scores, labels, valid, C, SIGMA, PRUNE, N)
    order, lab = nms.soft_nms_order(scores, labels, valid, C)
    got = nms.soft_nms_segments(_matrix_blocks(iou, order, lab), order,
                                lab, scores, C, SIGMA, PRUNE, N)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ref[1].any() and not (ref[1] & ~valid).any()
    if case == "ties":
        assert (scores[:, :, None] == scores[:, None, :]).sum() > 8 * N


@pytest.mark.parametrize("case", ["random", "one_class", "outside"])
def test_segment_model_stops_early_and_caps_steps(case):
    """A prune that ends most loops early, and ``max_out`` below the
    longest loop."""
    boxes, scores, labels, valid, C = _scenes(case)
    iou = iou3d_rotated_pairwise(boxes)
    order, lab = nms.soft_nms_order(scores, labels, valid, C)
    blocks = _matrix_blocks(iou, order, lab)
    for prune, max_out in ((0.4, 300), (PRUNE, 7)):
        ref = nms.soft_nms_plain(iou, scores, labels, valid, C, SIGMA, prune,
                                 max_out)
        got = nms.soft_nms_segments(blocks, order, lab, scores, C, SIGMA,
                                    prune, max_out)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert int(ref[2].max()) <= max_out - 1


def test_segment_ties_go_to_the_lower_box_index():
    """Equal scores in one class whose scan positions are not in box
    index order once scores decay: box 3 decays to the score of box 1."""
    boxes = torch.tensor([[[0.0, 0, 0, 1, 1, 1, 0], [9.0, 0, 0, 1, 1, 1, 0],
                           [0.3, 0, 0, 1, 1, 1, 0], [20.0, 0, 0, 1, 1, 1, 0]]])
    iou = iou3d_rotated_pairwise(boxes)
    live = torch.tensor([0.9, 0.5, 0.8, 0.5])
    decay = torch.exp(-(iou[0, 0, 2] ** 2) / torch.tensor(SIGMA))
    # box 2 after box 0's decay equals boxes 1 and 3: a three-way tie
    live[1] = live[3] = live[2] * decay
    labels = torch.zeros((1, 4), dtype=torch.int32)
    valid = torch.ones((1, 4), dtype=torch.bool)
    ref = nms.soft_nms_plain(iou, live[None], labels, valid, 1, SIGMA, PRUNE,
                             4)
    order, lab = nms.soft_nms_order(live[None], labels, valid, 1)
    got = nms.soft_nms_segments(_matrix_blocks(iou, order, lab), order, lab,
                                live[None], 1, SIGMA, PRUNE, 4)
    assert ref[2].tolist() == [[0, 1, 2, 3]]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", ["random", "one_class", "outside",
                                  "invalid"])
def test_class_blocks_plain_equal_the_matrix(case):
    boxes, scores, labels, valid, C = _scenes(case)
    order, lab = nms.soft_nms_order(scores, labels, valid, C)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    blocks = nms.iou3d_class_blocks(bx, lab)
    same = (lab[:, :, None] == lab[:, None, :]) & (lab[:, :, None] >= 0)
    mat = _matrix_blocks(iou3d_rotated_pairwise(boxes), order, lab)
    assert torch.equal(blocks[same], mat[same])
    assert not blocks[~same].any()
    # overlapping pairs beyond each box with itself
    assert (blocks[same] > 0).sum() > 1.5 * (lab >= 0).sum()
    # the model on the kernel's own blocks equals the plain soft-NMS
    N = scores.shape[1]
    ref = nms.soft_nms_plain(iou3d_rotated_pairwise(boxes), scores, labels,
                             valid, C, SIGMA, PRUNE, N)
    got = nms.soft_nms_segments(blocks, order, lab, scores, C, SIGMA, PRUNE,
                                N)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", ["random", "empty_classes", "outside"])
def test_soft_nms_order_segments(case):
    """Labels ascend in scan order; class c's segment holds exactly its
    valid boxes, by descending score, ties to the lower index; every
    other box (invalid or outside [0, C)) comes first or last at -1."""
    boxes, scores, labels, valid, C = _scenes(case)
    order, lab = nms.soft_nms_order(scores, labels, valid, C)
    assert (lab[:, 1:] >= lab[:, :-1]).all()
    assert ((lab == -1) | ((lab >= 0) & (lab < C))).all()
    for b in range(scores.shape[0]):
        assert sorted(order[b].tolist()) == list(range(scores.shape[1]))
        for c in range(C):
            seg = order[b][lab[b] == c].tolist()
            mine = [i for i in range(scores.shape[1])
                    if valid[b, i] and labels[b, i] == c]
            assert seg == sorted(mine, key=lambda i: (-scores[b, i], i))


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "outside"])
def test_soft_nms_matches_jax_per_class(case):
    """At 64 boxes a scene: JAX's IoU differs from the port's plain IoU by
    fp32 rounding (sin, cos, the shoelace sum's order), which a longer
    loop accumulates into its decayed scores until two near-equal scores
    swap (at 300 boxes a scene, rounded to 1/8, two boxes of 33 kept)."""
    boxes, scores, labels, valid, C = _scenes(case, N=64)
    B, N = scores.shape
    out, keep, step = nms.soft_nms(boxes, scores, labels, valid, C, SIGMA,
                                   PRUNE, N)
    nb, sc, lb, vd = (t.numpy() for t in (boxes, scores, labels, valid))
    n_kept = 0
    for b in range(B):
        for c in range(C):
            jidx, jouts, jok = (np.asarray(a) for a in soft_nms3d(
                nb[b], sc[b], vd[b] & (lb[b] == c), gaussian_sigma=SIGMA,
                prune_threshold=PRUNE, max_out=N))
            mine = (lb[b] == c) & keep[b].numpy()
            idx = np.flatnonzero(mine)[np.argsort(step[b].numpy()[mine],
                                                  kind="stable")]
            k = len(idx)
            np.testing.assert_array_equal(idx, jidx[:k], err_msg=str((b, c)))
            assert jok[:k].all() and not jok[k:].any()
            np.testing.assert_allclose(out[b].numpy()[idx], jouts[:k],
                                       rtol=5e-5, atol=1e-6)
            n_kept += k
    assert n_kept == int(keep.sum()) > 10
    assert not out[~keep].any() and (step[~keep] == -1).all()


def test_soft_nms_rejects_bad_shapes():
    boxes, scores, labels, valid, C = _scenes("tiny")
    with pytest.raises(ValueError):
        nms.soft_nms(boxes[..., :6], scores, labels, valid, C, SIGMA, PRUNE,
                     1)
    with pytest.raises(ValueError):
        nms.soft_nms_segments(torch.zeros(1, 2, 2), torch.zeros(
            1, 1, dtype=torch.long), labels[:1], scores[:1], C, SIGMA, PRUNE,
            1)
    with pytest.raises(ValueError):
        nms.iou3d_class_blocks(boxes, labels[:, :0])


def test_the_new_n1_form_is_a_counted_wrapper():
    w = kernel_wrappers()
    assert w["iou3d_rotated_blocks"] is nms.iou3d_class_blocks
    assert w["soft_nms"] is nms.soft_nms_segments
    assert all(isinstance(fn.launches, int) for fn in w.values())
    # CPU tensors run the plain versions and count no launch
    boxes, scores, labels, valid, C = _scenes("tiny")
    before = (nms.iou3d_class_blocks.launches,
              nms.soft_nms_segments.launches)
    nms.soft_nms(boxes, scores, labels, valid, C, SIGMA, PRUNE, 1)
    order, lab = nms.soft_nms_order(scores, labels, valid, C)
    nms.soft_nms_segments(nms.iou3d_class_blocks(boxes, lab), order, lab,
                          scores, C, SIGMA, PRUNE, 1)
    assert (nms.iou3d_class_blocks.launches,
            nms.soft_nms_segments.launches) == before


# -- mirrors of the CUDA kernel's search and argmax key -----------------------

def _lower_bound_warp(lab, v):
    """``lower_bound_warp`` of csrc/nms.cu: 32 probes a round."""
    lo, hi, rounds = 0, len(lab), 0
    while lo < hi:
        rounds += 1
        gap = (hi - lo + 31) // 32
        below = sum(1 for lane in range(32)
                    if lo + lane * gap < hi and lab[lo + lane * gap] < v)
        if below == 0:
            return lo, rounds
        hi = min(lo + below * gap, hi)
        lo += (below - 1) * gap + 1
    return lo, rounds


@pytest.mark.parametrize("N", [0, 1, 31, 32, 33, 1000, 5000])
def test_warp_search_finds_segment_bounds(N):
    rng = np.random.RandomState(N)
    lab = np.sort(rng.randint(-1, 20, N)).astype(np.int32)
    ref = torch.searchsorted(torch.from_numpy(lab),
                             torch.arange(-2, 23, dtype=torch.int32))
    for v, want in zip(range(-2, 23), ref.tolist()):
        got, rounds = _lower_bound_warp(lab, v)
        assert got == want, (N, v)
        assert rounds <= 3


def _score_key(v):
    """``score_key`` of csrc/nms.cu on a float32 numpy array."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    u = v.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def _key_score(k):
    k = k.astype(np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(
        np.uint32).view(np.float32)


def test_argmax_key_picks_what_argmax_picks():
    rng = np.random.RandomState(0)
    for trial in range(200):
        n = rng.randint(1, 40)
        v = rng.choice(np.array([-np.inf, -1.5, -0.0, 0.0, 1e-30, 0.25, 0.5,
                                 0.5000001, 3.0], np.float32), n)
        key = (_score_key(v) << np.uint64(32)) | (
            np.uint64(0xFFFFFFFF) - np.arange(n, dtype=np.uint64))
        assert int(np.argmax(key)) == int(torch.from_numpy(v).argmax()), v
        top = v[int(np.argmax(key))]
        assert _key_score(np.array([key.max() >> np.uint64(32)]))[0] == top
