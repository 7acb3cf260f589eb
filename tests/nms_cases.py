"""Box sets for the NMS, rotated-IoU and metric tests of the port (numpy
only, so the card tests, which import no JAX, share them with the CPU
tests)."""
import numpy as np

KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


def clustered_boxes(seed, n=512, ncls=18, thr=0.5):
    """Gravity-centred boxes (n, 7), scores with ties, labels and valid:
    clusters of jittered copies (many overlaps of one label), chains of
    equal boxes spaced so that neighbours overlap by IoU = thr x (1
    +- 2e-4) and next neighbours by less, some rotated by 45 or 90
    degrees."""
    rng = np.random.RandomState(seed)
    boxes, labels = [], []
    while len(boxes) < n:
        kind = rng.randint(3)
        c = rng.uniform([-6, -6, 0.2], [6, 6, 2.0])
        size = rng.uniform(0.3, 1.5, 3)
        lab = rng.randint(ncls)
        if kind == 0:            # a cluster of jittered copies
            for _ in range(rng.randint(4, 12)):
                b = np.r_[c + rng.randn(3) * 0.1 * size,
                          size * rng.uniform(0.8, 1.25, 3),
                          rng.choice([0.0, np.pi / 4, np.pi / 2])
                          + rng.randn() * 0.05]
                boxes.append(b)
                labels.append(lab if rng.rand() < 0.8 else rng.randint(ncls))
        else:                    # a chain along x at IoU ~ thr
            # equal boxes shifted by s along x: IoU = (L - s) / (L + s)
            r = thr * (1 + rng.choice([-2e-4, 2e-4, 0.05, -0.05]))
            step = size[0] * (1 - r) / (1 + r)
            yaw = 0.0 if kind == 1 else np.pi / 2
            if yaw:              # dx runs along y after 90 degrees
                size = size[[1, 0, 2]]
                step = size[1] * (1 - r) / (1 + r)
            for k in range(rng.randint(3, 9)):
                boxes.append(np.r_[c + [k * step, 0, 0], size, yaw])
                labels.append(lab)
    boxes = np.asarray(boxes[:n], np.float32)
    labels = np.asarray(labels[:n], np.int32)
    scores = np.round(rng.rand(n), 2).astype(np.float32)     # ties
    valid = rng.rand(n) > 0.1
    return boxes, scores, labels, valid


def degenerate_pairs():
    """(a, b) box pairs (cx, cy, cz, dx, dy, dz, yaw)."""
    base = np.array([0.3, -0.2, 0.5, 1.2, 0.8, 0.6, 0.3])
    pairs = [(base, base)]                                    # identical
    for yaw in (0.0, 0.7):                                    # touching edge
        a = np.r_[base[:6], yaw]
        shift = np.array([np.cos(yaw), np.sin(yaw)]) * base[3]
        pairs.append((a, np.r_[a[:2] + shift, a[2:]]))
    inner = base.copy()                                       # inside
    inner[3:6] *= 0.5
    pairs += [(base, inner), (inner, base)]
    for rot in (np.pi / 2, np.pi / 4, -np.pi / 4, np.pi):     # rotations
        pairs.append((base, np.r_[base[:6], base[6] + rot]))
    sq = np.r_[base[:3], 1.0, 1.0, 0.6, 0.0]                  # square at 90
    pairs.append((sq, np.r_[sq[:6], np.pi / 2]))
    flat = base.copy()                                        # zero height
    flat[5] = 0.0
    pairs += [(flat, base), (flat, flat)]
    tiny = np.r_[base[:3], 1e-4, 1e-4, 1e-4, 0.1]             # degenerate
    pairs.append((base, tiny))
    return [(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in pairs]


def random_kitti_scenes(seed, n=5):
    """Scenes with names (the three classes, Van, Person_sitting and
    DontCare), 2D boxes, occlusion, truncation and alpha; detections are
    jittered copies of most GT rows plus a few strays."""
    rng = np.random.RandomState(seed)
    names_all = np.array(list(KITTI_CLASSES)
                         + ["Van", "Person_sitting", "DontCare"],
                         dtype=object)
    gts, dets = [], []
    for _ in range(n):
        G = rng.randint(2, 9)
        names = names_all[rng.randint(0, len(names_all), G)]
        size = np.array([3.9, 1.6, 1.5]) * rng.uniform(0.5, 1.2, (G, 3))
        boxes = np.concatenate([rng.uniform([2, -15, -2], [50, 15, -1],
                                            (G, 3)), size,
                                rng.uniform(-np.pi, np.pi, (G, 1))], 1)
        xy = rng.uniform(0, 900, (G, 2))
        bbox = np.concatenate([xy, xy + rng.uniform(15, 90, (G, 2))], 1)
        gts.append({
            "boxes": boxes.astype(np.float32), "names": names,
            "labels": np.array([KITTI_CLASSES.index(m)
                                if m in KITTI_CLASSES else -1
                                for m in names]),
            "bbox": bbox.astype(np.float32),
            "occluded": rng.randint(0, 3, G),
            "truncated": (rng.rand(G) * 0.6).astype(np.float32),
            "alpha": rng.uniform(-np.pi, np.pi, G).astype(np.float32)})
        hit = (rng.rand(G) < 0.8) & (names != "DontCare")
        k = int(hit.sum()) + rng.randint(1, 4)
        db = np.concatenate([boxes[hit], rng.uniform(
            [2, -15, -2, 1, 0.5, 1, -3], [50, 15, -1, 4, 2, 2, 3],
            (k - hit.sum(), 7))])
        db[:hit.sum(), :3] += rng.randn(hit.sum(), 3) * 0.15
        db[:hit.sum(), 6] += rng.randn(hit.sum()) * 0.1
        dl = np.concatenate([np.where(gts[-1]["labels"][hit] >= 0,
                                      gts[-1]["labels"][hit],
                                      rng.randint(0, 3, hit.sum())),
                             rng.randint(0, 3, k - hit.sum())])
        dbox = np.concatenate([bbox[hit], rng.uniform(0, 900, (k - hit.sum(),
                                                               2)).repeat(
            2, 1) + [0, 0, 40, 40]])
        dets.append({
            "boxes": db.astype(np.float32), "labels": dl,
            "scores": rng.rand(k).astype(np.float32),
            "bbox": (dbox + rng.randn(k, 4) * 3).astype(np.float32),
            "alpha": np.concatenate([gts[-1]["alpha"][hit],
                                     rng.uniform(-3, 3, k - hit.sum())]
                                    ).astype(np.float32)})
    return gts, dets


def indoor_scenes(seed, ncls=10, n=6):
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(n):
        G = rng.randint(0, 9)
        gb = np.concatenate([rng.uniform([-3, 0, -1], [3, 6, 0], (G, 3)),
                             rng.uniform(0.3, 1.5, (G, 3)),
                             rng.uniform(-3, 3, (G, 1))], 1)
        gl = rng.randint(0, ncls, G)
        keep = rng.rand(G) < 0.7
        D = int(keep.sum()) + rng.randint(0, 4)
        db = np.concatenate([gb[keep], rng.uniform(
            [-3, 0, -1, 0.3, 0.3, 0.3, -3], [3, 6, 0, 1.5, 1.5, 1.5, 3],
            (D - keep.sum(), 7))])
        db[:keep.sum(), :3] += rng.randn(keep.sum(), 3) * 0.1
        gts.append({"boxes": gb.astype(np.float32), "labels": gl})
        dets.append({"boxes": db.astype(np.float32),
                     "labels": np.concatenate([gl[keep], rng.randint(
                         0, ncls, D - keep.sum())]),
                     "scores": rng.rand(D).astype(np.float32)})
    return gts, dets
