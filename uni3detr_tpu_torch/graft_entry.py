"""The port's check entry points (counterpart of the JAX package's
``__graft_entry__.py``): the flagship eval forward with example
arguments, and a dry run on n ranks over the JAX dry run's (data,
spatial) layout.

    python -c "from uni3detr_tpu_torch import graft_entry as g; \\
        g.dryrun_multichip(2)"
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda", cfg=None):
    """(forward, example args) of the flagship SUN RGB-D model (``cfg``,
    default ``presets.SUNRGBD``) in eval mode on ``device``: voxelize ->
    sparse encoder -> SECOND3D + FPN -> the 4-group decoder -> the
    per-layer heads, ``forward(points, pts_mask, random_points)``. Every
    parameter and buffer is zero, as the JAX entry's variables; the
    points are zeros, all valid, and the random query group 0.5."""
    from . import presets
    from .models.detector import Uni3DETR

    cfg = cfg or presets.SUNRGBD
    model = Uni3DETR(cfg).eval()
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.zero_()
    model.to(device)
    B, P = 1, cfg.num_points
    points = torch.zeros((B, P, 3), dtype=torch.float32, device=device)
    pts_mask = torch.ones((B, P), dtype=torch.bool, device=device)
    rp = torch.full((B, cfg.num_query, 3), 0.5, dtype=torch.float32,
                    device=device)

    def forward(points, pts_mask, rp):
        return model(points, pts_mask, rp)

    return forward, (points, pts_mask, rp)


def dryrun_config():
    """The JAX dry run's tiny model (``__graft_entry__.py``), with a
    256-point budget (its train batch's) for the eval's collation."""
    from .config import Uni3DETRConfig

    return Uni3DETRConfig(
        num_classes=3, code_size=8,
        pc_range=(-2.0, -2.0, -1.0, 2.0, 2.0, 1.0),
        voxel_size=(0.125, 0.125, 0.25), grid_size=(8, 32, 32),
        max_points_per_voxel=4, max_voxels=256, max_voxels_test=256,
        in_point_features=3, num_points=256,
        encoder_base_channels=8, encoder_out_channels=32,
        encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
        encoder_downsample_paddings=((1, 1, 1), (1, 1, 1), (1, 1, 1)),
        backbone_channels=(16, 16, 16), backbone_layers=(1, 1, 1),
        neck_channels=(32, 32, 32),
        num_query=16, embed_dim=32, num_decoder_layers=2, num_heads=4,
        ffn_dim=64, max_gt=8, max_num=32,
        post_center_range=(-2.0, -2.0, -1.0, 2.0, 2.0, 1.0))


def dryrun_batch(B: int):
    """The JAX dry run's global batch of B scenes (``RandomState(0)``)."""
    cfg = dryrun_config()
    P, G = 256, cfg.max_gt
    rng = np.random.RandomState(0)
    return {
        "points": rng.uniform(-2, 2, (B, P, 3)).astype(np.float32),
        "pts_mask": np.ones((B, P), bool),
        "gt_boxes": np.concatenate([
            rng.uniform(-1, 1, (B, G, 3)), rng.uniform(0.3, 1, (B, G, 3)),
            rng.uniform(-np.pi, np.pi, (B, G, 1))], -1).astype(np.float32),
        "gt_labels": rng.randint(0, 3, (B, G)).astype(np.int32),
        "gt_mask": np.ones((B, G), bool),
    }


def dryrun_layout(n_devices: int):
    """(data, spatial) of the JAX dry run: spatial 2 when n is even."""
    spatial = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // spatial, spatial


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """Run n ranks (``parallel.launch.spawn``; ranks share the cards
    round-robin when there are fewer, over gloo; ``device="cpu"`` runs
    them on the CPU) in the (data, spatial) layout of ``dryrun_layout``:
    one train step of the tiny model on a global batch of 2 x data
    scenes (the volume split along H over the spatial ranks), then
    ``run_inference_distributed`` over 2 x data + 1 scenes (a shard a
    rank, whole). Prints each rank's loss and scene counts; raises when
    a rank fails. Returns the ranks' results."""
    from .parallel.launch import spawn

    data, spatial = dryrun_layout(n_devices)
    res = spawn("uni3detr_tpu_torch.graft_entry:_dryrun_rank", n_devices,
                kwargs={"device": device}, device=device, timeout=timeout,
                spatial=spatial)
    loss = res[0]["loss"]
    assert all(r["loss"] == loss for r in res), [r["loss"] for r in res]
    print(f"dryrun_multichip({n_devices}): mesh=({data},{spatial}), "
          f"{n_devices} ranks on {device}, loss={loss:.4f}, "
          f"{res[0]['n_eval']} scenes gathered, {res[0]['n_det']} dets OK")
    return res


def _dryrun_rank(device):
    """One rank of :func:`dryrun_multichip` (inside the process group)."""
    from .ops import launch_counts
    from .models.detector import Uni3DETR
    from .parallel import dist
    from .train.evaluator import run_inference_distributed
    from .train.step import make_optimizer, train_step
    from .weights import random_state_dict

    W, r, G = dist.world_size(), dist.rank(), dist.data_size()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    cfg = dryrun_config()
    B = 2 * G
    batch = dryrun_batch(B)
    model = Uni3DETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    model.to(dev)
    opt = make_optimizer(model, 1e-3)
    local = dist.local_slice(B)
    before = launch_counts()
    logs = train_step(model, opt, {k: torch.from_numpy(v[local]).to(dev)
                                   for k, v in batch.items()})
    loss = float(logs["total_loss"])
    assert np.isfinite(loss), loss
    print(f"rank {r}/{W}: train step on {B // G} of {B} scenes (spatial "
          f"{dist.spatial_index()} of {dist.spatial_size()}), "
          f"loss={loss:.4f}")

    n_eval = 2 * G + 1
    eval_ds = [{"points": batch["points"][i % B],
                "gt_boxes": batch["gt_boxes"][i % B],
                "gt_labels": batch["gt_labels"][i % B]}
               for i in range(n_eval)]
    dets, gts = run_inference_distributed(eval_ds, model.eval(), cfg,
                                          device=dev, batch_size=2)
    after = launch_counts()
    out = {"rank": r, "loss": loss, "n_eval": len(dets), "n_det": 0,
           "layout": (G, dist.spatial_size()),
           "launches": {k: after[k] - before[k] for k in after}}
    if r == 0:
        assert len(dets) == n_eval and len(gts) == n_eval, \
            (len(dets), n_eval)
        assert all(np.isfinite(d["boxes"]).all() for d in dets)
        out["n_det"] = sum(len(d["scores"]) for d in dets)
        print(f"rank 0: eval of {n_eval} scenes over {W} ranks gathered, "
              f"{out['n_det']} dets")
    return out
