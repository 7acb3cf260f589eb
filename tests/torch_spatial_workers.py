"""Rank functions of the port's spatial-sharding tests
(``test_torch_port_spatial.py``). ``parallel.launch.spawn`` runs them in
fresh processes over a (data, spatial) layout: this module imports no
JAX. Each returns numpy arrays and plain objects."""
import os

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_tiny.py")


def _np(t):
    return t.detach().cpu().numpy()


def halo_cases(S):
    """(H, before, after) of the op checks at S ranks: one row a rank
    at H = S, two-row halos, one side only."""
    return [(S, 1, 1), (2 * S, 2, 1), (4 * S, 1, 0), (2 * S, 0, 2)]


def volume(seed, h, channels=3):
    """A (2, C, 2, h, 3) volume, the same on every rank."""
    return np.random.RandomState(seed).randn(2, channels, 2, h, 3).astype(
        np.float32)


def cotangent(seed, shape):
    """A cotangent of this rank's own (``seed`` + rank)."""
    from uni3detr_tpu_torch.parallel import dist
    return torch.from_numpy(np.random.RandomState(
        seed + 100 * dist.rank()).randn(*shape).astype(np.float32))


def ops():
    """``shard``, ``halo`` and ``gather`` on this rank inside the train
    step's scope: for each case of ``halo_cases`` the halo'd slice of a
    whole volume and the whole volume's gradient under this rank's
    cotangent, and the gathered volume with its gradient likewise."""
    from uni3detr_tpu_torch.parallel import dist, spatial

    S = dist.spatial_size()
    out = {"halo": [], "layout": (dist.data_index(), dist.spatial_index())}
    with dist.sharded_batch():
        assert dist.spatial_active()
        for i, (h, before, after) in enumerate(halo_cases(S)):
            x = torch.from_numpy(volume(i, h)).requires_grad_()
            y = spatial.halo(spatial.shard(x, 3), before, after, 3)
            (y * cotangent(i, y.shape)).sum().backward()
            out["halo"].append((_np(y), _np(x.grad)))
        x = torch.from_numpy(volume(9, 2 * S)).requires_grad_()
        z = spatial.gather(spatial.shard(x, 3), 3)
        (z * cotangent(9, z.shape)).sum().backward()
        out["gather"] = (_np(z), _np(x.grad))
    out["divides"] = [spatial.divides(h) for h in (S, 2 * S + 1)]
    return out


def second3d_fpn(cfg, state_dict, x, ct):
    """SECOND3D + SECOND3DFPN of ``cfg`` from ``state_dict`` in train mode
    on this rank's H slice of ``x`` (B, C, D, H, W), the fused volume
    gathered, the loss ``sum(fused * ct) / S``: (fused, x's gradient, the
    parameter gradients, the state dict after)."""
    from uni3detr_tpu_torch.models.second3d import SECOND3D, SECOND3DFPN
    from uni3detr_tpu_torch.parallel import dist, spatial

    bb = SECOND3D(cfg.encoder_out_channels, cfg.backbone_channels,
                  cfg.backbone_layers, cfg.backbone_strides)
    neck = SECOND3DFPN(cfg.backbone_channels, cfg.neck_channels,
                       cfg.neck_upsample_strides)
    mods = torch.nn.ModuleDict({"pts_backbone": bb, "pts_neck": neck})
    mods.load_state_dict({k: torch.from_numpy(v)
                          for k, v in state_dict.items()})
    mods.train()
    xt = torch.from_numpy(x).requires_grad_()
    h = x.shape[3]
    with dist.sharded_batch():
        hs = bb.heights(h)
        fused = neck(bb(spatial.shard(xt, 3), h), hs)
        sliced = fused.shape[3] != neck.height(hs)
        if sliced:
            fused = spatial.gather(fused, 3)
        (fused * torch.from_numpy(ct)).sum().div(
            dist.spatial_size()).backward()
    return dict(fused=_np(fused), dx=_np(xt.grad), sliced=sliced,
                grads={n: _np(p.grad) for n, p in mods.named_parameters()},
                state={k: _np(v) for k, v in mods.state_dict().items()})


def dense_encoder(enc_kw, state_dict, voxels, wsum):
    """The dense sparse encoder (``SparseEncoderHD(impl="dense",
    **enc_kw)``) in train mode on the global voxels inside the train
    step's scope, split along H: (this rank's volume, the global grid,
    the state dict after, the parameter gradients of ``sum(volume *
    wsum)`` over this rank's rows, over S where the volume is whole on
    every rank)."""
    from uni3detr_tpu_torch.models.sparse_encoder import SparseEncoderHD
    from uni3detr_tpu_torch.parallel import dist, spatial

    enc = SparseEncoderHD(**enc_kw)
    enc.load_state_dict({k: torch.from_numpy(v)
                         for k, v in state_dict.items()})
    enc.train()
    f, c, m = (torch.from_numpy(a) for a in voxels)
    with dist.sharded_batch():
        vol, grid = enc(f, c, m, spatial=True)
        w = torch.from_numpy(wsum)
        if vol.shape[2] != grid[1]:
            (vol * spatial.shard(w, 2)).sum().backward()
        else:
            (vol * w).sum().div(dist.spatial_size()).backward()
    return dict(vol=_np(vol), grid=grid,
                state={k: _np(v) for k, v in enc.state_dict().items()},
                grads={n: _np(p.grad) for n, p in enc.named_parameters()})


def ov_step(cfg, state_dict, batch, modality, lr):
    """One OV ``train_step`` (modality ``modality``) on this data group's
    slice of ``batch``, with ``spatial.gather`` and ``spatial.halo``
    replaced by a raise: (logs, state dict after, AdamW's first moments
    by name)."""
    from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR
    from uni3detr_tpu_torch.parallel import dist, spatial
    from uni3detr_tpu_torch.train.step import make_optimizer, train_step

    def refuse(*a, **k):
        raise AssertionError("the OV point branch split its volume")

    model = OV_Uni3DETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    opt = make_optimizer(model, lr)
    sl = dist.local_slice(len(batch["gt_mask"]))
    real = spatial.gather, spatial.halo
    spatial.gather = spatial.halo = refuse
    try:
        logs = train_step(model, opt, {k: torch.from_numpy(v[sl])
                                       for k, v in batch.items()},
                          modality=modality)
    finally:
        spatial.gather, spatial.halo = real
    mu = {n: _np(opt.adamw.state[p]["exp_avg"])
          for n, p in model.named_parameters() if p in opt.adamw.state}
    return ({k: float(v) for k, v in logs.items()},
            {k: _np(v) for k, v in model.state_dict().items()}, mu)


def cli_spatial(work_dir, rendezvous):
    """``cli.train --spatial-shard 2`` with the JAX CLI's multi-process
    flags on the CPU: 3 steps, an eval after the first epoch; returns the
    CLI's summary and this rank's weights after."""
    from uni3detr_tpu_torch.cli import train as cli_train
    from uni3detr_tpu_torch.train import step as step_mod

    seen = {}
    real = step_mod.train_step

    def watch(model, opt, batch, **kw):
        seen["model"] = model
        seen.setdefault("batches", []).append(
            {k: _np(v) for k, v in batch.items()})
        return real(model, opt, batch, **kw)

    step_mod.train_step = watch
    try:
        res = cli_train.main([
            TINY, "--work-dir", work_dir, "--max-steps", "3", "--device",
            "cpu", "--spatial-shard", "2", "--num-processes",
            os.environ["WORLD_SIZE"], "--process-id", os.environ["RANK"],
            "--coordinator", rendezvous, "--cfg-options", "data.length=4",
            "evaluation.interval=1", "evaluation.max_samples=3",
            "log_config.interval=1"])
    finally:
        step_mod.train_step = real
    keep = ("epoch", "step", "evals", "rank", "world_size")
    return ({k: res[k] for k in keep},
            {k: _np(v) for k, v in seen["model"].state_dict().items()},
            seen["batches"])
