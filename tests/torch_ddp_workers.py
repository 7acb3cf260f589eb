"""Rank functions of the port's data-parallel tests
(``test_torch_port_ddp.py``, and the card test of two ranks sharing one
card in ``test_torch_port_cuda.py``). ``parallel.launch.spawn`` runs them
in fresh processes: this module imports no JAX. Each returns numpy
arrays and plain objects."""
import os

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_tiny.py")


def _np(t):
    return t.detach().cpu().numpy()


def _bn_state(bn, p, s):
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    return bn.train()


def basics(masked, dense, tmpdir):
    """``local_slice``, ``gather_objects`` under both transports, and
    one train-mode forward + backward of ``MaskedBatchNorm`` and
    ``second3d.BatchNorm3d`` on this rank's slice of the global batch
    (``masked``: x, mask, params, stats, cotangent; ``dense``: x (N, C,
    D, H, W), params, stats, cotangent), inside ``dist.sharded_batch()``
    and again outside it (``*_local``)."""
    from uni3detr_tpu_torch.models.layers import MaskedBatchNorm
    from uni3detr_tpu_torch.models.second3d import BatchNorm3d
    from uni3detr_tpu_torch.parallel import dist

    r = dist.rank()
    out = {"slice": dist.local_slice(8)}
    try:
        dist.local_slice(5)
        out["odd"] = None
    except AssertionError as e:
        out["odd"] = str(e)
    out["gather"] = dist.gather_objects({"rank": r,
                                         "arr": np.arange(r + 3)})
    os.environ["UNI3DETR_GATHER"] = "file"
    try:
        out["gather_file"] = dist.gather_objects([r] * (r + 1), tmpdir,
                                                 name="t")
    finally:
        del os.environ["UNI3DETR_GATHER"]
    out["left"] = sorted(os.listdir(tmpdir))

    def bn_run(bn, x, ct, *extra):
        sl = dist.local_slice(x.shape[0])
        xt = torch.from_numpy(x[sl]).requires_grad_()
        y = bn(xt, *(torch.from_numpy(e[sl]) for e in extra))
        (y * torch.from_numpy(ct[sl])).sum().backward()
        return dict(y=_np(y), dx=_np(xt.grad), mean=_np(bn.running_mean),
                    var=_np(bn.running_var), dscale=_np(bn.weight.grad),
                    dbias=_np(bn.bias.grad))

    x, mask, p, s, ct = masked
    xd, pd, sd, ctd = dense
    with dist.sharded_batch():
        out["masked"] = bn_run(_bn_state(MaskedBatchNorm(x.shape[-1]), p, s),
                               x, ct, mask)
        out["dense"] = bn_run(_bn_state(BatchNorm3d(xd.shape[1]), pd, sd),
                              xd, ctd)
    # outside the train step's context: the rank's own statistics
    out["masked_local"] = bn_run(
        _bn_state(MaskedBatchNorm(x.shape[-1]), p, s), x, ct, mask)
    out["dense_local"] = bn_run(_bn_state(BatchNorm3d(xd.shape[1]), pd, sd),
                                xd, ctd)
    return out


def train_step(cfg, state_dict, batch, lr, device="cpu"):
    """One ``train_step`` of ``Uni3DETR(cfg)`` from ``state_dict`` on this
    rank's slice of the global ``batch``: (logs, state_dict after, the
    AdamW first moments by parameter name, launches)."""
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.ops import launch_counts
    from uni3detr_tpu_torch.parallel import dist
    from uni3detr_tpu_torch.train.step import make_optimizer
    from uni3detr_tpu_torch.train.step import train_step as step

    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    model = Uni3DETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    model.to(dev)
    opt = make_optimizer(model, lr)
    sl = dist.local_slice(len(batch["points"]))
    before = launch_counts()
    logs = step(model, opt, {k: torch.from_numpy(v[sl]).to(dev)
                             for k, v in batch.items()})
    after = launch_counts()
    mu = {n: _np(opt.adamw.state[p]["exp_avg"])
          for n, p in model.named_parameters() if p in opt.adamw.state}
    return ({k: float(v) for k, v in logs.items()},
            {k: _np(v) for k, v in model.state_dict().items()}, mu,
            {k: after[k] - before[k] for k in after})


def scene_points(scenes, view, nq=None):
    """The random query group of a batch keyed by its scenes' dataset
    indices: scene i's points from ``RandomState(1000 + i)``."""
    from uni3detr_tpu_torch import presets
    nq = nq or presets.TINY_SYNTHETIC.num_query
    return np.stack([np.random.RandomState(1000 + i + 7919 * view)
                     .uniform(size=(nq, 3)).astype(np.float32)
                     for i in scenes])


def inference(state_dict, n, batch_sizes):
    """``run_inference_distributed`` of the tiny config's val split (the
    first ``n`` scenes) at each batch size with ``scene_points``;
    returns {batch size: (dets, gts)} (rank 0's; ([], []) elsewhere)."""
    from uni3detr_tpu_torch import config_file
    from uni3detr_tpu_torch.data.datasets import build_dataset
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.train.evaluator import run_inference_distributed

    cfg = config_file.load_config(TINY)
    mc = config_file.build_model_config(cfg)
    ds = build_dataset(cfg.data, cfg.class_names, mc.pc_range, "val")
    model = Uni3DETR(mc).eval()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    return {bs: run_inference_distributed(
        ds, model, mc, device="cpu", batch_size=bs, max_samples=n,
        random_points=scene_points) for bs in batch_sizes}


def clis(work_dir, rendezvous, device="cpu"):
    """``cli.train`` (3 steps over 2 epochs, an eval after the first),
    its resume from ``epoch_1``, then ``cli.test`` on the resumed
    ``latest``, each with the JAX CLI's multi-process flags and a
    rendezvous of its own; returns the three results, minus the
    detections of other ranks."""
    from uni3detr_tpu_torch.cli import test as cli_test
    from uni3detr_tpu_torch.cli import train as cli_train

    r = os.environ["RANK"]
    W = os.environ["WORLD_SIZE"]

    def flags(tag):
        return ["--device", device, "--num-processes", W, "--process-id", r,
                "--coordinator", f"{rendezvous}_{tag}"]

    opts = ["--cfg-options", "data.length=8", "evaluation.interval=1",
            "evaluation.max_samples=5", "log_config.interval=1"]
    first = cli_train.main([TINY, "--work-dir", work_dir, "--max-steps", "3",
                            *flags("train"), *opts])
    resumed = cli_train.main([TINY, "--work-dir", work_dir, "--resume-from",
                              os.path.join(work_dir, "epoch_1"),
                              *flags("resume"), *opts])
    test = cli_test.main([TINY, os.path.join(work_dir, "latest"), "--eval",
                          "bbox", "--max-samples", "5", "--out",
                          os.path.join(work_dir, "dets.pkl"),
                          *flags("test")])
    keep = ("epoch", "step", "evals", "rank", "world_size")
    return ({k: first[k] for k in keep}, {k: resumed[k] for k in keep},
            {k: test[k] for k in ("dets", "gts", "metrics", "rank",
                                  "world_size")})
