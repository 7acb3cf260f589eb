"""Data and spatial parallelism over ``torch.distributed`` (counterpart
of ``uni3detr_tpu/parallel/mesh.py``).

The JAX package runs one GSPMD program over a (data, spatial) device
mesh. One jit spans the global batch, so its BN statistics, its loss
normalizers and its OV modality draw are the global batch's, and XLA
inserts the gradient psums and the halo exchanges of the dense volume
split along H. The port runs one process per rank, as the reference's
DDP does (SURVEY §2.4), and does each of these by hand.

The rank layout is ``make_mesh``'s: W ranks in W // S data groups of S
spatial ranks (``set_layout``), rank ``r = g * S + s`` at data index
``g = r // S`` and spatial index ``s = r % S``. The S ranks of a data
group hold the same scenes; with S = 1 (the default) it is data
parallelism. Two kinds of subgroup: the spatial group (the S ranks of
this data group: ``spatial_group``) and the data-axis group (the W / S
ranks with this spatial index, which ``batch_group`` names outside
``spatial_slices``).

- ``sharded_batch``, the context in which the train step runs: inside
  it the train-mode BN statistics (``models/layers.py``) and the positive
  count that divides the set losses (``train/losses.py``) are the global
  batch's, through ``batch_ranks`` and the differentiable ``batch_sum``
  over ``batch_group``; outside it every forward and loss is the rank's
  own and makes no collective;
- ``spatial_slices``, inside it, where the tensors are H slices of the
  dense volume (``parallel/spatial.py``): a batch statistic then sums
  over every rank; elsewhere the S ranks of a group hold the same
  tensor and it sums over the data axis only;
- ``average_gradients`` before the clip: the sum over every rank divided
  by the number of data groups (each rank's loss is scaled by 1 / S in
  ``train/step.py``), so that the norm and the clip see the global
  gradient; ``mean_over_ranks`` for the logged losses;
- the modality draw seeded from (seed, step) alone, equal on every rank
  (``cli/train.py``).

``make_mesh``'s counterpart is ``set_layout``; ``constrain``'s is
``parallel/spatial.py``. ``shard_batch``, ``global_batch`` and
``to_host`` have none: parameters live whole on every rank, and each
data group loads its own slice of the global batch (``local_slice``).

Without a process group, or with one rank, every helper is the
single-process identity and no collective runs.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from datetime import timedelta
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

# the gloo group of host objects and barriers when the default group is
# NCCL (None: the default group)
_OBJ_GROUP = None
_OWNED = False
_TIMEOUT = timedelta(minutes=30)     # a collective's wait for the others
_SHARDED = False     # inside sharded_batch()
_SLICES = False      # inside spatial_slices()
# the (data, spatial) layout: S, and this rank's subgroups (None: the
# default group)
_SPATIAL = 1
_SPATIAL_GROUP = None
_DATA_GROUP = None


def world_size() -> int:
    """The number of ranks of the active process group (1 without)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return rank() == 0


def _init_method(coordinator: Optional[str]) -> str:
    if coordinator is None:
        return "env://"      # MASTER_ADDR / MASTER_PORT, as torchrun sets
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda", spatial: int = 1) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    ``coordinator`` is the JAX CLI's ``host:port`` (``tcp://`` is put in
    front) or a full ``tcp://`` / ``file://`` URL; without it the
    address comes from ``MASTER_ADDR`` / ``MASTER_PORT``.
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``, as torchrun sets them. The rank's device is
    ``cuda:LOCAL_RANK % device_count`` (``LOCAL_RANK`` defaults to the
    rank) and is made current; ``device="cpu"`` keeps the rank on the
    CPU. The backend defaults to NCCL when every rank of the host
    (``LOCAL_WORLD_SIZE``, else all of them) has a card of its own, and
    to gloo when ranks share a card (NCCL refuses two ranks on one
    device) or run on the CPU. With NCCL a gloo group carries the host
    objects and barriers. On the card the local rank 0 builds the
    kernels before the others load them. A group already up is used as
    it is. ``spatial``: the layout's S (``set_layout``)."""
    global _OBJ_GROUP, _OWNED
    env = os.environ
    world = num_processes if num_processes is not None \
        else int(env.get("WORLD_SIZE", "1"))
    me = process_id if process_id is not None else int(env.get("RANK", "0"))
    local = int(env.get("LOCAL_RANK", me))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass "
                               "device='cpu' to run the ranks on the CPU)")
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)      # before NCCL's first call
        backend = backend or ("nccl" if local_world <= n else "gloo")
    else:
        dev = torch.device("cpu")
        backend = backend or "gloo"
    if dist.is_initialized():
        set_layout(spatial)
        return dev
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=world, rank=me, timeout=_TIMEOUT)
    _OWNED = True
    _OBJ_GROUP = dist.new_group(backend="gloo") if backend == "nccl" \
        else None
    if dev.type == "cuda":
        from ..ops import cuda_lib
        if local == 0:
            cuda_lib.library()
        barrier()
    set_layout(spatial)
    return dev


def layout_error(world: int, spatial: int) -> Optional[str]:
    """Why W ranks cannot form a (W // S, S) layout, or None."""
    if spatial < 1 or world % spatial:
        return (f"--spatial-shard {spatial} must divide the number of "
                f"processes {world}: the (data, spatial) layout holds "
                f"W // S data groups of S ranks each")
    return None


def set_layout(spatial: int = 1) -> None:
    """Make the (data, spatial) layout of S = ``spatial`` over the ranks:
    the spatial groups (ranks g*S .. g*S + S-1) and the data-axis groups
    (ranks s, S + s, ...), created by ``new_group`` in the same order on
    every rank, which must all call it. S = 1 creates no group (the
    data-axis group is the default one). Raises ValueError when S does
    not divide W (one process included)."""
    global _SPATIAL, _SPATIAL_GROUP, _DATA_GROUP
    err = layout_error(world_size(), spatial)
    if err:
        raise ValueError(err)
    if spatial == _SPATIAL:
        return
    _SPATIAL, _SPATIAL_GROUP, _DATA_GROUP = spatial, None, None
    if spatial == 1:
        return
    w = world_size()
    g, s = divmod(rank(), spatial)
    for i in range(w // spatial):
        grp = dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
        if i == g:
            _SPATIAL_GROUP = grp
    for j in range(spatial):
        grp = dist.new_group(list(range(j, w, spatial)))
        if j == s:
            _DATA_GROUP = grp


def spatial_size() -> int:
    """S: the ranks of a data group (1: data parallel only)."""
    return _SPATIAL


def spatial_index() -> int:
    """s: this rank's place in its data group."""
    return rank() % _SPATIAL


def data_size() -> int:
    """W // S: the number of data groups."""
    return world_size() // _SPATIAL


def data_index() -> int:
    """g: this rank's data group."""
    return rank() // _SPATIAL


def spatial_group():
    """The process group of this data group's S ranks (None when S = 1:
    no collective runs over it then)."""
    return _SPATIAL_GROUP


def destroy_distributed() -> None:
    """Tear down the process group if ``init_distributed`` started it."""
    global _OBJ_GROUP, _OWNED, _SPATIAL, _SPATIAL_GROUP, _DATA_GROUP
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OBJ_GROUP, _OWNED = None, False
    _SPATIAL, _SPATIAL_GROUP, _DATA_GROUP = 1, None, None


def local_slice(n: int) -> slice:
    """This data group's contiguous slice of a length-``n`` global batch
    axis (the groups' slices in order make the global batch; the S ranks
    of a group take the same one)."""
    w, r = data_size(), data_index()
    per = n // w
    assert per * w == n, f"global batch {n} must divide process count {w}"
    return slice(r * per, (r + 1) * per)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_OBJ_GROUP)


def gather_objects(obj, tmpdir: Optional[str] = None,
                   name: str = "gather") -> Optional[List]:
    """Every rank's picklable ``obj`` on rank 0, in rank order; None on
    the other ranks. The transport is a collective on the pickled bytes
    (``gather_object`` over gloo: no shared filesystem needed); under
    ``UNI3DETR_GATHER=file`` each rank writes ``tmpdir/NAME_part_R.pkl``
    and rank 0 reads them, which needs ``tmpdir`` on storage that every
    rank sees."""
    w, r = world_size(), rank()
    if w == 1:
        return [obj]
    if os.environ.get("UNI3DETR_GATHER", "collective") != "file":
        out = [None] * w if r == 0 else None
        dist.gather_object(obj, out, dst=0, group=_OBJ_GROUP)
        return out
    assert tmpdir is not None, "UNI3DETR_GATHER=file needs a shared tmpdir"
    os.makedirs(tmpdir, exist_ok=True)
    path = os.path.join(tmpdir, f"{name}_part_{r}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)
    barrier()
    out = None
    if r == 0:
        out = []
        for i in range(w):
            p = os.path.join(tmpdir, f"{name}_part_{i}.pkl")
            with open(p, "rb") as f:
                out.append(pickle.load(f))
            os.remove(p)
    barrier()
    return out


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite ``module``'s parameters and buffers with rank ``src``'s
    (one flat broadcast per dtype)."""
    if world_size() == 1:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    with torch.no_grad():
        tensors = list(module.parameters()) + list(module.buffers())
        for ts in _by_dtype(tensors):
            flat = _flatten_dense_tensors(ts)
            wire = flat.to(torch.uint8) if flat.dtype == torch.bool else flat
            dist.broadcast(wire, src)
            flat = wire.to(flat.dtype)
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


def group_broadcast(tensors: dict) -> dict:
    """``tensors`` (a dict) as the first rank of this data group holds
    them, on each of its S ranks (a broadcast over the spatial group,
    bool as uint8); as they are when S = 1."""
    if _SPATIAL == 1:
        return tensors
    src = data_index() * _SPATIAL
    out = {}
    for k, t in tensors.items():
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        dist.broadcast(wire, src, group=_SPATIAL_GROUP)
        out[k] = wire.to(t.dtype)
    return out


@contextlib.contextmanager
def sharded_batch():
    """Within: each data group's batch is its slice of one global batch,
    so the train-mode BN statistics and the loss's positive count are
    summed over the groups (``batch_ranks``, ``batch_sum``), as the JAX
    package's one jit over the sharded batch takes them. Every rank must
    make the same calls inside. ``train.step.train_step`` enters it."""
    global _SHARDED
    old, _SHARDED = _SHARDED, True
    try:
        yield
    finally:
        _SHARDED = old


@contextlib.contextmanager
def spatial_slices(on: bool = True):
    """Within (with ``on``, inside ``sharded_batch()``): the tensors are
    this rank's H slices of the dense volume, the S ranks of a group
    holding disjoint slices, so the batch statistics sum over every
    rank. ``on=False`` restores the replicated rule for a tensor whose H
    does not divide by S."""
    global _SLICES
    old, _SLICES = _SLICES, on
    try:
        yield
    finally:
        _SLICES = old


def spatial_active() -> bool:
    """Whether the dense volume is split along H here: S > 1, inside
    ``sharded_batch()`` (the train step; an eval forward runs whole)."""
    return _SHARDED and _SPATIAL > 1


def batch_group():
    """The group a batch statistic sums over: every rank (None, the
    default group) within ``spatial_slices()``, else the data-axis group
    (the default group when S = 1)."""
    return None if _SLICES else _DATA_GROUP


def batch_ranks() -> int:
    """The number of ranks that share the batch, inside
    ``sharded_batch()``: W within ``spatial_slices()``, else the number
    of data groups; 1 outside."""
    if not _SHARDED:
        return 1
    return world_size() if _SLICES else data_size()


def batch_sum(*ts: torch.Tensor):
    """The sums of ``ts`` over the ranks that share the batch (one
    collective for all, over ``batch_group()``), differentiable: the
    backward sums the cotangents over the same ranks, so the gradient
    through a global statistic reaches every rank's inputs. ``ts``
    themselves when ``batch_ranks()`` is 1."""
    if batch_ranks() == 1:
        return ts
    flat = _GroupSum.apply(torch.cat([t.reshape(-1) for t in ts]),
                           batch_group())
    return tuple(v.view_as(t) for v, t in
                 zip(flat.split([t.numel() for t in ts]), ts))


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (None: every rank),
    outside autograd (a new tensor)."""
    if world_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, outside autograd."""
    w = world_size()
    return t if w == 1 else all_reduce_sum(t) / w


def average_gradients(grads: List[torch.Tensor]) -> None:
    """Replace each gradient by its sum over every rank divided by the
    number of data groups, in place (one flat all-reduce per dtype):
    with S = 1 the mean over the ranks; with S > 1 each rank's loss
    carries 1 / S and the spatial ranks' partial gradients of the sliced
    layers add up in the same sum. Every rank must pass the same list, a
    gradient the loss did not reach as zeros."""
    if world_size() == 1:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    for gs in _by_dtype(grads):
        flat = _flatten_dense_tensors(gs)
        dist.all_reduce(flat)
        flat.div_(data_size())
        torch._foreach_copy_(gs, _unflatten_dense_tensors(flat, gs))
